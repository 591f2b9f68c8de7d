// Crosspack stack kernel: C[c] = C[c] + alpha * sum_{entries of c} A[a] @ B[b],
// with P runs (one per C block) computed side by side in one thread block.
//
// Replaces the TPU crosspack kernels of the JAX package,
// dbcsr_tpu/acc/pallas_smm.py:
//   _crosspack_kernel (with _crosspack_epilogue), launched by
//     _pallas_crosspack                       -> smm_crosspack_launch
//   _crosspack_vmem_kernel (A and B resident on chip), launched by
//     _pallas_crosspack_vmem                  -> smm_crosspack_resident_launch
// On the TPU, P runs dealt onto lanes were packed into one block-diagonal
// (R*k, P*m)^T x (R*k, P*n) dot per grid step, each lane carried its run's
// sum in VMEM from step to step, and per-lane outputs were scattered back
// into C.  Here the host (dbcsr_tpu_torch/acc/crosspack.py) sorts the runs
// by length and deals them into packs of P:
//   a_idx, b_idx : int32[S]          operand block of each entry, stack order
//   run_ptr      : int32[nruns+1]    entries of run r are run_ptr[r]..run_ptr[r+1]
//   run_c        : int32[nruns]      destination C block of run r (distinct)
//   pack_runs    : int32[npacks*P]   the runs of each pack, -1 = empty slot
// A is (Na, m, k), B is (Nb, k, n), C is (Nc, m, n), all row-major.
//
// Bound on an H100.  For the f32 north-star product (10k^2, 23x23 blocks,
// occupancy 0.1: 825,573 block products in 186,045 runs) the least traffic
// is the unique A and B blocks read once plus each C block read and
// written once, about 0.9 GB, 0.27 ms at 3.35 TB/s; its 2.02e10 true
// flops take 0.30 ms at the 67 TFLOP/s FP32 peak, so the strict bound is
// the operations.  Dealing runs by length scatters neighbouring runs over
// all block rows, so every entry fetches its A and B blocks: about 4.3 GB
// of block traffic, 1.29 ms at 3.35 TB/s if none of it hit in L2.
//
// Two hand-written paths, picked by shape (smm_crosspack_path):
// * the warp path (smm_warp.cuh), for m, n, k <= 32 and P <= MAX_WARPS
//   when P warps' buffers fit shared memory: one pack is one block of P
//   warps, one run each; persistent blocks loop over packs.  Each warp
//   keeps its run's padded C block in registers (f64: DMMA tiles; f32 and
//   bf16: register micro-tiles in full f32, half a shared load an FMA),
//   stages the next step's blocks with cp.async, 16 bytes a lane, while it
//   multiplies the current one, and writes C once.  R keeps its meaning,
//   entries staged per step: a step stages at most R entries a warp, fewer
//   when P warps' double buffers would pass SMEM_BUDGET bytes (the f32
//   23^3 pack (4, 4) stages one).  Measured on the f32 north star (2.0
//   ms), the kernel takes 1.65 ms without its operand copies and 0.85 ms
//   without its products: the FMAs and their shared-memory loads bound it.
// * the tiled path, for wider packs (m or n up to 64, or more than
//   MAX_WARPS runs): each thread accumulates up to MAXJ outputs of the
//   pack's P*m*n, and the block walks the P runs together, staging R
//   entries per step (fewer above SMEM_BUDGET) in shared memory.
// Both compute only the diagonal products of the TPU's packed dot; packs
// own disjoint C blocks, so there are no atomics and no per-lane outputs
// to scatter, and each element sums in one fixed order (entry by entry in
// stack order, k ascending), so repeats are bit for bit equal.  The
// accumulator is double for f64 and float for f32 and bf16; f32 runs on
// the CUDA cores, never through TF32.  Staging depth changes no sum's
// order, only how often a warp or block waits.
//
// The resident variant (K4) is the same kernel with another launch.  On
// the TPU "resident" meant the whole of A and B in VMEM; the on-chip
// memory of this card that can hold whole operand bins is the 50 MB L2.
// Its launch sets aside persisting L2 and puts an access-policy window
// (hitProp persisting) on that one launch.  CUDA allows one window per
// launch, so it covers one operand bin: the caller passes the bin with
// more re-reads per byte (every entry reads one block of each, so that is
// the bin with fewer blocks).  After the kernel the launch waits for its
// stream, resets the persisting lines and returns the set-aside to zero,
// so later launches inherit nothing; the reset is not ordered on a
// stream, hence the wait.

#include "smm_warp.cuh"

namespace {

using smm::AccOf;
using smm::load_acc;
using smm::load_ro;
using smm::store_acc;

constexpr int MAXJ = 8;            // tiled path: outputs each thread accumulates
constexpr int MAX_THREADS = 1024;  // so a pack holds at most 8192 outputs
constexpr int MAX_P = 128;         // P * max(m, n) <= 128 in every plan
constexpr int MAX_WARPS = 8;       // warp path: runs (warps) of a pack
constexpr size_t SMEM_BUDGET = 72 * 1024;       // staging a step aims under
constexpr size_t SMEM_MAX = 227 * 1024 - 4096;  // opt-in limit less static

template <typename T, bool RESIDENT>
__device__ __forceinline__ typename AccOf<T>::type load_operand(const T* p) {
  if constexpr (RESIDENT) {
    return load_ro(p);
  } else {
    return load_acc(p);
  }
}

template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(MAX_THREADS)
smm_crosspack_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     T* __restrict__ c, const int* __restrict__ a_idx,
                     const int* __restrict__ b_idx,
                     const int* __restrict__ run_ptr,
                     const int* __restrict__ run_c,
                     const int* __restrict__ pack_runs, int P, int R, int m,
                     int n, int k, typename AccOf<T>::type alpha) {
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int lane_e0[MAX_P];
  __shared__ int lane_len[MAX_P];
  __shared__ int lane_cblk[MAX_P];

  const int mk = m * k, kn = k * n, mn = m * n;
  Acc* as = reinterpret_cast<Acc*>(smem_raw);  // [P][R][m][k]
  Acc* bs = as + (size_t)P * R * mk;           // [P][R][k][n]
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  if (tid < P) {
    const int r = pack_runs[(int64_t)blockIdx.x * P + tid];
    int e0 = 0, len = 0, cb = 0;
    if (r >= 0) {
      e0 = run_ptr[r];
      len = run_ptr[r + 1] - e0;
      cb = run_c[r];
    }
    lane_e0[tid] = e0;
    lane_len[tid] = len;
    lane_cblk[tid] = cb;
  }
  __syncthreads();
  int longest = 0;
  for (int p = 0; p < P; ++p) longest = max(longest, lane_len[p]);

  // output o = tid + j * nthr is element (r, cc) of lane p
  Acc acc[MAXJ];
  int lane_of[MAXJ], aoff[MAXJ], boff[MAXJ];
  const int total = P * mn;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    acc[j] = Acc(0);
    const int o = tid + j * nthr;
    lane_of[j] = -1;
    aoff[j] = boff[j] = 0;
    if (o < total) {
      const int p = o / mn, rem = o - p * mn;
      const int r = rem / n, cc = rem - r * n;
      lane_of[j] = p;
      aoff[j] = p * R * mk + r * k;
      boff[j] = p * R * kn + cc;
    }
  }

  const int warp = tid / 32, wlane = tid % 32, nwarps = nthr / 32;
  for (int s0 = 0; s0 < longest; s0 += R) {
    // each warp copies whole blocks: slot = (lane p, entry e of the step)
    for (int slot = warp; slot < P * R; slot += nwarps) {
      const int p = slot / R, e = slot - p * R;
      if (s0 + e >= lane_len[p]) continue;
      const int ent = lane_e0[p] + s0 + e;
      const T* asrc = a + (int64_t)a_idx[ent] * mk;
      const T* bsrc = b + (int64_t)b_idx[ent] * kn;
      Acc* adst = as + (size_t)slot * mk;
      Acc* bdst = bs + (size_t)slot * kn;
      for (int w = wlane; w < mk; w += 32) adst[w] = load_operand<T, RESIDENT>(asrc + w);
      for (int w = wlane; w < kn; w += 32) bdst[w] = load_operand<T, RESIDENT>(bsrc + w);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      if (lane_of[j] < 0) continue;
      const int cnt = min(R, lane_len[lane_of[j]] - s0);
      Acc sum = acc[j];
      for (int e = 0; e < cnt; ++e) {
        const Acc* ap = as + aoff[j] + e * mk;
        const Acc* bp = bs + boff[j] + e * kn;
        for (int kk = 0; kk < k; ++kk) sum += ap[kk] * bp[kk * n];
      }
      acc[j] = sum;
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int p = lane_of[j];
    if (p < 0 || lane_len[p] == 0) continue;
    const int rem = tid + j * nthr - p * mn;
    T* dst = c + (int64_t)lane_cblk[p] * mn + rem;
    store_acc(dst, load_acc(dst) + alpha * acc[j]);
  }
}

template <typename T, int MAXT>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
smm_crosspack_warp_kernel(const T* __restrict__ a, const T* __restrict__ b,
                          T* __restrict__ c, const int* __restrict__ a_idx,
                          const int* __restrict__ b_idx,
                          const int* __restrict__ run_ptr,
                          const int* __restrict__ run_c,
                          const int* __restrict__ pack_runs, int npacks, int m,
                          int n, int k, int r, typename AccOf<T>::type alpha) {
  smm::warp_kernel<T, MAXT>(a, b, c, a_idx, b_idx, run_ptr, run_c, m, n, k, r,
                            alpha, smm::PackRuns{pack_runs, npacks});
}

struct Shape {
  bool warp;       // the warp path
  int nthreads;
  int r_stage;     // entries staged per step
  size_t smem;
};

// The path, threads, staged entries per step and dynamic shared memory
// of a launch; false when the pack fits neither path.
template <typename Acc>
bool launch_shape(int P, int R, int m, int n, int k, Shape* s) {
  const long long total = (long long)P * m * n;
  if (P < 2 || P > MAX_P || R < 1 || m < 1 || n < 1 || k < 1 ||
      total > (long long)MAXJ * MAX_THREADS)
    return false;
  if (smm::warp_dims(m, n, k) && P <= MAX_WARPS) {
    int rs = 1;
    while (rs < R && (size_t)P * smm::warp_geom(m, n, k, rs + 1, sizeof(Acc)).per_warp *
                             sizeof(Acc) <= SMEM_BUDGET)
      ++rs;
    const size_t smem = (size_t)P * smm::warp_geom(m, n, k, rs, sizeof(Acc)).per_warp * sizeof(Acc);
    if (smem <= SMEM_MAX) {
      *s = {true, 32 * P, rs, smem};
      return true;
    }
  }
  const size_t per_entry = (size_t)P * ((size_t)m * k + (size_t)k * n) * sizeof(Acc);
  if (per_entry > SMEM_MAX) return false;
  const int nthr = (int)(((total + MAXJ - 1) / MAXJ + 31) / 32 * 32);
  size_t rs = SMEM_BUDGET / per_entry;
  if (rs < 1) rs = 1;
  if (rs > (size_t)R) rs = R;
  *s = {false, nthr < 64 ? 64 : nthr, (int)rs, rs * per_entry};
  return true;
}

template <typename T, int MAXT>
cudaError_t launch_warp(const Shape& s, const void* a, const void* b, void* c,
                        const void* a_idx, const void* b_idx, const void* run_ptr,
                        const void* run_c, const void* pack_runs, int npacks,
                        int m, int n, int k, double alpha, cudaStream_t stream,
                        cudaLaunchAttribute* attr) {
  using Acc = typename AccOf<T>::type;
  int grid = 0;
  const cudaError_t err = smm::persistent_grid(smm_crosspack_warp_kernel<T, MAXT>,
                                               s.nthreads, s.smem, npacks, &grid);
  if (err != cudaSuccess) return err;
  return smm::launch_kernel(
      smm_crosspack_warp_kernel<T, MAXT>, grid, s.nthreads, s.smem, stream, attr,
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      static_cast<const int*>(a_idx), static_cast<const int*>(b_idx),
      static_cast<const int*>(run_ptr), static_cast<const int*>(run_c),
      static_cast<const int*>(pack_runs), npacks, m, n, k, s.r_stage,
      static_cast<Acc>(alpha));
}

template <typename T, bool RESIDENT>
cudaError_t launch_tiled(const Shape& s, const void* a, const void* b, void* c,
                         const void* a_idx, const void* b_idx, const void* run_ptr,
                         const void* run_c, const void* pack_runs, int npacks,
                         int P, int m, int n, int k, double alpha,
                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  using Acc = typename AccOf<T>::type;
  if (s.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        smm_crosspack_kernel<T, RESIDENT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
    if (err != cudaSuccess) return err;
  }
  return smm::launch_kernel(
      smm_crosspack_kernel<T, RESIDENT>, npacks, s.nthreads, s.smem, stream, attr,
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      static_cast<const int*>(a_idx), static_cast<const int*>(b_idx),
      static_cast<const int*>(run_ptr), static_cast<const int*>(run_c),
      static_cast<const int*>(pack_runs), P, s.r_stage, m, n, k,
      static_cast<Acc>(alpha));
}

// One launch of either path; attr, when given, is the resident launch's
// access-policy window.
template <typename T>
cudaError_t launch(const void* a, const void* b, void* c, const void* a_idx,
                   const void* b_idx, const void* run_ptr, const void* run_c,
                   const void* pack_runs, int npacks, int P, int R, int m,
                   int n, int k, double alpha, cudaStream_t stream,
                   cudaLaunchAttribute* attr) {
  using Acc = typename AccOf<T>::type;
  Shape s;
  if (!launch_shape<Acc>(P, R, m, n, k, &s)) return cudaErrorInvalidValue;
  if (s.warp) {
    switch (smm::warp_class(m, n)) {
      case 2:
        return launch_warp<T, 2>(s, a, b, c, a_idx, b_idx, run_ptr, run_c,
                                 pack_runs, npacks, m, n, k, alpha, stream, attr);
      case 3:
        return launch_warp<T, 3>(s, a, b, c, a_idx, b_idx, run_ptr, run_c,
                                 pack_runs, npacks, m, n, k, alpha, stream, attr);
      default:
        return launch_warp<T, 4>(s, a, b, c, a_idx, b_idx, run_ptr, run_c,
                                 pack_runs, npacks, m, n, k, alpha, stream, attr);
    }
  }
  if (attr)
    return launch_tiled<T, true>(s, a, b, c, a_idx, b_idx, run_ptr, run_c,
                                 pack_runs, npacks, P, m, n, k, alpha, stream, attr);
  return launch_tiled<T, false>(s, a, b, c, a_idx, b_idx, run_ptr, run_c,
                                pack_runs, npacks, P, m, n, k, alpha, stream, attr);
}

template <typename T>
cudaError_t launch_resident(const void* a, const void* b, void* c,
                            const void* a_idx, const void* b_idx,
                            const void* run_ptr, const void* run_c,
                            const void* pack_runs, int npacks, int P, int R,
                            int m, int n, int k, double alpha,
                            const void* window, size_t window_bytes,
                            cudaStream_t stream) {
  using Acc = typename AccOf<T>::type;
  Shape s;
  if (!launch_shape<Acc>(P, R, m, n, k, &s) || window == nullptr ||
      window_bytes == 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  int dev = 0, max_persist = 0, max_window = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_persist, cudaDevAttrMaxPersistingL2CacheSize, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_window, cudaDevAttrMaxAccessPolicyWindowSize, dev);
  if (err != cudaSuccess) return err;
  if (max_persist <= 0 || max_window <= 0) return cudaErrorNotSupported;
  const size_t set_aside =
      window_bytes < (size_t)max_persist ? window_bytes : (size_t)max_persist;
  const size_t num_bytes =
      window_bytes < (size_t)max_window ? window_bytes : (size_t)max_window;
  err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, set_aside);
  if (err != cudaSuccess) return err;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeAccessPolicyWindow;
  attr[0].val.accessPolicyWindow.base_ptr = const_cast<void*>(window);
  attr[0].val.accessPolicyWindow.num_bytes = num_bytes;
  attr[0].val.accessPolicyWindow.hitRatio =
      set_aside >= num_bytes ? 1.0f : (float)set_aside / (float)num_bytes;
  attr[0].val.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
  attr[0].val.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
  err = launch<T>(a, b, c, a_idx, b_idx, run_ptr, run_c, pack_runs, npacks, P,
                  R, m, n, k, alpha, stream, attr);
  // undo the set-aside whatever happened, and report the first failure
  const cudaError_t sync = cudaStreamSynchronize(stream);
  const cudaError_t reset = cudaCtxResetPersistingL2Cache();
  const cudaError_t limit = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0);
  if (err != cudaSuccess) return err;
  if (sync != cudaSuccess) return sync;
  if (reset != cudaSuccess) return reset;
  return limit;
}

}  // namespace

extern "C" {

// dtype: 0 = float64, 1 = float32, 2 = bfloat16.  Each returns the launch's
// cudaError_t (0 = success); the caller raises on anything else.
int smm_crosspack_launch(int dtype, const void* a, const void* b, void* c,
                         const void* a_idx, const void* b_idx,
                         const void* run_ptr, const void* run_c,
                         const void* pack_runs, int npacks, int P, int R,
                         int m, int n, int k, double alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npacks <= 0) return 0;
  switch (dtype) {
    case 0:
      return launch<double>(a, b, c, a_idx, b_idx, run_ptr, run_c, pack_runs,
                            npacks, P, R, m, n, k, alpha, s, nullptr);
    case 1:
      return launch<float>(a, b, c, a_idx, b_idx, run_ptr, run_c, pack_runs,
                           npacks, P, R, m, n, k, alpha, s, nullptr);
    case 2:
      return launch<__nv_bfloat16>(a, b, c, a_idx, b_idx, run_ptr, run_c,
                                   pack_runs, npacks, P, R, m, n, k, alpha, s,
                                   nullptr);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The resident launch: ``window`` .. ``window + window_bytes`` is the
// operand bin the launch keeps in persisting L2.
int smm_crosspack_resident_launch(int dtype, const void* a, const void* b,
                                  void* c, const void* a_idx,
                                  const void* b_idx, const void* run_ptr,
                                  const void* run_c, const void* pack_runs,
                                  int npacks, int P, int R, int m, int n,
                                  int k, double alpha, const void* window,
                                  long long window_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npacks <= 0) return 0;
  if (window_bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t wb = static_cast<size_t>(window_bytes);
  switch (dtype) {
    case 0:
      return launch_resident<double>(a, b, c, a_idx, b_idx, run_ptr, run_c,
                                     pack_runs, npacks, P, R, m, n, k, alpha,
                                     window, wb, s);
    case 1:
      return launch_resident<float>(a, b, c, a_idx, b_idx, run_ptr, run_c,
                                    pack_runs, npacks, P, R, m, n, k, alpha,
                                    window, wb, s);
    case 2:
      return launch_resident<__nv_bfloat16>(a, b, c, a_idx, b_idx, run_ptr,
                                            run_c, pack_runs, npacks, P, R, m,
                                            n, k, alpha, window, wb, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The path a launch of this pack takes: 1 = warp path, 0 = tiled path,
// -1 = no path (the launch would fail with cudaErrorInvalidValue).
int smm_crosspack_path(int dtype, int P, int R, int m, int n, int k) {
  Shape s;
  bool ok = false;
  switch (dtype) {
    case 0: ok = launch_shape<double>(P, R, m, n, k, &s); break;
    case 1:
    case 2: ok = launch_shape<float>(P, R, m, n, k, &s); break;
    default: return -1;
  }
  return ok ? (s.warp ? 1 : 0) : -1;
}

// The card's persisting-L2 limit in bytes (cudaDevAttrMaxPersistingL2CacheSize).
int smm_crosspack_persisting_l2_max(int device, long long* out) {
  int v = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxPersistingL2CacheSize, device);
  *out = v;
  return static_cast<int>(err);
}

const char* smm_crosspack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
