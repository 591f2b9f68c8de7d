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
// Design.  One thread block owns one pack: the P C blocks of its runs.  It
// walks the P runs together, R entries per step: each step stages the
// step's P*R A and B blocks in shared memory, then every thread adds the
// lane products of its outputs (at most MAXJ each, over all P*m*n outputs
// of the pack).  The off-diagonal products of the TPU's packed dot are not
// computed, and a lane whose run has ended idles.  At the end each output
// is written once, C = C + alpha*acc: packs own disjoint C blocks, so there
// are no atomics and no per-lane outputs to scatter, and each element sums
// in one fixed order (entry by entry in stack order, k ascending), so
// repeats are bit for bit equal.  The accumulator is double for f64 and
// float for f32 and bf16 (bf16 converted on load); f32 runs on the CUDA
// cores, never through TF32.  A step stages at most R entries per lane but
// fewer when P*R blocks of A and B would pass SMEM_BUDGET bytes of shared
// memory (the f64 23^3 pack (4, 4) would take 135 KB): staging depth
// changes no sum's order, only how often the block synchronises.
//
// The resident variant (K4) is the same body.  On the TPU "resident" meant
// the whole of A and B in VMEM; the on-chip memory of this card that can
// hold whole operand bins is the 50 MB L2.  Its launch sets aside
// persisting L2 and puts an access-policy window (hitProp persisting) on
// that one launch, and the kernel reads A and B through the read-only
// path.  CUDA allows one window per launch, so it covers one operand bin:
// the caller passes the bin with more re-reads per byte (every entry reads
// one block of each, so that is the bin with fewer blocks).  After the
// kernel the launch waits for its stream, resets the persisting lines and
// returns the set-aside to zero, so later launches inherit nothing; the
// reset is not ordered on a stream, hence the wait.
//
// Bound on an H100.  For the f32 north-star product (10k^2, 23x23 blocks,
// occupancy 0.1) the least traffic is the unique A and B blocks read once
// plus each C block read and written once, about 0.9 GB, 0.26 ms at
// 3.35 TB/s; its 2.02e10 true flops take 0.30 ms at the 67 TFLOP/s FP32
// peak, so the two limits lie close and the strict bound is the
// operations.  In f64 the same product is bound by bytes (1.79 GB,
// 0.53 ms).  Per-entry operand traffic (each entry fetching its blocks) is
// several times either.  This first design does little about it: blocks
// are re-fetched per entry, every FMA reads both operands from shared
// memory, and a pack is as slow as its longest run.  mma.sync/DMMA block
// products, TMA staging and split long runs are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXJ = 8;            // outputs each thread accumulates
constexpr int MAX_THREADS = 1024;  // so a pack holds at most 8192 outputs
constexpr int MAX_P = 128;         // P * max(m, n) <= 128 in every plan
constexpr size_t SMEM_BUDGET = 72 * 1024;        // staging a step aims under
constexpr size_t SMEM_MAX = 227 * 1024 - 4096;   // opt-in limit less static

template <typename T> struct AccOf { using type = T; };
template <> struct AccOf<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ double load_acc(const double* p) { return *p; }
__device__ __forceinline__ float load_acc(const float* p) { return *p; }
__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// read-only (non-coherent) path, for the operands of the resident launch
__device__ __forceinline__ double load_ro(const double* p) { return __ldg(p); }
__device__ __forceinline__ float load_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_ro(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void store_acc(double* p, double v) { *p = v; }
__device__ __forceinline__ void store_acc(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_acc(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

struct Shape {
  int nthreads;
  int r_stage;
  size_t smem;
};

// Threads, staged entries per step and dynamic shared memory of a launch;
// false when the pack does not fit one thread block.
template <typename Acc>
bool launch_shape(int P, int R, int m, int n, int k, Shape* s) {
  const long long total = (long long)P * m * n;
  if (P < 2 || P > MAX_P || R < 1 || m < 1 || n < 1 || k < 1 ||
      total > (long long)MAXJ * MAX_THREADS)
    return false;
  const size_t per_entry = (size_t)P * ((size_t)m * k + (size_t)k * n) * sizeof(Acc);
  if (per_entry > SMEM_MAX) return false;
  int nthr = (int)(((total + MAXJ - 1) / MAXJ + 31) / 32 * 32);
  s->nthreads = nthr < 64 ? 64 : nthr;
  size_t rs = SMEM_BUDGET / per_entry;
  if (rs < 1) rs = 1;
  if (rs > (size_t)R) rs = R;
  s->r_stage = (int)rs;
  s->smem = rs * per_entry;
  return true;
}

template <typename T, bool RESIDENT>
cudaError_t prepare_kernel(const Shape& s) {
  if (s.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(smm_crosspack_kernel<T, RESIDENT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)s.smem);
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* c, const void* a_idx,
                   const void* b_idx, const void* run_ptr, const void* run_c,
                   const void* pack_runs, int npacks, int P, int R, int m,
                   int n, int k, double alpha, cudaStream_t stream) {
  using Acc = typename AccOf<T>::type;
  Shape s;
  if (!launch_shape<Acc>(P, R, m, n, k, &s)) return cudaErrorInvalidValue;
  cudaError_t err = prepare_kernel<T, false>(s);
  if (err != cudaSuccess) return err;
  smm_crosspack_kernel<T, false><<<npacks, s.nthreads, s.smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      static_cast<const int*>(a_idx), static_cast<const int*>(b_idx),
      static_cast<const int*>(run_ptr), static_cast<const int*>(run_c),
      static_cast<const int*>(pack_runs), P, s.r_stage, m, n, k,
      static_cast<Acc>(alpha));
  return cudaGetLastError();
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
  cudaError_t err = prepare_kernel<T, true>(s);
  if (err != cudaSuccess) return err;
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(npacks);
  cfg.blockDim = dim3(s.nthreads);
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, smm_crosspack_kernel<T, true>, static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<T*>(c),
      static_cast<const int*>(a_idx), static_cast<const int*>(b_idx),
      static_cast<const int*>(run_ptr), static_cast<const int*>(run_c),
      static_cast<const int*>(pack_runs), P, s.r_stage, m, n, k,
      static_cast<Acc>(alpha));
  if (err == cudaSuccess) err = cudaGetLastError();
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
                            npacks, P, R, m, n, k, alpha, s);
    case 1:
      return launch<float>(a, b, c, a_idx, b_idx, run_ptr, run_c, pack_runs,
                           npacks, P, R, m, n, k, alpha, s);
    case 2:
      return launch<__nv_bfloat16>(a, b, c, a_idx, b_idx, run_ptr, run_c,
                                   pack_runs, npacks, P, R, m, n, k, alpha, s);
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
