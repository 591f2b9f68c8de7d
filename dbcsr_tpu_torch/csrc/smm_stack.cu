// Stack kernel: C[c] = C[c] + alpha * sum_{entries of c} A[a] @ B[b].
//
// Replaces the TPU stack kernel of the JAX package,
// dbcsr_tpu/acc/pallas_smm.py:_smm_kernel (launched by _pallas_process),
// in both its base and "kmerge" variants, which compute the same function.
// The host side (dbcsr_tpu_torch/acc/smm.py:prepare_stack) turns a stack
// sorted by destination block into one "run" per C block:
//   a_idx, b_idx : int32[S]        operand block of each entry, stack order
//   run_ptr      : int32[nruns+1]  entries of run r are run_ptr[r]..run_ptr[r+1]
//   run_c        : int32[nruns]    destination C block of run r (distinct)
// A is (Na, m, k), B is (Nb, k, n), C is (Nc, m, n), all row-major.
//
// Bound on an H100, on the f64 north-star product (10k^2, 23x23 blocks,
// occupancy 0.1): 825,573 block products in 186,045 runs (4.4 entries a
// run on average, 16 at most), 2.02e10 flops, 0.30 ms on the FP64 tensor
// cores (67 TFLOP/s).  Read once, the referenced A and B blocks and the C
// blocks read and written move 1.79 GB, 0.534 ms at 3.35 TB/s: the strict
// bound is the bytes.  But within one block row of C every entry reads a
// different B block, and B (80 MB) exceeds the 50 MB L2, so walked in C
// order the kernel moves about 3.5 GB of B, 0.08 GB of A and 1.58 GB of C,
// 5.2 GB or 1.55 ms; and every entry brings its two blocks (8.5 kB) from
// L2 into the SM.  The cost is moving blocks, not multiplying them.
//
// Two hand-written paths, picked by shape (smm_stack_path):
// * the warp path (smm_warp.cuh), for m, n, k <= 32: one warp per run,
//   W = 4 warps a block taking 4 consecutive runs (in C order they share
//   A blocks of one block row through L1 and L2), persistent blocks.  The
//   run's padded C block stays in registers, f64 products run on the FP64
//   tensor cores (DMMA), f32/bf16 on register micro-tiles, and each
//   entry's blocks are staged with cp.async, 16 bytes a lane, while the
//   previous entry multiplies, across run boundaries too.  For the 23x23
//   f64 blocks a warp holds 18.5 kB of shared memory and 188 registers:
//   two blocks of four warps an SM.  Measured on the north star (2.0 ms),
//   the kernel takes as long without its products and 1.43 ms without its
//   operand copies: staging the blocks bounds it.  Walking the runs in
//   square tiles of C blocks instead of rows (16 to 128 blocks wide)
//   changed nothing, so device-memory traffic of B does not.
// * the tiled path, for larger blocks (e.g. 100x50x20): one thread block
//   of 256 threads owns one 32x32 output tile of one C block and loops
//   over the run, staging 16-deep k slices of A and B in shared memory.
// Both: no two warps or blocks write the same element, so there are no
// atomics, and each element sums its entries in stack order and k
// ascending, so results are reproducible run to run.  The accumulator is
// double for f64 and float for f32 and bf16 (bf16 converted on load); f32
// never runs through TF32.

#include "smm_warp.cuh"

namespace {

using smm::AccOf;
using smm::load_acc;
using smm::store_acc;

constexpr int W = 4;    // warps (runs) of a warp-path block
constexpr int TM = 32;  // tiled path: output tile rows
constexpr int TN = 32;  // output tile cols
constexpr int TK = 16;  // depth of one staged operand slice
constexpr int NTX = 16; // threads along n; each thread owns 2 x 2 outputs
constexpr int NTY = 16; // threads along m
constexpr int NTHREADS = NTX * NTY;

template <typename T, int MAXT>
__global__ void __launch_bounds__(W * 32, 1)
smm_stack_warp_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ c, const int* __restrict__ a_idx,
                      const int* __restrict__ b_idx,
                      const int* __restrict__ run_ptr,
                      const int* __restrict__ run_c, int nruns, int m, int n,
                      int k, typename AccOf<T>::type alpha) {
  smm::warp_kernel<T, MAXT>(a, b, c, a_idx, b_idx, run_ptr, run_c, m, n, k,
                            1, alpha, smm::ConsecutiveRuns{nruns});
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
smm_stack_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ c, const int* __restrict__ a_idx,
                 const int* __restrict__ b_idx,
                 const int* __restrict__ run_ptr,
                 const int* __restrict__ run_c, int m, int n, int k,
                 typename AccOf<T>::type alpha) {
  using Acc = typename AccOf<T>::type;
  __shared__ Acc as[TM][TK + 1];
  __shared__ Acc bs[TK][TN + 1];

  const int run = blockIdx.x;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.z * TN;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * NTX + tx;
  const int64_t mk = (int64_t)m * k;
  const int64_t kn = (int64_t)k * n;

  Acc acc[2][2] = {{Acc(0), Acc(0)}, {Acc(0), Acc(0)}};
  const int e0 = run_ptr[run];
  const int e1 = run_ptr[run + 1];
  for (int e = e0; e < e1; ++e) {
    const T* ablk = a + (int64_t)a_idx[e] * mk;
    const T* bblk = b + (int64_t)b_idx[e] * kn;
    for (int k0 = 0; k0 < k; k0 += TK) {
      for (int i = tid; i < TM * TK; i += NTHREADS) {
        const int r = i / TK, kk = i % TK;
        const int gr = row0 + r, gk = k0 + kk;
        as[r][kk] = (gr < m && gk < k) ? load_acc(ablk + (int64_t)gr * k + gk)
                                       : Acc(0);
      }
      for (int i = tid; i < TK * TN; i += NTHREADS) {
        const int kk = i / TN, cc = i % TN;
        const int gk = k0 + kk, gc = col0 + cc;
        bs[kk][cc] = (gk < k && gc < n) ? load_acc(bblk + (int64_t)gk * n + gc)
                                        : Acc(0);
      }
      __syncthreads();
      const int kend = min(TK, k - k0);
      for (int kk = 0; kk < kend; ++kk) {
        const Acc a0 = as[ty][kk];
        const Acc a1 = as[ty + NTY][kk];
        const Acc b0 = bs[kk][tx];
        const Acc b1 = bs[kk][tx + NTX];
        acc[0][0] += a0 * b0;
        acc[0][1] += a0 * b1;
        acc[1][0] += a1 * b0;
        acc[1][1] += a1 * b1;
      }
      __syncthreads();
    }
  }
  T* cblk = c + (int64_t)run_c[run] * m * n;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = row0 + ty + i * NTY;
      const int cc = col0 + tx + j * NTX;
      if (r < m && cc < n) {
        T* p = cblk + (int64_t)r * n + cc;
        store_acc(p, load_acc(p) + alpha * acc[i][j]);
      }
    }
  }
}

template <typename T, int MAXT>
cudaError_t launch_warp(const void* a, const void* b, void* c, const void* a_idx,
                        const void* b_idx, const void* run_ptr, const void* run_c,
                        int nruns, int m, int n, int k, double alpha,
                        cudaStream_t stream) {
  using Acc = typename AccOf<T>::type;
  const size_t smem = (size_t)W * smm::warp_geom(m, n, k, 1, sizeof(Acc)).per_warp * sizeof(Acc);
  const int ngroups = (nruns + W - 1) / W;
  int grid = 0;
  const cudaError_t err = smm::persistent_grid(smm_stack_warp_kernel<T, MAXT>,
                                               W * 32, smem, ngroups, &grid);
  if (err != cudaSuccess) return err;
  smm_stack_warp_kernel<T, MAXT><<<grid, W * 32, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      static_cast<const int*>(a_idx), static_cast<const int*>(b_idx),
      static_cast<const int*>(run_ptr), static_cast<const int*>(run_c), nruns,
      m, n, k, static_cast<Acc>(alpha));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* c, const void* a_idx,
                   const void* b_idx, const void* run_ptr, const void* run_c,
                   int nruns, int m, int n, int k, double alpha,
                   cudaStream_t stream) {
  using Acc = typename AccOf<T>::type;
  if (smm::warp_dims(m, n, k)) {
    switch (smm::warp_class(m, n)) {
      case 2:
        return launch_warp<T, 2>(a, b, c, a_idx, b_idx, run_ptr, run_c, nruns,
                                 m, n, k, alpha, stream);
      case 3:
        return launch_warp<T, 3>(a, b, c, a_idx, b_idx, run_ptr, run_c, nruns,
                                 m, n, k, alpha, stream);
      default:
        return launch_warp<T, 4>(a, b, c, a_idx, b_idx, run_ptr, run_c, nruns,
                                 m, n, k, alpha, stream);
    }
  }
  const dim3 grid(nruns, (m + TM - 1) / TM, (n + TN - 1) / TN);
  const dim3 block(NTX, NTY);
  smm_stack_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      static_cast<const int*>(a_idx), static_cast<const int*>(b_idx),
      static_cast<const int*>(run_ptr), static_cast<const int*>(run_c), m, n,
      k, static_cast<Acc>(alpha));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float64, 1 = float32, 2 = bfloat16.  Returns the launch's
// cudaError_t (0 = success); the caller raises on anything else.
int smm_stack_launch(int dtype, const void* a, const void* b, void* c,
                     const void* a_idx, const void* b_idx,
                     const void* run_ptr, const void* run_c, int nruns, int m,
                     int n, int k, double alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nruns <= 0) return 0;
  switch (dtype) {
    case 0:
      return launch<double>(a, b, c, a_idx, b_idx, run_ptr, run_c, nruns, m, n,
                            k, alpha, s);
    case 1:
      return launch<float>(a, b, c, a_idx, b_idx, run_ptr, run_c, nruns, m, n,
                           k, alpha, s);
    case 2:
      return launch<__nv_bfloat16>(a, b, c, a_idx, b_idx, run_ptr, run_c,
                                   nruns, m, n, k, alpha, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The path a launch of this shape takes: 1 = warp path, 0 = tiled path.
int smm_stack_path(int m, int n, int k) { return smm::warp_dims(m, n, k) ? 1 : 0; }

const char* smm_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
