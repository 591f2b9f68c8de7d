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
// Design.  The Pallas kernel walks its grid in order and carries a run's
// sum in VMEM from one grid step to the next; CUDA blocks run in no order,
// so here one thread block owns one TM x TN output tile of one C block and
// loops over the whole run itself.  No two blocks write the same element,
// so there are no atomics, and every element sums its terms in one fixed
// order (entry by entry, k ascending): results are reproducible run to run.
// Tiling over m, n and k lets the kernel take any block size (5, 13, 23,
// 100, ...), so there is no max_kernel_dim gate.  The accumulator is
// double for f64 and float for f32 and bf16 (bf16 converted on load).
//
// Bound on an H100.  The work is bound by memory.  A 23^3 f64 entry does
// 2*23^3 = 24 kflop on two 23x23 operand blocks (8.5 kB): 2.9 flop/byte
// when every entry fetches its operands, against the ~20 flop/byte at
// which the FP64 tensor cores (67 TFLOP/s) would become the limit at
// 3.35 TB/s.  The least bytes are the referenced A and B blocks once each
// plus the C blocks of the runs read and written once; on the north-star
// product that is still under 20 flop/byte.  This first design does little
// about it: operand tiles go through shared memory once per entry per
// output tile and the FMAs run on the CUDA cores in plain double/float; a
// 23x23 block fills 52% of a 32x32 tile.  TMA staging, DMMA/wgmma and
// persistent blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 32;  // output tile rows
constexpr int TN = 32;  // output tile cols
constexpr int TK = 16;  // depth of one staged operand slice
constexpr int NTX = 16; // threads along n; each thread owns 2 x 2 outputs
constexpr int NTY = 16; // threads along m
constexpr int NTHREADS = NTX * NTY;

template <typename T> struct AccOf { using type = T; };
template <> struct AccOf<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ double load_acc(const double* p) { return *p; }
__device__ __forceinline__ float load_acc(const float* p) { return *p; }
__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_acc(double* p, double v) { *p = v; }
__device__ __forceinline__ void store_acc(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_acc(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

template <typename T>
void launch(const void* a, const void* b, void* c, const void* a_idx,
            const void* b_idx, const void* run_ptr, const void* run_c,
            int nruns, int m, int n, int k, double alpha,
            cudaStream_t stream) {
  using Acc = typename AccOf<T>::type;
  const dim3 grid(nruns, (m + TM - 1) / TM, (n + TN - 1) / TN);
  const dim3 block(NTX, NTY);
  smm_stack_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      static_cast<const int*>(a_idx), static_cast<const int*>(b_idx),
      static_cast<const int*>(run_ptr), static_cast<const int*>(run_c), m, n,
      k, static_cast<Acc>(alpha));
}

}  // namespace

extern "C" {

// dtype: 0 = float64, 1 = float32, 2 = bfloat16.  Returns the launch's
// cudaGetLastError() (0 = success); the caller raises on anything else.
int smm_stack_launch(int dtype, const void* a, const void* b, void* c,
                     const void* a_idx, const void* b_idx,
                     const void* run_ptr, const void* run_c, int nruns, int m,
                     int n, int k, double alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nruns <= 0) return 0;
  switch (dtype) {
    case 0:
      launch<double>(a, b, c, a_idx, b_idx, run_ptr, run_c, nruns, m, n, k,
                     alpha, s);
      break;
    case 1:
      launch<float>(a, b, c, a_idx, b_idx, run_ptr, run_c, nruns, m, n, k,
                    alpha, s);
      break;
    case 2:
      launch<__nv_bfloat16>(a, b, c, a_idx, b_idx, run_ptr, run_c, nruns, m,
                            n, k, alpha, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* smm_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
