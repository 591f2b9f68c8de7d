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
// ascending, so results are reproducible run to run and a C block's bits
// do not depend on which other runs share its launch.  The accumulator
// is double for f64 and float for f32 and bf16 (bf16 converted on load);
// f32 never runs through TF32.
//
// Two more groups of forms, behind the same entry point (the JAX package
// runs both in XLA, dbcsr_tpu/acc/smm.py:78-135, never in Pallas):
// * complex c4/c8 (smm_stack_complex_kernel), the tiled path only (the
//   warp path's DMMA is real-only): interleaved real and imaginary
//   parts, 4 real FMAs a complex multiply-add in the storage precision,
//   complex alpha.  Bound on the c8 north star: 3.6 GB of bytes, about
//   1.07 ms; 8.1e10 real flops, 1.2 ms at the FP64 tensor-core rate or
//   2.4 ms on the FP64 CUDA cores these FMAs run on.
// * demoted compute (acc/precision.py): the operands stay at the request
//   dtype and are rounded to f32 or bf16 as they are staged (tiled) or
//   read from shared memory (warp path, smm_warp.cuh:DemTile).
//   Uncompensated, an entry's k-sum runs in f32 and is widened into the
//   run's sum; compensated, hi*hi + (hi*lo + lo*hi) of the operands'
//   hi/lo splits accumulates in the wide type.  The bytes are those of
//   the native form, and f32 CUDA-core FMAs are no faster than the FP64
//   tensor cores: demotion saves nothing on this card.

#include <type_traits>

#include "smm_warp.cuh"

namespace {

using smm::AccOf;
using smm::load_acc;
using smm::store_acc;
using smm::split_hi_lo;
using smm::to_compute;

constexpr int W = 4;    // warps (runs) of a warp-path block
constexpr int TM = 32;  // tiled path: output tile rows
constexpr int TN = 32;  // output tile cols
constexpr int TK = 16;  // depth of one staged operand slice
constexpr int NTX = 16; // threads along n; each thread owns 2 x 2 outputs
constexpr int NTY = 16; // threads along m
constexpr int NTHREADS = NTX * NTY;

template <typename T, int MAXT, typename TileT>
__global__ void __launch_bounds__(W * 32, 1)
smm_stack_warp_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ c, const int* __restrict__ a_idx,
                      const int* __restrict__ b_idx,
                      const int* __restrict__ run_ptr,
                      const int* __restrict__ run_c, int nruns, int m, int n,
                      int k, typename AccOf<T>::type alpha) {
  smm::warp_kernel<T, MAXT, smm::ConsecutiveRuns, TileT>(
      a, b, c, a_idx, b_idx, run_ptr, run_c, m, n, k, 1, alpha,
      smm::ConsecutiveRuns{nruns});
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

// The tiled path's demoted forms: CT the compute dtype (0 f32, 1 bf16),
// COMP the two-product compensation.  W is the wide type; the staged
// slices hold the compute-rounded values (in f32) or, compensated, the
// hi and lo parts (in W).
template <typename T, int CT, bool COMP>
__global__ void __launch_bounds__(NTHREADS)
smm_stack_demoted_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         T* __restrict__ c, const int* __restrict__ a_idx,
                         const int* __restrict__ b_idx,
                         const int* __restrict__ run_ptr,
                         const int* __restrict__ run_c, int m, int n, int k,
                         typename AccOf<T>::type alpha) {
  using Wt = typename AccOf<T>::type;
  using S = typename std::conditional<COMP, Wt, float>::type;
  constexpr int LM = COMP ? TM : 1, LK = COMP ? TK : 1;
  __shared__ S ah[TM][TK + 1];
  __shared__ S bh[TK][TN + 1];
  __shared__ S al[LM][TK + 1];
  __shared__ S bl[LK][TN + 1];

  const int run = blockIdx.x;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.z * TN;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * NTX + tx;
  const int64_t mk = (int64_t)m * k;
  const int64_t kn = (int64_t)k * n;

  Wt acc[2][2] = {{Wt(0), Wt(0)}, {Wt(0), Wt(0)}};
  const int e0 = run_ptr[run];
  const int e1 = run_ptr[run + 1];
  for (int e = e0; e < e1; ++e) {
    const T* ablk = a + (int64_t)a_idx[e] * mk;
    const T* bblk = b + (int64_t)b_idx[e] * kn;
    float p[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // an entry's f32 k-sum
    for (int k0 = 0; k0 < k; k0 += TK) {
      for (int i = tid; i < TM * TK; i += NTHREADS) {
        const int r = i / TK, kk = i % TK;
        const int gr = row0 + r, gk = k0 + kk;
        const Wt x = (gr < m && gk < k) ? load_acc(ablk + (int64_t)gr * k + gk) : Wt(0);
        if constexpr (COMP) {
          Wt hi, lo;
          split_hi_lo<CT>(x, hi, lo);
          ah[r][kk] = hi;
          al[r][kk] = lo;
        } else {
          ah[r][kk] = static_cast<S>(to_compute<CT>(x));
        }
      }
      for (int i = tid; i < TK * TN; i += NTHREADS) {
        const int kk = i / TN, cc = i % TN;
        const int gk = k0 + kk, gc = col0 + cc;
        const Wt x = (gk < k && gc < n) ? load_acc(bblk + (int64_t)gk * n + gc) : Wt(0);
        if constexpr (COMP) {
          Wt hi, lo;
          split_hi_lo<CT>(x, hi, lo);
          bh[kk][cc] = hi;
          bl[kk][cc] = lo;
        } else {
          bh[kk][cc] = static_cast<S>(to_compute<CT>(x));
        }
      }
      __syncthreads();
      const int kend = min(TK, k - k0);
      for (int kk = 0; kk < kend; ++kk) {
        if constexpr (COMP) {
          const Wt a0 = ah[ty][kk], a1 = ah[ty + NTY][kk];
          const Wt a0l = al[ty][kk], a1l = al[ty + NTY][kk];
          const Wt b0 = bh[kk][tx], b1 = bh[kk][tx + NTX];
          const Wt b0l = bl[kk][tx], b1l = bl[kk][tx + NTX];
          acc[0][0] += a0 * b0 + (a0 * b0l + a0l * b0);
          acc[0][1] += a0 * b1 + (a0 * b1l + a0l * b1);
          acc[1][0] += a1 * b0 + (a1 * b0l + a1l * b0);
          acc[1][1] += a1 * b1 + (a1 * b1l + a1l * b1);
        } else {
          const float a0 = ah[ty][kk], a1 = ah[ty + NTY][kk];
          const float b0 = bh[kk][tx], b1 = bh[kk][tx + NTX];
          p[0][0] = fmaf(a0, b0, p[0][0]);
          p[0][1] = fmaf(a0, b1, p[0][1]);
          p[1][0] = fmaf(a1, b0, p[1][0]);
          p[1][1] = fmaf(a1, b1, p[1][1]);
        }
      }
      __syncthreads();
    }
    if constexpr (!COMP) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) acc[i][j] += static_cast<Wt>(p[i][j]);
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
        T* q = cblk + (int64_t)r * n + cc;
        store_acc(q, load_acc(q) + alpha * acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ float cfma(float x, float y, float z) { return fmaf(x, y, z); }
__device__ __forceinline__ double cfma(double x, double y, double z) { return fma(x, y, z); }

// The complex forms (R = float for c4, double for c8): the tiled path's
// layout with the real and imaginary parts staged apart; each element
// sums its entries in stack order and k ascending, 4 FMAs a multiply-add.
template <typename R>
__global__ void __launch_bounds__(NTHREADS)
smm_stack_complex_kernel(const R* __restrict__ a, const R* __restrict__ b,
                         R* __restrict__ c, const int* __restrict__ a_idx,
                         const int* __restrict__ b_idx,
                         const int* __restrict__ run_ptr,
                         const int* __restrict__ run_c, int m, int n, int k,
                         R alpha_re, R alpha_im) {
  __shared__ R asr[TM][TK + 1], asi[TM][TK + 1];
  __shared__ R bsr[TK][TN + 1], bsi[TK][TN + 1];

  const int run = blockIdx.x;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.z * TN;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * NTX + tx;
  const int64_t mk = (int64_t)m * k;
  const int64_t kn = (int64_t)k * n;

  R re[2][2] = {{R(0), R(0)}, {R(0), R(0)}};
  R im[2][2] = {{R(0), R(0)}, {R(0), R(0)}};
  const int e0 = run_ptr[run];
  const int e1 = run_ptr[run + 1];
  for (int e = e0; e < e1; ++e) {
    const R* ablk = a + 2 * (int64_t)a_idx[e] * mk;
    const R* bblk = b + 2 * (int64_t)b_idx[e] * kn;
    for (int k0 = 0; k0 < k; k0 += TK) {
      for (int i = tid; i < TM * TK; i += NTHREADS) {
        const int r = i / TK, kk = i % TK;
        const int gr = row0 + r, gk = k0 + kk;
        const bool in = gr < m && gk < k;
        const int64_t o = 2 * ((int64_t)gr * k + gk);
        asr[r][kk] = in ? ablk[o] : R(0);
        asi[r][kk] = in ? ablk[o + 1] : R(0);
      }
      for (int i = tid; i < TK * TN; i += NTHREADS) {
        const int kk = i / TN, cc = i % TN;
        const int gk = k0 + kk, gc = col0 + cc;
        const bool in = gk < k && gc < n;
        const int64_t o = 2 * ((int64_t)gk * n + gc);
        bsr[kk][cc] = in ? bblk[o] : R(0);
        bsi[kk][cc] = in ? bblk[o + 1] : R(0);
      }
      __syncthreads();
      const int kend = min(TK, k - k0);
      for (int kk = 0; kk < kend; ++kk) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const R ar = asr[ty + i * NTY][kk], ai = asi[ty + i * NTY][kk];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const R br = bsr[kk][tx + j * NTX], bi = bsi[kk][tx + j * NTX];
            re[i][j] = cfma(ar, br, re[i][j]);
            re[i][j] = cfma(-ai, bi, re[i][j]);
            im[i][j] = cfma(ar, bi, im[i][j]);
            im[i][j] = cfma(ai, br, im[i][j]);
          }
        }
      }
      __syncthreads();
    }
  }
  R* cblk = c + 2 * (int64_t)run_c[run] * m * n;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = row0 + ty + i * NTY;
      const int cc = col0 + tx + j * NTX;
      if (r < m && cc < n) {
        R* q = cblk + 2 * ((int64_t)r * n + cc);
        const R sr = re[i][j], si = im[i][j];
        q[0] = q[0] + (alpha_re * sr - alpha_im * si);
        q[1] = q[1] + (alpha_re * si + alpha_im * sr);
      }
    }
  }
}

template <typename T, int MAXT, typename TileT>
cudaError_t launch_warp(const void* a, const void* b, void* c, const void* a_idx,
                        const void* b_idx, const void* run_ptr, const void* run_c,
                        int nruns, int m, int n, int k, double alpha,
                        cudaStream_t stream) {
  using Acc = typename AccOf<T>::type;
  const size_t smem = (size_t)W * smm::warp_geom(m, n, k, 1, sizeof(Acc)).per_warp * sizeof(Acc);
  const int ngroups = (nruns + W - 1) / W;
  int grid = 0;
  const cudaError_t err = smm::persistent_grid(smm_stack_warp_kernel<T, MAXT, TileT>,
                                               W * 32, smem, ngroups, &grid);
  if (err != cudaSuccess) return err;
  smm_stack_warp_kernel<T, MAXT, TileT><<<grid, W * 32, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      static_cast<const int*>(a_idx), static_cast<const int*>(b_idx),
      static_cast<const int*>(run_ptr), static_cast<const int*>(run_c), nruns,
      m, n, k, static_cast<Acc>(alpha));
  return cudaGetLastError();
}

// The warp path's register tile of a form: Tile for native compute
// (DMMA for f64), DemTile for a demoted one (CT >= 0).
template <typename T, int MAXT, int CT, bool COMP>
using TileOf = typename std::conditional<
    (CT < 0), smm::Tile<typename AccOf<T>::type, MAXT>,
    smm::DemTile<typename AccOf<T>::type, MAXT, (CT < 0 ? 0 : CT), COMP>>::type;

// CT = -1: native compute; 0/1: demoted to f32/bf16, COMP compensated.
template <typename T, int CT, bool COMP>
cudaError_t launch(const void* a, const void* b, void* c, const void* a_idx,
                   const void* b_idx, const void* run_ptr, const void* run_c,
                   int nruns, int m, int n, int k, double alpha,
                   cudaStream_t stream) {
  using Acc = typename AccOf<T>::type;
  if (smm::warp_dims(m, n, k)) {
    switch (smm::warp_class(m, n)) {
      case 2:
        return launch_warp<T, 2, TileOf<T, 2, CT, COMP>>(
            a, b, c, a_idx, b_idx, run_ptr, run_c, nruns, m, n, k, alpha, stream);
      case 3:
        return launch_warp<T, 3, TileOf<T, 3, CT, COMP>>(
            a, b, c, a_idx, b_idx, run_ptr, run_c, nruns, m, n, k, alpha, stream);
      default:
        return launch_warp<T, 4, TileOf<T, 4, CT, COMP>>(
            a, b, c, a_idx, b_idx, run_ptr, run_c, nruns, m, n, k, alpha, stream);
    }
  }
  const dim3 grid(nruns, (m + TM - 1) / TM, (n + TN - 1) / TN);
  const dim3 block(NTX, NTY);
  if constexpr (CT < 0) {
    smm_stack_kernel<T><<<grid, block, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
        static_cast<const int*>(a_idx), static_cast<const int*>(b_idx),
        static_cast<const int*>(run_ptr), static_cast<const int*>(run_c), m, n,
        k, static_cast<Acc>(alpha));
  } else {
    smm_stack_demoted_kernel<T, CT, COMP><<<grid, block, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
        static_cast<const int*>(a_idx), static_cast<const int*>(b_idx),
        static_cast<const int*>(run_ptr), static_cast<const int*>(run_c), m, n,
        k, static_cast<Acc>(alpha));
  }
  return cudaGetLastError();
}

template <typename R>
cudaError_t launch_complex(const void* a, const void* b, void* c, const void* a_idx,
                           const void* b_idx, const void* run_ptr, const void* run_c,
                           int nruns, int m, int n, int k, double alpha,
                           double alpha_im, cudaStream_t stream) {
  const dim3 grid(nruns, (m + TM - 1) / TM, (n + TN - 1) / TN);
  const dim3 block(NTX, NTY);
  smm_stack_complex_kernel<R><<<grid, block, 0, stream>>>(
      static_cast<const R*>(a), static_cast<const R*>(b), static_cast<R*>(c),
      static_cast<const int*>(a_idx), static_cast<const int*>(b_idx),
      static_cast<const int*>(run_ptr), static_cast<const int*>(run_c), m, n,
      k, static_cast<R>(alpha), static_cast<R>(alpha_im));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float64, 1 = float32, 2 = bfloat16, 3 = complex64,
// 4 = complex128.  compute: 0 = native, 1 = f32, 2 = f32 compensated,
// 3 = bf16, 4 = bf16 compensated (float64 takes all five, float32 the
// native and bf16 forms, the others native only).  alpha_im is the
// imaginary part of a complex alpha.  Returns the launch's cudaError_t
// (0 = success); the caller raises on anything else.
int smm_stack_launch(int dtype, int compute, const void* a, const void* b,
                     void* c, const void* a_idx, const void* b_idx,
                     const void* run_ptr, const void* run_c, int nruns, int m,
                     int n, int k, double alpha, double alpha_im, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nruns <= 0) return 0;
#define SMM_ARGS a, b, c, a_idx, b_idx, run_ptr, run_c, nruns, m, n, k, alpha, s
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0:
      switch (compute) {
        case 0: return launch<double, -1, false>(SMM_ARGS);
        case 1: return launch<double, 0, false>(SMM_ARGS);
        case 2: return launch<double, 0, true>(SMM_ARGS);
        case 3: return launch<double, 1, false>(SMM_ARGS);
        case 4: return launch<double, 1, true>(SMM_ARGS);
        default: return bad;
      }
    case 1:
      switch (compute) {
        case 0: return launch<float, -1, false>(SMM_ARGS);
        case 3: return launch<float, 1, false>(SMM_ARGS);
        case 4: return launch<float, 1, true>(SMM_ARGS);
        default: return bad;
      }
    case 2:
      return compute == 0 ? launch<__nv_bfloat16, -1, false>(SMM_ARGS) : bad;
    case 3:
      return compute == 0 ? launch_complex<float>(a, b, c, a_idx, b_idx, run_ptr, run_c,
                                                  nruns, m, n, k, alpha, alpha_im, s)
                          : bad;
    case 4:
      return compute == 0 ? launch_complex<double>(a, b, c, a_idx, b_idx, run_ptr, run_c,
                                                   nruns, m, n, k, alpha, alpha_im, s)
                          : bad;
    default:
      return bad;
  }
#undef SMM_ARGS
}

// The path a launch of this dtype and shape takes: 1 = warp path, 0 =
// tiled path (complex always takes the tiled path).
int smm_stack_path(int dtype, int m, int n, int k) {
  return dtype < 3 && smm::warp_dims(m, n, k) ? 1 : 0;
}

const char* smm_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
