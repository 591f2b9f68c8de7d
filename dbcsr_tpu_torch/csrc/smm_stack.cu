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
// A second entry point, smm_superstack_launch, is the fused launch of
// one C bin: every span of the bin (each with its own k) in one launch,
// bit for bit the per-span launches (the superstack section below).
//
// Two more groups of forms, behind the same entry point (the JAX package
// runs both in XLA, dbcsr_tpu/acc/smm.py:78-135, never in Pallas), both
// on both paths (the warp path's register tiles in smm_warp.cuh):
// * complex c4/c8: interleaved real and imaginary parts, complex alpha.
//   On the warp path the parts are staged as they lie and a fragment
//   reads both parts of an element in one load; c8 runs 4 DMMAs a tile
//   and k-step (Ar.Br, (-Ai).Bi, Ar.Bi, Ai.Br) with two warps a block
//   (each warp's slots take 37 kB at 23x23x23) and reads C at the end of
//   a run (two register tiles leave no room for it); c4 runs 4 f32 FMAs
//   a multiply-add on Tile<float>'s lane layout.  The tiled path
//   (smm_stack_complex_kernel) stays for larger blocks.  Bound on the
//   north star: 8.0e10 real flops, 1.20 ms at 67 TFLOP/s on the FP64
//   tensor cores (c8) or the f32 CUDA cores (c4); the bytes take less.
// * demoted compute (acc/precision.py): the operands stay at the request
//   dtype in device memory and are converted once, as each staged slot
//   lands (warp path) or each slice is staged (tiled path).
//   Uncompensated, an entry's k-sum runs in f32 and is widened into the
//   run's sum: f64->f32 on f32 FMAs, ->bf16 on the bf16 tensor cores
//   (mma.sync m16n8k16, f32 out).  Compensated, each product of the
//   operands' hi/lo splits is summed in the wide type: for f64 data one
//   DMMA product of depth 3k over the hi and lo parts, which are exact
//   in f64 (at least 3x the FP64 tensor cores' time for native f64's
//   products, where `stack_bound_s` takes the compute type's peak); for
//   f32 data the bf16 tensor cores into the f32 sum.  Each form moves
//   the native form's bytes.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (perf/tree_ab.py,
// this source against the tiled complex and per-read-converting demoted
// kernels in turns, north star per multiply, `test_H2O` per product):
// c8 8.5 ms (11.7 before; bound 1.22 ms), c4 5.2 ms (8.9; 1.21), f64->f32
// 4.0 ms (7.2; 0.534 ms, bytes), against native f64 K1's 2.1 ms.  On
// `test_H2O` (native f64 K1 1.1 ms, bound 0.21): f64->f32c 3.7 ms (6.1-6.4;
// bound 0.62 ms, its DMMA products alone), f64->bf16c 4.2 ms (8.1; 0.043),
// f64->bf16 1.9 ms (6.1-6.2; 0.043), f32->bf16c 2.8 ms (3.7; 0.042),
// f32->bf16 1.5 ms (3.4; 0.022).  Every form inherits native K1's
// staging-bound warp pipeline (see above) and adds its own work per entry.

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

// WN warps a block; Z = 2 for complex data (T its real type)
template <typename T, int MAXT, typename TileT, int WN, int Z>
__global__ void __launch_bounds__(WN * 32, 1)
smm_stack_warp_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ c, const int* __restrict__ a_idx,
                      const int* __restrict__ b_idx,
                      const int* __restrict__ run_ptr,
                      const int* __restrict__ run_c, int nruns, int m, int n,
                      int k, typename AccOf<T>::type alpha,
                      typename AccOf<T>::type alpha_im) {
  smm::warp_kernel<T, MAXT, smm::ConsecutiveRuns, TileT, Z>(
      a, b, c, a_idx, b_idx, run_ptr, run_c, m, n, k, 1, alpha,
      smm::ConsecutiveRuns{nruns}, alpha_im);
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

// One launch's arguments.  attrs non-null asks for the instance's
// attributes instead of a launch: registers a thread, local (spilled)
// bytes a thread, shared bytes a block, warps a block, blocks an SM.
struct Args {
  const void *a, *b;
  void* c;
  const void *a_idx, *b_idx, *run_ptr, *run_c;
  int nruns, m, n, k;
  double alpha, alpha_im;
  cudaStream_t stream;
  int* attrs;
};

template <typename K>
cudaError_t kernel_attrs(K kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)(smem + fa.sharedSizeBytes);
  out[3] = threads / 32;
  out[4] = per_sm;
  return err;
}

template <typename T, int MAXT, typename TileT, int WN = W, int Z = 1>
cudaError_t launch_warp(const Args& x) {
  using Acc = typename AccOf<T>::type;
  const size_t smem = (size_t)WN *
                      smm::warp_geom(x.m, x.n, x.k, 1, sizeof(Acc), Z,
                                     TileT::plane_bytes(x.m, x.n, x.k)).per_warp *
                      sizeof(Acc);
  const auto kernel = smm_stack_warp_kernel<T, MAXT, TileT, WN, Z>;
  int grid = 0;
  const cudaError_t err =
      smm::persistent_grid(kernel, WN * 32, smem, (x.nruns + WN - 1) / WN, &grid);
  if (err != cudaSuccess) return err;
  if (x.attrs) return kernel_attrs(kernel, WN * 32, smem, x.attrs);
  kernel<<<grid, WN * 32, smem, x.stream>>>(
      static_cast<const T*>(x.a), static_cast<const T*>(x.b), static_cast<T*>(x.c),
      static_cast<const int*>(x.a_idx), static_cast<const int*>(x.b_idx),
      static_cast<const int*>(x.run_ptr), static_cast<const int*>(x.run_c), x.nruns, x.m,
      x.n, x.k, static_cast<Acc>(x.alpha), static_cast<Acc>(x.alpha_im));
  return cudaGetLastError();
}

// The warp path's register tile of a form (smm_warp.cuh): CT = -1 native
// (Tile: DMMA for f64, FMAs for f32/bf16); demoted to f32 (CT 0) or bf16
// (CT 1), COMP compensated.
template <typename T, int MAXT, int CT, bool COMP> struct FormTile {
  using type = smm::Tile<typename AccOf<T>::type, MAXT>;
};
template <int MAXT> struct FormTile<double, MAXT, 0, false> {
  using type = smm::F32Tile<MAXT>;
};
template <int MAXT> struct FormTile<double, MAXT, 0, true> {
  using type = smm::CompTile<MAXT, 0>;
};
template <int MAXT> struct FormTile<double, MAXT, 1, false> {
  using type = smm::BfTile<double, MAXT, false>;
};
template <int MAXT> struct FormTile<double, MAXT, 1, true> {
  using type = smm::CompTile<MAXT, 1>;
};
template <int MAXT> struct FormTile<float, MAXT, 1, false> {
  using type = smm::BfTile<float, MAXT, false>;
};
template <int MAXT> struct FormTile<float, MAXT, 1, true> {
  using type = smm::BfTile<float, MAXT, true>;
};

// CT = -1: native compute; 0/1: demoted to f32/bf16, COMP compensated.
template <typename T, int CT, bool COMP>
cudaError_t launch(const Args& x) {
  using Acc = typename AccOf<T>::type;
  if (smm::warp_dims(x.m, x.n, x.k)) {
    switch (smm::warp_class(x.m, x.n)) {
      case 2: return launch_warp<T, 2, typename FormTile<T, 2, CT, COMP>::type>(x);
      case 3: return launch_warp<T, 3, typename FormTile<T, 3, CT, COMP>::type>(x);
      default: return launch_warp<T, 4, typename FormTile<T, 4, CT, COMP>::type>(x);
    }
  }
  const dim3 grid(x.nruns, (x.m + TM - 1) / TM, (x.n + TN - 1) / TN);
  const dim3 block(NTX, NTY);
#define TILED_ARGS                                                                     \
  static_cast<const T*>(x.a), static_cast<const T*>(x.b), static_cast<T*>(x.c),        \
      static_cast<const int*>(x.a_idx), static_cast<const int*>(x.b_idx),              \
      static_cast<const int*>(x.run_ptr), static_cast<const int*>(x.run_c), x.m, x.n, x.k, \
      static_cast<Acc>(x.alpha)
  if constexpr (CT < 0) {
    if (x.attrs) return kernel_attrs(smm_stack_kernel<T>, NTHREADS, 0, x.attrs);
    smm_stack_kernel<T><<<grid, block, 0, x.stream>>>(TILED_ARGS);
  } else {
    if (x.attrs)
      return kernel_attrs(smm_stack_demoted_kernel<T, CT, COMP>, NTHREADS, 0, x.attrs);
    smm_stack_demoted_kernel<T, CT, COMP><<<grid, block, 0, x.stream>>>(TILED_ARGS);
  }
#undef TILED_ARGS
  return cudaGetLastError();
}

// c8 takes two warps a block: a warp's two step buffers hold 37 kB at
// 23x23x23, so three such blocks fill an SM
template <typename R>
cudaError_t launch_complex(const Args& x) {
  constexpr int WN = sizeof(R) == 8 ? 2 : W;
  if (smm::warp_dims(x.m, x.n, x.k)) {
    switch (smm::warp_class(x.m, x.n)) {
      case 2: return launch_warp<R, 2, smm::CTile<R, 2>, WN, 2>(x);
      case 3: return launch_warp<R, 3, smm::CTile<R, 3>, WN, 2>(x);
      default: return launch_warp<R, 4, smm::CTile<R, 4>, WN, 2>(x);
    }
  }
  if (x.attrs) return kernel_attrs(smm_stack_complex_kernel<R>, NTHREADS, 0, x.attrs);
  const dim3 grid(x.nruns, (x.m + TM - 1) / TM, (x.n + TN - 1) / TN);
  const dim3 block(NTX, NTY);
  smm_stack_complex_kernel<R><<<grid, block, 0, x.stream>>>(
      static_cast<const R*>(x.a), static_cast<const R*>(x.b), static_cast<R*>(x.c),
      static_cast<const int*>(x.a_idx), static_cast<const int*>(x.b_idx),
      static_cast<const int*>(x.run_ptr), static_cast<const int*>(x.run_c), x.m, x.n, x.k,
      static_cast<R>(x.alpha), static_cast<R>(x.alpha_im));
  return cudaGetLastError();
}

// dtype: 0 = float64, 1 = float32, 2 = bfloat16, 3 = complex64,
// 4 = complex128.  compute: 0 = native, 1 = f32, 2 = f32 compensated,
// 3 = bf16, 4 = bf16 compensated (float64 takes all five, float32 the
// native and bf16 forms, the others native only).
cudaError_t dispatch(int dtype, int compute, const Args& x) {
  const cudaError_t bad = cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      switch (compute) {
        case 0: return launch<double, -1, false>(x);
        case 1: return launch<double, 0, false>(x);
        case 2: return launch<double, 0, true>(x);
        case 3: return launch<double, 1, false>(x);
        case 4: return launch<double, 1, true>(x);
        default: return bad;
      }
    case 1:
      switch (compute) {
        case 0: return launch<float, -1, false>(x);
        case 3: return launch<float, 1, false>(x);
        case 4: return launch<float, 1, true>(x);
        default: return bad;
      }
    case 2: return compute == 0 ? launch<__nv_bfloat16, -1, false>(x) : bad;
    case 3: return compute == 0 ? launch_complex<float>(x) : bad;
    case 4: return compute == 0 ? launch_complex<double>(x) : bad;
    default: return bad;
  }
}


// ------------------------------------------------------------ superstack
// The fused launch of one C bin (acc/smm.py:execute_superstack): every
// span of the bin (one (A bin, B bin) pair each, sharing the bin's m and
// n, each with its own k) in ONE launch, where the per-span path launches
// the kernels above once per span.  Replaces the JAX package's fused
// chain of K1 launches inside one jit, dbcsr_tpu/acc/smm.py:_fused_fn
// (pallas_smm.process_launches, dbcsr_tpu/acc/pallas_smm.py:765).
//
// The host (stack_kernel.superstack_table) merges the spans' runs into
// one run per C block, each a list of segments in span order; segment j
// is the entries seg_beg[j]..seg_end[j] of span seg_span[j]'s own stack
// arrays.  A warp (warp path) or a thread block per 32x32 tile (tiled
// path) owns a C block and walks its segments in span order: each
// segment's products are summed exactly as the per-span launch sums its
// run (the same register tile, entry order and k order), and after each
// segment C = C + alpha * sum is stored as the per-span launch stores it
// at the end of its run.  So the fused result is bit for bit the
// per-span result, and a C block touched by one span costs what it costs
// per span.  The operands are staged synchronously, one entry at a time:
// a simple kernel that is right, not a tuned one (its bound is the
// per-span kernels' bytes less the C round-trips it saves).
constexpr int MAX_SPANS = 32;  // spans of one fused launch

struct SpanTable {
  const void* a[MAX_SPANS];      // the span's A bin (Na, m, k)
  const void* b[MAX_SPANS];      // its B bin (Nb, k, n)
  const int* a_idx[MAX_SPANS];   // its stack's operand indices
  const int* b_idx[MAX_SPANS];
  int k[MAX_SPANS];
};

// one warp's shared memory: one entry slot at the bins' largest k, then
// the C block's sum
__host__ __device__ inline int fused_per_warp(int m, int n, int kmax, int size) {
  const int q = 16 / size;
  const smm::WarpGeom g = smm::warp_geom(m, n, kmax, 1, size);
  return smm::round_up(g.slot, q) + smm::round_up(8 * g.mt * g.sb, q);
}

template <typename T, int MAXT, typename TileT>
__global__ void __launch_bounds__(W * 32, 1)
smm_superstack_warp_kernel(SpanTable spans, T* __restrict__ c,
                           const int* __restrict__ seg_span,
                           const int* __restrict__ seg_beg,
                           const int* __restrict__ seg_end,
                           const int* __restrict__ run_ptr,
                           const int* __restrict__ run_c, int nruns, int m,
                           int n, int kmax, typename AccOf<T>::type alpha) {
  using S = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* const sm = reinterpret_cast<S*>(smem_raw);
  const int per_warp = fused_per_warp(m, n, kmax, sizeof(S));
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  S* const slot = sm + warp * per_warp;
  S* const cs = slot + smm::round_up(smm::warp_geom(m, n, kmax, 1, sizeof(S)).slot,
                                     16 / (int)sizeof(S));
  const smm::FlatIter itn = smm::flat_iter(n, lane);
  const int mn = m * n;
  for (int i = 0;; ++i) {
    const int run = (blockIdx.x + i * gridDim.x) * nw + warp;
    if (run >= nruns) break;
    T* const cblk = c + (int64_t)__ldg(run_c + run) * mn;
    const int s0 = __ldg(run_ptr + run), s1 = __ldg(run_ptr + run + 1);
    for (int sg = s0; sg < s1; ++sg) {
      const int sp = __ldg(seg_span + sg);
      const int k = spans.k[sp];
      const T* const a = static_cast<const T*>(spans.a[sp]);
      const T* const b = static_cast<const T*>(spans.b[sp]);
      const int* const ai = spans.a_idx[sp];
      const int* const bi = spans.b_idx[sp];
      const smm::WarpGeom g = smm::warp_geom(m, n, k, 1, sizeof(S));
      const int mk = m * k, kn = k * n;
      TileT acc;
      acc.zero();
      const int e1 = __ldg(seg_end + sg);
      for (int e = __ldg(seg_beg + sg); e < e1; ++e) {
        const int oa = smm::stage_flat(slot, a + (int64_t)__ldg(ai + e) * mk, mk, lane);
        const int ob = smm::stage_flat(slot + g.a_area, b + (int64_t)__ldg(bi + e) * kn,
                                       kn, lane);
        smm::cp_async_commit();
        smm::cp_async_wait<0>();
        __syncwarp();
        acc.mma(slot + oa, slot + g.a_area + ob, g, n, k, lane);
        __syncwarp();  // the slot is free for the next entry
      }
      // C = C + alpha * sum, as the per-span launch ends its run
      acc.store(cs, g, m, n, lane);
      __syncwarp();
      int rr = itn.r0, cc = itn.c0;
      for (int w = lane; w < mn; w += 32) {
        T* const p = cblk + w;
        const S cv = load_acc(p);
        store_acc(p, cv + alpha * cs[rr * g.sb + cc]);
        cc += itn.rem;
        rr += itn.q;
        if (cc >= n) {
          cc -= n;
          ++rr;
        }
      }
      __syncwarp();  // cs is free for the next segment
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
smm_superstack_tiled_kernel(SpanTable spans, T* __restrict__ c,
                            const int* __restrict__ seg_span,
                            const int* __restrict__ seg_beg,
                            const int* __restrict__ seg_end,
                            const int* __restrict__ run_ptr,
                            const int* __restrict__ run_c, int m, int n,
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
  T* const cblk = c + (int64_t)run_c[run] * m * n;
  for (int sg = run_ptr[run]; sg < run_ptr[run + 1]; ++sg) {
    const int sp = seg_span[sg];
    const int k = spans.k[sp];
    const T* const a = static_cast<const T*>(spans.a[sp]);
    const T* const b = static_cast<const T*>(spans.b[sp]);
    const int* const ai = spans.a_idx[sp];
    const int* const bi = spans.b_idx[sp];
    const int64_t mk = (int64_t)m * k;
    const int64_t kn = (int64_t)k * n;
    Acc acc[2][2] = {{Acc(0), Acc(0)}, {Acc(0), Acc(0)}};
    for (int e = seg_beg[sg]; e < seg_end[sg]; ++e) {
      const T* ablk = a + (int64_t)ai[e] * mk;
      const T* bblk = b + (int64_t)bi[e] * kn;
      for (int k0 = 0; k0 < k; k0 += TK) {
        for (int i = tid; i < TM * TK; i += NTHREADS) {
          const int r = i / TK, kk = i % TK;
          const int gr = row0 + r, gk = k0 + kk;
          as[r][kk] = (gr < m && gk < k) ? load_acc(ablk + (int64_t)gr * k + gk) : Acc(0);
        }
        for (int i = tid; i < TK * TN; i += NTHREADS) {
          const int kk = i / TN, cc = i % TN;
          const int gk = k0 + kk, gc = col0 + cc;
          bs[kk][cc] = (gk < k && gc < n) ? load_acc(bblk + (int64_t)gk * n + gc) : Acc(0);
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
}

template <typename T, int MAXT>
cudaError_t launch_superstack_warp(const SpanTable& spans, void* c, const void* seg_span,
                                   const void* seg_beg, const void* seg_end,
                                   const void* run_ptr, const void* run_c, int nruns,
                                   int m, int n, int kmax, double alpha,
                                   cudaStream_t stream) {
  using Acc = typename AccOf<T>::type;
  using TileT = smm::Tile<Acc, MAXT>;
  const size_t smem = (size_t)W * fused_per_warp(m, n, kmax, sizeof(Acc)) * sizeof(Acc);
  int grid = 0;
  const cudaError_t err = smm::persistent_grid(smm_superstack_warp_kernel<T, MAXT, TileT>,
                                               W * 32, smem, (nruns + W - 1) / W, &grid);
  if (err != cudaSuccess) return err;
  smm_superstack_warp_kernel<T, MAXT, TileT><<<grid, W * 32, smem, stream>>>(
      spans, static_cast<T*>(c), static_cast<const int*>(seg_span),
      static_cast<const int*>(seg_beg), static_cast<const int*>(seg_end),
      static_cast<const int*>(run_ptr), static_cast<const int*>(run_c), nruns, m, n,
      kmax, static_cast<Acc>(alpha));
  return cudaGetLastError();
}

// Every span takes the per-span launch's path: the warp path when all
// of the bin's shapes are warp shapes, the tiled path when none is; a bin
// that mixes the two is refused (the host keeps it on the per-span path).
template <typename T>
cudaError_t launch_superstack(const SpanTable& spans, int kmin, int kmax, void* c,
                              const void* seg_span, const void* seg_beg,
                              const void* seg_end, const void* run_ptr,
                              const void* run_c, int nruns, int m, int n, double alpha,
                              cudaStream_t stream) {
  using Acc = typename AccOf<T>::type;
  if (smm::warp_dims(m, n, kmax) && smm::warp_dims(m, n, kmin)) {
#define SUPER_ARGS spans, c, seg_span, seg_beg, seg_end, run_ptr, run_c, nruns, m, n, kmax, alpha, stream
    switch (smm::warp_class(m, n)) {
      case 2: return launch_superstack_warp<T, 2>(SUPER_ARGS);
      case 3: return launch_superstack_warp<T, 3>(SUPER_ARGS);
      default: return launch_superstack_warp<T, 4>(SUPER_ARGS);
    }
#undef SUPER_ARGS
  }
  if (smm::warp_dims(m, n, kmin) || smm::warp_dims(m, n, kmax))
    return cudaErrorInvalidValue;
  const dim3 grid(nruns, (m + TM - 1) / TM, (n + TN - 1) / TN);
  const dim3 block(NTX, NTY);
  smm_superstack_tiled_kernel<T><<<grid, block, 0, stream>>>(
      spans, static_cast<T*>(c), static_cast<const int*>(seg_span),
      static_cast<const int*>(seg_beg), static_cast<const int*>(seg_end),
      static_cast<const int*>(run_ptr), static_cast<const int*>(run_c), m, n,
      static_cast<Acc>(alpha));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The stack launch of one form (dtype and compute as `dispatch`);
// alpha_im is the imaginary part of a complex alpha.  Returns the
// launch's cudaError_t (0 = success); the caller raises on anything else.
int smm_stack_launch(int dtype, int compute, const void* a, const void* b,
                     void* c, const void* a_idx, const void* b_idx,
                     const void* run_ptr, const void* run_c, int nruns, int m,
                     int n, int k, double alpha, double alpha_im, void* stream) {
  if (nruns <= 0) return 0;
  const Args x{a, b, c, a_idx, b_idx, run_ptr, run_c, nruns, m, n, k, alpha, alpha_im,
               static_cast<cudaStream_t>(stream), nullptr};
  return static_cast<int>(dispatch(dtype, compute, x));
}

// The attributes of the instance a launch of this form and shape runs
// (out[5]: registers a thread, local bytes a thread, shared bytes a
// block, warps a block, blocks an SM); returns a cudaError_t.
int smm_stack_attrs(int dtype, int compute, int m, int n, int k, int* out) {
  const Args x{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, m, n, k,
               1.0, 0.0, nullptr, out};
  return static_cast<int>(dispatch(dtype, compute, x));
}

// The path a launch of this shape takes: 1 = warp path, 0 = tiled path
// (every dtype and form alike).
int smm_stack_path(int dtype, int m, int n, int k) {
  (void)dtype;
  return smm::warp_dims(m, n, k) ? 1 : 0;
}

// The fused launch of one C bin: nspans (<= smm_superstack_max_spans())
// spans, given by host arrays of their A and B bins' and index arrays'
// device pointers and their k; the merged run table (seg_span, seg_beg,
// seg_end: nseg segments; run_ptr, run_c: nruns runs) on the device.
// dtype 0 = float64, 1 = float32, 2 = bfloat16 (native compute only).
// Returns the launch's cudaError_t; cudaErrorInvalidValue for a bin
// whose spans mix the warp and tiled paths or exceed the span table.
int smm_superstack_launch(int dtype, int nspans, const long long* span_a,
                          const long long* span_b, const long long* span_aidx,
                          const long long* span_bidx, const int* span_k, void* c,
                          const void* seg_span, const void* seg_beg,
                          const void* seg_end, const void* run_ptr, const void* run_c,
                          int nruns, int m, int n, double alpha, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (nruns <= 0) return 0;
  if (nspans < 1 || nspans > MAX_SPANS) return bad;
  SpanTable spans = {};
  int kmin = span_k[0], kmax = span_k[0];
  for (int s = 0; s < nspans; ++s) {
    spans.a[s] = reinterpret_cast<const void*>(span_a[s]);
    spans.b[s] = reinterpret_cast<const void*>(span_b[s]);
    spans.a_idx[s] = reinterpret_cast<const int*>(span_aidx[s]);
    spans.b_idx[s] = reinterpret_cast<const int*>(span_bidx[s]);
    spans.k[s] = span_k[s];
    kmin = span_k[s] < kmin ? span_k[s] : kmin;
    kmax = span_k[s] > kmax ? span_k[s] : kmax;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SUPER_ARGS spans, kmin, kmax, c, seg_span, seg_beg, seg_end, run_ptr, run_c, nruns, m, n, alpha, s
  switch (dtype) {
    case 0: return launch_superstack<double>(SUPER_ARGS);
    case 1: return launch_superstack<float>(SUPER_ARGS);
    case 2: return launch_superstack<__nv_bfloat16>(SUPER_ARGS);
    default: return bad;
  }
#undef SUPER_ARGS
}

int smm_superstack_max_spans() { return MAX_SPANS; }

const char* smm_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
