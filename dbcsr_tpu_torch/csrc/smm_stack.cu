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
// * the tiled path (namespace `tiled`), for larger blocks: a thread block
//   of 8 warps owns a whole C block (up to 8 x 27 tiles of 8x8; larger
//   blocks are cut into chunks, one owner an element), its warps own row
//   strips of it in registers, f64 on DMMA and f32/bf16 on register
//   micro-tiles, and each entry is staged once for all warps with
//   cp.async, two buffers deep across entries and runs; C is read and
//   written once a run, coalesced.  Bound on the RI contraction's
//   (529,23,23) f64 stacks (943,698 products, 190,965 C blocks of 97 kB,
//   4.9 entries a run): C read and written (37.2 GB) and T read (4.2 GB)
//   once, 41.4 GB or 12.37 ms at 3.35 TB/s; the padded products
//   (536x24x24 an entry) take 8.7 ms on the FP64 tensor cores, the
//   useful flops alone 15.5 ms on the CUDA cores, so DMMA is what can
//   bring the path near its bound.  Walked in C order, a block row's A
//   blocks (97 kB each, 92 GB staged in all) come from L2.  The earlier
//   tile (32x32 outputs a block, 2x2 a thread, one shared load an FMA,
//   scalar staging between two barriers a 16-deep slice, the CUDA cores) took
//   122.9 ms here (NVIDIA H100 80GB HBM3, 700 W); this design's times are
//   in the section's note.
// Both: no two warps or blocks write the same element, so there are no
// atomics, and each element sums its entries in stack order and k
// ascending, so results are reproducible run to run and a C block's bits
// do not depend on which other runs share its launch.  The accumulator
// is double for f64 and float for f32 and bf16 (bf16 converted on load);
// f32 never runs through TF32.
//
// A second entry point, smm_superstack_launch, is the fused launch of
// one C bin: every span of the bin (each with its own k) in one launch,
// on the same two paths with a segment policy, bit for bit the per-span
// launches (the superstack section below).
//
// Two more groups of forms, behind the same entry point (the JAX package
// runs both in XLA, dbcsr_tpu/acc/smm.py:78-135, never in Pallas), both
// on both paths (the warp path's register tiles in smm_warp.cuh):
// Their tiled forms (smm_stack_demoted_kernel, smm_stack_complex_kernel)
// keep the earlier 32x32 tile for blocks past 32.
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
  smm::warp_kernel<T, MAXT, smm::ConsecutiveRuns, smm::StackRuns, TileT, Z>(
      smm::StackRuns{a, b, a_idx, b_idx, run_ptr, run_c, nruns, k}, c, m, n, k, 1, alpha,
      smm::ConsecutiveRuns{nruns}, alpha_im);
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

// The spans of one fused launch (the superstack section below): each
// span's A bin (Na, m, k), B bin (Nb, k, n), stack operand indices and k.
constexpr int MAX_SPANS = 32;  // spans of one fused launch

struct SpanTable {
  const void* a[MAX_SPANS];
  const void* b[MAX_SPANS];
  const int* a_idx[MAX_SPANS];
  const int* b_idx[MAX_SPANS];
  int k[MAX_SPANS];
};

// The merged runs of one fused C bin (the superstack section): run r is
// the segments run_ptr[r]..run_ptr[r+1]-1, segment j the entries
// seg_beg[j]..seg_end[j]-1 of span seg_span[j].
struct SegmentRuns {
  static constexpr bool SEGMENTS = true;
  SpanTable spans;
  const int *seg_span, *seg_beg, *seg_end, *run_ptr, *run_c;
  int nruns;
  __device__ __forceinline__ int cblk(int r) const { return __ldg(run_c + r); }
  __device__ __forceinline__ int segs_from(int r) const { return __ldg(run_ptr + r); }
  __device__ __forceinline__ int segs_to(int r) const { return __ldg(run_ptr + r + 1); }
  __device__ __forceinline__ smm::Seg seg(int s) const {
    return {__ldg(seg_span + s), __ldg(seg_beg + s), __ldg(seg_end + s)};
  }
  __device__ __forceinline__ const void* a(int sp) const { return spans.a[sp]; }
  __device__ __forceinline__ const void* b(int sp) const { return spans.b[sp]; }
  __device__ __forceinline__ const int* ai(int sp) const { return spans.a_idx[sp]; }
  __device__ __forceinline__ const int* bi(int sp) const { return spans.b_idx[sp]; }
  __device__ __forceinline__ int k(int sp) const { return spans.k[sp]; }
};

// ------------------------------------------------------------ tiled path
// Blocks with m, n or k > 32, native f64, f32 and bf16 (the complex and
// demoted forms above keep the 32x32 tile).  One thread block of NW = 8
// warps owns a chunk of a C block: all of it up to 8 * MTW * NTW tiles
// of 8x8 (the (529,23,23) blocks of the RI contraction are one chunk of
// 67 x 3 tiles), else one of the chunks the block is cut into; no two
// blocks write one element.  The warps split the chunk's tiles as
// wr x wc warps (`Geom`, the arrangement with the fewest chunks, then the
// fewest tiles a warp): a warp owns every wr-th row tile and a contiguous
// run of column tiles, at most MTW x NTW of them, its sum in registers:
// f64 on DMMA (m8n8k4, the warp path's fragments), f32 and bf16 on the
// CUDA cores in full f32, each lane a micro-tile of row tiles by 2 nc
// contiguous columns (MTW A values and 2 NTW B values a k for 2 MTW NTW
// FMAs).  Thread blocks are persistent and take the chunks grid-stride in
// C order, so the blocks in flight share one block row's A blocks in L2.
// Each entry is staged once for all warps with cp.async, two buffers deep
// across entries, segments and runs: the next entry lands while this one
// multiplies.  Whole entries ("flat"): the chunk's rows of A and all of
// B, each copied flat, 16 bytes a thread, at the offset its source has
// within 16 bytes (the warp path's trick); when two such slots exceed
// the shared memory, k slices of `ks` (a multiple of 4) of A's chunk
// rows and B's chunk columns, element by element, padded strides.  A
// run's C chunk is prefetched into L2 as its first entry is staged; at
// the end of a segment the warps write their sums into the buffer just
// multiplied and the block updates C = C + alpha * sum with coalesced
// loads and stores, once.  Each element sums its entries in stack order
// and k in ascending 4-deep steps, whatever the chunking or the slicing,
// so repeats are bit for bit equal and a fused bin (SegmentRuns) is bit
// for bit its spans' launches (StackRuns).
//
// Measured on 40,000 runs of (529,23,23) blocks at 4.5 entries a run
// (perf/kernel_ab.py --tiled, NVIDIA H100 80GB HBM3, 700 W): f64 10.2 ms
// against the earlier 32x32 tile's 21.4 (bound 2.44 ms, bytes); 8.5 without its
// products and 7.4 without its operand copies, so staging and products
// take about as long and each hides only part of the other with one
// block an SM.  f32 7.0 against 18.9 (bound 1.50, operations); 5.1 and
// 5.8.  A predicate on every product of the register tile cost the f32
// tile 2.5x (19.2 ms), hence `full`.
namespace tiled {

constexpr int NW = 8;    // warps a thread block
constexpr int NTH = NW * 32;
constexpr int MTW = 9;   // a warp's register tile: at most MTW row tiles
constexpr int NTW = 3;   // by NTW column tiles of 8x8
constexpr int SMEM_MAX = 227 * 1024;  // dynamic shared memory a block may hold
constexpr int EB = 8;    // C elements a thread loads at once when it updates C

__host__ __device__ inline int imin(int x, int y) { return x < y ? x : y; }
__host__ __device__ inline int imax(int x, int y) { return x > y ? x : y; }

struct Geom {
  int mt, nt;      // 8-row and 8-column tiles of the padded C block
  int wr, wc;      // warps along the rows and the columns, wr * wc = NW
  int rmt, cnt;    // row and column tiles of one chunk
  int nrc, ncc;    // chunks along the rows and the columns of a C block
  int flat;        // 1: whole entries staged flat; 0: k slices
  int ks;          // k-slice depth (flat: k rounded up to 4)
  int lda, ldb;    // sliced: row strides of the staged A and B slices
  int a_area;      // elements of T of one buffer's A area
  int buf;         // bytes of one buffer: a slot (A area, then B area) or the chunk's sum
  int smem;        // bytes of dynamic shared memory: two buffers
};

// two buffers, each a slot of `slot_bytes` or a chunk's sum, fit a block
__host__ __device__ inline bool fits(int slot_bytes, int sum_bytes) {
  return 2 * smm::round_up(imax(slot_bytes, sum_bytes), 16) <= SMEM_MAX;
}

// The geometry of a launch of (m, n) blocks whose entries reach depth
// kmax; tsize and ssize are the bytes of the data and the sum types.
__host__ __device__ inline Geom geom(int m, int n, int kmax, int tsize, int ssize) {
  Geom g;
  g.mt = (m + 7) / 8;
  g.nt = (n + 7) / 8;
  long long best = -1;
  for (int wr = NW; wr >= 1; wr /= 2) {
    const int wc = NW / wr;
    const int rmt = imin(g.mt, wr * MTW), cnt = imin(g.nt, wc * NTW);
    const int nrc = (g.mt + rmt - 1) / rmt, ncc = (g.nt + cnt - 1) / cnt;
    const int tr = (rmt + wr - 1) / wr, tc = (cnt + wc - 1) / wc;
    const long long key = (long long)nrc * ncc * 65536 + tr * tc * 256 + tr + tc;
    if (best < 0 || key < best) {
      best = key;
      g.wr = wr, g.wc = wc, g.rmt = rmt, g.cnt = cnt, g.nrc = nrc, g.ncc = ncc;
    }
  }
  const int q = 16 / tsize, kp = smm::round_up(kmax, 4);
  const int sum_bytes = 8 * g.rmt * 8 * g.cnt * ssize;  // the chunk's sum, row stride 8 cnt
  g.flat = 1;
  g.ks = kp;
  g.lda = g.ldb = 0;
  g.a_area = smm::round_up(8 * g.rmt * kmax + kp + q, q);
  int slot = g.a_area + smm::round_up(kp * n + 8 * g.nt + q, q);
  if (!fits(slot * tsize, sum_bytes)) {
    g.flat = 0;
    g.ldb = 8 * g.cnt + 4;
    for (g.ks = imin(kp, 64); g.ks > 4; g.ks -= 4) {
      g.lda = g.ks + 4;
      g.a_area = smm::round_up(8 * g.rmt * g.lda, q);
      if (fits((g.a_area + smm::round_up(g.ks * g.ldb, q)) * tsize, sum_bytes)) break;
    }
    g.lda = g.ks + 4;
    g.a_area = smm::round_up(8 * g.rmt * g.lda, q);
    slot = g.a_area + smm::round_up(g.ks * g.ldb, q);
  }
  g.buf = smm::round_up(imax(slot * tsize, sum_bytes), 16);
  g.smem = 2 * g.buf;
  return g;
}

// one thread's element copies into shared memory: cp.async for 4 and 8
// bytes, a plain load and store for bf16 (cp.async copies 4 bytes at least)
__device__ __forceinline__ void copy1(double* d, const double* s) { smm::cp_async<8>(d, s); }
__device__ __forceinline__ void copy1(float* d, const float* s) { smm::cp_async<4>(d, s); }
__device__ __forceinline__ void copy1(__nv_bfloat16* d, const __nv_bfloat16* s) {
  *reinterpret_cast<unsigned short*>(d) = __ldg(reinterpret_cast<const unsigned short*>(s));
}

// 16 bytes into shared memory, not kept in L1 (an entry is used once)
__device__ __forceinline__ void cp_async_cg16(void* d, const void* s) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smm::smem_addr(d)), "l"(s)
               : "memory");
}

// Stage `count` contiguous elements at src into the area, the whole block
// of threads: 16-byte pieces, one a thread in turn, from the first
// 16-byte boundary of src, the elements before and after it singly.
// Returns the offset (elements) of the copy in its area.
template <typename T>
__device__ __forceinline__ int stage_flat(T* area, const T* src, int count, int tid) {
  constexpr int q = 16 / sizeof(T);
  const int off = (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
  T* dst = area + off;
  const int head = imin(count, (q - off) & (q - 1));
  if (tid < head) copy1(dst + tid, src + tid);
  const int pieces = (count - head) / q;
  for (int i = tid; i < pieces; i += NTH) cp_async_cg16(dst + head + i * q, src + head + i * q);
  const int tail = head + pieces * q + tid;
  if (tail < count) copy1(dst + tail, src + tail);
  return off;
}

// Stage rows x cols elements of a row-major source (row stride lds) into
// dst (row stride ldd), element by element.
template <typename T>
__device__ __forceinline__ void stage_2d(T* dst, int ldd, const T* src, int lds, int rows,
                                         int cols, int tid) {
  for (int i = tid; i < rows * cols; i += NTH) {
    const int r = i / cols, c = i - r * cols;
    copy1(dst + r * ldd + c, src + (int64_t)r * lds + c);
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// A warp's share of a chunk: row tiles r0, r0 + wr, ... (nr of them) and
// column tiles c0 .. c0 + nc - 1 of the chunk; bc0 is the column tile c0
// in the staged B (flat: all of B; sliced: the chunk's columns).
struct Strip {
  int r0, nr, c0, nc, bc0;
};

// A strip that fills at least 3/4 of the register tile multiplies all of
// it: the padded products on zeros cost less than a predicate per product
// (measured on the f32 FMAs: 7.8 against 19.2 ms on (529,23,23) stacks,
// NVIDIA H100 80GB HBM3, `perf/kernel_ab.py --tiled`); a smaller strip
// keeps the predicates.
__device__ __forceinline__ bool full(const Strip& s) { return 4 * s.nr * s.nc >= 3 * MTW * NTW; }

// f64 on DMMA: fragments of m8n8k4 as in smm::Tile<double> (g = lane/4,
// t = lane%4: A(g, t), B(t, g), C(g, 2t) and C(g, 2t+1)); A(r, kk) is
// as[r * lda + kk] and B(kk, c) is bs[kk * ldb + c]; the k padding of the
// last 4-deep step is zeroed by predicate.
struct DTile {
  double v[MTW][NTW][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j) v[i][j][0] = v[i][j][1] = 0.0;
  }

  // FULL: every tile of the register tile multiplies (the fragments
  // past the strip are zero): no predicate per product
  template <bool FULL>
  __device__ __forceinline__ void mma_k(const double* ap, int astep, const double* bp, int ldb,
                                        int kd, int t, const Strip& s) {
#pragma unroll 1
    for (int kk = 0; kk < kd; kk += 4) {
      const bool kin = kk + t < kd;
      double af[MTW], bf[NTW];
#pragma unroll
      for (int i = 0; i < MTW; ++i) af[i] = i < s.nr && kin ? ap[i * astep + kk] : 0.0;
#pragma unroll
      for (int j = 0; j < NTW; ++j) bf[j] = j < s.nc && kin ? bp[kk * ldb + 8 * j] : 0.0;
#pragma unroll
      for (int i = 0; i < MTW; ++i)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          if (FULL || (i < s.nr && j < s.nc)) smm::dmma(v[i][j], af[i], bf[j]);
    }
  }

  __device__ __forceinline__ void mma(const double* as, int lda, const double* bs, int ldb,
                                      int kd, int wr, const Strip& s, int lane) {
    const int gr = lane >> 2, t = lane & 3;
    const double* ap = as + (8 * s.r0 + gr) * lda + t;
    const double* bp = bs + t * ldb + 8 * s.bc0 + gr;
    if (full(s))
      mma_k<true>(ap, 8 * wr * lda, bp, ldb, kd, t, s);
    else
      mma_k<false>(ap, 8 * wr * lda, bp, ldb, kd, t, s);
  }

  // cs (row stride sb, the chunk's rows and columns) = the warp's sums
  __device__ __forceinline__ void store(double* cs, int sb, int wr, const Strip& s,
                                        int lane) const {
    const int gr = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        if (i < s.nr && j < s.nc) {
          double* p = cs + (8 * (s.r0 + wr * i) + gr) * sb + 8 * (s.c0 + j) + 2 * t;
          p[0] = v[i][j][0];
          p[1] = v[i][j][1];
        }
  }
};

// f32 and bf16 on the CUDA cores in f32 (never TF32): the lane owns rows
// 8 (r0 + wr i) + lane/4 and the 2 nc columns from 8 c0 + (lane%4) 2 nc.
struct FTile {
  float v[MTW][2 * NTW];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int j = 0; j < 2 * NTW; ++j) v[i][j] = 0.0f;
  }

  template <bool FULL, typename T>
  __device__ __forceinline__ void mma_k(const T* ap, int astep, const T* bp, int ldb, int kd,
                                        int tn, const Strip& s) {
#pragma unroll 2
    for (int kk = 0; kk < kd; ++kk) {
      float af[MTW], bf[2 * NTW];
#pragma unroll
      for (int i = 0; i < MTW; ++i) af[i] = i < s.nr ? to_f(ap[i * astep + kk]) : 0.0f;
#pragma unroll
      for (int j = 0; j < 2 * NTW; ++j) bf[j] = j < tn ? to_f(bp[kk * ldb + j]) : 0.0f;
#pragma unroll
      for (int i = 0; i < MTW; ++i)
#pragma unroll
        for (int j = 0; j < 2 * NTW; ++j)
          if (FULL || (i < s.nr && j < tn)) v[i][j] = fmaf(af[i], bf[j], v[i][j]);
    }
  }

  template <typename T>
  __device__ __forceinline__ void mma(const T* as, int lda, const T* bs, int ldb, int kd,
                                      int wr, const Strip& s, int lane) {
    const int tn = 2 * s.nc;
    const T* ap = as + (8 * s.r0 + (lane >> 2)) * lda;
    const T* bp = bs + 8 * s.bc0 + (lane & 3) * tn;
    if (full(s))
      mma_k<true>(ap, 8 * wr * lda, bp, ldb, kd, tn, s);
    else
      mma_k<false>(ap, 8 * wr * lda, bp, ldb, kd, tn, s);
  }

  __device__ __forceinline__ void store(float* cs, int sb, int wr, const Strip& s,
                                        int lane) const {
    const int tn = 2 * s.nc, r = lane >> 2, c = 8 * s.c0 + (lane & 3) * tn;
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int j = 0; j < 2 * NTW; ++j)
        if (i < s.nr && j < tn) cs[(8 * (s.r0 + wr * i) + r) * sb + c + j] = v[i][j];
  }
};

template <typename T> struct TileOf { using type = FTile; };
template <> struct TileOf<double> { using type = DTile; };

using smm::Seg;

// Where the block's walk stands: work item w (a run's chunk), its C
// block, segment s of the run's s..s1-1, entry e (its operand blocks ia
// and ib), k slice sl of nsl.  The indices are loaded a slice ahead of
// their use: nothing waits on them.
struct Cursor {
  int w, cblk, s, s1, e, ia, ib, k, sl, nsl;
  bool fresh;  // the work item's first slice
  Seg sg;
};

// two blocks an SM for 4- and 2-byte data (at most 128 registers; two
// (529,23,23) f32 buffers take 103 kB), one for f64 (its 27 tiles take
// 108 registers and its buffers 207 kB)
template <typename T, typename Runs>
__global__ void __launch_bounds__(NTH, sizeof(T) == 8 ? 1 : 2)
tiled_kernel(Runs runs, T* __restrict__ c, int m, int n, Geom g, int nwork,
             typename AccOf<T>::type alpha) {
  using S = typename AccOf<T>::type;
  using TileT = typename TileOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp % g.wr, wc = warp / g.wr;
  const int nch = g.nrc * g.ncc, sb = 8 * g.cnt;

  // the chunk of work item w: its first row and column, and its valid
  // rows and columns
  auto chunk = [&](int w, int& row0, int& rv, int& col0, int& cv) {
    const int ch = w % nch;
    row0 = ch / g.ncc * 8 * g.rmt;
    col0 = ch % g.ncc * 8 * g.cnt;
    rv = imin(8 * g.rmt, m - row0);
    cv = imin(8 * g.cnt, n - col0);
  };
  auto entry = [&](Cursor& x) {
    x.ia = __ldg(runs.ai(x.sg.sp) + x.e);
    x.ib = __ldg(runs.bi(x.sg.sp) + x.e);
  };
  // the entry's A chunk rows and B block
  auto a_of = [&](const Cursor& x) {
    const int row0 = x.w % nch / g.ncc * 8 * g.rmt;
    return static_cast<const T*>(runs.a(x.sg.sp)) + ((int64_t)x.ia * m + row0) * x.k;
  };
  auto b_of = [&](const Cursor& x) {
    return static_cast<const T*>(runs.b(x.sg.sp)) + (int64_t)x.ib * x.k * n;
  };
  auto open_seg = [&](Cursor& x) {
    x.sg = runs.seg(x.s);
    x.k = runs.k(x.sg.sp);
    x.e = x.sg.e0;
    x.sl = 0;
    x.nsl = g.flat ? 1 : (x.k + g.ks - 1) / g.ks;
    entry(x);
  };
  auto start = [&](Cursor& x, int w) {
    x.w = w;
    if (w >= nwork) return;
    const int run = w / nch;
    x.cblk = runs.cblk(run);
    x.s = runs.segs_from(run);
    x.s1 = runs.segs_to(run);
    x.fresh = true;
    open_seg(x);
  };
  auto advance = [&](Cursor& x) {
    x.fresh = false;
    if (++x.sl < x.nsl) return;
    x.sl = 0;
    if (++x.e < x.sg.e1) {
      entry(x);
    } else if (++x.s < x.s1) {
      open_seg(x);
    } else {
      start(x, x.w + gridDim.x);
    }
  };
  // the cursor's slice into buffer bb; the first slice of a work item
  // also prefetches its C chunk's rows into L2
  auto stage = [&](const Cursor& x, int bb) {
    T* const area = reinterpret_cast<T*>(smem_raw + bb * g.buf);
    int row0, rv, col0, cv;
    chunk(x.w, row0, rv, col0, cv);
    const int k = x.k;
    const T* const ap = a_of(x);
    const T* const bp = b_of(x);
    if (g.flat) {
      stage_flat(area, ap, rv * k, tid);
      stage_flat(area + g.a_area, bp, k * n, tid);
    } else {
      const int k0 = x.sl * g.ks, kv = imin(g.ks, k - k0);
      stage_2d(area, g.lda, ap + k0, k, rv, kv, tid);
      stage_2d(area + g.a_area, g.ldb, bp + (int64_t)k0 * n + col0, n, kv, cv, tid);
    }
    if (x.fresh) {
      const char* p0 = reinterpret_cast<const char*>(c + ((int64_t)x.cblk * m + row0) * n);
      const char* p1 = p0 + (int64_t)rv * n * sizeof(T);
      p0 -= reinterpret_cast<uintptr_t>(p0) & 127;
      for (const char* p = p0 + tid * 128; p < p1; p += NTH * 128)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
    }
  };
  // the warp's share of the work item's chunk
  auto strip = [&](int w) {
    const int ch = w % nch, rc = ch / g.ncc, cc = ch % g.ncc;
    const int rmt_c = imin(g.rmt, g.mt - rc * g.rmt), cnt_c = imin(g.cnt, g.nt - cc * g.cnt);
    const int per = (cnt_c + g.wc - 1) / g.wc;
    Strip s;
    s.r0 = wr;
    s.nr = wr < rmt_c ? (rmt_c - wr + g.wr - 1) / g.wr : 0;
    s.c0 = wc * per;
    s.nc = imax(0, imin(per, cnt_c - s.c0));
    s.bc0 = g.flat ? cc * g.cnt + s.c0 : s.c0;
    return s;
  };

  // cur multiplies while nxt lands and fut's indices load
  Cursor cur;
  start(cur, blockIdx.x);
  if (cur.w >= nwork) return;
  stage(cur, 0);
  smm::cp_async_commit();
  Cursor nxt = cur;
  advance(nxt);
  TileT acc;
  int bb = 0;
  while (true) {
    if (nxt.w < nwork) stage(nxt, bb ^ 1);
    smm::cp_async_commit();
    Cursor fut = nxt;
    if (nxt.w < nwork) advance(fut);
    smm::cp_async_wait<1>();  // every group but the newest: this slice has landed
    __syncthreads();
    const Strip s = strip(cur.w);
    const T* const area = reinterpret_cast<const T*>(smem_raw + bb * g.buf);
    if (cur.e == cur.sg.e0 && cur.sl == 0) acc.zero();
    if (g.flat) {
      const int k = cur.k;
      const int oa = (int)((reinterpret_cast<uintptr_t>(a_of(cur)) & 15) / sizeof(T));
      const int ob = (int)((reinterpret_cast<uintptr_t>(b_of(cur)) & 15) / sizeof(T));
      acc.mma(area + oa, k, area + g.a_area + ob, n, k, g.wr, s, lane);
    } else {
      acc.mma(area, g.lda, area + g.a_area, g.ldb, imin(g.ks, cur.k - cur.sl * g.ks),
              g.wr, s, lane);
    }
    if (cur.e + 1 == cur.sg.e1 && cur.sl + 1 == cur.nsl) {
      // the segment ends: C = C + alpha * sum over the chunk, the sums
      // through the buffer just multiplied, then coalesced, EB loads of
      // C in flight a thread before their stores
      __syncthreads();
      S* const cs = reinterpret_cast<S*>(smem_raw + bb * g.buf);
      acc.store(cs, sb, g.wr, s, lane);
      __syncthreads();
      int row0, rv, col0, cv;
      chunk(cur.w, row0, rv, col0, cv);
      T* const cb = c + ((int64_t)cur.cblk * m + row0) * n + col0;
      const smm::FlatIter it = smm::flat_iter(cv, tid, NTH);
      const int total = rv * cv;
      int r = it.r0, cc = it.c0;
      for (int w0 = tid; w0 < total; w0 += EB * NTH) {
        S old[EB];
        int po[EB], so[EB];
#pragma unroll
        for (int j = 0; j < EB; ++j) {
          po[j] = r * n + cc;
          so[j] = r * sb + cc;
          old[j] = w0 + j * NTH < total ? load_acc(cb + po[j]) : S(0);
          cc += it.rem;
          r += it.q;
          if (cc >= cv) {
            cc -= cv;
            ++r;
          }
        }
#pragma unroll
        for (int j = 0; j < EB; ++j)
          if (w0 + j * NTH < total) store_acc(cb + po[j], smm::fmadd(alpha, cs[so[j]], old[j]));
      }
    }
    if (nxt.w >= nwork) break;
    __syncthreads();  // the buffer is free for the slice after next
    cur = nxt;
    nxt = fut;
    bb ^= 1;
  }
  smm::cp_async_wait<0>();
}

// Launch (or, attrs non-null, report the instance of) the tiled kernel
// on `runs`, whose entries reach depth kmax.
template <typename T, typename Runs>
cudaError_t launch(const Runs& runs, void* c, int m, int n, int kmax, double alpha,
                   cudaStream_t stream, int* attrs) {
  using S = typename AccOf<T>::type;
  const Geom g = geom(m, n, kmax, sizeof(T), sizeof(S));
  const long long work = (long long)runs.nruns * g.nrc * g.ncc;
  if (work > 0x7fffffff) return cudaErrorInvalidValue;
  const auto kernel = tiled_kernel<T, Runs>;
  int grid = 0;
  const cudaError_t err = smm::persistent_grid(kernel, NTH, g.smem, (int)work, &grid);
  if (err != cudaSuccess) return err;
  if (attrs) return kernel_attrs(kernel, NTH, g.smem, attrs);
  kernel<<<grid, NTH, g.smem, stream>>>(runs, static_cast<T*>(c), m, n, g, (int)work,
                                        static_cast<S>(alpha));
  return cudaGetLastError();
}

}  // namespace tiled

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
  if constexpr (CT < 0) {
    const smm::StackRuns runs{x.a, x.b,
                                static_cast<const int*>(x.a_idx),
                                static_cast<const int*>(x.b_idx),
                                static_cast<const int*>(x.run_ptr),
                                static_cast<const int*>(x.run_c), x.nruns, x.k};
    return tiled::launch<T>(runs, x.c, x.m, x.n, x.k, x.alpha, x.stream, x.attrs);
  } else {
    if (x.attrs)
      return kernel_attrs(smm_stack_demoted_kernel<T, CT, COMP>, NTHREADS, 0, x.attrs);
    const dim3 grid(x.nruns, (x.m + TM - 1) / TM, (x.n + TN - 1) / TN);
    const dim3 block(NTX, NTY);
    smm_stack_demoted_kernel<T, CT, COMP><<<grid, block, 0, x.stream>>>(
        static_cast<const T*>(x.a), static_cast<const T*>(x.b), static_cast<T*>(x.c),
        static_cast<const int*>(x.a_idx), static_cast<const int*>(x.b_idx),
        static_cast<const int*>(x.run_ptr), static_cast<const int*>(x.run_c), x.m, x.n, x.k,
        static_cast<Acc>(x.alpha));
    return cudaGetLastError();
  }
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
// one run per C block, each a list of segments in span order (SpanTable
// and SegmentRuns above).  Each segment's products are summed exactly as
// the per-span launch sums its run, and after each segment
// C = C + alpha * sum is rounded to T as the per-span launch stores it:
// so the fused result is bit for bit the per-span result.
// * Warp path: smm::warp_kernel (smm_warp.cuh) with SegmentRuns, one
//   warp a merged run, on the per-span launch's pipeline: entry e+1 is
//   staged with cp.async while e multiplies, across segments and runs,
//   each slot sized at the bin's largest k.  A bin's runs hold one or two
//   entries, so latency, not bytes or products, bounds it: every load a
//   segment needs is issued one to three segments ahead, and below the
//   32x32 class several blocks of four warps share an SM, so warps in
//   flight hide the loads' latency.  f64: the run's C block is read and
//   written at each segment's end, from L2, where it was prefetched two
//   segments ahead, and four blocks share an SM (at most 128 registers);
//   f32 and bf16: C stays in registers from the run's start to its end,
//   three blocks an SM (at most 170).  Each choice was the faster of the
//   two on `mixed_blocks` (PERF.md, "K1's fused launch").
// * Tiled path: the tiled kernel above with SegmentRuns: a chunk's C is
//   read and written at the end of each segment.
template <typename T, int MAXT>
__global__ void __launch_bounds__(W * 32, MAXT < 4 ? (sizeof(T) == 8 ? 4 : 3) : 1)
smm_superstack_warp_kernel(SegmentRuns runs, T* __restrict__ c, int m, int n, int kmax,
                           typename AccOf<T>::type alpha) {
  smm::warp_kernel<T, MAXT, smm::ConsecutiveRuns, SegmentRuns>(
      runs, c, m, n, kmax, 1, alpha, smm::ConsecutiveRuns{runs.nruns});
}

template <typename T, int MAXT>
cudaError_t launch_superstack_warp(const SegmentRuns& runs, void* c, int m, int n,
                                   int kmax, double alpha, cudaStream_t stream, int* attrs) {
  using S = typename AccOf<T>::type;
  const size_t smem = (size_t)W * smm::warp_geom(m, n, kmax, 1, sizeof(S)).per_warp * sizeof(S);
  const auto kernel = smm_superstack_warp_kernel<T, MAXT>;
  int grid = 0;
  const cudaError_t err =
      smm::persistent_grid(kernel, W * 32, smem, (runs.nruns + W - 1) / W, &grid);
  if (err != cudaSuccess) return err;
  if (attrs) return kernel_attrs(kernel, W * 32, smem, attrs);
  kernel<<<grid, W * 32, smem, stream>>>(runs, static_cast<T*>(c), m, n, kmax,
                                         static_cast<S>(alpha));
  return cudaGetLastError();
}

// Every span takes the per-span launch's path: the warp path when all
// of the bin's shapes are warp shapes, the tiled path when none is; a bin
// that mixes the two is refused (the host keeps it on the per-span path).
template <typename T>
cudaError_t launch_superstack(const SegmentRuns& runs, int kmin, int kmax, void* c,
                              int m, int n, double alpha, cudaStream_t stream, int* attrs) {
  if (smm::warp_dims(m, n, kmax) && smm::warp_dims(m, n, kmin)) {
    switch (smm::warp_class(m, n)) {
      case 2: return launch_superstack_warp<T, 2>(runs, c, m, n, kmax, alpha, stream, attrs);
      case 3: return launch_superstack_warp<T, 3>(runs, c, m, n, kmax, alpha, stream, attrs);
      default: return launch_superstack_warp<T, 4>(runs, c, m, n, kmax, alpha, stream, attrs);
    }
  }
  if (smm::warp_dims(m, n, kmin) || smm::warp_dims(m, n, kmax)) return cudaErrorInvalidValue;
  return tiled::launch<T>(runs, c, m, n, kmax, alpha, stream, attrs);
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
// With attrs non-null nothing launches: attrs gets the instance's
// attributes, as smm_stack_attrs gives them.
static int superstack(int dtype, int nspans, const long long* span_a, const long long* span_b,
                      const long long* span_aidx, const long long* span_bidx,
                      const int* span_k, void* c, const void* seg_span, const void* seg_beg,
                      const void* seg_end, const void* run_ptr, const void* run_c, int nruns,
                      int m, int n, double alpha, void* stream, int* attrs) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (nruns <= 0) return 0;
  if (nspans < 1 || nspans > MAX_SPANS) return bad;
  SegmentRuns runs = {};
  int kmin = span_k[0], kmax = span_k[0];
  for (int s = 0; s < nspans; ++s) {
    runs.spans.a[s] = span_a ? reinterpret_cast<const void*>(span_a[s]) : nullptr;
    runs.spans.b[s] = span_b ? reinterpret_cast<const void*>(span_b[s]) : nullptr;
    runs.spans.a_idx[s] = span_aidx ? reinterpret_cast<const int*>(span_aidx[s]) : nullptr;
    runs.spans.b_idx[s] = span_bidx ? reinterpret_cast<const int*>(span_bidx[s]) : nullptr;
    runs.spans.k[s] = span_k[s];
    kmin = span_k[s] < kmin ? span_k[s] : kmin;
    kmax = span_k[s] > kmax ? span_k[s] : kmax;
  }
  runs.seg_span = static_cast<const int*>(seg_span);
  runs.seg_beg = static_cast<const int*>(seg_beg);
  runs.seg_end = static_cast<const int*>(seg_end);
  runs.run_ptr = static_cast<const int*>(run_ptr);
  runs.run_c = static_cast<const int*>(run_c);
  runs.nruns = nruns;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_superstack<double>(runs, kmin, kmax, c, m, n, alpha, s, attrs);
    case 1: return launch_superstack<float>(runs, kmin, kmax, c, m, n, alpha, s, attrs);
    case 2: return launch_superstack<__nv_bfloat16>(runs, kmin, kmax, c, m, n, alpha, s, attrs);
    default: return bad;
  }
}

int smm_superstack_launch(int dtype, int nspans, const long long* span_a,
                          const long long* span_b, const long long* span_aidx,
                          const long long* span_bidx, const int* span_k, void* c,
                          const void* seg_span, const void* seg_beg,
                          const void* seg_end, const void* run_ptr, const void* run_c,
                          int nruns, int m, int n, double alpha, void* stream) {
  return superstack(dtype, nspans, span_a, span_b, span_aidx, span_bidx, span_k, c, seg_span,
                    seg_beg, seg_end, run_ptr, run_c, nruns, m, n, alpha, stream, nullptr);
}

// The attributes of the fused instance a bin of (m, n) blocks with the
// spans' depths span_k (nspans of them) runs (out[5] as smm_stack_attrs).
int smm_superstack_attrs(int dtype, int nspans, const int* span_k, int m, int n, int* out) {
  return superstack(dtype, nspans, nullptr, nullptr, nullptr, nullptr, span_k, nullptr,
                    nullptr, nullptr, nullptr, nullptr, nullptr, 1, m, n, 1.0, nullptr, out);
}

// The tiled path's geometry of a launch (native forms) of (m, n) blocks
// whose entries reach depth kmax (out[12]: wr, wc, rmt, cnt, nrc, ncc,
// flat, ks, lda, ldb, a_area, smem; acc/stack_kernel.py:tiled_geometry
// names them).  Returns cudaErrorInvalidValue for a dtype without one.
int smm_stack_tiled_geom(int dtype, int m, int n, int kmax, int* out) {
  const int sizes[3][2] = {{8, 8}, {4, 4}, {2, 4}};
  if (dtype < 0 || dtype > 2 || m < 1 || n < 1 || kmax < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const tiled::Geom g = tiled::geom(m, n, kmax, sizes[dtype][0], sizes[dtype][1]);
  const int vals[12] = {g.wr, g.wc, g.rmt, g.cnt, g.nrc, g.ncc, g.flat, g.ks, g.lda, g.ldb,
                        g.a_area, g.smem};
  for (int i = 0; i < 12; ++i) out[i] = vals[i];
  return 0;
}

int smm_superstack_max_spans() { return MAX_SPANS; }

const char* smm_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
