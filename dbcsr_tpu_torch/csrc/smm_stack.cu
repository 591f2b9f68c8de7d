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
// runs both in XLA, dbcsr_tpu/acc/smm.py:78-135, never in Pallas), on
// both paths: the warp path's register tiles in smm_warp.cuh, the tiled
// path's in its section below (the same kernel body, a form a policy).
// * complex c4/c8: interleaved real and imaginary parts, complex alpha.
//   The parts are staged as they lie and a fragment reads both parts of
//   an element in one load; c8 runs 4 DMMAs a tile and k-step (Ar.Br,
//   (-Ai).Bi, Ar.Bi, Ai.Br), on the warp path with two warps a block
//   (each warp's slots take 37 kB at 23x23x23) and C read at the end of
//   a run (two register tiles leave no room for it); c4 runs 4 f32 FMAs
//   a multiply-add on the f32 tiles' lane layout.  Bound on the north
//   star: 8.0e10 real flops, 1.20 ms at 67 TFLOP/s on the FP64 tensor
//   cores (c8) or the f32 CUDA cores (c4); the bytes take less.
// * demoted compute (acc/precision.py): the operands stay at the request
//   dtype in device memory and are converted once, as each staged slot
//   lands.  Uncompensated, an entry's k-sum runs in f32 and is widened
//   into the run's sum: f64->f32 on f32 FMAs, ->bf16 on the bf16 tensor
//   cores (mma.sync m16n8k16, f32 out).  Compensated, each product of
//   the operands' hi/lo splits is summed in the wide type: for f64 data
//   one DMMA product of depth 3k over the hi and lo parts, which are
//   exact in f64 (at least 3x the FP64 tensor cores' time for native
//   f64's products, where `stack_bound_s` takes the compute type's
//   peak); for f32 data the bf16 tensor cores into the f32 sum.  Each
//   form moves the native form's bytes.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (perf/tree_ab.py,
// the warp path against the earlier per-read-converting forms in turns,
// north star per multiply, `test_H2O` per product):
// c8 8.5 ms (11.7 before; bound 1.22 ms), c4 5.2 ms (8.9; 1.21), f64->f32
// 4.0 ms (7.2; 0.534 ms, bytes), against native f64 K1's 2.1 ms.  On
// `test_H2O` (native f64 K1 1.1 ms, bound 0.21): f64->f32c 3.7 ms (6.1-6.4;
// bound 0.62 ms, its DMMA products alone), f64->bf16c 4.2 ms (8.1; 0.043),
// f64->bf16 1.9 ms (6.1-6.2; 0.043), f32->bf16c 2.8 ms (3.7; 0.042),
// f32->bf16 1.5 ms (3.4; 0.022).  Every form inherits native K1's
// staging-bound warp pipeline (see above) and adds its own work per entry.
// The tiled forms' times are in the tiled section's note.

#include <type_traits>

#include "smm_warp.cuh"

namespace {

using smm::AccOf;
using smm::load_acc;
using smm::store_acc;
using smm::split_hi_lo;
using smm::to_compute;

constexpr int W = 4;  // warps (runs) of a warp-path block

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
// Blocks with m, n or k > 32, every form.  One thread block of NW = 8
// warps owns a chunk of a C block: all of it up to 8 * MT * NTW tiles of
// 8x8 (MT the form's register tile rows; the (529,23,23) blocks of the
// RI contraction are one chunk of 67 x 3 tiles for the native forms),
// else one of the chunks the block is cut into; no two blocks write one
// element.  The warps split the chunk's tiles as wr x wc warps (`Geom`,
// the arrangement with the fewest chunks, then the fewest tiles a warp):
// a warp owns every wr-th row tile and a contiguous run of column
// tiles, at most MT x NTW of them, its sum in registers (the form's
// register tile below).  Thread blocks are persistent and take the
// chunks grid-stride in C order, so the blocks in flight share one block
// row's A blocks in L2.  Each entry is staged once for all warps with
// cp.async, across entries, segments and runs: the next entry lands
// while this one multiplies.  Whole entries ("flat"): the chunk's rows
// of A and all of B, each copied flat, 16 bytes a thread, at the offset
// its source has within 16 bytes (the warp path's trick); when they
// exceed the shared memory, k slices of `ks` (a multiple of 4) of A's
// chunk rows and B's chunk columns, element by element, padded strides.
// A run's C chunk is prefetched into L2 as its first entry is staged; at
// the end of a segment the warps write their sums into shared memory
// and the block updates C = C + alpha * sum with coalesced loads and
// stores, once.  Each element sums its entries in stack order and k in
// ascending steps (4 deep on DMMA, 16 on the bf16 tensor cores), whatever
// the chunking or the slicing, so repeats are bit for bit equal and a
// fused bin (SegmentRuns) is bit for bit its spans' launches (StackRuns).
//
// The forms (`Native`, `Complex`, `F32Form`, `BfForm`, `CompForm`) are
// policies of the one kernel body: the data's type, the register tile,
// and, for the demoted forms, a converted plane.
// * native: two staging buffers; the tile reads them as they landed:
//   f64 on DMMA (m8n8k4, the warp path's fragments), f32 and bf16 on the
//   CUDA cores in full f32, each lane a micro-tile of row tiles by 2 nc
//   contiguous columns.
// * complex: staged as it lies, the parts interleaved (Z = 2 reals an
//   element, as the warp path's CTile): c8 on DMMA, 4 products a tile and
//   k-step (Ar.Br, (-Ai).Bi, Ar.Bi, Ai.Br) into a real and an imaginary
//   sum; c4 on 4 f32 FMAs a multiply-add.  The two sums take twice the
//   registers and the data twice the bytes, so the tile is 5 row tiles
//   (MT) and a (529,23) C block is cut into two chunks of 34 and 33 row
//   tiles, whose flat entries fit two buffers; complex alpha is applied
//   once, at the C update.
// * demoted (CVT): the operands stay at the request dtype in device
//   memory and land raw in one staging buffer; as each slot lands the
//   block converts it once into a plane of the compute form, which the
//   tile multiplies while the next slot lands in the raw buffer: f64->f32
//   as f32 in the slot's own layout (native f32's FMA tile, each entry's
//   k-sum in f32 widened into the run's f64 sum); -> bf16 as bf16, B
//   transposed, the k padding zero (the bf16 tensor cores, mma.sync
//   m16n8k16 on two of the warp's row tiles at once, each entry's sum in
//   a fresh f32 fragment added into the run's sum, the rule the warp
//   path's BfTile keeps); f64 compensated as the hi and lo parts in f64,
//   in the slot's layout (one DMMA product of depth 3k, CompTile's
//   scheme).  The sums pass through the plane at a segment's end.
//
// Measured on 40,000 runs of (529,23,23) blocks at 4.5 entries a run
// (perf/kernel_ab.py --tiled, NVIDIA H100 80GB HBM3, 700 W): f64 10.2 ms
// against the earlier 32x32 tile's 21.4 (bound 2.44 ms, bytes); 8.5 without its
// products and 7.4 without its operand copies, so staging and products
// take about as long and each hides only part of the other with one
// block an SM.  f32 7.0 against 18.9 (bound 1.50, operations); 5.1 and
// 5.8.  A predicate on every product of the register tile cost the f32
// tile 2.5x (19.2 ms), hence `full`.  The complex and demoted forms
// (same stack, same card; PERF.md): c8 29.6 ms (bound 6.01, operations),
// c4 19.6 (6.01), f64->f32 11.9 (2.44, bytes), f64->bf16 12.4 (2.44),
// f64->f32c 24.6 (4.51), f64->bf16c 26.2 (2.44), f32->bf16 8.2 (1.22),
// f32->bf16c 9.3 (1.22), against the earlier tile's 42.5, 31.5, 18.8,
// 18.2-19.2, 38.5, 39.3, 17.4-18.3 and 28.9-30.3.
namespace tiled {

constexpr int NW = 8;    // warps a thread block
constexpr int NTH = NW * 32;
constexpr int MTW = 9;   // the native register tile: at most MTW row tiles
constexpr int NTW = 3;   // by NTW column tiles of 8x8 (every form)
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
  int lda, ldb;    // sliced: row strides (elements) of the staged A and B slices
  int a_area;      // reals of T of one buffer's A area
  int buf;         // bytes of one staging buffer (native and complex: also the chunk's sum)
  int bufs;        // staging buffers: 2, or 1 beside a converted plane
  int pla, plb;    // the plane's row strides of A and B (elements of its type)
  int pa, pp;      // the plane's A part and one whole part (hi; lo after it), elements
  int smem;        // bytes of dynamic shared memory: the buffers, then the plane or sum
};

// the slot fits beside its second buffer, or beside the plane (and the
// sum, which passes through the plane's room at a segment's end)
__host__ __device__ inline bool fits(bool cvt, int slot_bytes, int plane_bytes, int sum_bytes) {
  if (cvt)
    return smm::round_up(slot_bytes, 16) + smm::round_up(imax(plane_bytes, sum_bytes), 16) <=
           SMEM_MAX;
  return 2 * smm::round_up(imax(slot_bytes, sum_bytes), 16) <= SMEM_MAX;
}

// The geometry of a launch of form F on (m, n) blocks whose entries reach
// depth kmax.  The complex and demoted forms (F::SPLIT) cut a C block's
// rows into as many balanced chunks as their register tile needs, and
// into more while a chunk's whole entries do not fit; then k slices (of
// fewer rows a chunk where even a 4-deep slice leaves no room for the
// chunk's sum).
template <typename F>
inline Geom geom(int m, int n, int kmax) {
  constexpr int Z = F::Z, TS = sizeof(typename F::T);
  constexpr int SS = sizeof(typename F::S);
  Geom g;
  g.mt = (m + 7) / 8;
  g.nt = (n + 7) / 8;
  long long best = -1;
  for (int wr = NW; wr >= 1; wr /= 2) {
    const int wc = NW / wr;
    const int rmt = imin(g.mt, wr * F::MT), cnt = imin(g.nt, wc * NTW);
    const int nrc = (g.mt + rmt - 1) / rmt, ncc = (g.nt + cnt - 1) / cnt;
    const int tr = (rmt + wr - 1) / wr, tc = (cnt + wc - 1) / wc;
    const long long key = (long long)nrc * ncc * 65536 + tr * tc * 256 + tr + tc;
    if (best < 0 || key < best) {
      best = key;
      g.wr = wr, g.wc = wc, g.rmt = rmt, g.cnt = cnt, g.nrc = nrc, g.ncc = ncc;
    }
  }
  g.bufs = F::CVT ? 1 : 2;
  const int q = 16 / TS, kp = smm::round_up(kmax, 4), nrc0 = g.nrc;
  int slot = 0, plane = 0;
  // the chunk's rows: balanced chunks for the forms that split
  auto rows = [&]() {
    if (F::SPLIT) g.rmt = (g.mt + g.nrc - 1) / g.nrc;
  };
  // one row tile fewer a chunk, while at least `least` are left
  auto fewer = [&](int least) {
    if (!F::SPLIT || g.rmt - 1 < least) return false;
    g.nrc = (g.mt + g.rmt - 2) / (g.rmt - 1);
    return true;
  };
  // whether the buffers (and the plane or the chunk's sum) fit
  auto fit = [&]() {
    return fits(F::CVT, slot * TS, plane, 8 * g.rmt * 8 * g.cnt * Z * SS);
  };
  auto sliced = [&](int ks) {
    g.ks = ks;
    g.lda = ks + 4;
    g.a_area = smm::round_up(Z * 8 * g.rmt * g.lda, q);
    slot = g.a_area + smm::round_up(Z * ks * g.ldb, q);
    plane = F::plane(8 * g.rmt, 8 * g.cnt, ks, slot, g);
    return fit();
  };
  g.lda = g.ldb = 0;
  g.ks = kp;
  for (g.flat = 1;;) {
    rows();
    g.a_area = smm::round_up(Z * (8 * g.rmt * kmax + kp) + q, q);
    slot = g.a_area + smm::round_up(Z * (kp * n + 8 * g.nt) + q, q);
    plane = F::plane(8 * g.rmt, 8 * g.cnt, kp, slot, g);
    if (fit()) break;
    if (!fewer(g.wr)) {
      g.flat = 0;
      break;
    }
  }
  if (!g.flat) {
    g.nrc = nrc0;
    g.ldb = 8 * g.cnt + 4;
    do {
      rows();
      int ks = imin(kp, 64);
      while (ks > 4 && !sliced(ks)) ks -= 4;
      if (sliced(ks)) break;
    } while (fewer(1));
  }
  const int sum_bytes = 8 * g.rmt * 8 * g.cnt * Z * SS;  // the chunk's sum, row stride 8 cnt
  if (F::CVT) {
    g.buf = smm::round_up(slot * TS, 16);
    g.smem = g.buf + smm::round_up(imax(plane, sum_bytes), 16);
  } else {
    g.buf = smm::round_up(imax(slot * TS, sum_bytes), 16);
    g.smem = 2 * g.buf;
  }
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

// f(r, c) for every element of a rows x cols block, the block's threads
// taking them in turn
template <typename Fn>
__device__ __forceinline__ void for_each_rc(int rows, int cols, int tid, Fn f) {
  const smm::FlatIter it = smm::flat_iter(cols, tid, NTH);
  int r = it.r0, c = it.c0;
  for (int w = tid; w < rows * cols; w += NTH) {
    f(r, c);
    c += it.rem;
    r += it.q;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// A warp's share of a chunk: row tiles r0, r0 + wr, ... (nr of them) and
// column tiles c0 .. c0 + nc - 1 of the chunk; bc0 is the column tile c0
// in the B the tile reads (staged flat: all of B; sliced or converted:
// the chunk's columns).
struct Strip {
  int r0, nr, c0, nc, bc0;
};

// Where a tile reads an entry (or slice): A(r, kk) = a[r * lda + kk] from
// the chunk's first row, B(kk, c) = b[kk * ldb + c] (strides in elements;
// complex data: elements of two reals), or a converted plane in its
// form's layout, whose lo part (compensated forms) starts `part`
// elements after the hi part.
template <typename P>
struct Src {
  const P *a, *b;
  int lda, ldb, part;
};

// A strip that fills at least 3/4 of the register tile multiplies all of
// it: the padded products on zeros cost less than a predicate per product
// (measured on the f32 FMAs: 7.8 against 19.2 ms on (529,23,23) stacks,
// NVIDIA H100 80GB HBM3, `perf/kernel_ab.py --tiled`); a smaller strip
// keeps the predicates.
template <int MT>
__device__ __forceinline__ bool full(const Strip& s) {
  return 4 * s.nr * s.nc >= 3 * MT * NTW;
}

// ---------------------------------------------------- register tiles
// Each: zero() at a segment's start, mma() per entry or slice,
// end_entry() after an entry's last slice, store() of the sums into
// shared memory (row stride sb elements; complex: two reals each).

// f64 on DMMA: fragments of m8n8k4 as in smm::Tile<double> (g = lane/4,
// t = lane%4: A(g, t), B(t, g), C(g, 2t) and C(g, 2t+1)); the k padding
// of the last 4-deep step is zeroed by predicate.
template <int MT>
struct DTile {
  double v[MT][NTW][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
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
      double af[MT], bf[NTW];
#pragma unroll
      for (int i = 0; i < MT; ++i) af[i] = i < s.nr && kin ? ap[i * astep + kk] : 0.0;
#pragma unroll
      for (int j = 0; j < NTW; ++j) bf[j] = j < s.nc && kin ? bp[kk * ldb + 8 * j] : 0.0;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          if (FULL || (i < s.nr && j < s.nc)) smm::dmma(v[i][j], af[i], bf[j]);
    }
  }

  __device__ __forceinline__ void mma(const Src<double>& x, int kd, int wr, const Strip& s,
                                      int lane) {
    const int gr = lane >> 2, t = lane & 3;
    const double* ap = x.a + (8 * s.r0 + gr) * x.lda + t;
    const double* bp = x.b + t * x.ldb + 8 * s.bc0 + gr;
    if (full<MT>(s))
      mma_k<true>(ap, 8 * wr * x.lda, bp, x.ldb, kd, t, s);
    else
      mma_k<false>(ap, 8 * wr * x.lda, bp, x.ldb, kd, t, s);
  }

  __device__ __forceinline__ void end_entry() {}

  // cs (row stride sb, the chunk's rows and columns) = the warp's sums
  __device__ __forceinline__ void store(double* cs, int sb, int wr, const Strip& s,
                                        int lane) const {
    const int gr = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i)
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
template <int MT>
struct FTile {
  float v[MT][2 * NTW];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * NTW; ++j) v[i][j] = 0.0f;
  }

  template <bool FULL, typename T>
  __device__ __forceinline__ void mma_k(const T* ap, int astep, const T* bp, int ldb, int kd,
                                        int tn, const Strip& s) {
#pragma unroll 2
    for (int kk = 0; kk < kd; ++kk) {
      float af[MT], bf[2 * NTW];
#pragma unroll
      for (int i = 0; i < MT; ++i) af[i] = i < s.nr ? to_f(ap[i * astep + kk]) : 0.0f;
#pragma unroll
      for (int j = 0; j < 2 * NTW; ++j) bf[j] = j < tn ? to_f(bp[kk * ldb + j]) : 0.0f;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * NTW; ++j)
          if (FULL || (i < s.nr && j < tn)) v[i][j] = fmaf(af[i], bf[j], v[i][j]);
    }
  }

  template <typename T>
  __device__ __forceinline__ void mma(const Src<T>& x, int kd, int wr, const Strip& s,
                                      int lane) {
    const int tn = 2 * s.nc;
    const T* ap = x.a + (8 * s.r0 + (lane >> 2)) * x.lda;
    const T* bp = x.b + 8 * s.bc0 + (lane & 3) * tn;
    if (full<MT>(s))
      mma_k<true>(ap, 8 * wr * x.lda, bp, x.ldb, kd, tn, s);
    else
      mma_k<false>(ap, 8 * wr * x.lda, bp, x.ldb, kd, tn, s);
  }

  __device__ __forceinline__ void end_entry() {}

  template <typename W>
  static __device__ __forceinline__ void store_micro(W* cs, const W (&v)[MT][2 * NTW], int sb,
                                                     int wr, const Strip& s, int lane) {
    const int tn = 2 * s.nc, r = lane >> 2, c = 8 * s.c0 + (lane & 3) * tn;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * NTW; ++j)
        if (i < s.nr && j < tn) cs[(8 * (s.r0 + wr * i) + r) * sb + c + j] = v[i][j];
  }

  __device__ __forceinline__ void store(float* cs, int sb, int wr, const Strip& s,
                                        int lane) const {
    store_micro(cs, v, sb, wr, s, lane);
  }
};

// f64 -> f32: FTile on the f32 plane, each entry's f32 k-sum widened into
// the run's f64 sum (the order `form_tolerance` assumes)
template <int MT>
struct F32WTile {
  FTile<MT> f;
  double w[MT][2 * NTW];

  __device__ __forceinline__ void zero() {
    f.zero();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * NTW; ++j) w[i][j] = 0.0;
  }
  __device__ __forceinline__ void mma(const Src<float>& x, int kd, int wr, const Strip& s,
                                      int lane) {
    f.mma(x, kd, wr, s, lane);
  }
  __device__ __forceinline__ void end_entry() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * NTW; ++j) {
        w[i][j] += static_cast<double>(f.v[i][j]);
        f.v[i][j] = 0.0f;
      }
  }
  __device__ __forceinline__ void store(double* cs, int sb, int wr, const Strip& s,
                                        int lane) const {
    FTile<MT>::store_micro(cs, w, sb, wr, s, lane);
  }
};

// f64 compensated (f32c, bf16c): DMMA on the hi and lo planes, per
// 4-deep k-step hi.hi, then hi.lo, then lo.hi of every tile, straight
// into the run's f64 sum: one product of depth 3k (CompTile's scheme)
template <int MT>
struct CompDTile {
  DTile<MT> d;

  __device__ __forceinline__ void zero() { d.zero(); }

  template <bool FULL>
  __device__ __forceinline__ void mma_k(const double* ap, int astep, const double* bp, int ldb,
                                        int part, int kd, int t, const Strip& s) {
#pragma unroll 1
    for (int kk = 0; kk < kd; kk += 4) {
      const bool kin = kk + t < kd;
      double ah[MT], al[MT], bh[NTW], bl[NTW];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const bool in = i < s.nr && kin;
        ah[i] = in ? ap[i * astep + kk] : 0.0;
        al[i] = in ? ap[part + i * astep + kk] : 0.0;
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const bool in = j < s.nc && kin;
        bh[j] = in ? bp[kk * ldb + 8 * j] : 0.0;
        bl[j] = in ? bp[part + kk * ldb + 8 * j] : 0.0;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          if (FULL || (i < s.nr && j < s.nc)) smm::dmma(d.v[i][j], ah[i], bh[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          if (FULL || (i < s.nr && j < s.nc)) smm::dmma(d.v[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          if (FULL || (i < s.nr && j < s.nc)) smm::dmma(d.v[i][j], al[i], bh[j]);
    }
  }

  __device__ __forceinline__ void mma(const Src<double>& x, int kd, int wr, const Strip& s,
                                      int lane) {
    const int gr = lane >> 2, t = lane & 3;
    const double* ap = x.a + (8 * s.r0 + gr) * x.lda + t;
    const double* bp = x.b + t * x.ldb + 8 * s.bc0 + gr;
    if (full<MT>(s))
      mma_k<true>(ap, 8 * wr * x.lda, bp, x.ldb, x.part, kd, t, s);
    else
      mma_k<false>(ap, 8 * wr * x.lda, bp, x.ldb, x.part, kd, t, s);
  }

  __device__ __forceinline__ void end_entry() {}

  __device__ __forceinline__ void store(double* cs, int sb, int wr, const Strip& s,
                                        int lane) const {
    d.store(cs, sb, wr, s, lane);
  }
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// -> bf16 on the tensor cores (mma.sync m16n8k16, bf16 in, f32 out): a
// fragment's 16 rows are two of the warp's row tiles, 2p and 2p + 1 of its
// strip (rows g and g + 8 of the fragment: row g of each), B read from
// the transposed plane.  Fragments as smm::BfTile's (g = lane/4, t =
// lane%4: A rows g, g+8 at columns 2t, 2t+1 and 2t+8, 2t+9; B column g at
// the same depths; C rows g, g+8 at columns 2t, 2t+1).  Each entry's sum
// runs in a fresh f32 fragment (compensated: hi.hi, hi.lo and lo.hi) and
// is then added into the run's sum W (f64 for f64 data, f32 for f32
// data): the tensor cores' f32 sums truncate, and a run of thousands of
// entries summed in the fragment itself misses `form_tolerance`.
template <typename W, int MT, bool COMP>
struct BTile {
  static constexpr int MP = (MT + 1) / 2;  // fragments of two row tiles
  W v[MP][NTW][4];
  float p[MP][NTW][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MP; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[i][j][q] = W(0);
          p[i][j][q] = 0.0f;
        }
  }

  __device__ __forceinline__ void mma(const Src<__nv_bfloat16>& x, int kd, int wr,
                                      const Strip& s, int lane) {
    const int gr = lane >> 2, t = lane & 3;
    // kd's padding to 16 is zero in the planes
#pragma unroll 1
    for (int kc = 0; kc < kd; kc += 16) {
      uint32_t ah[MP][4], al[MP][4];
#pragma unroll
      for (int i = 0; i < MP; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tile = 2 * i + h;
          const __nv_bfloat16* r = x.a + (8 * (s.r0 + wr * tile) + gr) * x.lda + kc + 2 * t;
          const bool in = tile < s.nr;
          ah[i][h] = in ? ld32(r) : 0u;
          ah[i][h + 2] = in ? ld32(r + 8) : 0u;
          al[i][h] = COMP && in ? ld32(r + x.part) : 0u;
          al[i][h + 2] = COMP && in ? ld32(r + x.part + 8) : 0u;
        }
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        if (j < s.nc) {
          const __nv_bfloat16* y = x.b + (8 * (s.bc0 + j) + gr) * x.ldb + kc + 2 * t;
          const uint32_t bh0 = ld32(y), bh1 = ld32(y + 8);
          const uint32_t bl0 = COMP ? ld32(y + x.part) : 0u;
          const uint32_t bl1 = COMP ? ld32(y + x.part + 8) : 0u;
#pragma unroll
          for (int i = 0; i < MP; ++i)
            if (2 * i < s.nr) {
              smm::bf16_mma(p[i][j], ah[i], bh0, bh1);
              if (COMP) {
                smm::bf16_mma(p[i][j], ah[i], bl0, bl1);
                smm::bf16_mma(p[i][j], al[i], bh0, bh1);
              }
            }
        }
    }
  }

  __device__ __forceinline__ void end_entry() {
#pragma unroll
    for (int i = 0; i < MP; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[i][j][q] += static_cast<W>(p[i][j][q]);
          p[i][j][q] = 0.0f;
        }
  }

  __device__ __forceinline__ void store(W* cs, int sb, int wr, const Strip& s, int lane) const {
    const int gr = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MP; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int tile = 2 * i + (q >> 1);
          if (tile < s.nr && j < s.nc)
            cs[(8 * (s.r0 + wr * tile) + gr) * sb + 8 * (s.c0 + j) + 2 * t + (q & 1)] =
                v[i][j][q];
        }
  }
};

// c8 on DMMA: per 4-deep k-step each 8x8 tile of the real sum takes
// Ar.Br and then (-Ai).Bi, the imaginary one Ar.Bi and then Ai.Br (the
// warp path's CTile order); a fragment reads both parts in one load
template <int MT>
struct CDTile {
  double re[MT][NTW][2], im[MT][NTW][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j) re[i][j][0] = re[i][j][1] = im[i][j][0] = im[i][j][1] = 0.0;
  }

  template <bool FULL>
  __device__ __forceinline__ void mma_k(const double2* ap, int astep, const double2* bp,
                                        int ldb, int kd, int t, const Strip& s) {
#pragma unroll 1
    for (int kk = 0; kk < kd; kk += 4) {
      const bool kin = kk + t < kd;
      double2 af[MT], bf[NTW];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        af[i] = i < s.nr && kin ? ap[i * astep + kk] : make_double2(0.0, 0.0);
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        bf[j] = j < s.nc && kin ? bp[kk * ldb + 8 * j] : make_double2(0.0, 0.0);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const double nai = -af[i].y;
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          if (FULL || (i < s.nr && j < s.nc)) {
            smm::dmma(re[i][j], af[i].x, bf[j].x);
            smm::dmma(re[i][j], nai, bf[j].y);
            smm::dmma(im[i][j], af[i].x, bf[j].y);
            smm::dmma(im[i][j], af[i].y, bf[j].x);
          }
      }
    }
  }

  __device__ __forceinline__ void mma(const Src<double>& x, int kd, int wr, const Strip& s,
                                      int lane) {
    const int gr = lane >> 2, t = lane & 3;
    const double2* ap = reinterpret_cast<const double2*>(x.a) + (8 * s.r0 + gr) * x.lda + t;
    const double2* bp = reinterpret_cast<const double2*>(x.b) + t * x.ldb + 8 * s.bc0 + gr;
    if (full<MT>(s))
      mma_k<true>(ap, 8 * wr * x.lda, bp, x.ldb, kd, t, s);
    else
      mma_k<false>(ap, 8 * wr * x.lda, bp, x.ldb, kd, t, s);
  }

  __device__ __forceinline__ void end_entry() {}

  __device__ __forceinline__ void store(double* cs, int sb, int wr, const Strip& s,
                                        int lane) const {
    const int gr = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        if (i < s.nr && j < s.nc)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            double* p = cs + 2 * ((8 * (s.r0 + wr * i) + gr) * sb + 8 * (s.c0 + j) + 2 * t + h);
            p[0] = re[i][j][h];
            p[1] = im[i][j][h];
          }
  }
};

// c4 on the CUDA cores in FTile's lane layout, 4 f32 FMAs a multiply-add
// in the warp path's CTile<float> order, never TF32
template <int MT>
struct CFTile {
  float re[MT][2 * NTW], im[MT][2 * NTW];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * NTW; ++j) re[i][j] = im[i][j] = 0.0f;
  }

  template <bool FULL>
  __device__ __forceinline__ void mma_k(const float2* ap, int astep, const float2* bp, int ldb,
                                        int kd, int tn, const Strip& s) {
#pragma unroll 1
    for (int kk = 0; kk < kd; ++kk) {
      float2 af[MT], bf[2 * NTW];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        af[i] = i < s.nr ? ap[i * astep + kk] : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int j = 0; j < 2 * NTW; ++j)
        bf[j] = j < tn ? bp[kk * ldb + j] : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * NTW; ++j)
          if (FULL || (i < s.nr && j < tn)) {
            re[i][j] = fmaf(af[i].x, bf[j].x, re[i][j]);
            re[i][j] = fmaf(-af[i].y, bf[j].y, re[i][j]);
            im[i][j] = fmaf(af[i].x, bf[j].y, im[i][j]);
            im[i][j] = fmaf(af[i].y, bf[j].x, im[i][j]);
          }
    }
  }

  __device__ __forceinline__ void mma(const Src<float>& x, int kd, int wr, const Strip& s,
                                      int lane) {
    const int tn = 2 * s.nc;
    const float2* ap = reinterpret_cast<const float2*>(x.a) + (8 * s.r0 + (lane >> 2)) * x.lda;
    const float2* bp = reinterpret_cast<const float2*>(x.b) + 8 * s.bc0 + (lane & 3) * tn;
    if (full<MT>(s))
      mma_k<true>(ap, 8 * wr * x.lda, bp, x.ldb, kd, tn, s);
    else
      mma_k<false>(ap, 8 * wr * x.lda, bp, x.ldb, kd, tn, s);
  }

  __device__ __forceinline__ void end_entry() {}

  __device__ __forceinline__ void store(float* cs, int sb, int wr, const Strip& s,
                                        int lane) const {
    const int tn = 2 * s.nc, r = lane >> 2, c = 8 * s.c0 + (lane & 3) * tn;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * NTW; ++j)
        if (i < s.nr && j < tn) {
          float* p = cs + 2 * ((8 * (s.r0 + wr * i) + r) * sb + c + j);
          p[0] = re[i][j];
          p[1] = im[i][j];
        }
  }
};

// ------------------------------------------------------------- forms
// T the data's real type (Z reals an element), S the sum's, P what the
// tile reads (the data itself, or the plane it is converted into), MT
// the register tile's row tiles, MINB the blocks an SM the registers are
// capped for; CVT: one staging buffer and a converted plane, which the
// tile multiplies while the next entry lands (a second staging buffer
// measured no faster, PERF.md); MIRROR: the
// plane has the staged slot's layout (the same offsets and strides, so
// the tile reads it as a slot), each value converted in place of its
// source; SPLIT: balanced chunks, more of them while a whole entry does
// not fit.  plane() sets the plane's layout in g (its parts of `pp`
// elements: hi, then lo) and returns its bytes; convert() fills it from
// a landed slot (MIRROR: the whole slot of `pp` reals; otherwise A rv x
// kv, row stride lda, and the chunk's columns of B, kv x cv, row stride
// ldb).

struct NoPlane {
  static constexpr bool CVT = false, MIRROR = false;
  __host__ __device__ static int plane(int, int, int, int, Geom& g) {
    g.pla = g.plb = g.pa = g.pp = 0;
    return 0;
  }
  template <typename... A>
  __device__ static void convert(A...) {}
};

template <typename TT>
struct Native : NoPlane {
  using T = TT;
  using S = typename AccOf<T>::type;
  using P = T;
  static constexpr int Z = 1, MT = MTW, MINB = sizeof(T) == 8 ? 1 : 2;
  static constexpr bool SPLIT = false;
  using Tile = typename std::conditional<sizeof(T) == 8, DTile<MT>, FTile<MT>>::type;
};

template <typename R>
struct Complex : NoPlane {
  using T = R;
  using S = R;
  using P = R;
  static constexpr int Z = 2, MT = 5, MINB = sizeof(R) == 8 ? 1 : 2;
  static constexpr bool SPLIT = true;
  using Tile = typename std::conditional<sizeof(R) == 8, CDTile<MT>, CFTile<MT>>::type;
};

// f64 -> f32: the slot rounded to f32, two values a thread at a time.
// The native f32 tile's 9 row tiles (a (529,23) C block one chunk, one
// block an SM: 11.9 ms on the synthetic stack) beat two blocks an SM on
// 5 row tiles in two chunks (13.6; 4 row tiles: 16.0; PERF.md)
struct F32Form {
  using T = double;
  using S = double;
  using P = float;
  static constexpr int Z = 1, MT = MTW, MINB = 1;
  static constexpr bool CVT = true, MIRROR = true, SPLIT = true;
  using Tile = F32WTile<MT>;
  __host__ __device__ static int plane(int, int, int, int slot, Geom& g) {
    g.pla = g.plb = g.pa = 0;
    g.pp = slot;
    return 4 * slot;
  }
  __device__ static void convert(float* pl, const Geom& g, const double* raw, int tid) {
    const double2* src = reinterpret_cast<const double2*>(raw);
    float2* dst = reinterpret_cast<float2*>(pl);
    for (int i = tid; i < g.pp / 2; i += NTH) {
      const double2 x = src[i];
      dst[i] = make_float2(static_cast<float>(x.x), static_cast<float>(x.y));
    }
  }
};

// -> bf16 (f64 or f32 data): A [rows][KS] and B transposed [cols][KS],
// KS = ks rounded up to 16, plus 8 (conflict-free 4-byte fragment loads),
// the k padding zero, two values of a row a thread at a time;
// compensated, the lo parts after the hi parts.  f64 data takes the
// native tile's 9 row tiles (a (529,23) C block one chunk: 12.4 against
// 14.3 ms on 6 row tiles in two), f32 data 6 and two blocks an SM
// (f32->bf16c 9.3 against 9.7 on 9; PERF.md)
template <typename TT, bool COMP>
struct BfForm {
  using T = TT;
  using S = TT;
  using P = __nv_bfloat16;
  static constexpr int Z = 1, MT = sizeof(TT) == 8 ? MTW : 6, MINB = sizeof(TT) == 8 ? 1 : 2;
  static constexpr bool CVT = true, MIRROR = false, SPLIT = true;
  using Tile = BTile<S, MT, COMP>;
  __host__ __device__ static int plane(int rows, int cols, int ks, int, Geom& g) {
    g.pla = g.plb = smm::round_up(ks, 16) + 8;
    g.pa = rows * g.pla;
    g.pp = smm::round_up(g.pa + cols * g.plb, 8);
    return 2 * g.pp * (COMP ? 2 : 1);
  }
  __device__ static void convert(__nv_bfloat16* pl, const Geom& g, const TT* ra, int lda,
                                 const TT* rb, int ldb, int rv, int kv, int cv, int tid) {
    const int kh = smm::round_up(kv, 16) / 2;  // pairs of a row, the padding's included
    auto put = [&](__nv_bfloat16* d, TT x0, TT x1) {
      const __nv_bfloat162 hi =
          __floats2bfloat162_rn(static_cast<float>(x0), static_cast<float>(x1));
      *reinterpret_cast<__nv_bfloat162*>(d) = hi;
      if (COMP)
        *reinterpret_cast<__nv_bfloat162*>(d + g.pp) = __floats2bfloat162_rn(
            static_cast<float>(x0 - static_cast<TT>(__low2float(hi))),
            static_cast<float>(x1 - static_cast<TT>(__high2float(hi))));
    };
    for_each_rc(rv, kh, tid, [&](int r, int h) {
      const int kk = 2 * h;
      const TT* x = ra + r * lda + kk;
      put(pl + r * g.pla + kk, kk < kv ? x[0] : TT(0), kk + 1 < kv ? x[1] : TT(0));
    });
    for_each_rc(cv, kh, tid, [&](int c, int h) {
      const int kk = 2 * h;
      const TT* x = rb + kk * ldb + c;
      put(pl + g.pa + c * g.plb + kk, kk < kv ? x[0] : TT(0), kk + 1 < kv ? x[ldb] : TT(0));
    });
  }
};

// f64 compensated (CT 0 = f32c, 1 = bf16c): the slot's hi parts, then
// its lo parts (the splits are exact in f64)
template <int CT>
struct CompForm {
  using T = double;
  using S = double;
  using P = double;
  static constexpr int Z = 1, MT = 5, MINB = 1;
  static constexpr bool CVT = true, MIRROR = true, SPLIT = true;
  using Tile = CompDTile<MT>;
  __host__ __device__ static int plane(int, int, int, int slot, Geom& g) {
    g.pla = g.plb = g.pa = 0;
    g.pp = slot;
    return 8 * 2 * slot;
  }
  __device__ static void convert(double* pl, const Geom& g, const double* raw, int tid) {
    for (int i = tid; i < g.pp; i += NTH) smm::split_hi_lo<CT>(raw[i], pl[i], pl[g.pp + i]);
  }
};

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

// The kernel body of every form F (above): registers capped for F::MINB
// blocks an SM (native: two for 4- and 2-byte data, at most 128
// registers, two (529,23,23) f32 buffers taking 103 kB; one for f64, its
// 27 tiles taking 108 registers and its buffers 207 kB).  alpha_im is a
// complex alpha's imaginary part.
template <typename F, typename Runs>
__global__ void __launch_bounds__(NTH, F::MINB)
tiled_kernel(Runs runs, typename F::T* __restrict__ c, int m, int n, Geom g, int nwork,
             typename F::S alpha, typename F::S alpha_im) {
  using T = typename F::T;
  using S = typename F::S;
  using P = typename F::P;
  using TileT = typename F::Tile;
  constexpr int Z = F::Z;
  constexpr bool CVT = F::CVT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp % g.wr, wc = warp / g.wr;
  const int nch = g.nrc * g.ncc, sb = 8 * g.cnt;
  P* const plane = reinterpret_cast<P*>(smem_raw + g.bufs * g.buf);

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
    return static_cast<const T*>(runs.a(x.sg.sp)) + Z * ((int64_t)x.ia * m + row0) * x.k;
  };
  auto b_of = [&](const Cursor& x) {
    return static_cast<const T*>(runs.b(x.sg.sp)) + Z * (int64_t)x.ib * x.k * n;
  };
  // a staged block's offset (reals) within its area
  auto off = [](const T* p) { return (int)((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T)); };
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
  // the depth of the cursor's slice
  auto depth = [&](const Cursor& x) { return g.flat ? x.k : imin(g.ks, x.k - x.sl * g.ks); };
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
      stage_flat(area, ap, Z * rv * k, tid);
      stage_flat(area + g.a_area, bp, Z * k * n, tid);
    } else {
      const int k0 = x.sl * g.ks, kv = depth(x);
      stage_2d(area, Z * g.lda, ap + Z * k0, Z * k, rv, Z * kv, tid);
      stage_2d(area + g.a_area, Z * g.ldb, bp + Z * ((int64_t)k0 * n + col0), Z * n, kv,
               Z * cv, tid);
    }
    if (x.fresh) {
      const char* p0 = reinterpret_cast<const char*>(c + Z * ((int64_t)x.cblk * m + row0) * n);
      const char* p1 = p0 + (int64_t)Z * rv * n * sizeof(T);
      p0 -= reinterpret_cast<uintptr_t>(p0) & 127;
      for (const char* p = p0 + tid * 128; p < p1; p += NTH * 128)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
    }
  };
  // CVT: the cursor's slot, landed in the one staging buffer, into the
  // plane, each value converted once
  auto convert = [&](const Cursor& x) {
    const T* const area = reinterpret_cast<const T*>(smem_raw);
    if constexpr (F::MIRROR) {
      F::convert(plane, g, area, tid);
    } else {
      int row0, rv, col0, cv;
      chunk(x.w, row0, rv, col0, cv);
      if (g.flat)
        F::convert(plane, g, area + off(a_of(x)), x.k, area + g.a_area + off(b_of(x)) + col0,
                   n, rv, x.k, cv, tid);
      else
        F::convert(plane, g, area, g.lda, area + g.a_area, g.ldb, rv, depth(x), cv, tid);
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
    s.bc0 = g.flat && (!CVT || F::MIRROR) ? cc * g.cnt + s.c0 : s.c0;
    return s;
  };

  // cur multiplies while nxt lands and fut's indices load; with a plane
  // (CVT), cur is in the plane and nxt lands in the one staging buffer
  Cursor cur;
  start(cur, blockIdx.x);
  if (cur.w >= nwork) return;
  stage(cur, 0);
  smm::cp_async_commit();
  Cursor nxt = cur;
  advance(nxt);
  if constexpr (CVT) {
    smm::cp_async_wait<0>();
    __syncthreads();
    convert(cur);
    __syncthreads();
    if (nxt.w < nwork) stage(nxt, 0);
    smm::cp_async_commit();
  }
  TileT acc;
  int bb = 0;
  while (true) {
    if constexpr (!CVT) {
      if (nxt.w < nwork) stage(nxt, bb ^ 1);
      smm::cp_async_commit();
    }
    Cursor fut = nxt;
    if (nxt.w < nwork) advance(fut);
    if constexpr (!CVT) {
      smm::cp_async_wait<1>();  // every group but the newest: this slice has landed
      __syncthreads();
    }
    const Strip s = strip(cur.w);
    if (cur.e == cur.sg.e0 && cur.sl == 0) acc.zero();
    Src<P> src;
    if constexpr (CVT && !F::MIRROR) {
      src = {plane, plane + g.pa, g.pla, g.plb, g.pp};
    } else {  // the slot, or the plane that mirrors it
      const P* const base = CVT ? plane : reinterpret_cast<const P*>(smem_raw + bb * g.buf);
      if (g.flat)
        src = {base + off(a_of(cur)), base + g.a_area + off(b_of(cur)), cur.k, n, g.pp};
      else
        src = {base, base + g.a_area, g.lda, g.ldb, g.pp};
    }
    const int kd = depth(cur);
    acc.mma(src, kd, g.wr, s, lane);
    if (cur.sl + 1 == cur.nsl) acc.end_entry();
    if (cur.e + 1 == cur.sg.e1 && cur.sl + 1 == cur.nsl) {
      // the segment ends: C = C + alpha * sum over the chunk, the sums
      // through shared memory (the buffer just multiplied, or the plane),
      // then coalesced, EB loads of C in flight a thread before their
      // stores; complex: each real beside its element's other part
      __syncthreads();
      S* const cs = reinterpret_cast<S*>(CVT ? reinterpret_cast<unsigned char*>(plane)
                                             : smem_raw + bb * g.buf);
      acc.store(cs, sb, g.wr, s, lane);
      __syncthreads();
      int row0, rv, col0, cv;
      chunk(cur.w, row0, rv, col0, cv);
      T* const cb = c + Z * (((int64_t)cur.cblk * m + row0) * n + col0);
      const int cvr = Z * cv;  // reals of a chunk row
      const smm::FlatIter it = smm::flat_iter(cvr, tid, NTH);
      const int total = rv * cvr;
      int r = it.r0, cc = it.c0;
      for (int w0 = tid; w0 < total; w0 += EB * NTH) {
        S old[EB];
        int po[EB], so[EB];
#pragma unroll
        for (int j = 0; j < EB; ++j) {
          po[j] = r * Z * n + cc;
          so[j] = r * Z * sb + cc;
          old[j] = w0 + j * NTH < total ? load_acc(cb + po[j]) : S(0);
          cc += it.rem;
          r += it.q;
          if (cc >= cvr) {
            cc -= cvr;
            ++r;
          }
        }
#pragma unroll
        for (int j = 0; j < EB; ++j)
          if (w0 + j * NTH < total) {
            if constexpr (Z == 1) {
              store_acc(cb + po[j], smm::fmadd(alpha, cs[so[j]], old[j]));
            } else {
              const S sr = cs[so[j] & ~1], si = cs[so[j] | 1];
              store_acc(cb + po[j], so[j] & 1 ? old[j] + (alpha * si + alpha_im * sr)
                                              : old[j] + (alpha * sr - alpha_im * si));
            }
          }
      }
    }
    if (nxt.w >= nwork) break;
    if constexpr (CVT) {
      smm::cp_async_wait<0>();  // nxt has landed
      __syncthreads();          // and the plane's readers are done
      convert(nxt);
      __syncthreads();
      if (fut.w < nwork) stage(fut, 0);
      smm::cp_async_commit();
    } else {
      __syncthreads();  // the buffer is free for the slice after next
      bb ^= 1;
    }
    cur = nxt;
    nxt = fut;
  }
  smm::cp_async_wait<0>();
}

// Launch (or, attrs non-null, report the instance of) the tiled kernel
// of form F on `runs`, whose entries reach depth kmax.
template <typename F, typename Runs>
cudaError_t launch(const Runs& runs, void* c, int m, int n, int kmax, double alpha,
                   double alpha_im, cudaStream_t stream, int* attrs) {
  using S = typename F::S;
  const Geom g = geom<F>(m, n, kmax);
  const long long work = (long long)runs.nruns * g.nrc * g.ncc;
  if (work > 0x7fffffff) return cudaErrorInvalidValue;
  const auto kernel = tiled_kernel<F, Runs>;
  int grid = 0;
  const cudaError_t err = smm::persistent_grid(kernel, NTH, g.smem, (int)work, &grid);
  if (err != cudaSuccess) return err;
  if (attrs) return kernel_attrs(kernel, NTH, g.smem, attrs);
  kernel<<<grid, NTH, g.smem, stream>>>(runs, static_cast<typename F::T*>(c), m, n, g,
                                        (int)work, static_cast<S>(alpha),
                                        static_cast<S>(alpha_im));
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

// The tiled path's form of (T, CT, COMP), as FormTile names the warp
// path's register tile
template <typename T, int CT, bool COMP> struct TiledForm {
  using type = tiled::Native<T>;  // CT = -1
};
template <> struct TiledForm<double, 0, false> {
  using type = tiled::F32Form;
};
template <> struct TiledForm<double, 0, true> {
  using type = tiled::CompForm<0>;
};
template <> struct TiledForm<double, 1, false> {
  using type = tiled::BfForm<double, false>;
};
template <> struct TiledForm<double, 1, true> {
  using type = tiled::CompForm<1>;
};
template <> struct TiledForm<float, 1, false> {
  using type = tiled::BfForm<float, false>;
};
template <> struct TiledForm<float, 1, true> {
  using type = tiled::BfForm<float, true>;
};

smm::StackRuns stack_runs(const Args& x) {
  return {x.a, x.b, static_cast<const int*>(x.a_idx), static_cast<const int*>(x.b_idx),
          static_cast<const int*>(x.run_ptr), static_cast<const int*>(x.run_c), x.nruns, x.k};
}

// CT = -1: native compute; 0/1: demoted to f32/bf16, COMP compensated.
template <typename T, int CT, bool COMP>
cudaError_t launch(const Args& x) {
  if (smm::warp_dims(x.m, x.n, x.k)) {
    switch (smm::warp_class(x.m, x.n)) {
      case 2: return launch_warp<T, 2, typename FormTile<T, 2, CT, COMP>::type>(x);
      case 3: return launch_warp<T, 3, typename FormTile<T, 3, CT, COMP>::type>(x);
      default: return launch_warp<T, 4, typename FormTile<T, 4, CT, COMP>::type>(x);
    }
  }
  return tiled::launch<typename TiledForm<T, CT, COMP>::type>(
      stack_runs(x), x.c, x.m, x.n, x.k, x.alpha, 0.0, x.stream, x.attrs);
}

// c8 takes two warps a block on the warp path: a warp's two step buffers
// hold 37 kB at 23x23x23, so three such blocks fill an SM
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
  return tiled::launch<tiled::Complex<R>>(stack_runs(x), x.c, x.m, x.n, x.k, x.alpha,
                                          x.alpha_im, x.stream, x.attrs);
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
  return tiled::launch<tiled::Native<T>>(runs, c, m, n, kmax, alpha, 0.0, stream, attrs);
}

// a form's tiled geometry into out[13] (smm_stack_tiled_geom)
template <typename F>
int tiled_geom(int m, int n, int kmax, int* out) {
  const tiled::Geom g = tiled::geom<F>(m, n, kmax);
  const int vals[13] = {g.wr,  g.wc,  g.rmt, g.cnt,    g.nrc,  g.ncc, g.flat,
                        g.ks,  g.lda, g.ldb, g.a_area, g.smem, g.bufs};
  for (int i = 0; i < 13; ++i) out[i] = vals[i];
  return 0;
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

// The tiled path's geometry of a launch of one form (dtype and compute
// as smm_stack_launch) of (m, n) blocks whose entries reach depth kmax
// (out[13]: wr, wc, rmt, cnt, nrc, ncc, flat, ks, lda, ldb, a_area,
// smem, bufs; acc/stack_kernel.py:tiled_geometry names them).  Returns
// cudaErrorInvalidValue for a form the kernel does not have.
int smm_stack_tiled_geom(int dtype, int compute, int m, int n, int kmax, int* out) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (m < 1 || n < 1 || kmax < 1) return bad;
  switch (dtype * 8 + compute) {
    case 0: return tiled_geom<tiled::Native<double>>(m, n, kmax, out);
    case 1: return tiled_geom<TiledForm<double, 0, false>::type>(m, n, kmax, out);
    case 2: return tiled_geom<TiledForm<double, 0, true>::type>(m, n, kmax, out);
    case 3: return tiled_geom<TiledForm<double, 1, false>::type>(m, n, kmax, out);
    case 4: return tiled_geom<TiledForm<double, 1, true>::type>(m, n, kmax, out);
    case 8: return tiled_geom<tiled::Native<float>>(m, n, kmax, out);
    case 11: return tiled_geom<TiledForm<float, 1, false>::type>(m, n, kmax, out);
    case 12: return tiled_geom<TiledForm<float, 1, true>::type>(m, n, kmax, out);
    case 16: return tiled_geom<tiled::Native<__nv_bfloat16>>(m, n, kmax, out);
    case 24: return tiled_geom<tiled::Complex<float>>(m, n, kmax, out);
    case 32: return tiled_geom<tiled::Complex<double>>(m, n, kmax, out);
    default: return bad;
  }
}

int smm_superstack_max_spans() { return MAX_SPANS; }

const char* smm_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
