// The warp path shared by the stack kernel (smm_stack.cu, K1) and the
// crosspack kernel (smm_crosspack.cu, K3 and K4): one warp computes one
// run, C[run_c] = C[run_c] + alpha * sum_{e in run} A[a_idx[e]] @ B[b_idx[e]],
// for blocks with m, n, k <= WARP_MAX_DIM.  The kernels differ only in
// which runs the warps of a block take (`ConsecutiveRuns`, `PackRuns`)
// and what a run is made of (`StackRuns`: one stack's; K1's fused launch,
// smm_stack.cu's SegmentRuns: a C block's segments, one a span).
//
// Per warp, in shared memory (the staged type S is double for f64 and
// float for f32 and bf16): two step buffers of r entry slots, each slot
// an A and a B block stored flat, as they lie in device memory; the sum
// is written out through the buffer of the run's last step.  The warp
// stages step s+1 with cp.async while it multiplies step s.  A 23x23 f64
// block is 4232 B and begins on 8 bytes only, so a slot keeps the block
// at the offset its source has within 16 bytes: then all but the first
// and last element copy in 16-byte pieces, one per lane.  bf16 is
// converted to f32 as it is staged, by plain loads.  The pipeline runs across runs: the
// next run's first step is staged while this run's last step multiplies,
// and a run's C block is loaded into registers when the run starts.  The
// sum of the block, padded to 8-multiples in m and n, stays in registers
// for the whole run:
//   f64: the FP64 tensor cores, mma.sync m8n8k4 (DMMA), mt x nt tiles of
//        8x8, two doubles of each tile a lane (18 for a 24x24 block), k
//        padded to a multiple of 4 with zeros by predicate;
//   f32/bf16: the CUDA cores in full f32 (never TF32), each lane owning a
//        micro-tile of mt rows (lane/4 + 8i) by 2*nt contiguous columns,
//        so each k loads mt A values and 2*nt B values for 2*mt*nt FMAs.
// Reads past the last row of A or the last column of B reach only padded
// outputs, which are never written.  At the end the warp passes the sum
// through shared memory and writes C + alpha * sum over the block's valid
// m*n elements with coalesced stores, once.  No atomics: a run owns its C
// block.  Each output sums its entries in stack order and k ascending
// (DMMA sums a k-step of 4 in an order fixed by the hardware), so repeats
// are bit for bit equal.  Blocks are persistent: each loops over groups
// of runs, so a warp whose run ends early takes the next one.
//
// K1's complex and demoted forms take the same pipeline with their own
// register tiles (the tiles' section below).  Complex data is staged as
// it lies, its parts interleaved (z = 2 reals an element in the slot's
// geometry): c8 on DMMA, four a tile and k-step; c4 on f32 FMAs.  A
// demoted tile converts each value of a slot once, as the slot lands,
// into planes of its own in shared memory: f32 planes for f64 -> f32
// (f32 FMAs, each entry's k-sum widened into the f64 sum), bf16 planes
// for -> bf16 (the bf16 tensor cores, mma.sync m16n8k16 with f32 sums),
// and, for f64 data's compensated forms, hi in place in the slot and lo
// in a plane, multiplied as one DMMA product of depth 3k (the parts'
// products are exact in f64).  The forms keep the determinism contract:
// each element sums its entries in stack order, in a fixed order within
// an entry (dbcsr_tpu/acc/smm.py:_batch_dot, :78-135, computes the same
// function).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace smm {

constexpr int WARP_MAX_DIM = 32;  // m, n, k of the warp path

template <typename T> struct AccOf { using type = T; };
template <> struct AccOf<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ double load_acc(const double* p) { return *p; }
__device__ __forceinline__ float load_acc(const float* p) { return *p; }
__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// read-only (non-coherent) path
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
// c + alpha * x, one rounding: every C update of K1 (per span and fused)
// takes this form, so that a fused bin is bit for bit its spans' launches
__device__ __forceinline__ double fmadd(double alpha, double x, double c) {
  return fma(alpha, x, c);
}
__device__ __forceinline__ float fmadd(float alpha, float x, float c) {
  return fmaf(alpha, x, c);
}
// v rounded to the storage type T and read back, as a store and a load
__device__ __forceinline__ float round_as(const float*, float v) { return v; }
__device__ __forceinline__ double round_as(const double*, double v) { return v; }
__device__ __forceinline__ float round_as(const __nv_bfloat16*, float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ---------------------------------------------------------------- layout

// x rounded up to = 4 (mod 8): the row stride of the C block, through
// which the sum is written out
__host__ __device__ constexpr int pad_stride(int x) { return (x + 3) / 8 * 8 + 4; }

__host__ __device__ constexpr int round_up(int x, int q) { return (x + q - 1) / q * q; }

// Shared memory of one warp, in elements of the staged type S (q = 16 /
// sizeof(S) elements make 16 bytes).  Each entry slot holds the A block
// and the B block flat, as they lie in device memory, each in an area that
// begins on 16 bytes; a block starts at the offset within its area that
// its source address has within 16 bytes, so that it copies in 16-byte
// pieces.  The areas have room for the reads past a block's end that
// the padded tiles make (they touch only padded outputs or are zeroed).
struct WarpGeom {
  int mt, nt;      // 8-row and 8-column tiles of the padded block
  int kp;          // k rounded up to a multiple of 4 (one DMMA k-step)
  int sb;          // row stride of the C block
  int a_area;      // one A area
  int slot;        // one entry: A area, then B area
  int stage;       // one step buffer: r slots
  int buf;         // one step buffer, large enough for the C block too
  int offs;        // start of the slots' block offsets (2 ints a slot, 2r slots)
  int planes;      // start of the register tile's converted planes
  int per_warp;    // two step buffers, the offsets and the planes
};

// z: reals an element holds (2 for complex, staged as its interleaved
// parts); plane_bytes: the converted planes of a demoted tile
__host__ __device__ inline WarpGeom warp_geom(int m, int n, int k, int r, int size,
                                              int z = 1, int plane_bytes = 0) {
  const int q = 16 / size;
  WarpGeom g;
  g.mt = (m + 7) / 8;
  g.nt = (n + 7) / 8;
  g.kp = (k + 3) / 4 * 4;
  g.sb = pad_stride(8 * g.nt);
  g.a_area = round_up(z * (8 * g.mt * k + g.kp) + q, q);
  g.slot = g.a_area + round_up(z * (g.kp * n + 8 * g.nt) + q, q);
  g.stage = r * g.slot;
  g.buf = g.stage > z * 8 * g.mt * g.sb ? g.stage : z * 8 * g.mt * g.sb;
  g.offs = 2 * g.buf;
  g.planes = g.offs + round_up(4 * r * 4 / size, q);
  g.per_warp = g.planes + round_up(plane_bytes, 16) / size;
  return g;
}

// the register tiling a shape is compiled for: max(mt, nt), at least 2
inline int warp_class(int m, int n) {
  const int t = (m > n ? m : n) + 7;
  return t / 8 < 2 ? 2 : t / 8;
}

inline bool warp_dims(int m, int n, int k) {
  return m >= 1 && n >= 1 && k >= 1 && m <= WARP_MAX_DIM && n <= WARP_MAX_DIM &&
         k <= WARP_MAX_DIM;
}

// ------------------------------------------------------------- staging

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
template <int BYTES>
__device__ __forceinline__ void cp_async(void* d, const void* s) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(d)),
               "l"(s), "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage `count` contiguous elements at src into the area; returns the
// offset (elements) of the block in its area.  f64/f32: asynchronously,
// 16 bytes a lane from the first 16-byte boundary of src, single elements
// before it and after the last whole piece.
template <typename S>
__device__ __forceinline__ int stage_flat(S* area, const S* src, int count, int lane) {
  constexpr int q = 16 / sizeof(S);
  const int off = (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(S));
  S* dst = area + off;
  const int head = min(count, (q - off) & (q - 1));
  if (lane < head) cp_async<sizeof(S)>(dst + lane, src + lane);
  const int pieces = (count - head) / q;
  for (int i = lane; i < pieces; i += 32)
    cp_async<16>(dst + head + i * q, src + head + i * q);
  const int tail = head + pieces * q + lane;
  if (tail < count) cp_async<sizeof(S)>(dst + tail, src + tail);
  return off;
}
// bf16: converted to f32 as it is staged, by plain loads (cp.async copies
// at least 4 bytes and cannot convert)
__device__ __forceinline__ int stage_flat(float* area, const __nv_bfloat16* src,
                                          int count, int lane) {
  for (int w = lane; w < count; w += 32) area[w] = load_ro(src + w);
  return 0;
}

// a lane's walk over a row-major block of `cols` columns: start (r0, c0)
// = divmod(start, cols), step divmod(step, cols) (32 elements at a time
// from the lane's own by default)
struct FlatIter {
  int r0, c0, q, rem;
};
__device__ __forceinline__ FlatIter flat_iter(int cols, int start, int step = 32) {
  return {start / cols, start % cols, step / cols, step % cols};
}

// Convert the row-major rows x cols block at src (flat, as staged) into
// dst, row stride ld, or transposed (TRANS: column c of src is row c of
// dst, stride ld): each element once, f(x) its converted value.
template <bool TRANS, typename D, typename Src, typename F>
__device__ __forceinline__ void convert_block(D* dst, int ld, const Src* src, int rows,
                                              int cols, int lane, F f) {
  const FlatIter it = flat_iter(cols, lane);
  int r = it.r0, c = it.c0;
  for (int w = lane; w < rows * cols; w += 32) {
    dst[TRANS ? c * ld + r : r * ld + c] = f(src[w]);
    c += it.rem;
    r += it.q;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// ------------------------------------------------------ block products
//
// A register tile sums one run's products.  warp_kernel calls, per run,
// zero(), then entry() once per entry as its slot lands (the A and B
// blocks flat, as staged), then store() to put the sum in shared memory.
// A tile that converts its operands owns `plane_bytes(m, n, k)` of the
// warp's shared memory (`planes`), set up once per launch by init().
// PREFETCH_C: whether the run's C block also fits in registers.

__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

template <typename S, int MAXT> struct Tile;

// f64: DMMA.  Fragments of m8n8k4 (g = lane/4, t = lane%4): A(g, t),
// B(t, g), C(g, 2t) and C(g, 2t+1).  A and B are read flat (row strides
// k and n); the k padding is zeroed by predicate.
template <int MAXT> struct Tile<double, MAXT> {
  double v[MAXT][MAXT][2];
  static constexpr bool PREFETCH_C = true;

  __host__ __device__ static int plane_bytes(int, int, int) { return 0; }
  __device__ static void init(unsigned char*, int, int, int, int) {}

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MAXT; ++i)
#pragma unroll
      for (int j = 0; j < MAXT; ++j) v[i][j][0] = v[i][j][1] = 0.0;
  }

  // FULL: the block fills the register tile (mt = nt = MAXT), so no
  // product needs a predicate (the fused launch takes it; the sums are
  // the same either way)
  template <bool FULL = false>
  __device__ __forceinline__ void mma(const double* as, const double* bs,
                                      const WarpGeom& g, int n, int k, int lane) {
    const int gr = lane >> 2, t = lane & 3;
    const double* ap = as + gr * k + t;
    const double* bp = bs + t * n + gr;
    constexpr int UNROLL = MAXT < 4 ? 2 : 1;  // 32x32 blocks: no registers to spare
#pragma unroll UNROLL
    for (int kk = 0; kk < g.kp; kk += 4) {
      const bool kin = kk + t < k;
      double af[MAXT], bf[MAXT];
#pragma unroll
      for (int i = 0; i < MAXT; ++i) af[i] = (FULL || i < g.mt) && kin ? ap[8 * i * k + kk] : 0.0;
#pragma unroll
      for (int j = 0; j < MAXT; ++j) bf[j] = (FULL || j < g.nt) && kin ? bp[kk * n + 8 * j] : 0.0;
#pragma unroll
      for (int i = 0; i < MAXT; ++i)
#pragma unroll
        for (int j = 0; j < MAXT; ++j)
          if (FULL || (i < g.mt && j < g.nt)) dmma(v[i][j], af[i], bf[j]);
    }
  }

  __device__ __forceinline__ void entry(double* as, double* bs, const WarpGeom& g, int,
                                        int n, int k, int lane, unsigned char*) {
    mma(as, bs, g, n, k, lane);
  }

  // cs = the sum, over the valid elements
  __device__ __forceinline__ void store(double* cs, const WarpGeom& g, int m,
                                        int n, int lane) const {
    const int gr = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MAXT; ++i)
#pragma unroll
      for (int j = 0; j < MAXT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = gr + 8 * i, c = 8 * j + 2 * t + h;
          if (i < g.mt && j < g.nt && r < m && c < n) cs[r * g.sb + c] = v[i][j][h];
        }
  }
};

// cs = a micro-tile sum (the f32 lane layout below: rows lane/4 + 8i,
// columns (lane%4)*2nt + j), over the valid elements
template <typename S, typename V, int MAXT>
__device__ __forceinline__ void store_micro(S* cs, const V (&v)[MAXT][2 * MAXT],
                                            const WarpGeom& g, int m, int n, int lane) {
  const int tn = 2 * g.nt, r0 = lane >> 2, c0 = (lane & 3) * tn;
#pragma unroll
  for (int i = 0; i < MAXT; ++i)
#pragma unroll
    for (int j = 0; j < 2 * MAXT; ++j) {
      const int r = r0 + 8 * i, c = c0 + j;
      if (i < g.mt && j < tn && r < m && c < n) cs[r * g.sb + c] = v[i][j];
    }
}

// f32 (and bf16 staged as f32): FMAs on the CUDA cores; the lane owns
// rows lane/4 + 8i (i < mt) and columns (lane%4)*2nt .. +2nt.  A read
// past row m-1 or B past column n-1 touches only padded outputs.
template <int MAXT> struct Tile<float, MAXT> {
  float v[MAXT][2 * MAXT];
  static constexpr bool PREFETCH_C = true;

  __host__ __device__ static int plane_bytes(int, int, int) { return 0; }
  __device__ static void init(unsigned char*, int, int, int, int) {}

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MAXT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * MAXT; ++j) v[i][j] = 0.0f;
  }

  template <bool FULL = false>  // as Tile<double>'s
  __device__ __forceinline__ void mma(const float* as, const float* bs,
                                      const WarpGeom& g, int n, int k, int lane) {
    const int tn = 2 * g.nt;
    const float* ap = as + (lane >> 2) * k;
    const float* bp = bs + (lane & 3) * tn;
#pragma unroll 2
    for (int kk = 0; kk < k; ++kk) {
      float af[MAXT], bf[2 * MAXT];
#pragma unroll
      for (int i = 0; i < MAXT; ++i) af[i] = FULL || i < g.mt ? ap[8 * i * k + kk] : 0.0f;
#pragma unroll
      for (int j = 0; j < 2 * MAXT; ++j) bf[j] = FULL || j < tn ? bp[kk * n + j] : 0.0f;
#pragma unroll
      for (int i = 0; i < MAXT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * MAXT; ++j)
          if (FULL || (i < g.mt && j < tn)) v[i][j] = fmaf(af[i], bf[j], v[i][j]);
    }
  }

  __device__ __forceinline__ void entry(float* as, float* bs, const WarpGeom& g, int,
                                        int n, int k, int lane, unsigned char*) {
    mma(as, bs, g, n, k, lane);
  }

  __device__ __forceinline__ void store(float* cs, const WarpGeom& g, int m,
                                        int n, int lane) const {
    store_micro(cs, v, g, m, n, lane);
  }
};

// ------------------------------------------------------- complex forms
// The operands are staged as they lie, real and imaginary parts
// interleaved; a fragment reads both parts of an element in one load.
template <typename R, int MAXT> struct CTile;

// c8: DMMA.  Per 4-deep k-step each 8x8 tile of the real sum takes
// Ar.Br and then (-Ai).Bi, the imaginary one Ar.Bi and then Ai.Br: 4
// DMMAs, each element summing its entries in stack order.
template <int MAXT> struct CTile<double, MAXT> {
  double re[MAXT][MAXT][2], im[MAXT][MAXT][2];
  static constexpr bool PREFETCH_C = false;  // two tiles leave no room

  __host__ __device__ static int plane_bytes(int, int, int) { return 0; }
  __device__ static void init(unsigned char*, int, int, int, int) {}

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MAXT; ++i)
#pragma unroll
      for (int j = 0; j < MAXT; ++j) re[i][j][0] = re[i][j][1] = im[i][j][0] = im[i][j][1] = 0.0;
  }

  __device__ __forceinline__ void entry(double* as, double* bs, const WarpGeom& g, int,
                                        int n, int k, int lane, unsigned char*) {
    const int gr = lane >> 2, t = lane & 3;
    const double2* ap = reinterpret_cast<const double2*>(as) + gr * k + t;
    const double2* bp = reinterpret_cast<const double2*>(bs) + t * n + gr;
#pragma unroll 1
    for (int kk = 0; kk < g.kp; kk += 4) {
      const bool kin = kk + t < k;
      double2 af[MAXT], bf[MAXT];
#pragma unroll
      for (int i = 0; i < MAXT; ++i)
        af[i] = i < g.mt && kin ? ap[8 * i * k + kk] : make_double2(0.0, 0.0);
#pragma unroll
      for (int j = 0; j < MAXT; ++j)
        bf[j] = j < g.nt && kin ? bp[kk * n + 8 * j] : make_double2(0.0, 0.0);
#pragma unroll
      for (int i = 0; i < MAXT; ++i) {
        const double nai = -af[i].y;
#pragma unroll
        for (int j = 0; j < MAXT; ++j)
          if (i < g.mt && j < g.nt) {
            dmma(re[i][j], af[i].x, bf[j].x);
            dmma(re[i][j], nai, bf[j].y);
            dmma(im[i][j], af[i].x, bf[j].y);
            dmma(im[i][j], af[i].y, bf[j].x);
          }
      }
    }
  }

  // cs = the sum, interleaved, over the valid elements
  __device__ __forceinline__ void store(double* cs, const WarpGeom& g, int m, int n,
                                        int lane) const {
    const int gr = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MAXT; ++i)
#pragma unroll
      for (int j = 0; j < MAXT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = gr + 8 * i, c = 8 * j + 2 * t + h;
          if (i < g.mt && j < g.nt && r < m && c < n) {
            cs[2 * (r * g.sb + c)] = re[i][j][h];
            cs[2 * (r * g.sb + c) + 1] = im[i][j][h];
          }
        }
  }
};

// c4: FMAs on the CUDA cores in Tile<float>'s lane layout, 4 a
// multiply-add in c8's order (the tiled path's CFTile keeps it), never
// TF32.
template <int MAXT> struct CTile<float, MAXT> {
  float re[MAXT][2 * MAXT], im[MAXT][2 * MAXT];
  static constexpr bool PREFETCH_C = MAXT < 4;

  __host__ __device__ static int plane_bytes(int, int, int) { return 0; }
  __device__ static void init(unsigned char*, int, int, int, int) {}

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MAXT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * MAXT; ++j) re[i][j] = im[i][j] = 0.0f;
  }

  __device__ __forceinline__ void entry(float* as, float* bs, const WarpGeom& g, int, int n,
                                        int k, int lane, unsigned char*) {
    const int tn = 2 * g.nt;
    const float2* ap = reinterpret_cast<const float2*>(as) + (lane >> 2) * k;
    const float2* bp = reinterpret_cast<const float2*>(bs) + (lane & 3) * tn;
#pragma unroll 1
    for (int kk = 0; kk < k; ++kk) {
      float2 af[MAXT], bf[2 * MAXT];
#pragma unroll
      for (int i = 0; i < MAXT; ++i)
        af[i] = i < g.mt ? ap[8 * i * k + kk] : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int j = 0; j < 2 * MAXT; ++j)
        bf[j] = j < tn ? bp[kk * n + j] : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < MAXT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * MAXT; ++j)
          if (i < g.mt && j < tn) {
            re[i][j] = fmaf(af[i].x, bf[j].x, re[i][j]);
            re[i][j] = fmaf(-af[i].y, bf[j].y, re[i][j]);
            im[i][j] = fmaf(af[i].x, bf[j].y, im[i][j]);
            im[i][j] = fmaf(af[i].y, bf[j].x, im[i][j]);
          }
    }
  }

  __device__ __forceinline__ void store(float* cs, const WarpGeom& g, int m, int n,
                                        int lane) const {
    const int tn = 2 * g.nt, r0 = lane >> 2, c0 = (lane & 3) * tn;
#pragma unroll
    for (int i = 0; i < MAXT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * MAXT; ++j) {
        const int r = r0 + 8 * i, c = c0 + j;
        if (i < g.mt && j < tn && r < m && c < n) {
          cs[2 * (r * g.sb + c)] = re[i][j];
          cs[2 * (r * g.sb + c) + 1] = im[i][j];
        }
      }
  }
};

// ------------------------------------------------------- demoted forms
// Demoted compute: CT 0 = f32, 1 = bf16.  A staged value is converted
// once, as its entry lands; bf16 rounds through f32, as torch's
// conversion does.
template <int CT>
__device__ __forceinline__ float to_compute(double x) {
  const float f = static_cast<float>(x);
  return CT == 0 ? f : __bfloat162float(__float2bfloat16(f));
}
template <int CT>
__device__ __forceinline__ float to_compute(float x) {
  return CT == 0 ? x : __bfloat162float(__float2bfloat16(x));
}

// hi = compute(x), lo = compute(x - hi), both held in the wide type W
template <int CT, typename W>
__device__ __forceinline__ void split_hi_lo(W x, W& hi, W& lo) {
  hi = static_cast<W>(to_compute<CT>(x));
  lo = static_cast<W>(to_compute<CT>(x - hi));
}

__device__ __forceinline__ float f4_at(const float4& x, int s) {
  return s == 0 ? x.x : s == 1 ? x.y : s == 2 ? x.z : x.w;
}

// f64 -> f32, uncompensated: the operands converted into f32 planes, A
// with rows of KA = 4 (mod 8) floats (a lane's 4-deep A read is one
// conflict-free 16-byte load), B with rows of 8 nt floats, the k and
// row padding zero; each entry's k-sum in f32 on the CUDA cores in
// Tile<float>'s lane layout, then widened into the run's f64 sum.
template <int MAXT> struct F32Tile {
  double v[MAXT][2 * MAXT];
  static constexpr bool PREFETCH_C = MAXT < 4;

  __host__ __device__ static int ka(int k) {
    const int k4 = round_up(k, 4);
    return k4 % 8 ? k4 : k4 + 4;
  }
  __host__ __device__ static int plane_bytes(int m, int n, int k) {
    return 4 * round_up(8 * ((m + 7) / 8) * ka(k) + round_up(k, 4) * 8 * ((n + 7) / 8), 4);
  }
  __device__ static void init(unsigned char* planes, int m, int n, int k, int lane) {
    float* p = reinterpret_cast<float*>(planes);
    for (int w = lane; w < plane_bytes(m, n, k) / 4; w += 32) p[w] = 0.0f;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MAXT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * MAXT; ++j) v[i][j] = 0.0;
  }

  __device__ __forceinline__ void entry(double* as, double* bs, const WarpGeom& g, int m,
                                        int n, int k, int lane, unsigned char* planes) {
    const int KA = ka(k), NB = 8 * g.nt, k4 = round_up(k, 4), tn = 2 * g.nt;
    float* const pa = reinterpret_cast<float*>(planes);
    float* const pb = pa + 8 * g.mt * KA;
    auto cvt = [](double x) { return static_cast<float>(x); };
    __syncwarp();  // the planes' last readers are done
    convert_block<false>(pa, KA, as, m, k, lane, cvt);
    convert_block<false>(pb, NB, bs, k, n, lane, cvt);
    __syncwarp();
    float p[MAXT][2 * MAXT];
#pragma unroll
    for (int i = 0; i < MAXT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * MAXT; ++j) p[i][j] = 0.0f;
    const float* ap = pa + (lane >> 2) * KA;
    const float* bp = pb + (lane & 3) * tn;
#pragma unroll 1
    for (int kk = 0; kk < k4; kk += 4) {
      float4 a4[MAXT];
#pragma unroll
      for (int i = 0; i < MAXT; ++i)
        a4[i] = i < g.mt ? *reinterpret_cast<const float4*>(ap + 8 * i * KA + kk)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float bf[2 * MAXT];
#pragma unroll
        for (int j = 0; j < MAXT; ++j) {
          const float2 x = j < g.nt ? *reinterpret_cast<const float2*>(bp + (kk + s) * NB + 2 * j)
                                    : make_float2(0.0f, 0.0f);
          bf[2 * j] = x.x;
          bf[2 * j + 1] = x.y;
        }
#pragma unroll
        for (int i = 0; i < MAXT; ++i)
#pragma unroll
          for (int j = 0; j < 2 * MAXT; ++j)
            if (i < g.mt && j < tn) p[i][j] = fmaf(f4_at(a4[i], s), bf[j], p[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < MAXT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * MAXT; ++j) v[i][j] += static_cast<double>(p[i][j]);
  }

  __device__ __forceinline__ void store(double* cs, const WarpGeom& g, int m, int n,
                                        int lane) const {
    store_micro(cs, v, g, m, n, lane);
  }
};

__device__ __forceinline__ void bf16_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -> bf16 on the tensor cores (mma.sync m16n8k16, bf16 in, f32 out):
// the operands converted into bf16 planes, A row-major and B transposed
// (n rows of k), rows of KS = k rounded up to 16, plus 8 (conflict-free
// 4-byte fragment loads), the padding zero.  Fragments (g = lane/4,
// t = lane%4): A rows g and g+8 at columns 2t, 2t+1 and 2t+8, 2t+9; B
// column g at the same depths; C rows g, g+8 at columns 2t, 2t+1.  W is
// the run's sum, f64 for f64 data and f32 for f32 data, held in the
// fragments' layout.  Each entry's k-sum runs in a fresh f32 fragment
// (compensated, f32 data only: hi.hi, hi.lo and lo.hi of the splits;
// f64 data takes CompTile) and is then added into the sum by an f32 or
// f64 add.  The tensor cores' f32 sums truncate: a 5000-entry run summed
// in the fragment itself missed `form_tolerance` by 9x on the H100
// (7.6e-4 against 8.3e-5); an entry's 3k products do not.
template <typename W, int MAXT, bool COMP> struct BfTile {
  static constexpr int MT = (MAXT + 1) / 2;  // 16-row tiles
  W v[MT][MAXT][4];
  static constexpr bool PREFETCH_C = MAXT < 4 || sizeof(W) == 4;

  __host__ __device__ static int ks(int k) { return round_up(k, 16) + 8; }
  __host__ __device__ static int plane_bytes(int m, int n, int k) {
    return round_up(2 * ks(k) * (16 * ((m + 15) / 16) + 8 * ((n + 7) / 8)) * (COMP ? 2 : 1), 16);
  }
  __device__ static void init(unsigned char* planes, int m, int n, int k, int lane) {
    uint32_t* p = reinterpret_cast<uint32_t*>(planes);
    for (int w = lane; w < plane_bytes(m, n, k) / 4; w += 32) p[w] = 0u;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MAXT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[i][j][q] = W(0);
  }

  __device__ __forceinline__ void entry(W* as, W* bs, const WarpGeom& g, int m, int n, int k,
                                        int lane, unsigned char* planes) {
    const int KS = ks(k), mt16 = (m + 15) / 16;
    __nv_bfloat16* const pa = reinterpret_cast<__nv_bfloat16*>(planes);
    __nv_bfloat16* const pb = pa + 16 * mt16 * KS;
    __nv_bfloat16* const pal = pb + 8 * g.nt * KS;
    __nv_bfloat16* const pbl = pal + 16 * mt16 * KS;
    auto hi = [](W x) { return __float2bfloat16(static_cast<float>(x)); };
    auto lo = [](W x) {
      return __float2bfloat16(static_cast<float>(
          x - static_cast<W>(__bfloat162float(__float2bfloat16(static_cast<float>(x))))));
    };
    __syncwarp();  // the planes' last readers are done
    convert_block<false>(pa, KS, as, m, k, lane, hi);
    convert_block<true>(pb, KS, bs, k, n, lane, hi);
    if (COMP) {
      convert_block<false>(pal, KS, as, m, k, lane, lo);
      convert_block<true>(pbl, KS, bs, k, n, lane, lo);
    }
    __syncwarp();
    const int gr = lane >> 2, t = lane & 3;
    float p[MT][MAXT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MAXT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) p[i][j][q] = 0.0f;
    auto frag_a = [&](const __nv_bfloat16* base, int i, int kc, uint32_t (&f)[4]) {
      const __nv_bfloat16* x = base + (16 * i + gr) * KS + kc + 2 * t;
      f[0] = *reinterpret_cast<const uint32_t*>(x);
      f[1] = *reinterpret_cast<const uint32_t*>(x + 8 * KS);
      f[2] = *reinterpret_cast<const uint32_t*>(x + 8);
      f[3] = *reinterpret_cast<const uint32_t*>(x + 8 * KS + 8);
    };
#pragma unroll 1
    for (int kc = 0; kc < KS - 8; kc += 16) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if (i < mt16) {
          frag_a(pa, i, kc, ah[i]);
          if (COMP) frag_a(pal, i, kc, al[i]);
        }
#pragma unroll
      for (int j = 0; j < MAXT; ++j)
        if (j < g.nt) {
          const __nv_bfloat16* x = pb + (8 * j + gr) * KS + kc + 2 * t;
          const uint32_t bh0 = *reinterpret_cast<const uint32_t*>(x);
          const uint32_t bh1 = *reinterpret_cast<const uint32_t*>(x + 8);
          uint32_t bl0 = 0u, bl1 = 0u;
          if (COMP) {
            const __nv_bfloat16* y = pbl + (8 * j + gr) * KS + kc + 2 * t;
            bl0 = *reinterpret_cast<const uint32_t*>(y);
            bl1 = *reinterpret_cast<const uint32_t*>(y + 8);
          }
#pragma unroll
          for (int i = 0; i < MT; ++i)
            if (i < mt16) {
              bf16_mma(p[i][j], ah[i], bh0, bh1);
              if (COMP) {
                bf16_mma(p[i][j], ah[i], bl0, bl1);
                bf16_mma(p[i][j], al[i], bh0, bh1);
              }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MAXT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[i][j][q] += static_cast<W>(p[i][j][q]);
  }

  __device__ __forceinline__ void store(W* cs, const WarpGeom& g, int m, int n,
                                        int lane) const {
    const int gr = lane >> 2, t = lane & 3, mt16 = (m + 15) / 16;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MAXT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 16 * i + gr + 8 * (q >> 1), c = 8 * j + 2 * t + (q & 1);
          if (i < mt16 && j < g.nt && r < m && c < n) cs[r * g.sb + c] = v[i][j][q];
        }
  }
};

// f64 data, compensated (f32c, bf16c): the parts' products are exact in
// f64, so the form is one DMMA product of depth 3k, [Ah | Ah | Al] .
// [Bh ; Bl ; Bh], each entry summed straight into the run's f64 sum.  As
// a slot lands its values are split once: hi replaces the value in the
// slot, lo goes to a plane laid out as the slot's blocks.
template <int MAXT, int CT> struct CompTile {
  Tile<double, MAXT> t;
  static constexpr bool PREFETCH_C = MAXT < 4;

  __host__ __device__ static int lo_a(int m, int k) {
    return round_up(8 * ((m + 7) / 8) * k + round_up(k, 4), 2);
  }
  __host__ __device__ static int plane_bytes(int m, int n, int k) {
    return 8 * (lo_a(m, k) + round_up(k, 4) * n + 8 * ((n + 7) / 8));
  }
  __device__ static void init(unsigned char*, int, int, int, int) {}

  __device__ __forceinline__ void zero() { t.zero(); }

  __device__ __forceinline__ void entry(double* as, double* bs, const WarpGeom& g, int m,
                                        int n, int k, int lane, unsigned char* planes) {
    double* const al = reinterpret_cast<double*>(planes);
    double* const bl = al + lo_a(m, k);
    __syncwarp();  // the planes' last readers are done
#pragma unroll 4
    for (int w = lane; w < m * k; w += 32) split_hi_lo<CT>(as[w], as[w], al[w]);
#pragma unroll 4
    for (int w = lane; w < k * n; w += 32) split_hi_lo<CT>(bs[w], bs[w], bl[w]);
    __syncwarp();
    // per 4-deep k-step: hi.hi, then hi.lo, then lo.hi of every tile (a
    // sum's DMMAs mt nt apart); A and B read flat, as Tile<double> reads them
    const int gr = lane >> 2, tq = lane & 3;
    const double *ahp = as + gr * k + tq, *alp = al + gr * k + tq;
    const double *bhp = bs + tq * n + gr, *blp = bl + tq * n + gr;
#pragma unroll 1
    for (int kk = 0; kk < g.kp; kk += 4) {
      const bool kin = kk + tq < k;
      double ah[MAXT], alo[MAXT], bh[MAXT], blo[MAXT];
#pragma unroll
      for (int i = 0; i < MAXT; ++i) {
        ah[i] = i < g.mt && kin ? ahp[8 * i * k + kk] : 0.0;
        alo[i] = i < g.mt && kin ? alp[8 * i * k + kk] : 0.0;
      }
#pragma unroll
      for (int j = 0; j < MAXT; ++j) {
        bh[j] = j < g.nt && kin ? bhp[kk * n + 8 * j] : 0.0;
        blo[j] = j < g.nt && kin ? blp[kk * n + 8 * j] : 0.0;
      }
#pragma unroll
      for (int i = 0; i < MAXT; ++i)
#pragma unroll
        for (int j = 0; j < MAXT; ++j)
          if (i < g.mt && j < g.nt) dmma(t.v[i][j], ah[i], bh[j]);
#pragma unroll
      for (int i = 0; i < MAXT; ++i)
#pragma unroll
        for (int j = 0; j < MAXT; ++j)
          if (i < g.mt && j < g.nt) dmma(t.v[i][j], ah[i], blo[j]);
#pragma unroll
      for (int i = 0; i < MAXT; ++i)
#pragma unroll
        for (int j = 0; j < MAXT; ++j)
          if (i < g.mt && j < g.nt) dmma(t.v[i][j], alo[i], bh[j]);
    }
  }

  __device__ __forceinline__ void store(double* cs, const WarpGeom& g, int m, int n,
                                        int lane) const {
    t.store(cs, g, m, n, lane);
  }
};

// ------------------------------------------------------------ the runs

// Which run warp w of a block of nw warps takes as its i-th (-1: none,
// and none after it either).
// K1: groups of nw consecutive runs in stack (C) order, taken by the
// blocks grid-stride, so that all SMs sweep C's block rows together and
// share the rows' B blocks in L2 (one contiguous share of the groups per
// block measured about 40% slower)
struct ConsecutiveRuns {
  int nruns;
  __device__ int operator()(int i, int w, int nw) const {
    const int run = (blockIdx.x + i * gridDim.x) * nw + w;
    return run < nruns ? run : -1;
  }
};
// K3/K4: the P runs of one pack, as acc/crosspack.py dealt them; blocks
// take packs grid-stride
struct PackRuns {
  const int* pack_runs;
  int npacks;
  __device__ int operator()(int i, int w, int nw) const {
    const int pack = blockIdx.x + i * gridDim.x;
    return pack < npacks ? __ldg(pack_runs + (int64_t)pack * nw + w) : -1;
  }
};

// What a run is made of.  A segment: the entries e0..e1-1 of span sp's
// stack.  A run is a list of segments in order; the runs give each span's
// operand bins, operand indices and k.  SEGMENTS false: one segment a run,
// of one span (every stack launch); true: the merged runs of a fused C bin
// (smm_stack.cu's SegmentRuns).
struct Seg {
  int sp, e0, e1;
};

// the runs of one stack: one segment a run, one span
struct StackRuns {
  static constexpr bool SEGMENTS = false;
  const void *a_bin, *b_bin;
  const int *a_idx, *b_idx, *run_ptr, *run_c;
  int nruns, kk;
  __device__ __forceinline__ int cblk(int r) const { return __ldg(run_c + r); }
  __device__ __forceinline__ int segs_from(int r) const { return r; }
  __device__ __forceinline__ int segs_to(int r) const { return r + 1; }
  __device__ __forceinline__ Seg seg(int s) const {
    return {0, __ldg(run_ptr + s), __ldg(run_ptr + s + 1)};
  }
  __device__ __forceinline__ const void* a(int) const { return a_bin; }
  __device__ __forceinline__ const void* b(int) const { return b_bin; }
  __device__ __forceinline__ const int* ai(int) const { return a_idx; }
  __device__ __forceinline__ const int* bi(int) const { return b_idx; }
  __device__ __forceinline__ int k(int) const { return kk; }
};

// The body of a warp-path kernel: blockDim.x/32 warps, each walking the
// runs `run_of` gives it, r entries per step.  The walk is one pipeline
// across segments and runs: while a segment's last step multiplies, the
// next segment's first step is in flight, and the loads each segment
// needs first are issued one to three segments ahead (its run index, its
// segment and C block, its first 32 entry indices, its run's C block
// into registers), so that no load waits at the start of a segment.
// Each segment sums in the register tile, and at its end the C block
// becomes C + alpha * sum, rounded to T.  A fused bin's run (segments,
// one a span) keeps that C in registers until the run ends (f32 and bf16
// sums), or stores it and reads it again at the next segment's end from
// L2, where it was prefetched two segments ahead (f64: its registers are
// worth more as blocks in flight).  Either way each segment sums and
// rounds exactly as its span's launch does at that run's end, bit for
// bit.  With segments, k is the largest of the spans' depths (the slots'
// size) and a block that fills the register tile multiplies without a
// predicate a product (the sums are the same either way).
// Z = 2: complex data, T the real type, each element its two parts;
// alpha_im is then alpha's imaginary part.
template <typename T, int MAXT, typename RunOf, typename Runs,
          typename TileT = Tile<typename AccOf<T>::type, MAXT>, int Z = 1>
__device__ __forceinline__ void warp_kernel(
    const Runs& runs, T* __restrict__ c, int m, int n, int k, int r,
    typename AccOf<T>::type alpha, RunOf run_of, typename AccOf<T>::type alpha_im = 0) {
  using S = typename AccOf<T>::type;
  constexpr bool SEG = Runs::SEGMENTS;
  static_assert(!SEG || Z == 1, "segments take real data");
  constexpr int CPL = 2 * MAXT * MAXT;  // C elements of a lane: (8 MAXT)^2 / 32
  // the C block is read into registers as its run starts, unless the
  // register tile leaves no room for it (PREFETCH_C false: c8, and the
  // 32x32 class of c4 and of f64's demoted forms) or, with segments,
  // its sums are f64 (measured faster with C from L2 and more blocks an
  // SM); then it is read at each segment's end
  constexpr bool CPRE = TileT::PREFETCH_C && (!SEG || sizeof(S) == 4);
  constexpr int CREG = CPRE ? Z * CPL : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* sm = reinterpret_cast<S*>(smem_raw);
  const WarpGeom g = warp_geom(m, n, k, r, sizeof(S), Z, TileT::plane_bytes(m, n, k));
  // a segment's geometry at its span's depth (the slots are g's)
  auto geom_at = [&](int kk) { return SEG ? warp_geom(m, n, kk, r, sizeof(S)) : g; };
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const FlatIter itn = flat_iter(n, Z == 1 ? lane : lane >> 1, 32 / Z);
  const int mn = Z * m * n;  // in reals
  S* const wsm = sm + warp * g.per_warp;
  int* const offs = reinterpret_cast<int*>(wsm + g.offs);
  unsigned char* const planes = reinterpret_cast<unsigned char*>(wsm + g.planes);

  // where the walk stands: the warp's i-th run, its segment s of s0..s1-1
  struct Pos {
    int i, run, s0, s, s1;
  };
  auto pos_at = [&](int i) {
    Pos p{i, run_of(i, warp, nw), 0, 0, 0};
    if (p.run >= 0) {
      p.s0 = p.s = runs.segs_from(p.run);
      p.s1 = runs.segs_to(p.run);
    }
    return p;
  };
  auto next_pos = [&](const Pos& p) {
    if (SEG && p.run >= 0 && p.s + 1 < p.s1) return Pos{p.i, p.run, p.s0, p.s + 1, p.s1};
    return pos_at(p.i + 1);
  };
  // a segment: its entries, C block and span; whether it opens and
  // closes its run (len 0: none)
  struct Unit {
    int e0, len, cblk, sp;
    bool first, last;
  };
  auto unit_at = [&](const Pos& p) {
    Unit x{0, 0, 0, 0, true, true};
    if (p.run >= 0) {
      const Seg sg = runs.seg(p.s);
      x.e0 = sg.e0;
      x.len = sg.e1 - sg.e0;
      x.sp = sg.sp;
      x.cblk = runs.cblk(p.run);
      if (SEG) {
        x.first = p.s == p.s0;
        x.last = p.s + 1 == p.s1;
      }
    }
    return x;
  };
  // entry indices of segment x, entries 32*ch .. 32*ch+31, one per lane
  auto load_chunk = [&](const Unit& x, int ch, int& ai, int& bi) {
    const int e = (ch << 5) + lane;
    ai = e < x.len ? __ldg(runs.ai(x.sp) + x.e0 + e) : 0;
    bi = e < x.len ? __ldg(runs.bi(x.sp) + x.e0 + e) : 0;
  };
  // stage step s of segment x into step buffer buf; (chunk, ai, bi) hold
  // the segment's current 32 entry indices
  auto issue = [&](const Unit& x, int s, int buf, int& chunk, int& ai, int& bi) {
    const int kx = SEG ? runs.k(x.sp) : k;
    const int mk = Z * m * kx, kn = Z * kx * n, a_area = geom_at(kx).a_area;
    const T* const a = static_cast<const T*>(runs.a(x.sp));
    const T* const b = static_cast<const T*>(runs.b(x.sp));
    const int j0 = s * r, j1 = min(x.len, j0 + r);
    S* base = wsm + buf * g.buf;
    for (int j = j0; j < j1; ++j) {
      if ((j >> 5) != chunk) {
        chunk = j >> 5;
        load_chunk(x, chunk, ai, bi);
      }
      const int av = __shfl_sync(0xffffffffu, ai, j & 31);
      const int bv = __shfl_sync(0xffffffffu, bi, j & 31);
      S* slot = base + (j - j0) * g.slot;
      const int oa = stage_flat(slot, a + (int64_t)av * mk, mk, lane);
      const int ob = stage_flat(slot + a_area, b + (int64_t)bv * kn, kn, lane);
      if (lane == 0) {
        offs[2 * (buf * r + j - j0)] = oa;
        offs[2 * (buf * r + j - j0) + 1] = ob;
      }
    }
  };

  Pos p = pos_at(0);
  Unit cur = unit_at(p);
  if (cur.len <= 0) return;
  TileT::init(planes, m, n, k, lane);
  p = next_pos(p);
  Unit nx1 = unit_at(p);
  p = next_pos(p);
  Unit nx2 = unit_at(p);
  p = next_pos(p);  // the segment after nx2
  int chunk = 0, ai, bi, nchunk = 0, nai, nbi;
  load_chunk(cur, 0, ai, bi);
  load_chunk(nx1, 0, nai, nbi);
  int sc = 0;  // steps multiplied so far: step sc is in buffer sc & 1
  issue(cur, 0, 0, chunk, ai, bi);
  cp_async_commit();
  S creg[CREG];
  while (true) {
    // loads for later: this run's C block, the first indices of the
    // segment after next, the one after that, and its position's; with
    // segments (a fused bin's runs hold one or two entries) the C block
    // of the segment after next into L2 as well
    T* const cblk_p = c + (int64_t)cur.cblk * mn;
    if (CPRE && cur.first) {
#pragma unroll
      for (int i = 0; i < CREG; ++i) {
        const int w = lane + 32 * i;
        creg[i] = w < mn ? load_acc(cblk_p + w) : S(0);
      }
    }
    int n2ai, n2bi;
    load_chunk(nx2, 0, n2ai, n2bi);
    if (SEG && nx2.len > 0 && nx2.first) {
      const char* const c0 = reinterpret_cast<const char*>(c + (int64_t)nx2.cblk * mn);
      for (int off = 128 * lane - (int)(reinterpret_cast<uintptr_t>(c0) & 127);
           off < mn * (int)sizeof(T); off += 32 * 128)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(c0 + off));
    }
    const Unit nx3 = unit_at(p);
    const Pos p4 = next_pos(p);
    const int ku = SEG ? runs.k(cur.sp) : k;
    const WarpGeom gu = geom_at(ku);

    TileT acc;
    acc.zero();
    const int nsteps = (cur.len + r - 1) / r;
    for (int s = 0; s < nsteps; ++s, ++sc) {
      if (s + 1 < nsteps)
        issue(cur, s + 1, (sc + 1) & 1, chunk, ai, bi);
      else if (nx1.len > 0)
        issue(nx1, 0, (sc + 1) & 1, nchunk, nai, nbi);
      cp_async_commit();
      cp_async_wait<1>();  // every group but the newest: step sc has landed
      __syncwarp();
      const int bb = sc & 1;
      S* const buf = wsm + bb * g.buf;
      const int cnt = min(r, cur.len - s * r);
      for (int j = 0; j < cnt; ++j) {
        const int* o = offs + 2 * (bb * r + j);
        S* const as = buf + j * g.slot + o[0];
        S* const bs = buf + j * g.slot + gu.a_area + o[1];
        if constexpr (SEG) {
          if (gu.mt == MAXT && gu.nt == MAXT)
            acc.template mma<true>(as, bs, gu, n, ku, lane);
          else
            acc.mma(as, bs, gu, n, ku, lane);
        } else {
          acc.entry(as, bs, gu, m, n, ku, lane, planes);
        }
      }
      __syncwarp();  // the buffer is free for step sc + 2
    }

    // C = C + alpha * sum: the sum through shared memory (the buffer of
    // the step just multiplied), then coalesced, or left in registers
    // where the run goes on
    S* const cs = wsm + ((sc + 1) & 1) * g.buf;
    acc.store(cs, gu, m, n, lane);
    __syncwarp();
    int rr = itn.r0, cc = itn.c0;
#pragma unroll
    for (int i = 0; i < Z * CPL; ++i) {
      const int w = lane + 32 * i;
      if (w < mn) {
        const S cv = CPRE ? creg[CPRE ? i : 0] : load_acc(cblk_p + w);
        if constexpr (Z == 1) {
          const S cn = fmadd(alpha, cs[rr * g.sb + cc], cv);
          if (CPRE && !cur.last)  // the run goes on: C, as stored, stays
            creg[CPRE ? i : 0] = round_as(cblk_p, cn);
          else
            store_acc(cblk_p + w, cn);
        } else {  // the lane's part of element (rr, cc): real on even lanes
          const S sr = cs[2 * (rr * g.sb + cc)], si = cs[2 * (rr * g.sb + cc) + 1];
          store_acc(cblk_p + w, lane & 1 ? cv + (alpha * si + alpha_im * sr)
                                         : cv + (alpha * sr - alpha_im * si));
        }
      }
      cc += itn.rem;
      rr += itn.q;
      if (cc >= n) {
        cc -= n;
        ++rr;
      }
    }
    __syncwarp();  // the buffer is free for the next segment's second step

    if (nx1.len <= 0) break;
    cur = nx1;
    nx1 = nx2;
    nx2 = nx3;
    p = p4;
    chunk = nchunk;
    ai = nai;
    bi = nbi;
    nchunk = 0;
    nai = n2ai;
    nbi = n2bi;
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------ host side

// Opt the kernel into `smem` bytes of dynamic shared memory (above the
// default 48 KB) and size a persistent grid: as many blocks of `threads`
// as the card holds at once, at most `ngroups`.
template <typename K>
cudaError_t persistent_grid(K kernel, int threads, size_t smem, int ngroups,
                            int* grid) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, nsm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long cap = (long long)per_sm * nsm;
  *grid = (int)(ngroups < cap ? ngroups : cap);
  return cudaSuccess;
}

// Launch with an optional launch attribute (the resident launch's L2
// access-policy window); returns the launch's error.
template <typename... KArgs, typename... Args>
cudaError_t launch_kernel(void (*kernel)(KArgs...), int grid, int threads,
                          size_t smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = attr ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace smm
