// The warp path shared by the stack kernel (smm_stack.cu, K1) and the
// crosspack kernel (smm_crosspack.cu, K3 and K4): one warp computes one
// run, C[run_c] = C[run_c] + alpha * sum_{e in run} A[a_idx[e]] @ B[b_idx[e]],
// for blocks with m, n, k <= WARP_MAX_DIM.  The two kernels differ only
// in which runs the warps of a block take (`ConsecutiveRuns`, `PackRuns`).
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
// K1's demoted forms (acc/precision.py) take the f32 lane layout with
// `DemTile` in place of `Tile`: the staged operands stay at the request
// dtype and are rounded to the compute dtype (f32 or bf16) as they are
// read from shared memory.  Uncompensated, each entry's k-sum runs in
// f32 and is then added to the run's sum in the wide type (f64 for f64
// data); compensated, each operand splits into hi + lo in the compute
// dtype and hi*hi + (hi*lo + lo*hi) accumulates in the wide type
// (dbcsr_tpu/acc/smm.py:_batch_dot, :78-135).

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
  int per_warp;    // two step buffers and the offsets
};

__host__ __device__ inline WarpGeom warp_geom(int m, int n, int k, int r, int size) {
  const int q = 16 / size;
  WarpGeom g;
  g.mt = (m + 7) / 8;
  g.nt = (n + 7) / 8;
  g.kp = (k + 3) / 4 * 4;
  g.sb = pad_stride(8 * g.nt);
  g.a_area = round_up(8 * g.mt * k + g.kp + q, q);
  g.slot = g.a_area + round_up(g.kp * n + 8 * g.nt + q, q);
  g.stage = r * g.slot;
  g.buf = g.stage > 8 * g.mt * g.sb ? g.stage : 8 * g.mt * g.sb;
  g.offs = 2 * g.buf;
  g.per_warp = g.offs + round_up(4 * r * 4 / size, q);
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

// a lane's walk over a row-major block of `cols` columns, 32 elements at
// a time: start (r0, c0) = divmod(lane, cols), step divmod(32, cols)
struct FlatIter {
  int r0, c0, q, rem;
};
__device__ __forceinline__ FlatIter flat_iter(int cols, int lane) {
  return {lane / cols, lane % cols, 32 / cols, 32 % cols};
}

// ------------------------------------------------------ block products

template <typename S, int MAXT> struct Tile;

// f64: DMMA.  Fragments of m8n8k4 (g = lane/4, t = lane%4): A(g, t),
// B(t, g), C(g, 2t) and C(g, 2t+1).  A and B are read flat (row strides
// k and n); the k padding is zeroed by predicate.
template <int MAXT> struct Tile<double, MAXT> {
  double v[MAXT][MAXT][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MAXT; ++i)
#pragma unroll
      for (int j = 0; j < MAXT; ++j) v[i][j][0] = v[i][j][1] = 0.0;
  }

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
      for (int i = 0; i < MAXT; ++i) af[i] = i < g.mt && kin ? ap[8 * i * k + kk] : 0.0;
#pragma unroll
      for (int j = 0; j < MAXT; ++j) bf[j] = j < g.nt && kin ? bp[kk * n + 8 * j] : 0.0;
#pragma unroll
      for (int i = 0; i < MAXT; ++i)
#pragma unroll
        for (int j = 0; j < MAXT; ++j)
          if (i < g.mt && j < g.nt)
            asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
                "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
                : "+d"(v[i][j][0]), "+d"(v[i][j][1])
                : "d"(af[i]), "d"(bf[j]));
    }
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

// f32 (and bf16 staged as f32): FMAs on the CUDA cores; the lane owns
// rows lane/4 + 8i (i < mt) and columns (lane%4)*2nt .. +2nt.  A read
// past row m-1 or B past column n-1 touches only padded outputs.
template <int MAXT> struct Tile<float, MAXT> {
  float v[MAXT][2 * MAXT];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MAXT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * MAXT; ++j) v[i][j] = 0.0f;
  }

  __device__ __forceinline__ void mma(const float* as, const float* bs,
                                      const WarpGeom& g, int n, int k, int lane) {
    const int tn = 2 * g.nt;
    const float* ap = as + (lane >> 2) * k;
    const float* bp = bs + (lane & 3) * tn;
#pragma unroll 2
    for (int kk = 0; kk < k; ++kk) {
      float af[MAXT], bf[2 * MAXT];
#pragma unroll
      for (int i = 0; i < MAXT; ++i) af[i] = i < g.mt ? ap[8 * i * k + kk] : 0.0f;
#pragma unroll
      for (int j = 0; j < 2 * MAXT; ++j) bf[j] = j < tn ? bp[kk * n + j] : 0.0f;
#pragma unroll
      for (int i = 0; i < MAXT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * MAXT; ++j)
          if (i < g.mt && j < tn) v[i][j] = fmaf(af[i], bf[j], v[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* cs, const WarpGeom& g, int m,
                                        int n, int lane) const {
    const int tn = 2 * g.nt, r0 = lane >> 2, c0 = (lane & 3) * tn;
#pragma unroll
    for (int i = 0; i < MAXT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * MAXT; ++j) {
        const int r = r0 + 8 * i, c = c0 + j;
        if (i < g.mt && j < tn && r < m && c < n) cs[r * g.sb + c] = v[i][j];
      }
  }
};

// Demoted compute: CT 0 = f32, 1 = bf16; the compute value is held in
// f32, which represents both exactly (bf16 rounds through f32, as
// torch's conversion does).
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

// The demoted forms' register tile: the lane layout of Tile<float>, the
// run's sum in the staged (wide) type S.
template <typename S, int MAXT, int CT, bool COMP> struct DemTile {
  S v[MAXT][2 * MAXT];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MAXT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * MAXT; ++j) v[i][j] = S(0);
  }

  __device__ __forceinline__ void mma(const S* as, const S* bs, const WarpGeom& g, int n,
                                      int k, int lane) {
    const int tn = 2 * g.nt;
    const S* ap = as + (lane >> 2) * k;
    const S* bp = bs + (lane & 3) * tn;
    if (!COMP) {
      float p[MAXT][2 * MAXT];
#pragma unroll
      for (int i = 0; i < MAXT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * MAXT; ++j) p[i][j] = 0.0f;
      for (int kk = 0; kk < k; ++kk) {
        float af[MAXT], bf[2 * MAXT];
#pragma unroll
        for (int i = 0; i < MAXT; ++i) af[i] = i < g.mt ? to_compute<CT>(ap[8 * i * k + kk]) : 0.0f;
#pragma unroll
        for (int j = 0; j < 2 * MAXT; ++j) bf[j] = j < tn ? to_compute<CT>(bp[kk * n + j]) : 0.0f;
#pragma unroll
        for (int i = 0; i < MAXT; ++i)
#pragma unroll
          for (int j = 0; j < 2 * MAXT; ++j)
            if (i < g.mt && j < tn) p[i][j] = fmaf(af[i], bf[j], p[i][j]);
      }
#pragma unroll
      for (int i = 0; i < MAXT; ++i)
#pragma unroll
        for (int j = 0; j < 2 * MAXT; ++j) v[i][j] += static_cast<S>(p[i][j]);
    } else {
      for (int kk = 0; kk < k; ++kk) {
        S ah[MAXT], al[MAXT], bh[2 * MAXT], bl[2 * MAXT];
#pragma unroll
        for (int i = 0; i < MAXT; ++i) split_hi_lo<CT>(i < g.mt ? ap[8 * i * k + kk] : S(0), ah[i], al[i]);
#pragma unroll
        for (int j = 0; j < 2 * MAXT; ++j) split_hi_lo<CT>(j < tn ? bp[kk * n + j] : S(0), bh[j], bl[j]);
#pragma unroll
        for (int i = 0; i < MAXT; ++i)
#pragma unroll
          for (int j = 0; j < 2 * MAXT; ++j)
            if (i < g.mt && j < tn) v[i][j] += ah[i] * bh[j] + (ah[i] * bl[j] + al[i] * bh[j]);
      }
    }
  }

  __device__ __forceinline__ void store(S* cs, const WarpGeom& g, int m, int n, int lane) const {
    const int tn = 2 * g.nt, r0 = lane >> 2, c0 = (lane & 3) * tn;
#pragma unroll
    for (int i = 0; i < MAXT; ++i)
#pragma unroll
      for (int j = 0; j < 2 * MAXT; ++j) {
        const int r = r0 + 8 * i, c = c0 + j;
        if (i < g.mt && j < tn && r < m && c < n) cs[r * g.sb + c] = v[i][j];
      }
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

struct RunInfo {
  int e0, len, cblk;  // len 0: no run
};

// The body of a warp-path kernel: blockDim.x/32 warps, each walking the
// runs `run_of` gives it, r entries per step.  The walk is one pipeline
// across runs: while a run's last step multiplies, the next run's first
// step is in flight, and the loads each run needs first are issued a run
// or two ahead (its run index, its run_ptr/run_c, its first 32 entry
// indices, its C block into registers), so that no load waits at the
// start of a run.
template <typename T, int MAXT, typename RunOf,
          typename TileT = Tile<typename AccOf<T>::type, MAXT>>
__device__ __forceinline__ void warp_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
    const int* __restrict__ a_idx, const int* __restrict__ b_idx,
    const int* __restrict__ run_ptr, const int* __restrict__ run_c,
    int m, int n, int k, int r, typename AccOf<T>::type alpha,
    RunOf run_of) {
  using S = typename AccOf<T>::type;
  constexpr int CPL = 2 * MAXT * MAXT;  // C elements of a lane: (8 MAXT)^2 / 32
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* sm = reinterpret_cast<S*>(smem_raw);
  const WarpGeom g = warp_geom(m, n, k, r, sizeof(S));
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const FlatIter itn = flat_iter(n, lane);
  const int mk = m * k, kn = k * n, mn = m * n;
  S* const wsm = sm + warp * g.per_warp;
  int* const offs = reinterpret_cast<int*>(wsm + g.offs);
  auto run_at = [&](int i) { return run_of(i, warp, nw); };
  auto info_of = [&](int run) {
    RunInfo x{0, 0, 0};
    if (run >= 0) {
      x.e0 = __ldg(run_ptr + run);
      x.len = __ldg(run_ptr + run + 1) - x.e0;
      x.cblk = __ldg(run_c + run);
    }
    return x;
  };
  // entry indices of run x, entries 32*ch .. 32*ch+31, one per lane
  auto load_chunk = [&](const RunInfo& x, int ch, int& ai, int& bi) {
    const int e = (ch << 5) + lane;
    ai = e < x.len ? __ldg(a_idx + x.e0 + e) : 0;
    bi = e < x.len ? __ldg(b_idx + x.e0 + e) : 0;
  };
  // stage step s of run x into step buffer buf; (chunk, ai, bi) hold the
  // run's current 32 entry indices
  auto issue = [&](const RunInfo& x, int s, int buf, int& chunk, int& ai, int& bi) {
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
      const int ob = stage_flat(slot + g.a_area, b + (int64_t)bv * kn, kn, lane);
      if (lane == 0) {
        offs[2 * (buf * r + j - j0)] = oa;
        offs[2 * (buf * r + j - j0) + 1] = ob;
      }
    }
  };

  int nrun = 0;  // cur is the warp's nrun-th run
  RunInfo cur = info_of(run_at(0));
  if (cur.len <= 0) return;
  RunInfo nx1 = info_of(run_at(1));
  int r2 = run_at(2);
  int chunk = 0, ai, bi;
  load_chunk(cur, 0, ai, bi);
  int sc = 0;  // steps multiplied so far: step sc is in buffer sc & 1
  issue(cur, 0, 0, chunk, ai, bi);
  cp_async_commit();
  while (true) {
    // loads for later: this run's C block, the next run's first indices,
    // the info of the run after it, and the run index after that
    T* const cblk_p = c + (int64_t)cur.cblk * mn;
    S creg[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int w = lane + 32 * i;
      creg[i] = w < mn ? load_acc(cblk_p + w) : S(0);
    }
    int nchunk = 0, nai, nbi;
    load_chunk(nx1, 0, nai, nbi);
    const RunInfo nx2 = info_of(r2);
    const int r3 = run_at(nrun + 3);

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
      const S* buf = wsm + bb * g.buf;
      const int cnt = min(r, cur.len - s * r);
      for (int j = 0; j < cnt; ++j) {
        const int* o = offs + 2 * (bb * r + j);
        acc.mma(buf + j * g.slot + o[0], buf + j * g.slot + g.a_area + o[1], g, n, k, lane);
      }
      __syncwarp();  // the buffer is free for step sc + 2
    }

    // C = C + alpha * sum: the sum through shared memory (the buffer of
    // the step just multiplied), then coalesced
    S* const cs = wsm + ((sc + 1) & 1) * g.buf;
    acc.store(cs, g, m, n, lane);
    __syncwarp();
    int rr = itn.r0, cc = itn.c0;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int w = lane + 32 * i;
      if (w < mn) store_acc(cblk_p + w, creg[i] + alpha * cs[rr * g.sb + cc]);
      cc += itn.rem;
      rr += itn.q;
      if (cc >= n) {
        cc -= n;
        ++rr;
      }
    }
    __syncwarp();  // the buffer is free for the next run's second step

    if (nx1.len <= 0) break;
    cur = nx1;
    nx1 = nx2;
    r2 = r3;
    chunk = nchunk;
    ai = nai;
    bi = nbi;
    ++nrun;
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
