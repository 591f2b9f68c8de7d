// Host index engine of the multiply and the CSR conversion: the symbolic
// product, the stack sort and the COO fill, as C++ with OpenMP, called
// from Python through ctypes.
//
// Counterpart of dbcsr_tpu/native/index_engine.cpp (its three entry
// points and its version).  The
// reference does the same work in Fortran on the host: the CSR inner loops
// of dbcsr_mm_csr.F:178-357 and the stack binning of
// dbcsr_mm_accdrv.F:364-423.
//
// Built at first use by dbcsr_tpu_torch/native/__init__.py:
//   g++ -O3 -march=native -fopenmp -fPIC -shared index_engine.cpp -o lib.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Symbolic product expansion: every (i, k, j) multiply triple of A (CSR
// over block rows) and B (CSR over block rows), with the norm filter and
// the block-index limits applied on the fly, in the order of the NumPy
// path (mm/multiply.py:_candidates_numpy): row-major, then A entry, then
// B entry.
//
// Pass 1 (out_* == nullptr): returns the candidate count.
// Pass 2: fills out_i/out_j/out_a/out_b (capacity must hold the count of
// pass 1); returns the number written, or minus the count when it does
// not fit.
//
// Limits are inclusive block ranges; -1 leaves a side open.  sym_c != 0
// skips i > j (a symmetric C stores its upper triangle).  The norm filter
// is on when all three norm pointers are non-null: a candidate is kept
// when a_norms2[e] * b_norms2[f] >= row_eps2[i] (squared f32 norms and a
// squared eps per A row); a NaN product drops it, as in NumPy.
int64_t dbcsr_symbolic_product(
    const int64_t* a_row_ptr, int64_t a_nrows, const int32_t* a_cols,
    const int64_t* b_row_ptr, const int32_t* b_cols,
    const float* a_norms2, const float* b_norms2, const float* row_eps2,
    int32_t sym_c,
    int64_t fr, int64_t lr, int64_t fc, int64_t lc, int64_t fk, int64_t lk,
    int64_t capacity,
    int64_t* out_i, int64_t* out_j, int64_t* out_a, int64_t* out_b) {
  const bool counting = (out_i == nullptr);
  const bool use_eps = (a_norms2 && b_norms2 && row_eps2);

  // per-row output offsets, so rows run in parallel and still write in
  // the deterministic order above
  int64_t* row_counts = new int64_t[a_nrows + 1];
  row_counts[0] = 0;

#pragma omp parallel for schedule(dynamic, 16)
  for (int64_t i = 0; i < a_nrows; ++i) {
    if ((fr >= 0 && i < fr) || (lr >= 0 && i > lr)) {
      row_counts[i + 1] = 0;
      continue;
    }
    int64_t cnt = 0;
    const float eps2 = use_eps ? row_eps2[i] : 0.0f;
    for (int64_t e = a_row_ptr[i]; e < a_row_ptr[i + 1]; ++e) {
      const int32_t k = a_cols[e];
      if ((fk >= 0 && k < fk) || (lk >= 0 && k > lk)) continue;
      const float an2 = use_eps ? a_norms2[e] : 0.0f;
      for (int64_t f = b_row_ptr[k]; f < b_row_ptr[k + 1]; ++f) {
        const int32_t j = b_cols[f];
        if ((fc >= 0 && j < fc) || (lc >= 0 && j > lc)) continue;
        if (sym_c && i > j) continue;
        if (use_eps && !(an2 * b_norms2[f] >= eps2)) continue;
        ++cnt;
      }
    }
    row_counts[i + 1] = cnt;
  }
  for (int64_t i = 0; i < a_nrows; ++i) row_counts[i + 1] += row_counts[i];
  const int64_t total = row_counts[a_nrows];
  if (counting || total > capacity) {
    delete[] row_counts;
    return counting ? total : -total;
  }

#pragma omp parallel for schedule(dynamic, 16)
  for (int64_t i = 0; i < a_nrows; ++i) {
    if ((fr >= 0 && i < fr) || (lr >= 0 && i > lr)) continue;
    int64_t w = row_counts[i];
    const float eps2 = use_eps ? row_eps2[i] : 0.0f;
    for (int64_t e = a_row_ptr[i]; e < a_row_ptr[i + 1]; ++e) {
      const int32_t k = a_cols[e];
      if ((fk >= 0 && k < fk) || (lk >= 0 && k > lk)) continue;
      const float an2 = use_eps ? a_norms2[e] : 0.0f;
      for (int64_t f = b_row_ptr[k]; f < b_row_ptr[k + 1]; ++f) {
        const int32_t j = b_cols[f];
        if ((fc >= 0 && j < fc) || (lc >= 0 && j > lc)) continue;
        if (sym_c && i > j) continue;
        if (use_eps && !(an2 * b_norms2[f] >= eps2)) continue;
        out_i[w] = i;
        out_j[w] = j;
        out_a[w] = e;
        out_b[w] = f;
        ++w;
      }
    }
  }
  delete[] row_counts;
  return total;
}

namespace {

#ifdef _OPENMP
int thread_num() { return omp_get_thread_num(); }
int num_threads() { return omp_get_num_threads(); }
int max_threads() { return omp_get_max_threads(); }
#else
int thread_num() { return 0; }
int num_threads() { return 1; }
int max_threads() { return 1; }
#endif

// Order one group's entries (``ord``, ``len`` of them) by (C slot, A
// entry), on ``nt`` threads.  Each thread owns one contiguous range of
// C slots: it scans all the entries' slots, counts and then places the
// ones in its range (a counting sort, stable, so the entries of one C
// block keep their input order) into its part of the output, and orders
// each of its C blocks' entries by A entry.  A block takes few products
// and the expansion emits them with ascending A entries, so that last
// step is mostly one check.  A group whose slot range is far wider than
// its entry count takes a comparison sort instead.
void sort_group(int64_t* ord, int64_t len, const int32_t* c_slot,
                const int64_t* a_ent, int nt) {
  if (len < 2) return;
  nt = int(std::max<int64_t>(1, std::min<int64_t>(nt, len >> 14)));
  std::unique_ptr<int32_t[]> key(new int32_t[len]);
  int32_t smin = c_slot[ord[0]], smax = smin;
#pragma omp parallel for num_threads(nt) reduction(min : smin) reduction(max : smax)
  for (int64_t p = 0; p < len; ++p) {
    const int32_t s = c_slot[ord[p]];
    key[p] = s;
    smin = std::min(smin, s);
    smax = std::max(smax, s);
  }
  const int64_t range = int64_t(smax) - smin + 1;
  if (range > 4 * len + 1024) {
    std::stable_sort(ord, ord + len, [c_slot, a_ent](int64_t x, int64_t y) {
      if (c_slot[x] != c_slot[y]) return c_slot[x] < c_slot[y];
      return a_ent[x] < a_ent[y];
    });
    return;
  }
  std::unique_ptr<int64_t[]> tmp(new int64_t[len]), tmp_a(new int64_t[len]);
  std::vector<int64_t> base(nt + 1, 0);
#pragma omp parallel num_threads(nt)
  {
    const int t = thread_num(), T = num_threads();
    const int64_t s0 = range * t / T, s1 = range * (t + 1) / T;
    // end[s - s0]: after the counts, where slot s begins; after the
    // placement, where it ends (both relative to this thread's part)
    std::vector<int64_t> end(s1 - s0 + 1, 0);
    for (int64_t p = 0; p < len; ++p) {
      const int64_t s = key[p] - smin;
      if (s >= s0 && s < s1) ++end[s - s0 + 1];
    }
    for (int64_t i = 0; i < s1 - s0; ++i) end[i + 1] += end[i];
    base[t + 1] = end[s1 - s0];
#pragma omp barrier
#pragma omp single
    for (int u = 0; u < T; ++u) base[u + 1] += base[u];
    int64_t* val = tmp.get() + base[t];
    int64_t* ka = tmp_a.get() + base[t];
    for (int64_t p = 0; p < len; ++p) {
      const int64_t s = key[p] - smin;
      if (s >= s0 && s < s1) {
        const int64_t q = end[s - s0]++;
        val[q] = ord[p];
        ka[q] = a_ent[ord[p]];
      }
    }
    for (int64_t i = 0; i < s1 - s0; ++i) {
      const int64_t lo = i ? end[i - 1] : 0, n_s = end[i] - lo;
      int64_t *k = ka + lo, *v = val + lo;
      if (n_s < 2 || std::is_sorted(k, k + n_s)) continue;
      if (n_s <= 32) {  // insertion sort
        for (int64_t q = 1; q < n_s; ++q) {
          const int64_t kq = k[q], vq = v[q];
          int64_t r = q;
          for (; r > 0 && k[r - 1] > kq; --r) {
            k[r] = k[r - 1];
            v[r] = v[r - 1];
          }
          k[r] = kq;
          v[r] = vq;
        }
      } else {
        std::vector<std::pair<int64_t, int64_t>> kv(n_s);
        for (int64_t q = 0; q < n_s; ++q) kv[q] = {k[q], v[q]};
        std::sort(kv.begin(), kv.end());
        for (int64_t q = 0; q < n_s; ++q) v[q] = kv[q].second;
      }
    }
  }
  std::memcpy(ord, tmp.get(), len * sizeof(int64_t));
}

}  // namespace

// Stack order: a permutation sorting the entries by (group id, C slot,
// A entry) and the ngroups + 1 group boundaries, so the engine carves one
// stack per (C bin, A bin, B bin) group with a fixed accumulation order.
// A stable counting sort by group, then `sort_group` on each group.  No
// two entries tie on (C slot, A entry), so the order equals
// np.lexsort((a_ent, c_slot, group)).
void dbcsr_group_sort_stacks(
    int64_t n,
    const int64_t* group,   // group id per entry, in [0, ngroups)
    int64_t ngroups,
    const int32_t* c_slot,
    const int64_t* a_ent,
    int64_t* order,         // out: permutation (n)
    int64_t* bounds) {      // out: ngroups + 1 group boundaries
  // counting sort by group, each thread over one chunk of the entries
  const int nt = int(std::max<int64_t>(1, std::min<int64_t>(max_threads(), n >> 14)));
  std::vector<int64_t> pos(size_t(nt) * ngroups);  // pos[t * ngroups + g]
#pragma omp parallel num_threads(nt)
  {
    const int t = thread_num(), T = num_threads();
    const int64_t e0 = n * t / T, e1 = n * (t + 1) / T;
    std::vector<int64_t> c(ngroups, 0);
    for (int64_t e = e0; e < e1; ++e) ++c[group[e]];
    std::copy(c.begin(), c.end(), pos.begin() + size_t(t) * ngroups);
#pragma omp barrier
#pragma omp single
    {
      int64_t run = 0;
      for (int64_t g = 0; g < ngroups; ++g) {
        bounds[g] = run;
        for (int u = 0; u < T; ++u) {
          const int64_t v = pos[size_t(u) * ngroups + g];
          pos[size_t(u) * ngroups + g] = run;
          run += v;
        }
      }
      bounds[ngroups] = run;
    }
    std::copy(pos.begin() + size_t(t) * ngroups, pos.begin() + size_t(t + 1) * ngroups,
              c.begin());
    for (int64_t e = e0; e < e1; ++e) order[c[group[e]]++] = e;
  }

  // groups of at least 2^16 entries one after another, each on every
  // thread; the rest in parallel, one thread each
  const int64_t big = int64_t(1) << 16;
  for (int64_t g = 0; g < ngroups; ++g) {
    if (bounds[g + 1] - bounds[g] >= big)
      sort_group(order + bounds[g], bounds[g + 1] - bounds[g], c_slot, a_ent,
                 max_threads());
  }
#pragma omp parallel for schedule(dynamic)
  for (int64_t g = 0; g < ngroups; ++g) {
    if (bounds[g + 1] - bounds[g] < big)
      sort_group(order + bounds[g], bounds[g + 1] - bounds[g], c_slot, a_ent, 1);
  }
}

// Scatter element-COO values into contiguous per-block buffers: block b
// starts at blk_buf_offset[b] (in elements) of out and has blk_ncols[b]
// columns.  Used by ops/csr.py:matrix_from_csr, whose NumPy path is one
// fancy-indexed assignment.
void dbcsr_coo_fill_blocks(
    int64_t nnz,
    const int64_t* blk_of_entry,
    const int64_t* local_row, const int64_t* local_col,
    const char* values,            // nnz values of dtype_size bytes each
    int64_t dtype_size,            // 4, 8 or 16 bytes
    const int64_t* blk_buf_offset,
    const int64_t* blk_ncols,
    char* out) {
  // serial on purpose: duplicate (row, col) entries of a non-canonical
  // CSR input resolve deterministically, last one wins, as in NumPy
  for (int64_t e = 0; e < nnz; ++e) {
    const int64_t b = blk_of_entry[e];
    const int64_t pos = blk_buf_offset[b] + local_row[e] * blk_ncols[b] + local_col[e];
    std::memcpy(out + pos * dtype_size, values + e * dtype_size, dtype_size);
  }
}

int32_t dbcsr_native_version() { return 2; }

}  // extern "C"
