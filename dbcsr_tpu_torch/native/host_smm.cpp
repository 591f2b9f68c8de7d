// Native host-side batched small-matrix-multiply driver.
//
// A copy of the JAX package's dbcsr_tpu/native/host_smm.cpp: the
// reference's CPU stack path (`dbcsr_mm_hostdrv.F:90`, BLAS / libxsmm /
// the tuned SMM library of tools/build_libsmm).  It consumes the same
// sorted parameter stack the device kernels take (a_idx/b_idx/c_idx into
// the shape-binned block arrays) and accumulates C += alpha * A@B per
// entry on the host.  Entries are grouped into runs of equal C block
// (the stack is sorted by c), each run accumulates into an L1-resident
// scratch tile, and runs are independent, so the OpenMP loop needs no
// atomics.  It is the last link of the stack-driver failover chain for
// CPU tensors (`acc/smm.py`, mm_driver="host").
//
// Built into one library with index_engine.cpp (native/__init__.py).

#include <complex>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// One run of stack entries sharing a C block: accumulate into `acc`
// (zeroed by the caller), classic i/k/j order so the j loop vectorizes
// and the whole working set (A block + B block + acc tile) stays in L1
// for the small block sizes this library exists for (m,n,k <= ~100).
template <typename T>
inline void accumulate_entry(T* __restrict acc, const T* __restrict ab,
                             const T* __restrict bb, int64_t m, int64_t n,
                             int64_t k) {
  for (int64_t i = 0; i < m; ++i) {
    T* __restrict crow = acc + i * n;
    const T* __restrict arow = ab + i * k;
    for (int64_t kk = 0; kk < k; ++kk) {
      const T aik = arow[kk];
      const T* __restrict brow = bb + kk * n;
      for (int64_t j = 0; j < n; ++j) crow[j] += aik * brow[j];
    }
  }
}

// N-specialized variant: a compile-time inner (vector) dimension lets
// the compiler fully unroll the j loop into a fixed set of vector
// registers and keep the C rows register-resident across the whole k
// loop — the libxsmm/tools-build_libsmm trick, realized as templates.
// Rows are additionally register-blocked (R rows share each B-row
// load, turning a load-port-bound 1:1 FMA:load mix into R:1), with R
// chosen so R*ceil(N/lanes) C accumulators + the B row + broadcasts
// still fit the vector register file.
template <typename T, int N, int R>
inline void rows_block(T* __restrict acc, const T* __restrict ab,
                       const T* __restrict bb, int64_t i, int64_t k) {
  // local fixed-size accumulator block: with N and R compile-time the
  // j/r loops fully unroll and `creg` register-allocates, so the kk
  // loop runs R*ceil(N/lanes) FMAs per B-row load with no C traffic
  T creg[R][N];
  for (int r = 0; r < R; ++r)
    for (int j = 0; j < N; ++j) creg[r][j] = acc[(i + r) * N + j];
  for (int64_t kk = 0; kk < k; ++kk) {
    const T* __restrict brow = bb + kk * N;
    T x[R];
    for (int r = 0; r < R; ++r) x[r] = ab[(i + r) * k + kk];
    for (int j = 0; j < N; ++j) {
      const T bj = brow[j];
      for (int r = 0; r < R; ++r) creg[r][j] += x[r] * bj;
    }
  }
  for (int r = 0; r < R; ++r)
    for (int j = 0; j < N; ++j) acc[(i + r) * N + j] = creg[r][j];
}

template <typename T, int N>
inline void accumulate_entry_n(T* __restrict acc, const T* __restrict ab,
                               const T* __restrict bb, int64_t m, int64_t k) {
  // 4-row blocks up to N=32 (f64: 4*4 + 4 + 4 = 24 zmm of 32); wider
  // blocks would spill, take pairs; tail rows go one at a time.
  constexpr int R = (N <= 32) ? 4 : 2;
  int64_t i = 0;
  for (; i + R <= m; i += R) rows_block<T, N, R>(acc, ab, bb, i, k);
  for (; i < m; ++i) rows_block<T, N, 1>(acc, ab, bb, i, k);
}

template <typename T>
using entry_fn = void (*)(T* __restrict, const T* __restrict,
                          const T* __restrict, int64_t, int64_t);

// Instantiations cover the reference CI/tuned shapes (SURVEY §4 block
// multisets and parameters_*.json staples); anything else takes the
// generic kernel.  Only real (r4/r8) kernels are specialized — complex
// arithmetic doesn't reduce to one fused j-loop.
template <typename T>
entry_fn<T> pick_entry_n(int64_t n) {
  switch (n) {
    case 4:  return &accumulate_entry_n<T, 4>;
    case 5:  return &accumulate_entry_n<T, 5>;
    case 7:  return &accumulate_entry_n<T, 7>;
    case 8:  return &accumulate_entry_n<T, 8>;
    case 9:  return &accumulate_entry_n<T, 9>;
    case 13: return &accumulate_entry_n<T, 13>;
    case 16: return &accumulate_entry_n<T, 16>;
    case 18: return &accumulate_entry_n<T, 18>;
    case 21: return &accumulate_entry_n<T, 21>;
    case 23: return &accumulate_entry_n<T, 23>;
    case 25: return &accumulate_entry_n<T, 25>;
    case 29: return &accumulate_entry_n<T, 29>;
    case 32: return &accumulate_entry_n<T, 32>;
    case 45: return &accumulate_entry_n<T, 45>;
    case 64: return &accumulate_entry_n<T, 64>;
    case 67: return &accumulate_entry_n<T, 67>;
    case 78: return &accumulate_entry_n<T, 78>;
    default: return nullptr;
  }
}

template <typename T>
entry_fn<T> pick_entry(int64_t) { return nullptr; }
template <>
entry_fn<float> pick_entry<float>(int64_t n) { return pick_entry_n<float>(n); }
template <>
entry_fn<double> pick_entry<double>(int64_t n) {
  return pick_entry_n<double>(n);
}

template <typename T, typename S>
void smm_runs(T* c, const T* a, const T* b, const int32_t* ai,
              const int32_t* bi, const int32_t* ci, const int64_t* run_ptr,
              int64_t nruns, int64_t m, int64_t n, int64_t k, S alpha) {
  const int64_t asz = m * k, bsz = k * n, csz = m * n;
  const entry_fn<T> fixed = pick_entry<T>(n);
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<T> acc(static_cast<size_t>(csz));
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
    for (int64_t r = 0; r < nruns; ++r) {
      const int64_t s0 = run_ptr[r], s1 = run_ptr[r + 1];
      T* accp = acc.data();
      for (int64_t x = 0; x < csz; ++x) accp[x] = T(0);
      if (fixed) {
        for (int64_t s = s0; s < s1; ++s) {
          fixed(accp, a + static_cast<int64_t>(ai[s]) * asz,
                b + static_cast<int64_t>(bi[s]) * bsz, m, k);
        }
      } else {
        for (int64_t s = s0; s < s1; ++s) {
          accumulate_entry(accp, a + static_cast<int64_t>(ai[s]) * asz,
                           b + static_cast<int64_t>(bi[s]) * bsz, m, n, k);
        }
      }
      T* __restrict cb = c + static_cast<int64_t>(ci[s0]) * csz;
      for (int64_t x = 0; x < csz; ++x) cb[x] += alpha * accp[x];
    }
  }
}

}  // namespace

extern "C" {

// Process a full sorted stack on the host.  dtype_code uses the
// reference datatype enum (acc_libsmm.h:31-36: r4=1, r8=3, c4=5, c8=7;
// mirrored in core/kinds.py).  `ci` must be grouped (equal C blocks
// contiguous — the stack builder's sort guarantees it); runs are
// derived here.  Returns 0 on success, -1 for an unsupported dtype.
int32_t dbcsr_host_smm(int32_t dtype_code, void* c_data, const void* a_data,
                       const void* b_data, const int32_t* ai,
                       const int32_t* bi, const int32_t* ci, int64_t nstack,
                       int64_t m, int64_t n, int64_t k, double alpha_re,
                       double alpha_im) {
  if (nstack <= 0) return 0;
  std::vector<int64_t> run_ptr;
  run_ptr.reserve(static_cast<size_t>(nstack / 4 + 2));
  run_ptr.push_back(0);
  for (int64_t s = 1; s < nstack; ++s) {
    if (ci[s] != ci[s - 1]) run_ptr.push_back(s);
  }
  run_ptr.push_back(nstack);
  const int64_t nruns = static_cast<int64_t>(run_ptr.size()) - 1;
  switch (dtype_code) {
    case 1:
      smm_runs<float, float>(
          static_cast<float*>(c_data), static_cast<const float*>(a_data),
          static_cast<const float*>(b_data), ai, bi, ci, run_ptr.data(),
          nruns, m, n, k, static_cast<float>(alpha_re));
      return 0;
    case 3:
      smm_runs<double, double>(
          static_cast<double*>(c_data), static_cast<const double*>(a_data),
          static_cast<const double*>(b_data), ai, bi, ci, run_ptr.data(),
          nruns, m, n, k, alpha_re);
      return 0;
    case 5:
      smm_runs<std::complex<float>, std::complex<float>>(
          static_cast<std::complex<float>*>(c_data),
          static_cast<const std::complex<float>*>(a_data),
          static_cast<const std::complex<float>*>(b_data), ai, bi, ci,
          run_ptr.data(), nruns, m, n, k,
          std::complex<float>(static_cast<float>(alpha_re),
                              static_cast<float>(alpha_im)));
      return 0;
    case 7:
      smm_runs<std::complex<double>, std::complex<double>>(
          static_cast<std::complex<double>*>(c_data),
          static_cast<const std::complex<double>*>(a_data),
          static_cast<const std::complex<double>*>(b_data), ai, bi, ci,
          run_ptr.data(), nruns, m, n, k,
          std::complex<double>(alpha_re, alpha_im));
      return 0;
    default:
      return -1;
  }
}

}  // extern "C"
