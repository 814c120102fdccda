// Native kernel for the k-reciprocal expansion step of Jaccard re-ranking.
//
// Computes, for every item i of an (n x n) distance matrix with precomputed
// row-wise ranking, the k-reciprocal neighbor expansion set and its
// exp(-d) L1-normalized weights (the "V" rows), plus the per-query min/sum
// Jaccard intersection. This is the published k-reciprocal encoding
// (CVPR'17) as the reference implementation vendors it — expansion +
// weights: ibl/utils/rerank.py:50-68; the 2/3-overlap candidate expansion
// criterion: rerank.py:63; Jaccard min/sum: rerank.py:84-92.
// The per-item candidate loops are irregular pointer-chasing, hence C++
// instead of numpy.
//
// Exported C ABI consumed by openibl_tpu_torch/ops/_native.py via ctypes
// (the same source as the JAX package's native/rerank.cpp).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// k-reciprocal neighbors of `i`: forward top-(k+1) whose own top-(k+1)
// contains i.
void k_reciprocal(const int32_t* rank, int64_t rank_cols, int64_t i,
                  int32_t k, std::vector<int32_t>* out) {
  out->clear();
  const int32_t* fwd = rank + i * rank_cols;
  for (int32_t a = 0; a <= k; ++a) {
    int32_t cand = fwd[a];
    const int32_t* back = rank + static_cast<int64_t>(cand) * rank_cols;
    for (int32_t b = 0; b <= k; ++b) {
      if (back[b] == static_cast<int32_t>(i)) {
        out->push_back(cand);
        break;
      }
    }
  }
}

}  // namespace

namespace {

// Shared expansion loop. When `original` is non-null, emits the exp(-d)
// L1-normalized weights; otherwise emits only the (row, col) index pairs
// (the caller computes values from features — the streaming / no-N^2 path).
int64_t expansion_impl(const float* original, const int32_t* rank, int64_t n,
                       int64_t rank_cols, int32_t k1, int32_t half,
                       int32_t* out_rows, int32_t* out_cols, float* out_vals,
                       int64_t cap) {
  // `half` comes from the caller (np.around(k1/2), half-to-even) so the
  // native and numpy paths and the output-capacity bound always agree
  int64_t written = 0;
  std::vector<int32_t> k_recip, cand_recip, expansion;
  std::vector<char> in_set(n, 0);

  for (int64_t i = 0; i < n; ++i) {
    k_reciprocal(rank, rank_cols, i, k1, &k_recip);
    expansion = k_recip;
    for (int32_t v : k_recip) in_set[v] = 1;

    for (int32_t cand : k_recip) {
      k_reciprocal(rank, rank_cols, cand, half, &cand_recip);
      int64_t overlap = 0;
      for (int32_t v : cand_recip) overlap += in_set[v];
      if (3 * overlap > 2 * static_cast<int64_t>(cand_recip.size())) {
        expansion.insert(expansion.end(), cand_recip.begin(), cand_recip.end());
      }
    }
    // clear only the <= k1+1 entries set above: a full n-byte reset per item
    // is O(n^2) memory traffic (~8 GB at the 91k-item streaming scale)
    for (int32_t v : k_recip) in_set[v] = 0;
    std::sort(expansion.begin(), expansion.end());
    expansion.erase(std::unique(expansion.begin(), expansion.end()),
                    expansion.end());

    if (written + static_cast<int64_t>(expansion.size()) > cap) return -1;
    double sum = 0.0;
    const float* row = original ? original + i * n : nullptr;
    if (row) {
      for (int32_t e : expansion) sum += std::exp(-static_cast<double>(row[e]));
    }
    for (int32_t e : expansion) {
      out_rows[written] = static_cast<int32_t>(i);
      out_cols[written] = e;
      if (row) {
        out_vals[written] =
            static_cast<float>(std::exp(-static_cast<double>(row[e])) / sum);
      }
      ++written;
    }
  }
  return written;
}

}  // namespace

extern "C" int64_t expansion_weights(
    const float* original, const int32_t* rank, int64_t n, int64_t rank_cols,
    int32_t k1, int32_t half, int32_t* out_rows, int32_t* out_cols,
    float* out_vals, int64_t cap) {
  return expansion_impl(original, rank, n, rank_cols, k1, half, out_rows,
                        out_cols, out_vals, cap);
}

extern "C" int64_t expansion_sets(
    const int32_t* rank, int64_t n, int64_t rank_cols, int32_t k1,
    int32_t half, int32_t* out_rows, int32_t* out_cols, int64_t cap) {
  return expansion_impl(nullptr, rank, n, rank_cols, k1, half, out_rows,
                        out_cols, nullptr, cap);
}

// ---------------------------------------------------------------------------
// Jaccard min/sum intersection (re_ranking step 5) over sparse V rows.
//
// For each query row i of the sparse V matrix (CSR over rows, CSC over
// columns, both with 64-bit indptr):
//   acc[r] = sum_j min(V[i,j], V[r,j])   (only j in row i touch anything)
//   out[qi, r] = 1 - acc[r] / (2 - acc[r])
// The irregular gather/scatter over ~k1^2 elements per query is interpreter-
// bound in numpy/scipy (one numpy call per (i, j) pair); here it is a flat
// scalar loop, parallelized over queries (each thread owns a dense
// accumulator and disjoint output rows).

#include <thread>

namespace {

void jaccard_block(const int64_t* csr_indptr, const int32_t* csr_cols,
                   const float* csr_vals, const int64_t* csc_indptr,
                   const int32_t* csc_rows, const float* csc_vals, int64_t n,
                   const int64_t* query_rows, int64_t q_begin, int64_t q_end,
                   float* out) {
  std::vector<float> acc(n);
  for (int64_t qi = q_begin; qi < q_end; ++qi) {
    const int64_t i = query_rows[qi];
    std::fill(acc.begin(), acc.end(), 0.0f);
    for (int64_t p = csr_indptr[i]; p < csr_indptr[i + 1]; ++p) {
      const int32_t j = csr_cols[p];
      const float vij = csr_vals[p];
      for (int64_t c = csc_indptr[j]; c < csc_indptr[j + 1]; ++c) {
        const float vrj = csc_vals[c];
        acc[csc_rows[c]] += vij < vrj ? vij : vrj;
      }
    }
    float* o = out + qi * n;
    for (int64_t r = 0; r < n; ++r) {
      const float t = acc[r];
      o[r] = 1.0f - t / (2.0f - t);
    }
  }
}

}  // namespace

extern "C" void jaccard_queries(
    const int64_t* csr_indptr, const int32_t* csr_cols, const float* csr_vals,
    const int64_t* csc_indptr, const int32_t* csc_rows, const float* csc_vals,
    int64_t n, const int64_t* query_rows, int64_t n_q, int32_t n_threads,
    float* out) {
  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? static_cast<int32_t>(hw) : 1;
  }
  if (n_threads > n_q) n_threads = static_cast<int32_t>(n_q);
  if (n_threads <= 1) {
    jaccard_block(csr_indptr, csr_cols, csr_vals, csc_indptr, csc_rows,
                  csc_vals, n, query_rows, 0, n_q, out);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  const int64_t per = (n_q + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t b = t * per;
    const int64_t e = b + per < n_q ? b + per : n_q;
    if (b >= e) break;
    threads.emplace_back(jaccard_block, csr_indptr, csr_cols, csr_vals,
                         csc_indptr, csc_rows, csc_vals, n, query_rows, b, e,
                         out);
  }
  for (auto& th : threads) th.join();
}
