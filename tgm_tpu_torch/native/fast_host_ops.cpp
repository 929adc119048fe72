// Host-side data-path sorts and searches of tgm_tpu_torch (a copy of the
// JAX package's fast_host_ops.cpp; the two packages share no file).
//
// The card owns the model compute; this library speeds up the host-resident
// ingest around it, the O(E log E) steps that numpy runs on one thread: the
// global event argsort of DGData when timestamps arrive unsorted, and the
// temporal CSR's (node, time) ordering, both dominant when loading large
// graphs such as tgbl-flight or tgbl-comment.
//
//   * stable_sort_perm_i64: parallel stable argsort of the event timeline
//     (LSD radix, 8-bit digits, OpenMP prefix sums)
//   * lexsort2_perm_i64: stable argsort by (primary, secondary), the
//     temporal CSR's (node, time) ordering
//   * searchsorted_i64: batched binary search (left/right)
//
// A plain C ABI, loaded through ctypes (tgm_tpu_torch/native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// One LSD radix pass over 8-bit digits: stable counting sort of `idx` by
// digit `shift` of key[i], parallel histogram + exclusive scan.
void radix_pass(const uint64_t* keys, const int64_t* in_idx, int64_t* out_idx,
                int64_t n, int shift) {
  constexpr int kBuckets = 256;
#ifdef _OPENMP
  int n_threads = omp_get_max_threads();
#else
  int n_threads = 1;
#endif
  std::vector<int64_t> hist(static_cast<size_t>(n_threads) * kBuckets, 0);

#pragma omp parallel num_threads(n_threads)
  {
#ifdef _OPENMP
    int t = omp_get_thread_num();
#else
    int t = 0;
#endif
    int64_t chunk = (n + n_threads - 1) / n_threads;
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    int64_t* h = hist.data() + static_cast<size_t>(t) * kBuckets;
    for (int64_t i = lo; i < hi; ++i) {
      h[(keys[in_idx[i]] >> shift) & 0xFF]++;
    }
  }

  // Exclusive scan in (bucket, thread) order preserves stability.
  int64_t sum = 0;
  for (int b = 0; b < kBuckets; ++b) {
    for (int t = 0; t < n_threads; ++t) {
      int64_t* h = hist.data() + static_cast<size_t>(t) * kBuckets;
      int64_t c = h[b];
      h[b] = sum;
      sum += c;
    }
  }

#pragma omp parallel num_threads(n_threads)
  {
#ifdef _OPENMP
    int t = omp_get_thread_num();
#else
    int t = 0;
#endif
    int64_t chunk = (n + n_threads - 1) / n_threads;
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    int64_t* h = hist.data() + static_cast<size_t>(t) * kBuckets;
    for (int64_t i = lo; i < hi; ++i) {
      int b = (keys[in_idx[i]] >> shift) & 0xFF;
      out_idx[h[b]++] = in_idx[i];
    }
  }
}

void radix_argsort(const uint64_t* keys, int64_t* perm, int64_t n,
                   uint64_t max_key) {
  std::vector<int64_t> tmp(n);
  int64_t* a = perm;
  int64_t* b = tmp.data();
  for (int64_t i = 0; i < n; ++i) a[i] = i;
  for (int shift = 0; shift < 64; shift += 8) {
    if (shift > 0 && (max_key >> shift) == 0) break;
    radix_pass(keys, a, b, n, shift);
    std::swap(a, b);
  }
  if (a != perm) std::memcpy(perm, a, sizeof(int64_t) * n);
}

}  // namespace

extern "C" {

// Stable argsort of int64 (non-negative) keys: perm[i] = index of i-th
// smallest. Returns 0 on success.
int stable_sort_perm_i64(const int64_t* keys, int64_t n, int64_t* perm) {
  if (n <= 0) return 0;
  uint64_t max_key = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (keys[i] < 0) return 1;  // caller guarantees non-negative
    max_key = std::max<uint64_t>(max_key, static_cast<uint64_t>(keys[i]));
  }
  radix_argsort(reinterpret_cast<const uint64_t*>(keys), perm, n, max_key);
  return 0;
}

// Stable argsort by (primary, secondary): sort by secondary first, then
// stably by primary. Both non-negative int64.
int lexsort2_perm_i64(const int64_t* primary, const int64_t* secondary,
                      int64_t n, int64_t* perm) {
  if (n <= 0) return 0;
  uint64_t max_s = 0, max_p = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (primary[i] < 0 || secondary[i] < 0) return 1;
    max_s = std::max<uint64_t>(max_s, static_cast<uint64_t>(secondary[i]));
    max_p = std::max<uint64_t>(max_p, static_cast<uint64_t>(primary[i]));
  }
  std::vector<int64_t> tmp(n);
  int64_t* a = perm;
  int64_t* b = tmp.data();
  for (int64_t i = 0; i < n; ++i) a[i] = i;
  const uint64_t* sk = reinterpret_cast<const uint64_t*>(secondary);
  const uint64_t* pk = reinterpret_cast<const uint64_t*>(primary);
  for (int shift = 0; shift < 64; shift += 8) {
    if (shift > 0 && (max_s >> shift) == 0) break;
    radix_pass(sk, a, b, n, shift);
    std::swap(a, b);
  }
  for (int shift = 0; shift < 64; shift += 8) {
    if (shift > 0 && (max_p >> shift) == 0) break;
    radix_pass(pk, a, b, n, shift);
    std::swap(a, b);
  }
  if (a != perm) std::memcpy(perm, a, sizeof(int64_t) * n);
  return 0;
}

// Batched binary search over a sorted array; side 0 = left, 1 = right.
void searchsorted_i64(const int64_t* sorted, int64_t n, const int64_t* queries,
                      int64_t nq, int side, int64_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < nq; ++i) {
    const int64_t* end = sorted + n;
    const int64_t* it = side == 0 ? std::lower_bound(sorted, end, queries[i])
                                  : std::upper_bound(sorted, end, queries[i]);
    out[i] = it - sorted;
  }
}

}  // extern "C"
