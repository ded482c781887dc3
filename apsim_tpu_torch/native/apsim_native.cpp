// apsim_native: C++ hot-path helpers for the host side of the TPU engine.
//
// The reference's ETL is a Spark job (HashingTF over tokenized docs,
// etl/.../PreprocessWithTFIDF.scala:45-52); the rebuild's equivalent is this
// native tokenizer + feature hasher + per-doc TF counter, exposed through a
// C ABI and loaded from Python with ctypes (no pybind11 in the image).
//
// Hash parity contract: hash(token) == zlib.crc32(token_bytes) % num_features
// — identical to the pure-Python fallback in apsim_tpu/etl/tfidf.py, so the
// two paths are bit-for-bit interchangeable (asserted in tests).
//
// Also hosts the padded-batch builder used on every streaming insert
// (CSR -> fixed-shape [rows, k] dims/vals arrays for device scatter).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

// IEEE CRC-32 (zlib-compatible), table-driven.
struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};
const Crc32Table kCrc;

inline uint32_t crc32(const uint8_t* data, int64_t len) {
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = 0; i < len; ++i)
    c = kCrc.t[(c ^ data[i]) & 0xFFu] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

inline bool is_space(uint8_t c) {
  // Python str.split() whitespace set (ASCII subset; multi-byte UTF-8
  // whitespace is vanishingly rare in these corpora and handled identically
  // by both paths only if absent — documented deviation guard in tests)
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
         c == '\f';
}

// open-addressing uint32 -> count map, reused across documents; rehashes at
// 50% load so a document with more distinct tokens than the initial size
// estimate can never fill the table (a full table would probe forever)
struct CountMap {
  std::vector<uint32_t> keys;
  std::vector<uint32_t> vals;
  std::vector<uint32_t> used_slots;
  uint32_t mask = 0;

  void reset(size_t want) {
    size_t cap = 64;
    while (cap < want * 2) cap <<= 1;
    if (cap > keys.size()) {
      keys.assign(cap, 0xFFFFFFFFu);
      vals.assign(cap, 0);
      mask = static_cast<uint32_t>(cap - 1);
    } else {
      for (uint32_t s : used_slots) keys[s] = 0xFFFFFFFFu;
    }
    used_slots.clear();
  }

  void insert_raw(uint32_t key, uint32_t count) {
    uint32_t slot = (key * 2654435761u) & mask;
    while (keys[slot] != 0xFFFFFFFFu) slot = (slot + 1) & mask;
    keys[slot] = key;
    vals[slot] = count;
    used_slots.push_back(slot);
  }

  void grow() {
    std::vector<std::pair<uint32_t, uint32_t>> items;
    items.reserve(used_slots.size());
    for (uint32_t s : used_slots) items.emplace_back(keys[s], vals[s]);
    size_t cap = (static_cast<size_t>(mask) + 1) * 2;
    keys.assign(cap, 0xFFFFFFFFu);
    vals.assign(cap, 0);
    used_slots.clear();
    mask = static_cast<uint32_t>(cap - 1);
    for (const auto& kv : items) insert_raw(kv.first, kv.second);
  }

  void add(uint32_t key) {
    if ((used_slots.size() + 1) * 2 > static_cast<size_t>(mask) + 1) grow();
    uint32_t slot = (key * 2654435761u) & mask;
    while (true) {
      if (keys[slot] == 0xFFFFFFFFu) {
        keys[slot] = key;
        vals[slot] = 1;
        used_slots.push_back(slot);
        return;
      }
      if (keys[slot] == key) {
        ++vals[slot];
        return;
      }
      slot = (slot + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

// zlib-compatible crc32 of one buffer (parity check hook)
uint32_t apsim_crc32(const uint8_t* data, int64_t len) {
  return crc32(data, len);
}

// Hash a concatenated corpus into per-document TF vectors.
//
//   text        : UTF-8 bytes of all documents, concatenated
//   doc_offsets : int64[n_docs + 1] byte offsets into text
//   num_features: hashing space size (e.g. 2^20)
//   out_indptr  : int64[n_docs + 1]  (CSR row pointers, indptr[0]=0)
//   out_indices : int32[cap]         (hashed dims, sorted within each row)
//   out_values  : double[cap]        (term counts)
//
// Returns total nnz, or -1 if cap would be exceeded (caller retries with a
// larger cap; an upper bound is the total token count).
int64_t apsim_hash_corpus(const uint8_t* text, const int64_t* doc_offsets,
                          int64_t n_docs, uint32_t num_features,
                          int64_t* out_indptr, int32_t* out_indices,
                          double* out_values, int64_t cap) {
  CountMap map;
  std::vector<std::pair<uint32_t, uint32_t>> row;
  int64_t nnz = 0;
  out_indptr[0] = 0;
  for (int64_t d = 0; d < n_docs; ++d) {
    const uint8_t* p = text + doc_offsets[d];
    const uint8_t* end = text + doc_offsets[d + 1];
    // crude token-count estimate for map sizing
    map.reset(static_cast<size_t>((end - p) / 6 + 8));
    while (p < end) {
      while (p < end && is_space(*p)) ++p;
      const uint8_t* tok = p;
      while (p < end && !is_space(*p)) ++p;
      if (p > tok) {
        map.add(crc32(tok, p - tok) % num_features);
      }
    }
    row.clear();
    for (uint32_t s : map.used_slots) row.emplace_back(map.keys[s], map.vals[s]);
    std::sort(row.begin(), row.end());
    if (nnz + static_cast<int64_t>(row.size()) > cap) return -1;
    for (const auto& kv : row) {
      out_indices[nnz] = static_cast<int32_t>(kv.first);
      out_values[nnz] = static_cast<double>(kv.second);
      ++nnz;
    }
    out_indptr[d + 1] = nnz;
  }
  return nnz;
}

// Build a padded device batch from CSR rows:
//   dims[rows, k] initialized to pad_dim, vals[rows, k] to 0.
// Returns 0, or -1 if any row exceeds k.
int32_t apsim_pad_batch(const int64_t* indptr, const int32_t* indices,
                        const double* values, int64_t n_rows, int32_t k,
                        int32_t pad_dim, int32_t* out_dims, float* out_vals,
                        int32_t* out_lengths) {
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t s = indptr[r], e = indptr[r + 1];
    int64_t n = e - s;
    if (n > k) return -1;
    int32_t* dd = out_dims + r * k;
    float* vv = out_vals + r * k;
    for (int64_t i = 0; i < n; ++i) {
      dd[i] = indices[s + i];
      vv[i] = static_cast<float>(values[s + i]);
    }
    for (int64_t i = n; i < k; ++i) {
      dd[i] = pad_dim;
      vv[i] = 0.0f;
    }
    out_lengths[r] = static_cast<int32_t>(n);
  }
  return 0;
}

// Exact float64 dot products of sparse row pairs (a_rows[p] of CSR A vs
// b_rows[p] of CSR B) by merge-intersecting the two sorted index runs.
// This is the host rescore hot loop (the fp64 recheck that makes the
// device's superset threshold lossless — the TPU analog of the reference's
// float64 calculateSimilarity, CommonUtils.scala:98-117): O(nnz_a + nnz_b)
// per pair, no allocation, ~20x faster than the scipy multiply/sum path.
void apsim_pair_dots(
    const int64_t* a_indptr, const int32_t* a_indices, const double* a_data,
    const int64_t* b_indptr, const int32_t* b_indices, const double* b_data,
    const int64_t* a_rows, const int64_t* b_rows, int64_t n_pairs,
    double* out) {
  for (int64_t p = 0; p < n_pairs; ++p) {
    int64_t ia = a_indptr[a_rows[p]], ea = a_indptr[a_rows[p] + 1];
    int64_t ib = b_indptr[b_rows[p]], eb = b_indptr[b_rows[p] + 1];
    double acc = 0.0;
    // branchless two-pointer merge: the three-way branch above this loop's
    // predecessor was data-dependent and mispredicted on nearly every
    // iteration (random dim interleave) — cmov-style advance roughly halves
    // the wall time on TF-IDF rows.  Summation order over matching dims is
    // unchanged (ascending dim), so results stay bit-identical.
    while (ia < ea && ib < eb) {
      int32_t da = a_indices[ia], db = b_indices[ib];
      acc += (da == db) ? a_data[ia] * b_data[ib] : 0.0;
      ia += (da <= db);
      ib += (db <= da);
    }
    out[p] = acc;
  }
}

// Grouped scatter/gather rescore for SAME-matrix pair dots, ~2.7x the merge
// above on the Enron all-pairs candidates (14.8 -> 5.4 ms for 17k pairs).
// Requires host-side prep (rescore.py): pairs sorted by a-row, and a COMPACT
// dim translation of the CSR indices (cindices in [0, n_compact)) so the
// dense scratch stays L2-resident (~0.6 MB at 72k active dims instead of
// 8 MB over the raw 2^20 hashing space, where every gather would miss to
// DRAM).  Per group: scatter row i's values into scratch, then each pair
// (i, j) is a branch-free gather-multiply-accumulate over row j's nnz — no
// data-dependent branches (the merge's match test mispredicts on real
// TF-IDF), and two pairs are interleaved to split the serial fp64 add
// chain.  Bit-exactness: products of matched dims accumulate in the same
// ascending-dim order as the merge; unmatched dims contribute exact +0.0
// (scratch holds 0.0 there), which is an identity add, so results are
// bit-identical to apsim_pair_dots (asserted in tests; build pins
// -ffp-contract=off so neither path fuses).
//   scratch: double[n_compact], caller-zeroed; restored to all-zero on exit.
void apsim_group_dots(
    const int64_t* indptr, const int32_t* cindices, const double* data,
    const int64_t* a_rows, const int64_t* b_rows, int64_t n_pairs,
    double* scratch, double* out) {
  int64_t p = 0;
  while (p < n_pairs) {
    int64_t i = a_rows[p];
    int64_t si = indptr[i], ei = indptr[i + 1];
    for (int64_t t = si; t < ei; ++t) scratch[cindices[t]] = data[t];
    int64_t gend = p;
    while (gend < n_pairs && a_rows[gend] == i) ++gend;
    for (; p + 1 < gend; p += 2) {
      int64_t j0 = b_rows[p], j1 = b_rows[p + 1];
      int64_t t0 = indptr[j0], e0 = indptr[j0 + 1];
      int64_t t1 = indptr[j1], e1 = indptr[j1 + 1];
      double acc0 = 0.0, acc1 = 0.0;
      while (t0 < e0 && t1 < e1) {
        acc0 += scratch[cindices[t0]] * data[t0];
        acc1 += scratch[cindices[t1]] * data[t1];
        ++t0; ++t1;
      }
      for (; t0 < e0; ++t0) acc0 += scratch[cindices[t0]] * data[t0];
      for (; t1 < e1; ++t1) acc1 += scratch[cindices[t1]] * data[t1];
      out[p] = acc0; out[p + 1] = acc1;
    }
    for (; p < gend; ++p) {
      int64_t j = b_rows[p];
      double acc = 0.0;
      for (int64_t t = indptr[j]; t < indptr[j + 1]; ++t)
        acc += scratch[cindices[t]] * data[t];
      out[p] = acc;
    }
    for (int64_t t = si; t < ei; ++t) scratch[cindices[t]] = 0.0;
  }
}

}  // extern "C"
