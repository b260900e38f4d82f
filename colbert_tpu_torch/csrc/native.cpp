// The port's host runtime: the response serializer, the IVF CSR pack and the
// balanced list assignment, in plain C++ with an extern "C" interface for
// ctypes (colbert_tpu_torch/native/lib.py binds it; ops/_build.py compiles it
// with g++ at first use).  Counterpart of colbert_tpu/native/ivf_pack.cpp's
// pickle_triples, ivf_pack and balanced_assign, with the same outputs.
//
// Every function writes only into the output buffers it is given, so callers
// on several threads may share the inputs.  Every bad input returns a
// negative code and leaves the outputs undefined:
//   -1  a count out of range (n, k, m, kc or cap negative or too large)
//   -2  an id out of range (a list id in ivf_pack), or the output capacity
//       of pickle_triples exceeded
//   -3  a pid of pickle_triples past the corpus

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <utility>
#include <vector>

extern "C" {

// Stable counting sort of the rows by list id, O(N + K): the permutation by
// a scatter of row ids, then the code rows gathered in sorted order (reads
// from anywhere and sequential writes beat scattered row writes ~1.5x at
// 3.2 M rows of 64 bytes).
//   assignments  n int32 in [0, k)
//   codes        n * m bytes, row-major
//   out_perm     n int32: the original row of each sorted row
//   out_offsets  k + 1 int32: list l holds sorted rows [off[l], off[l + 1])
//   out_codes    n * m bytes: the rows grouped by list, in input order within a list
int ivf_pack(const int32_t* assignments, const uint8_t* codes, int64_t n, int32_t k, int32_t m,
             int32_t* out_perm, int32_t* out_offsets, uint8_t* out_codes) {
  if (n < 0 || n > std::numeric_limits<int32_t>::max() || k <= 0 || m < 0) return -1;
  std::vector<int64_t> start(static_cast<size_t>(k) + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t a = assignments[i];
    if (a < 0 || a >= k) return -2;
    ++start[static_cast<size_t>(a) + 1];
  }
  for (int32_t l = 0; l < k; ++l) start[l + 1] += start[l];
  for (int32_t l = 0; l <= k; ++l) out_offsets[l] = static_cast<int32_t>(start[l]);
  for (int64_t i = 0; i < n; ++i) out_perm[start[assignments[i]]++] = static_cast<int32_t>(i);
  for (int64_t j = 0; j < n; ++j)
    std::memcpy(out_codes + j * m, codes + static_cast<int64_t>(out_perm[j]) * m, static_cast<size_t>(m));
  return 0;
}

// Capacity-constrained assignment.  Each point, in order, takes its first
// candidate (best first; ids outside [0, k) skipped) that holds fewer than
// cap rows; a point with none spills, after the pass, to the least-filled
// list, the earliest on a tie: the smallest (fill, list) pair, kept in a
// min-heap, so a spill costs O(log k) and not a scan of every list.
//   candidates  n * kc int32
//   out_assign  n int32
int balanced_assign(const int32_t* candidates, int64_t n, int32_t kc, int32_t k, int32_t cap,
                    int32_t* out_assign) {
  if (n < 0 || kc <= 0 || k <= 0 || cap <= 0) return -1;
  std::vector<int64_t> fill(static_cast<size_t>(k), 0);
  std::vector<int64_t> spill;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* row = candidates + i * kc;
    bool placed = false;
    for (int32_t c = 0; c < kc; ++c) {
      const int32_t a = row[c];
      if (a >= 0 && a < k && fill[a] < cap) {
        out_assign[i] = a;
        ++fill[a];
        placed = true;
        break;
      }
    }
    if (!placed) spill.push_back(i);
  }
  if (spill.empty()) return 0;
  using Entry = std::pair<int64_t, int32_t>;  // (fill, list)
  std::vector<Entry> heap(static_cast<size_t>(k));
  for (int32_t l = 0; l < k; ++l) heap[l] = {fill[l], l};
  std::make_heap(heap.begin(), heap.end(), std::greater<Entry>());
  for (const int64_t i : spill) {
    std::pop_heap(heap.begin(), heap.end(), std::greater<Entry>());
    Entry& least = heap.back();
    out_assign[i] = least.second;
    ++least.first;
    std::push_heap(heap.begin(), heap.end(), std::greater<Entry>());
  }
  return 0;
}

// The pickle body of one batch of (pid, score, text) response rows.  Each
// passage's text is a prebuilt fragment ('X' + le32 length + UTF-8 + TUPLE3)
// in text_blob at [text_off[p], text_off[p + 1]); a row is then
//   ']' '(' { 'J' <pid le32> 'G' <score as a big-endian double> <fragment> } 'e'
// with pids below 0 (padding) left out.  The caller writes the protocol
// header and footer around all the batches.  The score is written from the
// double as it is: NaN and +-inf keep their bits.  Returns the bytes written.
int64_t pickle_triples(const int32_t* pids, const double* scores, int64_t nq, int64_t k,
                       int64_t num_pids, const uint8_t* text_blob, const int64_t* text_off,
                       uint8_t* out, int64_t out_cap) {
  if (nq < 0 || k < 0 || num_pids < 0 || out_cap < 0) return -1;
  int64_t w = 0;
  for (int64_t q = 0; q < nq; ++q) {
    if (w + 3 > out_cap) return -2;
    out[w++] = ']';
    out[w++] = '(';
    for (int64_t t = 0; t < k; ++t) {
      const int64_t idx = q * k + t;
      const int32_t pid = pids[idx];
      if (pid < 0) continue;
      if (pid >= num_pids) return -3;
      const int64_t flen = text_off[pid + 1] - text_off[pid];
      if (w + 14 + flen + 1 > out_cap) return -2;
      const uint32_t le = static_cast<uint32_t>(pid);
      out[w++] = 'J';
      for (int b = 0; b < 4; ++b) out[w++] = static_cast<uint8_t>(le >> (8 * b));
      uint64_t bits;
      std::memcpy(&bits, &scores[idx], 8);
      out[w++] = 'G';
      for (int b = 7; b >= 0; --b) out[w++] = static_cast<uint8_t>(bits >> (8 * b));
      std::memcpy(out + w, text_blob + text_off[pid], static_cast<size_t>(flen));
      w += flen;
    }
    out[w++] = 'e';
  }
  return w;
}

}  // extern "C"
