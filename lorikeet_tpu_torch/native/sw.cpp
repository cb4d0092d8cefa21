// Smith-Waterman affine-gap aligner (host-native hot path).
//
// Semantics contract: reference/src/smith_waterman/smith_waterman_aligner.rs
// :124-263 (matrix + backtrack with linear-gap optimization, priority
// diag >= right >= down) and :273-442 (traceback with the four overhang
// strategies).  The reference's AVX path comes from Intel GKL; here a tight
// scalar C++ loop serves the host side (device batches run csrc/sw.cu).
//
// Exported C ABI (ctypes):
//   sw_align(ref, ref_len, alt, alt_len, w_match, w_mismatch, w_open, w_extend,
//            strategy, cigar_out, cigar_cap, cigar_len_out, offset_out) -> 0/err
// cigar codes: (length << 4) | op with op: 0=M 1=I 2=D 4=S (BAM numbering).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

constexpr int32_t MATRIX_MIN_CUTOFF = -100000000;
constexpr int32_t LOW_INIT = INT32_MIN / 2;

enum Strategy { SOFTCLIP = 0, INDEL = 1, LEADING_INDEL = 2, IGNORE = 3 };
enum State { MATCH = 0, INSERTION = 1, DELETION = 2, CLIP = 4 };

struct Element { int op; int64_t len; };

}  // namespace

extern "C" int sw_align(
    const uint8_t* ref, int32_t ref_len,
    const uint8_t* alt, int32_t alt_len,
    int32_t w_match, int32_t w_mismatch, int32_t w_open, int32_t w_extend,
    int32_t strategy,
    uint32_t* cigar_out, int32_t cigar_cap,
    int32_t* cigar_len_out, int32_t* offset_out) {
  if (ref_len <= 0 || alt_len <= 0) return 1;
  const int64_t nrow = ref_len + 1, ncol = alt_len + 1;

  std::vector<int32_t> sw(nrow * ncol, 0);
  std::vector<int32_t> btrack(nrow * ncol, 0);
  std::vector<int32_t> best_gap_v(ncol + 1, LOW_INIT), gap_size_v(ncol + 1, 0);
  std::vector<int32_t> best_gap_h(nrow + 1, LOW_INIT), gap_size_h(nrow + 1, 0);

  if (strategy == INDEL || strategy == LEADING_INDEL) {
    int32_t cur = w_open;
    sw[1] = cur;
    for (int64_t j = 2; j < ncol; ++j) { cur += w_extend; sw[j] = cur; }
    cur = w_open;
    sw[ncol] = cur;
    for (int64_t i = 2; i < nrow; ++i) { cur += w_extend; sw[i * ncol] = cur; }
  }

  for (int64_t i = 1; i < nrow; ++i) {
    const uint8_t a_base = ref[i - 1];
    int32_t* row = &sw[i * ncol];
    const int32_t* prev_row = &sw[(i - 1) * ncol];
    int32_t* bt_row = &btrack[i * ncol];
    for (int64_t j = 1; j < ncol; ++j) {
      const uint8_t b_base = alt[j - 1];
      const int32_t step_diag =
          prev_row[j - 1] + (a_base == b_base ? w_match : w_mismatch);

      int32_t prev_gap = prev_row[j] + w_open;
      best_gap_v[j] += w_extend;
      if (prev_gap > best_gap_v[j]) { best_gap_v[j] = prev_gap; gap_size_v[j] = 1; }
      else gap_size_v[j] += 1;
      const int32_t step_down = best_gap_v[j];
      const int32_t kd = gap_size_v[j];

      prev_gap = row[j - 1] + w_open;
      best_gap_h[i] += w_extend;
      if (prev_gap > best_gap_h[i]) { best_gap_h[i] = prev_gap; gap_size_h[i] = 1; }
      else gap_size_h[i] += 1;
      const int32_t step_right = best_gap_h[i];
      const int32_t ki = gap_size_h[i];

      if (step_diag >= step_down && step_diag >= step_right) {
        row[j] = std::max(MATRIX_MIN_CUTOFF, step_diag);
        bt_row[j] = 0;
      } else if (step_right >= step_down) {
        row[j] = std::max(MATRIX_MIN_CUTOFF, step_right);
        bt_row[j] = -ki;
      } else {
        row[j] = std::max(MATRIX_MIN_CUTOFF, step_down);
        bt_row[j] = kd;
      }
    }
  }

  // --- traceback (calculate_cigar) ---
  int64_t p1 = 0, p2 = 0;
  int64_t segment_length = 0;
  if (strategy == INDEL) {
    p1 = ref_len; p2 = alt_len;
  } else {
    int32_t max_score = INT32_MIN;
    p2 = alt_len;
    for (int64_t i = 1; i < nrow; ++i) {
      const int32_t cur = sw[i * ncol + alt_len];
      if (cur >= max_score) { p1 = i; max_score = cur; }
    }
    if (strategy != LEADING_INDEL) {
      const int32_t* bottom = &sw[(int64_t)ref_len * ncol];
      for (int64_t j = 1; j < ncol; ++j) {
        const int32_t cur = bottom[j];
        if (cur > max_score ||
            (cur == max_score &&
             std::abs((int64_t)ref_len - j) < std::abs(p1 - p2))) {
          p1 = ref_len; p2 = j; max_score = cur;
          segment_length = alt_len - j;
        }
      }
    }
  }

  std::vector<Element> lce;
  if (segment_length > 0 && strategy == SOFTCLIP) {
    lce.push_back({CLIP, segment_length});
    segment_length = 0;
  }

  int state = MATCH;
  for (;;) {
    const int32_t btr = btrack[p1 * ncol + p2];
    int new_state;
    int64_t step_length = 1;
    if (btr > 0) { new_state = DELETION; step_length = btr; }
    else if (btr < 0) { new_state = INSERTION; step_length = -btr; }
    else new_state = MATCH;
    if (new_state == MATCH) { p1 -= 1; p2 -= 1; }
    else if (new_state == INSERTION) p2 -= step_length;
    else p1 -= step_length;
    if (new_state == state) segment_length += step_length;
    else {
      if (segment_length > 0) lce.push_back({state, segment_length});
      segment_length = step_length;
      state = new_state;
    }
    if (p1 <= 0 || p2 <= 0) break;
  }

  int32_t offset;
  if (strategy == SOFTCLIP) {
    lce.push_back({state, segment_length});
    if (p2 > 0) lce.push_back({CLIP, p2});
    offset = (int32_t)p1;
  } else if (strategy == IGNORE) {
    lce.push_back({state, segment_length + p2});
    offset = (int32_t)(p1 - p2);
  } else {
    lce.push_back({state, segment_length});
    if (p1 > 0) lce.push_back({DELETION, p1});
    else if (p2 > 0) lce.push_back({INSERTION, p2});
    offset = 0;
  }

  if ((int32_t)lce.size() > cigar_cap) return 2;
  const int32_t n = (int32_t)lce.size();
  for (int32_t k = 0; k < n; ++k) {
    const Element& e = lce[n - 1 - k];
    cigar_out[k] = ((uint32_t)e.len << 4) | (uint32_t)e.op;
  }
  *cigar_len_out = n;
  *offset_out = offset;
  return 0;
}
