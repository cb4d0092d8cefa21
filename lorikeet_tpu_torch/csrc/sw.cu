// Batched Smith-Waterman (affine gap) with traceback, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lorikeet_tpu/ops/sw_pallas.py `_kernel`
// (called from `_sw_pallas_dp`) together with the traceback that ran after
// it as jnp (`_start_points_jnp` + `_traceback_device`, fused in
// `_sw_full_jit`).  Semantics are those of the native aligner
// lorikeet_tpu/native/sw.cpp, which every result must equal bit for bit:
// exact int32 DP with the running-max gap recurrences (best_gap_v per column,
// best_gap_h per row, gap length restarting at 1 on an open), priority
// diag >= right >= down, scores floored at MATRIX_MIN_CUTOFF, the
// open + (k-1) * extend ramp on row 0 and column 0 for INDEL and
// LEADING_INDEL, and the traceback under the four overhang strategies.
//
// Inputs (one row of `meta` per pair, int64): ref_off, ref_len, alt_off,
// alt_len, scratch_off (bytes, a multiple of 32), cigar_off.  ref and alt
// are bytes of `seqs`.  Output: cigar[cigar_off ..] holds the CIGAR as
// native codes (len << 4 | op, op 0=M 1=I 2=D 4=S) in order, res[2b] its
// length and res[2b+1] the offset.  The list has room for ref_len + alt_len
// + 4 codes, as the native one.
//
// What bounds it on this card.  The recurrence needs 23 int32 operations
// per cell (substitution score 3; each gap's open add, extend add, compare,
// value select, length add and length select 6; the choice of three with
// its backtrack value 7; the floor 1): a realignment batch of 8 pairs of
// ~15,000 cells is 0.0002 ms of arithmetic.  What a launch costs is the
// serial chain: cell (i, j) waits for (i-1, j), (i, j-1) and (i-1, j-1), so
// a pair cannot finish in fewer than about R + A dependent steps, and every
// step that crosses threads costs a synchronisation.  After the sweep the
// traceback is a chain of dependent loads, one per CIGAR step.  So the
// design shortens the chain and makes each link cheap; bytes matter only
// for the backtrack slab, the one thing a pair writes to device memory.
//
// Design, warp form (alt_len <= 511; every realignment pair of `call`).
// One warp per pair, several warps per CTA and no CTA-wide barrier.  Lane l
// owns the K alternate columns l*K+1 .. l*K+K (K = 4, 8 or 16 by the pair's
// alt_len, chosen per warp inside one launch) and keeps their alt bases,
// the sw value of the row above, best_gap_v and its length in registers: a
// column is read only by itself.  The warp steps down the ref rows with a
// skew of one row a lane (lane l is on row s - l at step s), so a pair
// takes R + (A-1)/K steps.  Within a step a lane walks its K cells left to
// right with sw, best_gap_h and its length in registers, in selects and
// maxima only (a branch would diverge in every cell), ordered so that the
// chain from one cell's sw to the next is add, max, max; the last cell's
// three values reach the lane on the right by __shfl_up_sync at the next
// step, which is when that lane arrives at the same row.  Each lane
// prefetches the ref base of its next row.  A step's K backtrack values
// (0 diag, +k vertical gap of k, -k horizontal gap of k; |k| <= 8191, so
// int16) leave as one 8-, 16- or 32-byte vector per lane into a slab laid
// out [step][lane][K]: a step's 32 vectors are contiguous, so the warp
// writes whole lines.  Nothing else goes to memory: the lane that owns
// column A keeps the last column's argmax in registers as the rows go by
// (>=: later i wins), each lane folds its last-row cells under the native
// rule (greater value, then smaller |R - j|, then earlier j) when it reaches
// row R, and one __shfl_xor_sync reduction with the same key finishes the
// start point.  The traceback is walked by the whole warp: lane t loads the
// backtrack value t cells up the diagonal from the current cell, a ballot
// finds the first lane that holds a gap or left the matrix, the run of
// diagonal moves before it is taken in one go and then the gap's jump.  A
// 100-base read with one indel is walked in about five round trips to the
// slab (which a pair has just written, so it sits in L2) instead of a
// hundred dependent loads.  Lane 0 writes the run-length CIGAR: only the
// decoded CIGAR and (length, offset) leave the card.
//
// Design, CTA form (alt_len > 511: long reads).  One CTA per pair; thread t
// owns ref rows t, t + T, ... (ROWS of them, by template) and the CTA sweeps
// the anti-diagonals d = i + j with one __syncthreads() per diagonal.
// Shared memory holds, per row, the last three diagonals of sw and two
// diagonals of best_gap_v and its gap length; best_gap_h and its length stay
// in registers.  Every cell's backtrack value goes to a global slab of
// (R+1)(A+1) int32 per pair, laid out skewed (cell (i, j) at
// ((i + j) mod (A+1)) * (R+1) + i) so that one diagonal's writes are
// contiguous in i; the last column and last row of sw follow it.  Thread 0
// picks the start point and walks the slab.  Shared memory is 7 int32 per
// row: 8192 rows (ref_len <= 8191) take 229,376 bytes, under the 232,448 a
// CTA may use on this card; that is the cap ops/sw_cuda.py (MAX_REF_LEN)
// sends to either form.  Its R + A barriers make a long pair slow (later
// work: several warps per pair with a register wavefront, as above).
//
// sw_launch takes the form from the batch's longest alt, so a mixed batch
// is two launches (ops/sw_cuda.py orders the table by form).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int32_t kCutoff = -100000000;  // MATRIX_MIN_CUTOFF
constexpr int32_t kLow = INT32_MIN / 2;  // LOW_INIT of sw.cpp
constexpr int kMaxRows = 8192;           // ref_len + 1 at the cap
constexpr int kMaxThreads = 1024;
constexpr int kShmemPerRow = 7;          // int32: sw x3, best_gap_v x2, gap x2
constexpr int kWarpMaxAlt = 511;         // longest alt of the warp form
constexpr int kWarpsPerCta = 4;          // warp form: pairs per CTA
constexpr unsigned kFull = 0xffffffffu;

enum Strategy { SOFTCLIP = 0, INDEL = 1, LEADING_INDEL = 2, IGNORE = 3 };
enum State { MATCH = 0, INSERTION = 1, DELETION = 2, CLIP = 4 };

__device__ __forceinline__ int32_t code(int op, int64_t len) {
  return static_cast<int32_t>((static_cast<uint32_t>(len) << 4) |
                              static_cast<uint32_t>(op));
}

// ---- warp form ----

// Alt columns a lane holds: the narrowest strip whose 32 lanes cover the alt.
__host__ __device__ constexpr int warp_strip(int alt_len) {
  return alt_len <= 4 * 32 ? 4 : (alt_len <= 8 * 32 ? 8 : 16);
}

// One pair on one warp, K alt columns a lane.  `bt` is the pair's backtrack
// slab, int16 [steps][32][K]; `out` its CIGAR list; `res` its (length,
// offset).
template <int K>
__device__ void warp_pair(const uint8_t* __restrict__ ref, const int R,
                          const uint8_t* __restrict__ alt, const int A,
                          int16_t* bt, int32_t* __restrict__ out,
                          int32_t* __restrict__ res, const int w_match,
                          const int w_mis, const int w_open, const int w_ext,
                          const int strategy, const int lane) {
  const bool ramp = strategy == INDEL || strategy == LEADING_INDEL;
  const int j0 = lane * K;              // strip cell k is column j0 + k + 1
  const int lane_a = (A - 1) / K;       // the lane that owns column A
  const int k_a = (A - 1) - lane_a * K;
  const int nsteps = R + lane_a;

  int32_t ab[K], up[K], gap_v[K], len_v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k + 1;
    ab[k] = j <= A ? alt[j - 1] : 0;    // 0 matches no ref base
    up[k] = ramp ? w_open + (j - 1) * w_ext : 0;        // row 0
    gap_v[k] = kLow;
    len_v[k] = 0;
  }
  // what this lane hands to the lane on its right: sw, best_gap_h and its
  // length at the last cell of the row it has just finished
  int32_t out_sw = 0, out_gh = kLow, out_lh = 0;
  // sw(i-1, j0): row 0's value until the lane has done its first row
  int32_t diag_in = (lane > 0 && ramp) ? w_open + (j0 - 1) * w_ext : 0;
  int32_t rb_next = lane == 0 ? ref[0] : 0;
  int32_t col_best = INT32_MIN, col_i = 0;              // last column
  int32_t row_best = INT32_MIN, row_dist = INT32_MAX, row_j = INT32_MAX;

  for (int s = 1; s <= nsteps; ++s) {
    const int i = s - lane;
    int32_t left_sw = __shfl_up_sync(kFull, out_sw, 1);
    int32_t left_gh = __shfl_up_sync(kFull, out_gh, 1);
    int32_t left_lh = __shfl_up_sync(kFull, out_lh, 1);
    const int32_t rb = rb_next;
    rb_next = (i >= 0 && i < R) ? ref[i] : 0;           // row i + 1
    if (i < 1 || i > R || j0 >= A) continue;
    if (lane == 0) {                                    // column 0
      left_sw = ramp ? w_open + (i - 1) * w_ext : 0;
      left_gh = kLow;
      left_lh = 0;
    }
    int32_t diag = diag_in;
    diag_in = left_sw;
    uint32_t packed[K / 2];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // Columns past A in the last lane's strip are computed too: nothing
      // reads them.  No branches (lanes differ in every choice), and only
      // three operations between the left cell's sw and this one's: add,
      // max, max.
      const int32_t step_diag = diag + (rb == ab[k] ? w_match : w_mis);
      const int32_t open_v = up[k] + w_open;            // sw(i-1, j) + open
      const int32_t ext_v = gap_v[k] + w_ext;
      const int32_t down = max(open_v, ext_v);
      const int32_t kd = open_v > ext_v ? 1 : len_v[k] + 1;
      gap_v[k] = down;
      len_v[k] = kd;
      const int32_t floor_diag_down = max(kCutoff, max(step_diag, down));

      const int32_t open_h = left_sw + w_open;          // sw(i, j-1) + open
      const int32_t ext_h = left_gh + w_ext;
      const int32_t right = max(open_h, ext_h);
      const int32_t ki = open_h > ext_h ? 1 : left_lh + 1;

      // diag >= right >= down: the value is the largest of the three, the
      // backtrack value names the first in that order to reach it
      const int32_t val = max(floor_diag_down, right);
      const int32_t btr = (step_diag >= down && step_diag >= right) ? 0
                          : (right >= down ? -ki : kd);

      diag = up[k];
      up[k] = val;
      left_sw = val;
      left_gh = right;
      left_lh = ki;
      const uint32_t half = static_cast<uint32_t>(btr) & 0xffffu;
      if (k & 1) packed[k / 2] |= half << 16;
      else packed[k / 2] = half;
    }
    out_sw = left_sw;
    out_gh = left_gh;
    out_lh = left_lh;
    int16_t* dst = bt + (static_cast<size_t>(s - 1) * 32 + lane) * K;
    if constexpr (K == 4) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
    } else {
#pragma unroll
      for (int q = 0; q < K / 8; ++q)
        reinterpret_cast<uint4*>(dst)[q] = make_uint4(
            packed[4 * q], packed[4 * q + 1], packed[4 * q + 2],
            packed[4 * q + 3]);
    }
    if (lane == lane_a) {
      int32_t v = up[0];
#pragma unroll
      for (int k = 1; k < K; ++k) v = (k == k_a) ? up[k] : v;
      if (v >= col_best) { col_best = v; col_i = i; }   // later i wins
    }
    if (i == R) {                                       // the last row
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = j0 + k + 1;
        const int32_t dist = R >= j ? R - j : j - R;
        if (j <= A && (up[k] > row_best ||
                       (up[k] == row_best && dist < row_dist))) {
          row_best = up[k];
          row_dist = dist;
          row_j = j;
        }
      }
    }
  }

  // --- start point (sw.cpp calculate_cigar) ---
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int32_t v = __shfl_xor_sync(kFull, row_best, off);
    const int32_t d = __shfl_xor_sync(kFull, row_dist, off);
    const int32_t j = __shfl_xor_sync(kFull, row_j, off);
    if (v > row_best || (v == row_best &&
                         (d < row_dist || (d == row_dist && j < row_j)))) {
      row_best = v;
      row_dist = d;
      row_j = j;
    }
  }
  col_best = __shfl_sync(kFull, col_best, lane_a);
  col_i = __shfl_sync(kFull, col_i, lane_a);
  int p1, p2, seg = 0;
  if (strategy == INDEL) {
    p1 = R;
    p2 = A;
  } else {
    p1 = col_i;
    p2 = A;
    const int cur = p1 >= p2 ? p1 - p2 : p2 - p1;
    if (strategy != LEADING_INDEL &&
        (row_best > col_best || (row_best == col_best && row_dist < cur))) {
      p1 = R;
      p2 = row_j;
      seg = A - row_j;
    }
  }

  // --- traceback: every variable below is the same in all lanes ---
  __syncwarp();                         // the slab's writes, before its reads
  int n = 0;
  if (seg > 0 && strategy == SOFTCLIP) {
    if (lane == 0) out[n] = code(CLIP, seg);
    ++n;
    seg = 0;
  }
  int state = MATCH;
  for (;;) {
    // lane t looks t cells up the diagonal
    const int q1 = p1 - lane, q2 = p2 - lane;
    const bool inside = q1 >= 1 && q2 >= 1;
    int32_t btr = 0;
    if (inside) {
      const int l = (q2 - 1) / K;
      btr = bt[(static_cast<size_t>(q1 + l - 1) * 32 + l) * K
               + (q2 - 1 - l * K)];
    }
    const unsigned stop = __ballot_sync(kFull, !inside || btr != 0);
    const int run = stop ? __ffs(stop) - 1 : 32;        // diagonal moves
    if (run > 0) {
      p1 -= run;
      p2 -= run;
      if (state == MATCH) seg += run;
      else {
        if (seg > 0) { if (lane == 0) out[n] = code(state, seg); ++n; }
        seg = run;
        state = MATCH;
      }
      if (p1 <= 0 || p2 <= 0) break;
      if (run == 32) continue;
    }
    const int32_t gap = __shfl_sync(kFull, btr, run);   // a gap's jump
    const int next = gap > 0 ? DELETION : INSERTION;
    const int step = gap > 0 ? gap : -gap;
    if (next == DELETION) p1 -= step;
    else p2 -= step;
    if (next == state) seg += step;
    else {
      if (seg > 0) { if (lane == 0) out[n] = code(state, seg); ++n; }
      seg = step;
      state = next;
    }
    if (p1 <= 0 || p2 <= 0) break;
  }
  if (lane != 0) return;

  int offset;
  if (strategy == SOFTCLIP) {
    out[n++] = code(state, seg);
    if (p2 > 0) out[n++] = code(CLIP, p2);
    offset = p1;
  } else if (strategy == IGNORE) {
    out[n++] = code(state, seg + p2);
    offset = p1 - p2;
  } else {
    out[n++] = code(state, seg);
    if (p1 > 0) out[n++] = code(DELETION, p1);
    else if (p2 > 0) out[n++] = code(INSERTION, p2);
    offset = 0;
  }
  for (int a = 0, z = n - 1; a < z; ++a, --z) {   // built end to start
    const int32_t t = out[a];
    out[a] = out[z];
    out[z] = t;
  }
  res[0] = n;
  res[1] = offset;
}

__global__ void __launch_bounds__(kWarpsPerCta * 32)
sw_warp_kernel(const uint8_t* __restrict__ seqs,
               const int64_t* __restrict__ meta, uint8_t* scratch,
               int32_t* __restrict__ cigar, int32_t* __restrict__ res,
               int batch, int w_match, int w_mis, int w_open, int w_ext,
               int strategy) {
  const int pair = blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (pair >= batch) return;            // whole warps; no barrier follows
  const int lane = threadIdx.x & 31;
  const int64_t* m = meta + 6 * static_cast<int64_t>(pair);
  const uint8_t* ref = seqs + m[0];
  const int R = static_cast<int>(m[1]);
  const uint8_t* alt = seqs + m[2];
  const int A = static_cast<int>(m[3]);
  int16_t* bt = reinterpret_cast<int16_t*>(scratch + m[4]);
  int32_t* out = cigar + m[5];
  int32_t* r = res + 2 * static_cast<int64_t>(pair);
#define LORIKEET_PAIR ref, R, alt, A, bt, out, r, w_match, w_mis, w_open, \
    w_ext, strategy, lane
  const int K = warp_strip(A);
  if (K == 4) warp_pair<4>(LORIKEET_PAIR);
  else if (K == 8) warp_pair<8>(LORIKEET_PAIR);
  else warp_pair<16>(LORIKEET_PAIR);
#undef LORIKEET_PAIR
}

// ---- CTA form ----

template <int ROWS>
__global__ void __launch_bounds__(kMaxThreads)
sw_kernel(const uint8_t* __restrict__ seqs, const int64_t* __restrict__ meta,
          uint8_t* scratch, int32_t* __restrict__ cigar,
          int32_t* __restrict__ res, int w_match, int w_mis, int w_open,
          int w_ext, int strategy) {
  const int64_t* m = meta + 6 * static_cast<int64_t>(blockIdx.x);
  const uint8_t* ref = seqs + m[0];
  const int R = static_cast<int>(m[1]);
  const uint8_t* alt = seqs + m[2];
  const int A = static_cast<int>(m[3]);
  const int R1 = R + 1, A1 = A + 1;
  int32_t* bt = reinterpret_cast<int32_t*>(scratch + m[4]);
  int32_t* last_col = bt + static_cast<int64_t>(R1) * A1;   // [R1], by i
  int32_t* last_row = last_col + R1;                        // [A1], by j

  extern __shared__ int32_t smem[];
  int32_t* sw = smem;                 // [3][R1]: diagonal d at d % 3
  int32_t* gap_v = sw + 3 * R1;       // [2][R1]: best_gap_v, diagonal parity
  int32_t* len_v = gap_v + 2 * R1;    // [2][R1]: its gap length

  const int T = blockDim.x, tid = threadIdx.x;
  const bool ramp = strategy == INDEL || strategy == LEADING_INDEL;
  int32_t gap_h[ROWS], len_h[ROWS];
  uint8_t ref_base[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = tid + k * T;
    gap_h[k] = kLow;
    len_h[k] = 0;
    ref_base[k] = (i >= 1 && i <= R) ? ref[i - 1] : 0;
  }
  if (tid == 0) {
    sw[0] = 0;                                  // cell (0, 0), diagonal 0
    gap_v[0] = gap_v[R1] = kLow;                // row 0, never written again
    len_v[0] = len_v[R1] = 0;
  }
  __syncthreads();

  for (int d = 1; d <= R + A; ++d) {
    int32_t* cur = sw + (d % 3) * R1;
    const int32_t* prev1 = sw + ((d + 2) % 3) * R1;   // diagonal d - 1
    const int32_t* prev2 = sw + ((d + 1) % 3) * R1;   // diagonal d - 2
    const int32_t* gv_in = gap_v + ((d + 1) & 1) * R1;
    const int32_t* lv_in = len_v + ((d + 1) & 1) * R1;
    int32_t* gv_out = gap_v + (d & 1) * R1;
    int32_t* lv_out = len_v + (d & 1) * R1;
    int32_t* bt_diag = bt + static_cast<int64_t>(d % A1) * R1;
    const int32_t edge = ramp ? w_open + (d - 1) * w_ext : 0;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int i = tid + k * T;
      const int j = d - i;
      if (i > R || j < 0 || j > A) continue;
      if (i == 0 || j == 0) {          // row 0 / column 0: the boundary
        cur[i] = edge;
        continue;
      }
      const uint8_t b = __ldg(alt + j - 1);
      const int32_t step_diag =
          prev2[i - 1] + (ref_base[k] == b ? w_match : w_mis);

      int32_t prev_gap = prev1[i - 1] + w_open;        // sw(i-1, j) + open
      int32_t down = gv_in[i - 1] + w_ext;
      int32_t kd;
      if (prev_gap > down) { down = prev_gap; kd = 1; }
      else kd = lv_in[i - 1] + 1;

      prev_gap = prev1[i] + w_open;                    // sw(i, j-1) + open
      int32_t right = gap_h[k] + w_ext;
      int32_t ki;
      if (prev_gap > right) { right = prev_gap; ki = 1; }
      else ki = len_h[k] + 1;
      gap_h[k] = right;
      len_h[k] = ki;

      int32_t val, btr;
      if (step_diag >= down && step_diag >= right) { val = step_diag; btr = 0; }
      else if (right >= down) { val = right; btr = -ki; }
      else { val = down; btr = kd; }
      val = max(kCutoff, val);

      cur[i] = val;
      gv_out[i] = down;
      lv_out[i] = kd;
      bt_diag[i] = btr;
      if (j == A) last_col[i] = val;
      if (i == R) last_row[j] = val;
    }
    __syncthreads();
  }
  if (tid != 0) return;

  // --- start point and traceback (sw.cpp calculate_cigar) ---
  int64_t p1 = 0, p2 = 0, seg = 0;
  if (strategy == INDEL) {
    p1 = R;
    p2 = A;
  } else {
    int32_t best = INT32_MIN;
    p2 = A;
    for (int i = 1; i <= R; ++i) {
      const int32_t v = last_col[i];
      if (v >= best) { p1 = i; best = v; }
    }
    if (strategy != LEADING_INDEL) {
      for (int j = 1; j <= A; ++j) {
        const int32_t v = last_row[j];
        const int64_t dist = R >= j ? R - j : j - R;
        const int64_t cur = p1 >= p2 ? p1 - p2 : p2 - p1;
        if (v > best || (v == best && dist < cur)) {
          p1 = R;
          p2 = j;
          best = v;
          seg = A - j;
        }
      }
    }
  }

  int32_t* out = cigar + m[5];
  int n = 0;
  if (seg > 0 && strategy == SOFTCLIP) {
    out[n++] = code(CLIP, seg);
    seg = 0;
  }
  int state = MATCH;
  for (;;) {
    const int32_t btr = bt[((p1 + p2) % A1) * R1 + p1];
    int next;
    int64_t step = 1;
    if (btr > 0) { next = DELETION; step = btr; }
    else if (btr < 0) { next = INSERTION; step = -btr; }
    else next = MATCH;
    if (next == MATCH) { p1 -= 1; p2 -= 1; }
    else if (next == INSERTION) p2 -= step;
    else p1 -= step;
    if (next == state) seg += step;
    else {
      if (seg > 0) out[n++] = code(state, seg);
      seg = step;
      state = next;
    }
    if (p1 <= 0 || p2 <= 0) break;
  }

  int64_t offset;
  if (strategy == SOFTCLIP) {
    out[n++] = code(state, seg);
    if (p2 > 0) out[n++] = code(CLIP, p2);
    offset = p1;
  } else if (strategy == IGNORE) {
    out[n++] = code(state, seg + p2);
    offset = p1 - p2;
  } else {
    out[n++] = code(state, seg);
    if (p1 > 0) out[n++] = code(DELETION, p1);
    else if (p2 > 0) out[n++] = code(INSERTION, p2);
    offset = 0;
  }
  for (int a = 0, z = n - 1; a < z; ++a, --z) {   // built end to start
    const int32_t t = out[a];
    out[a] = out[z];
    out[z] = t;
  }
  res[2 * blockIdx.x] = n;
  res[2 * blockIdx.x + 1] = static_cast<int32_t>(offset);
}

template <int ROWS>
int launch(int batch, int rows_max, cudaStream_t stream, const void* seqs,
           const void* meta, void* scratch, void* cigar, void* res,
           int w_match, int w_mis, int w_open, int w_ext, int strategy) {
  const int per = (rows_max + ROWS - 1) / ROWS;
  const int threads = (per + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(kShmemPerRow) * rows_max *
                      sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sw_kernel<ROWS><<<batch, threads, smem, stream>>>(
      static_cast<const uint8_t*>(seqs), static_cast<const int64_t*>(meta),
      static_cast<uint8_t*>(scratch), static_cast<int32_t*>(cigar),
      static_cast<int32_t*>(res), w_match, w_mis, w_open, w_ext, strategy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest ref_len + 1 either form takes (the CTA form's shared memory
// bound; the warp form's int16 backtrack values hold gaps to 32,767).
int sw_max_rows() { return kMaxRows; }

// Longest alt of the warp form: a launch whose alt_max is at most this runs
// a warp per pair, any other a CTA per pair.
int sw_warp_max_alt() { return kWarpMaxAlt; }

// Bytes of scratch a pair needs at its scratch_off, a multiple of 32: the
// warp form's int16 backtrack slab [steps][32][K], or the CTA form's int32
// slab with the last column and last row.
long long sw_scratch_bytes(int ref_len, int alt_len) {
  if (alt_len <= kWarpMaxAlt) {
    const int K = warp_strip(alt_len);
    return (ref_len + (alt_len - 1) / K) * 64LL * K;
  }
  const long long cells = (ref_len + 1LL) * (alt_len + 1) + ref_len + alt_len
                          + 2;
  return (4 * cells + 31) / 32 * 32;
}

// Launch the batched alignment on `stream`; returns cudaGetLastError() (0 on
// success).  Device pointers: seqs u8, meta int64 [batch, 6], scratch bytes
// (per pair sw_scratch_bytes at scratch_off, 32-byte aligned), cigar int32
// (per pair R + A + 4 at cigar_off), res int32 [batch, 2].  rows_max is the
// largest ref_len + 1 and alt_max the longest alt of the batch.
int sw_launch(const void* seqs, const void* meta, void* scratch, void* cigar,
              void* res, int batch, int rows_max, int alt_max, int w_match,
              int w_mis, int w_open, int w_ext, int strategy, void* stream) {
  if (batch <= 0) return 0;
  if (rows_max < 2 || rows_max > kMaxRows || alt_max < 1 ||
      strategy < SOFTCLIP || strategy > IGNORE)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (alt_max <= kWarpMaxAlt) {
    const int grid = (batch + kWarpsPerCta - 1) / kWarpsPerCta;
    sw_warp_kernel<<<grid, kWarpsPerCta * 32, 0, s>>>(
        static_cast<const uint8_t*>(seqs), static_cast<const int64_t*>(meta),
        static_cast<uint8_t*>(scratch), static_cast<int32_t*>(cigar),
        static_cast<int32_t*>(res), batch, w_match, w_mis, w_open, w_ext,
        strategy);
    return static_cast<int>(cudaGetLastError());
  }
#define LORIKEET_ARGS batch, rows_max, s, seqs, meta, scratch, cigar, res, \
    w_match, w_mis, w_open, w_ext, strategy
  if (rows_max <= kMaxThreads) return launch<1>(LORIKEET_ARGS);
  if (rows_max <= 2 * kMaxThreads) return launch<2>(LORIKEET_ARGS);
  if (rows_max <= 4 * kMaxThreads) return launch<4>(LORIKEET_ARGS);
  return launch<8>(LORIKEET_ARGS);
#undef LORIKEET_ARGS
}

}  // extern "C"
