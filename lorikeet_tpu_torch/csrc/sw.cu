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
// alt_len, scratch_off, cigar_off.  ref and alt are bytes of `seqs`.  Output:
// cigar[cigar_off ..] holds the CIGAR as native codes (len << 4 | op, op
// 0=M 1=I 2=D 4=S) in order, res[2b] its length and res[2b+1] the offset.
// The list has room for ref_len + alt_len + 4 codes, as the native one.
//
// Design.  One CTA per pair; thread t owns ref rows t, t + T, ... (ROWS of
// them, by template) and the CTA sweeps the anti-diagonals d = i + j with
// one __syncthreads() per diagonal.  Shared memory holds, per row, the last
// three diagonals of sw (d-2 and d-1 are read, d is written) and two
// diagonals of the column running max best_gap_v and its gap length: cell
// (i, j) reads row i-1's value from diagonal d-1, so best_gap_v rides the
// diagonal.  best_gap_h and its length stay in registers, since row i's
// running max is read only by row i.  Every cell's backtrack value
// (0 diag, +k vertical gap of k, -k horizontal gap of k) goes to a global
// scratch slab of (R+1)(A+1) int32 per pair, laid out skewed (cell (i, j) at
// ((i + j) mod (A+1)) * (R+1) + i) so that one diagonal's writes are
// contiguous in i; the last column and last row of sw follow it.  After the
// sweep thread 0 picks the start point with the native tie rules (later i
// wins in the last column, earliest j at equal distance in the last row),
// walks the backtrack slab and writes the run-length CIGAR: only the
// decoded CIGAR leaves the card.
//
// Shared memory is 7 int32 per row: 8192 rows (ref_len <= 8191) take
// 229,376 bytes, under the 232,448 a CTA may use on this card; that is the
// cap ops/sw_cuda.py (MAX_REF_LEN) sends to the kernel.
//
// What bounds it on this card.  The recurrence needs 23 int32 operations
// per cell (substitution score 3; each gap's open add, extend add, compare,
// value select, length add and length select 6; the choice of three with
// its backtrack value 7; the floor 1), and the kernel adds index arithmetic
// and 5 shared-memory loads.  The pair's R + A diagonals form a serial
// chain with a barrier each, and a row is active only while its column is inside the
// alt, so a 650 x 100 pair keeps about 100 of its 651 threads busy per
// diagonal.  The traceback is serial in one thread.  Later work: a warp per
// short pair (no barriers, shuffles instead of shared memory), threads
// owning the shorter sequence, int16 backtrack values, and a parallel
// start-point reduction.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int32_t kCutoff = -100000000;  // MATRIX_MIN_CUTOFF
constexpr int32_t kLow = INT32_MIN / 2;  // LOW_INIT of sw.cpp
constexpr int kMaxRows = 8192;           // ref_len + 1 at the cap
constexpr int kMaxThreads = 1024;
constexpr int kShmemPerRow = 7;          // int32: sw x3, best_gap_v x2, gap x2

enum Strategy { SOFTCLIP = 0, INDEL = 1, LEADING_INDEL = 2, IGNORE = 3 };
enum State { MATCH = 0, INSERTION = 1, DELETION = 2, CLIP = 4 };

__device__ __forceinline__ int32_t code(int op, int64_t len) {
  return static_cast<int32_t>((static_cast<uint32_t>(len) << 4) |
                              static_cast<uint32_t>(op));
}

template <int ROWS>
__global__ void __launch_bounds__(kMaxThreads)
sw_kernel(const uint8_t* __restrict__ seqs, const int64_t* __restrict__ meta,
          int32_t* __restrict__ scratch, int32_t* __restrict__ cigar,
          int32_t* __restrict__ res, int w_match, int w_mis, int w_open,
          int w_ext, int strategy) {
  const int64_t* m = meta + 6 * static_cast<int64_t>(blockIdx.x);
  const uint8_t* ref = seqs + m[0];
  const int R = static_cast<int>(m[1]);
  const uint8_t* alt = seqs + m[2];
  const int A = static_cast<int>(m[3]);
  const int R1 = R + 1, A1 = A + 1;
  int32_t* bt = scratch + m[4];
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
      static_cast<int32_t*>(scratch), static_cast<int32_t*>(cigar),
      static_cast<int32_t*>(res), w_match, w_mis, w_open, w_ext, strategy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest ref_len + 1 the kernel takes (its shared memory bound).
int sw_max_rows() { return kMaxRows; }

// Launch the batched alignment on `stream`; returns cudaGetLastError() (0 on
// success).  Device pointers: seqs u8, meta int64 [batch, 6], scratch int32
// (per pair (R+1)(A+1) + (R+1) + (A+1) at scratch_off), cigar int32 (per
// pair R + A + 4 at cigar_off), res int32 [batch, 2].  rows_max is the
// largest ref_len + 1 of the batch.
int sw_launch(const void* seqs, const void* meta, void* scratch, void* cigar,
              void* res, int batch, int rows_max, int w_match, int w_mis,
              int w_open, int w_ext, int strategy, void* stream) {
  if (batch <= 0) return 0;
  if (rows_max < 2 || rows_max > kMaxRows || strategy < SOFTCLIP ||
      strategy > IGNORE)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LORIKEET_ARGS batch, rows_max, s, seqs, meta, scratch, cigar, res, \
    w_match, w_mis, w_open, w_ext, strategy
  if (rows_max <= kMaxThreads) return launch<1>(LORIKEET_ARGS);
  if (rows_max <= 2 * kMaxThreads) return launch<2>(LORIKEET_ARGS);
  if (rows_max <= 4 * kMaxThreads) return launch<4>(LORIKEET_ARGS);
  return launch<8>(LORIKEET_ARGS);
#undef LORIKEET_ARGS
}

}  // extern "C"
