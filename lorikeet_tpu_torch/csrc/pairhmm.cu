// Pair-HMM forward for Hopper (sm_90a): the grouped and the flat kernel.
//
// Replaces the Pallas TPU kernels of lorikeet_tpu/ops/pairhmm_pallas.py,
// `_kernel_grouped` and `_kernel` (+ their shared sweep `_dp_sweep`): per
// (read, haplotype) pair the log10 forward likelihood over an anti-diagonal
// wavefront, f32 with a power-of-two renormalisation every GROUP = 8
// diagonals.  grouped_kernel takes the grouped tables of
// ops/pairhmm_pack.py:prepare_grouped_jobs: table block b sweeps the 32 read
// rows of tile tile_tab[b] against haplotype hap_tab[b]; out[b * 32 + r] is
// the result for read row r of that tile.  flat_kernel takes one row per
// pair (pack_flat_inputs): read row p against haplotype row p, out[p].
// grouped_kernel runs the device function `sweep`; flat_kernel runs
// `sweep_cols` (below) for reads up to 511 bases and `sweep` for longer ones.
//
// Numerics contract (same as the TPU kernel and the torch twin
// pairhmm_sweep_torch): eps = expf(q * f32(-ln10/10)); mm = 1 - min(1,
// eps_i + eps_d), im = 1 - eps_g, ii = dd = eps_g; prior 1 - eps on a
// one-hot base-bit match, else eps * f32(1/3); D[0, j] = 1/hap_len; acc sums
// M + I over the last row for j in 1..hap_len; after every 8 diagonals all
// live state and acc are multiplied by 2^(127 - e), e the exponent of the
// largest interior M/I/D (boundary D excluded) or acc, and ls += e - 127;
// result = log10f(max(acc, FLT_MIN)) + ls * f32(log10 2).  Build without
// --use_fast_math / -ftz: denormals and IEEE expf/log10f are kept (the TPU
// flushes denormals; the deep rows where that shows fall below
// F32_SUSPECT_LOG10 and are recomputed in f64 by the caller).
//
// What bounds it on this card.  The DP touches device memory only for its
// u8 inputs (5 bytes per read base, once per block) and one f32 per pair.
// The recurrence needs 12 f32 multiplies and adds per cell: M = prior *
// (Pm * mm + Ps * (1 - gg)) 4, I = am * mi + ai * gg 3, D = M * md + D * gg
// 3, the I + D that the next M reads 1, and the rescaling (five multiplies,
// three maxima) once in 8 diagonals 1.  So it is bound by the FP32 pipes and
// by the serial chain of diagonals inside each pair, not by HBM bytes: what
// counts is how few instructions a cell issues beyond those 12, and that
// every SM has enough independent warps to hide the chain.
//
// Design.  One warp sweeps one (read, haplotype) pair.  Lane l holds a
// contiguous strip of K = Rpad/32 read rows, so row i-1 sits in the same
// lane except at the strip head, where __shfl_up_sync fetches it.  What the
// read row alone fixes is computed once in the prologue and kept in the
// strip: 1 - eps, eps / 3, mm = 1 - min(1, eps_i + eps_d) and 1 - eps_g
// (register strips; ptxas gives the 16-row strip 211 registers with them
// and without, no spill; the scratch strips derive them per cell instead,
// to save their memory traffic).  Row i on diagonal d meets haplotype base
// d - i - 1: each lane keeps its rows' haplotype bits in the strip as a
// shift register that moves one row a diagonal, takes its head from the
// lane above (a fourth shuffle) and is fed by lane 0 with one word of the
// staged haplotype, so no lane reads shared memory with a stride.  The
// renormalisation max is a __shfl_xor_sync reduction.  Reads up to 511
// bases keep their strip in registers (K = 4, 8, 16 by template); longer
// reads keep it in a global scratch slab per resident warp (L1/L2 cached),
// a strip of ceil((R+1)/32) rows sized to each read, so any read length
// runs on the device.  A pair stops at the first multiple of 8 diagonals
// >= R + H: the TPU kernel's further padded diagonals only rescale by exact
// powers of two.
//
// The grouped kernel: a CTA of 8 warps takes 8 consecutive read rows of one
// table block (grid = 4 CTAs per block) and stages the block's haplotype
// bits once in shared memory; each warp sweeps its one row and a pad row
// (read length 0) ends at once.  A block is thus 32 independent warps, not
// 4 warps working through 8 reads each: the main path's ~500 blocks become
// ~2,000 CTAs that fill the 132 SMs several times over and leave no long
// tail.  With scratch strips the grid is capped (scratch is sized by
// resident warps) and CTAs stride over the (block, quarter) list.
//
// The flat kernel: one warp per pair, with its own schedule, `sweep_cols`.
// The anti-diagonal sweep runs R + H diagonals over all 32K rows of the
// batch's strip, so a 90-base read against a 66-base haplotype in a batch
// padded to 128 rows computes 128 x 160 cells for 5,940 useful ones.  In
// sweep_cols lane l holds K consecutive read rows and, at step s, computes
// column j = s - l of all of them, top to bottom: a lane lags its upper
// neighbour by one haplotype column.  Cell (i, j) then reads (i-1, j-1) and
// (i, j-1) from the lane's own registers of the step before, and (i-1, j)
// from the row just computed; only the strip head's row above comes from
// lane l-1, whose last row computed column j on the step before: one
// __shfl_up_sync each of M, I and D, kept one more step as column j-1.  A
// pair takes H + L - 1 steps (L = ceil((R+1)/K) lanes in use) rounded up to
// 8, so the fill and drain cost L - 1 <= 31 steps, not R.  The rows are
// aligned so that row R is the last slot of lane L-1 (the first off = L*K -
// R - 1 slots of lane 0 lie above the boundary row and stay zero), which
// makes the last-row sum read a fixed register.  All K rows of a lane meet
// the same haplotype base at a step, hap_w[s - l - 1]: 32 consecutive words
// of the warp's slice, no shift register.  The boundary row is computed like
// any other, with prior 0, m->i = m->d = 0 and gg = 1, so D[0, j] stays 1/H
// without a per-step reset (its I stays 0: the row above it is a zero slot,
// or lane 0's head, which takes 0 in place of a shuffle).  K is the pair's
// own: pack_flat_inputs sorts the pairs into classes K = 1, 2, 4, 8, 16 (the
// smallest with 32K >= R + 1) and pairhmm_flat_launch runs one class a
// launch, each at its own register count.  Reads of 512 bases or more
// (class 0) keep `sweep` on scratch strips.  The renormalisation keeps its
// rule, every 8 steps over everything the warp carries (boundary D
// excluded) and acc, so the flat kernel is not bit-equal to the grouped one
// by construction: how log10f rounds a differently scaled acc may differ,
// and so may deep rows' denormals (below F32_SUSPECT_LOG10, recomputed in
// f64 by the caller).
//
// Each warp of the flat kernel stages its own haplotype's base bits in its
// own slice of shared memory ([warps][hpad] ints).  A warp synchronises with
// __syncwarp() alone, so warps of one CTA may run different numbers of
// pairs; the one __syncthreads() (after the base-bit table is loaded) lies
// before the pair loop.  The slices must fit the 227 KB a CTA can ask for:
// a batch with long haplotypes runs 2 or 1 warps per CTA, and past that
// (hpad over ~57,000) each resident warp stages into a slice of global
// scratch instead, so no pair leaves the device for its length.  The grid
// is one warp slot per pair of the class, capped (with a stride loop) where
// scratch is sized per resident warp: scratch read strips, global haplotype
// slices.  A warp takes its pairs through the class's permutation (`order`)
// and writes each result to the pair's input position.
// Not done yet (later work): TMA/cp.async staging of the inputs, two pairs
// interleaved in one warp to hide the chain's latency.

#include <cfloat>
#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;      // read rows per table block (GROUP_BLOCK_B)
constexpr int kWarps = 4;      // warps per CTA, flat kernel
constexpr int kThreads = kWarps * 32;
constexpr int kRowWarps = 8;   // warps (= read rows) per CTA, grouped kernel
constexpr int kRowThreads = kRowWarps * 32;
constexpr int kQuarters = kTile / kRowWarps;   // CTAs per table block
constexpr int kGroup = 8;      // diagonals per renormalisation (GROUP)
constexpr int kMaxRegK = 16;   // longest register strip (Rpad 512)
constexpr int kLongCtas = 264; // CTAs of a flat grid whose scratch is per warp
constexpr int kLongRowCtas = 132;  // the same for the grouped kernel's CTAs
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDecodeThreads = 256;  // threads per CTA, wire decode
constexpr int kDecodeCtas = 1056;    // grid cap (8 CTAs an SM), wire decode

constexpr float kLn10Over10 = -0x1.d791c6p-3f;  // f32(-ln(10) / 10)
constexpr float kThird = 0x1.555556p-2f;        // f32(1 / TRISTATE_CORRECTION)
constexpr float kLog10Of2 = 0x1.344136p-2f;     // f32(log10(2))

// per read row: the phred-derived coefficients, the one-hot read base bits
// and the haplotype base bits the row meets on this diagonal (both stored
// as float bits), and the DP state: M/I/D on diagonal d-1, and the row
// ABOVE's M and I+D on diagonal d-2 (the M recurrence's inputs).  Then
// either eps (kEq), from which a cell derives its four constants (scratch
// strips), or the constants themselves (register strips).
enum Field { kMi, kMd, kGg, kRb, kHb, kM, kI, kD, kPm, kPs, kEq,
             kPmatch = kEq, kPmis, kMm, kOmg, kNumRegFields,
             kNumFields = kEq + 1 };

// CTAs of the grouped kernel an SM must hold: caps the registers at 80 / 128
// / 255 for 4- / 8- / 16-row strips, which each build fits without a spill
// (left to itself ptxas stops at 64 for the 4-row strip and spills)
template <int KC>
constexpr int kMinCtas = KC == 16 ? 1 : (KC == 8 ? 2 : 3);

// Strip of K read rows held by one lane.  KC > 0: in registers (every loop
// over k is unrolled, so v[][] never leaves the register file).  KC == 0:
// in global scratch, field-major so that a warp's accesses coalesce.
template <int KC>
struct Strip {
  float v[kNumRegFields][KC];
  __device__ Strip(float*, int, int) {}
  __device__ float& at(int f, int k) { return v[f][k]; }
  __device__ float get(int f, int k) const {  // runtime k: select, no spill
    float out = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) out = (kk == k) ? v[f][kk] : out;
    return out;
  }
};

template <>
struct Strip<0> {
  float* base;
  int K;
  __device__ Strip(float* slab, int k_rows, int lane)
      : base(slab + lane), K(k_rows) {}
  __device__ float& at(int f, int k) {
    return base[(static_cast<size_t>(f) * K + k) * 32];
  }
  __device__ float get(int f, int k) { return at(f, k); }
};

template <int KC>
__device__ float sweep(Strip<KC>& st, const int K, const int lane,
                       const int R, const int H,
                       const int* hap_s,   // shared, or global written here
                       const int* __restrict__ lut,
                       const uint8_t* __restrict__ q,
                       const uint8_t* __restrict__ iq,
                       const uint8_t* __restrict__ dq,
                       const uint8_t* __restrict__ gq,
                       const uint8_t* __restrict__ rd) {
  const int KK = KC > 0 ? KC : K;
  // prologue: phred bytes -> probabilities, once per (read, block); plane
  // lane i holds read base i-1, lane 0 is the boundary row
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    const int i = lane * KK + k;
    const bool ok = i >= 1 && i <= R;
    const float eq = ok ? expf(static_cast<float>(q[i]) * kLn10Over10) : 0.f;
    const float mi = ok ? expf(static_cast<float>(iq[i]) * kLn10Over10) : 0.f;
    const float md = ok ? expf(static_cast<float>(dq[i]) * kLn10Over10) : 0.f;
    const float gg = ok ? expf(static_cast<float>(gq[i]) * kLn10Over10) : 0.f;
    st.at(kMi, k) = mi;
    st.at(kMd, k) = md;
    st.at(kGg, k) = gg;
    if constexpr (KC > 0) {
      st.at(kPmatch, k) = 1.f - eq;
      st.at(kPmis, k) = eq * kThird;
      st.at(kMm, k) = 1.f - fminf(1.f, mi + md);
      st.at(kOmg, k) = 1.f - gg;
    } else {
      st.at(kEq, k) = eq;
    }
    st.at(kRb, k) = __int_as_float(ok ? lut[rd[i]] : 0);
    st.at(kHb, k) = __int_as_float(0);
    st.at(kM, k) = 0.f;
    st.at(kI, k) = 0.f;
    st.at(kD, k) = 0.f;
    st.at(kPm, k) = 0.f;
    st.at(kPs, k) = 0.f;
  }
  float bval = 1.f / static_cast<float>(H > 0 ? H : 1);
  if (lane == 0) st.at(kD, 0) = bval;     // diagonal 0 holds cell (0, 0)
  float acc = 0.f;
  int ls = 0;
  const int end_lane = R / KK;
  const int end_k = R - end_lane * KK;
  const int ndiag = (R + H + kGroup - 1) / kGroup * kGroup;

  for (int d = 1; d <= ndiag; ++d) {
    // the row above each strip head, on diagonal d-1, and the haplotype
    // base it met there; lane 0's head is the boundary row, which meets
    // base d - 1
    const float up_m = __shfl_up_sync(kFull, st.at(kM, KK - 1), 1);
    const float up_i = __shfl_up_sync(kFull, st.at(kI, KK - 1), 1);
    const float up_d = __shfl_up_sync(kFull, st.at(kD, KK - 1), 1);
    float up_hb = __shfl_up_sync(kFull, st.at(kHb, KK - 1), 1);
    if (lane == 0) up_hb = __int_as_float(d <= H ? hap_s[d - 1] : 0);
    // bottom-up, so row k-1 still holds diagonal d-1 when row k reads it
#pragma unroll
    for (int k = KK - 1; k >= 0; --k) {
      const int ka = k > 0 ? k - 1 : 0;
      const float am = k > 0 ? st.at(kM, ka) : up_m;
      const float ai = k > 0 ? st.at(kI, ka) : up_i;
      const float ad = k > 0 ? st.at(kD, ka) : up_d;
      const float hb = k > 0 ? st.at(kHb, ka) : up_hb;
      st.at(kHb, k) = hb;
      const float mi = st.at(kMi, k);
      const float md = st.at(kMd, k);
      const float gg = st.at(kGg, k);
      float pmatch, pmis, mm, omg;
      if constexpr (KC > 0) {
        pmatch = st.at(kPmatch, k);
        pmis = st.at(kPmis, k);
        mm = st.at(kMm, k);
        omg = st.at(kOmg, k);
      } else {
        const float eq = st.at(kEq, k);
        pmatch = 1.f - eq;
        pmis = eq * kThird;
        mm = 1.f - fminf(1.f, mi + md);
        omg = 1.f - gg;
      }
      const float prior =
          (__float_as_int(st.at(kRb, k)) & __float_as_int(hb)) ? pmatch
                                                                 : pmis;
      const float m_new =
          prior * (st.at(kPm, k) * mm + st.at(kPs, k) * omg);
      const float i_new = am * mi + ai * gg;
      const float d_new = st.at(kM, k) * md + st.at(kD, k) * gg;
      st.at(kPm, k) = am;
      st.at(kPs, k) = ai + ad;
      st.at(kM, k) = m_new;
      st.at(kI, k) = i_new;
      st.at(kD, k) = d_new;
    }
    if (lane == 0) {                              // boundary row 0
      st.at(kM, 0) = 0.f;
      st.at(kI, 0) = 0.f;
      st.at(kD, 0) = bval;
    }
    if (lane == end_lane) {
      const int j = d - R;
      if (j >= 1 && j <= H) acc += st.get(kM, end_k) + st.get(kI, end_k);
    }
    if ((d & (kGroup - 1)) == 0) {
      float peak = acc;
#pragma unroll
      for (int k = 0; k < KK; ++k) {
        const float dv = (lane == 0 && k == 0) ? 0.f : st.at(kD, k);
        peak = fmaxf(peak, fmaxf(st.at(kM, k), fmaxf(st.at(kI, k), dv)));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        peak = fmaxf(peak, __shfl_xor_sync(kFull, peak, off));
      if (!(peak > 0.f)) peak = 1.f;
      const int e = (__float_as_int(peak) >> 23) & 0xFF;
      const float inv = __int_as_float((254 - e) << 23);   // 2^(127 - e)
#pragma unroll
      for (int k = 0; k < KK; ++k) {
        st.at(kM, k) *= inv;
        st.at(kI, k) *= inv;
        st.at(kD, k) *= inv;
        st.at(kPm, k) *= inv;
        st.at(kPs, k) *= inv;
      }
      acc *= inv;
      bval *= inv;
      ls += e - 127;
    }
  }
  const float total = __shfl_sync(kFull, acc, end_lane);
  return log10f(fmaxf(total, FLT_MIN)) + static_cast<float>(ls) * kLog10Of2;
}

template <int KC>
__global__ void __launch_bounds__(kRowThreads, kMinCtas<KC>)
grouped_kernel(const int* __restrict__ tile_tab,
               const int* __restrict__ hap_tab,
               const int* __restrict__ hap_lens,
               const uint8_t* __restrict__ quals,
               const uint8_t* __restrict__ ins_q,
               const uint8_t* __restrict__ del_q,
               const uint8_t* __restrict__ gcp_q,
               const uint8_t* __restrict__ read_u8,
               const int* __restrict__ read_lens,
               const uint8_t* __restrict__ haps,
               const int* __restrict__ base_bits,
               float* __restrict__ scratch,
               int nblocks, int rpad, int hpad,
               float* __restrict__ out) {
  extern __shared__ int hap_s[];                  // [hpad] base bits
  __shared__ int lut[256];
  for (int t = threadIdx.x; t < 256; t += blockDim.x) lut[t] = base_bits[t];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* slab = KC > 0 ? nullptr
      : scratch + (static_cast<size_t>(blockIdx.x) * kRowWarps + warp)
                  * static_cast<size_t>(rpad) * kNumFields;
  // unit u: rows (u % 4) * 8 .. + 7 of table block u / 4; every warp of the
  // CTA runs the same units, so the barriers below are met by all
  for (int u = blockIdx.x; u < nblocks * kQuarters; u += gridDim.x) {
    const int b = u / kQuarters;
    const int r = (u % kQuarters) * kRowWarps + warp;
    const int h = hap_tab[b];
    const int H = hap_lens[h];
    __syncthreads();          // lut loaded / previous unit done with hap_s
    for (int t = threadIdx.x; t < H; t += blockDim.x)
      hap_s[t] = lut[haps[static_cast<size_t>(h) * hpad + t]];
    __syncthreads();
    const int row = tile_tab[b] * kTile + r;
    const int R = read_lens[row];
    if (R == 0) continue;                         // pad row of a short tile
    // a scratch strip covers rows 0..R of this read only, so a short
    // read in a batch padded for a long one does not sweep the padding
    const int K = (R + 32) / 32;
    Strip<KC> st(slab, K, lane);
    const size_t o = static_cast<size_t>(row) * rpad;
    const float v = sweep<KC>(st, K, lane, R, H, hap_s, lut, quals + o,
                              ins_q + o, del_q + o, gcp_q + o, read_u8 + o);
    if (lane == 0) out[static_cast<size_t>(b) * kTile + r] = v;
  }
}

int long_grid(int nblocks) {
  const long long units = static_cast<long long>(nblocks) * kQuarters;
  return units < kLongRowCtas ? static_cast<int>(units) : kLongRowCtas;
}

template <int KC>
int launch(int grid, size_t smem, cudaStream_t stream,
           const void* tile_tab, const void* hap_tab, const void* hap_lens,
           const void* quals, const void* ins_q, const void* del_q,
           const void* gcp_q, const void* read_u8, const void* read_lens,
           const void* haps, const void* base_bits, void* scratch,
           int nblocks, int rpad, int hpad, void* out) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        grouped_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  grouped_kernel<KC><<<grid, kRowThreads, smem, stream>>>(
      static_cast<const int*>(tile_tab), static_cast<const int*>(hap_tab),
      static_cast<const int*>(hap_lens), static_cast<const uint8_t*>(quals),
      static_cast<const uint8_t*>(ins_q), static_cast<const uint8_t*>(del_q),
      static_cast<const uint8_t*>(gcp_q),
      static_cast<const uint8_t*>(read_u8),
      static_cast<const int*>(read_lens), static_cast<const uint8_t*>(haps),
      static_cast<const int*>(base_bits), static_cast<float*>(scratch),
      nblocks, rpad, hpad, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ---- flat: one warp per pair ----

// Strip width of the pair-owned schedule: K of the flat classes 1..16
// (class 0, reads of 512 bases or more, runs `sweep` on scratch strips).
constexpr int kMaxColK = 16;

// One (read, haplotype) pair in the column schedule (see the header): lane
// l holds rows lane * KC + k - off, k = 0..KC-1, and at step s computes
// column j = s - lane of all of them.  Returns the log10 likelihood.
template <int KC>
__device__ float sweep_cols(const int lane, const int R, const int H,
                            const int* hap_w, const int* __restrict__ lut,
                            const uint8_t* __restrict__ q,
                            const uint8_t* __restrict__ iq,
                            const uint8_t* __restrict__ dq,
                            const uint8_t* __restrict__ gq,
                            const uint8_t* __restrict__ rd) {
  const int L = (R + KC) / KC;              // lanes in use: ceil((R+1)/KC)
  const int off = L * KC - (R + 1);         // slots above row 0 in lane 0
  const float bval = 1.f / static_cast<float>(H > 0 ? H : 1);
  // per row: what the read row alone fixes, then M/I/D of the row's last
  // computed column (column 0 before the first step)
  float mi[KC], md[KC], gg[KC], pmatch[KC], pmis[KC], mm[KC], omg[KC];
  int rb[KC];
  float M[KC], I[KC], D[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int i = lane * KC + k - off;
    const bool ok = i >= 1 && i <= R;
    const float eq = ok ? expf(static_cast<float>(q[i]) * kLn10Over10) : 0.f;
    mi[k] = ok ? expf(static_cast<float>(iq[i]) * kLn10Over10) : 0.f;
    md[k] = ok ? expf(static_cast<float>(dq[i]) * kLn10Over10) : 0.f;
    gg[k] = ok ? expf(static_cast<float>(gq[i]) * kLn10Over10)
               : (i == 0 ? 1.f : 0.f);      // boundary row: D carries on
    pmatch[k] = 1.f - eq;
    pmis[k] = eq * kThird;
    mm[k] = 1.f - fminf(1.f, mi[k] + md[k]);
    omg[k] = 1.f - gg[k];
    rb[k] = ok ? lut[rd[i]] : 0;
    M[k] = 0.f;
    I[k] = 0.f;
    D[k] = i == 0 ? bval : 0.f;
  }
  // the strip head's row above on the step before (column j-1): its M, and
  // its I + D
  float hm = 0.f, hs = 0.f;
  float acc = 0.f;
  int ls = 0;
  const bool end_lane = lane == L - 1;      // row R: slot KC-1 of lane L-1
  const int zslot = lane == 0 ? off : -1;   // the boundary row's slot
  const int nsteps = (H + L - 1 + kGroup - 1) / kGroup * kGroup;

  for (int s = 1; s <= nsteps; ++s) {
    // lane l-1's last row computed column j = s - l on the step before;
    // lane 0's head lies above row 0 or is row 0, whose I must stay 0
    const float up_m = __shfl_up_sync(kFull, M[KC - 1], 1);
    const float up_i = __shfl_up_sync(kFull, I[KC - 1], 1);
    const float up_d = __shfl_up_sync(kFull, D[KC - 1], 1);
    const int j = s - lane;
    const bool in_hap = static_cast<unsigned>(j - 1) < static_cast<unsigned>(H);
    const int hb = in_hap ? hap_w[j - 1] : 0;
    float am = up_m;                        // row above, column j
    float ai = lane == 0 ? 0.f : up_i;
    float pm = hm, ps = hs;                 // row above, column j-1
    hm = up_m;
    hs = up_i + up_d;
    // top to bottom: row k-1 holds column j and pm/ps its column j-1
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const float prior = (rb[k] & hb) ? pmatch[k] : pmis[k];
      const float m_new = prior * (pm * mm[k] + ps * omg[k]);
      const float i_new = am * mi[k] + ai * gg[k];
      const float d_new = M[k] * md[k] + D[k] * gg[k];
      pm = M[k];
      ps = I[k] + D[k];
      M[k] = m_new;
      I[k] = i_new;
      D[k] = d_new;
      am = m_new;
      ai = i_new;
    }
    if (end_lane && in_hap) acc += M[KC - 1] + I[KC - 1];
    if ((s & (kGroup - 1)) == 0) {
      float peak = acc;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float dv = k == zslot ? 0.f : D[k];
        peak = fmaxf(peak, fmaxf(M[k], fmaxf(I[k], dv)));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        peak = fmaxf(peak, __shfl_xor_sync(kFull, peak, o));
      if (!(peak > 0.f)) peak = 1.f;
      const int e = (__float_as_int(peak) >> 23) & 0xFF;
      const float inv = __int_as_float((254 - e) << 23);   // 2^(127 - e)
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        M[k] *= inv;
        I[k] *= inv;
        D[k] *= inv;
      }
      hm *= inv;
      hs *= inv;
      acc *= inv;
      ls += e - 127;
    }
  }
  const float total = __shfl_sync(kFull, acc, L - 1);
  return log10f(fmaxf(total, FLT_MIN)) + static_cast<float>(ls) * kLog10Of2;
}

constexpr int kStaticSmem = 256 * sizeof(int);          // lut
constexpr size_t kMaxDynSmem = 227 * 1024 - kStaticSmem;

struct FlatPlan {
  int warps;        // warps per CTA
  int grid;         // CTAs
  size_t smem;      // dynamic shared memory per CTA (0: global hap slices)
  bool global_hap;  // haplotype slices in global scratch
  bool bounded;     // scratch is sized by grid * warps
};

// kclass: the pairs' strip width K (1..16), or 0 for scratch strips
FlatPlan flat_plan(int npairs, int hpad, int kclass) {
  FlatPlan p;
  const size_t slice = static_cast<size_t>(hpad) * sizeof(int);
  p.warps = kWarps;
  while (p.warps > 1 && slice * p.warps > kMaxDynSmem) p.warps >>= 1;
  p.global_hap = slice * p.warps > kMaxDynSmem;
  if (p.global_hap) p.warps = kWarps;
  p.smem = p.global_hap ? 0 : slice * p.warps;
  p.bounded = p.global_hap || kclass == 0;
  const int ctas = (npairs + p.warps - 1) / p.warps;
  p.grid = p.bounded && ctas > kLongCtas ? kLongCtas : ctas;
  return p;
}

// KC > 0: the pairs of class KC on sweep_cols; KC == 0: reads of 512
// bases or more on `sweep` with scratch strips.  Pair p of the launch is
// input row order[p]; its result goes to out[order[p]].
template <int KC>
__global__ void __launch_bounds__(kThreads)
flat_kernel(const uint8_t* __restrict__ quals,
            const uint8_t* __restrict__ ins_q,
            const uint8_t* __restrict__ del_q,
            const uint8_t* __restrict__ gcp_q,
            const uint8_t* __restrict__ read_u8,
            const int* __restrict__ read_lens,
            const uint8_t* __restrict__ haps,
            const int* __restrict__ hap_lens,
            const int* __restrict__ base_bits,
            const int* __restrict__ order,
            float* __restrict__ scratch,
            int* hap_scratch,
            int npairs, int rpad, int hpad,
            float* __restrict__ out) {
  extern __shared__ int hap_slices[];             // [warps][hpad] base bits
  __shared__ int lut[256];
  for (int t = threadIdx.x; t < 256; t += blockDim.x) lut[t] = base_bits[t];
  __syncthreads();              // the only CTA-wide barrier: before the loop
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t slot = static_cast<size_t>(blockIdx.x) * warps + warp;
  int* hap_w = hap_scratch != nullptr
      ? hap_scratch + slot * static_cast<size_t>(hpad)
      : hap_slices + static_cast<size_t>(warp) * hpad;
  float* slab = KC > 0 ? nullptr
      : scratch + slot * static_cast<size_t>(rpad) * kNumFields;
  const size_t stride = static_cast<size_t>(gridDim.x) * warps;
  for (size_t p = slot; p < static_cast<size_t>(npairs); p += stride) {
    const size_t row = static_cast<size_t>(order[p]);
    const int R = read_lens[row];
    const int H = hap_lens[row];
    const uint8_t* hap = haps + row * static_cast<size_t>(hpad);
    for (int t = lane; t < H; t += 32) hap_w[t] = lut[hap[t]];
    __syncwarp();
    const size_t o = row * static_cast<size_t>(rpad);
    float v;
    if constexpr (KC > 0) {
      // a read longer than its class's strip: NaN, which the caller's
      // escalation rule recomputes in f64
      v = R + 1 > 32 * KC
          ? __int_as_float(0x7fc00000)
          : sweep_cols<KC>(lane, R, H, hap_w, lut, quals + o, ins_q + o,
                           del_q + o, gcp_q + o, read_u8 + o);
    } else {
      const int K = (R + 32) / 32;
      Strip<0> st(slab, K, lane);
      v = sweep<0>(st, K, lane, R, H, hap_w, lut, quals + o, ins_q + o,
                   del_q + o, gcp_q + o, read_u8 + o);
    }
    if (lane == 0) out[row] = v;
    __syncwarp();               // the next pair overwrites this warp's slice
  }
}

template <int KC>
int launch_flat(const FlatPlan& plan, cudaStream_t stream,
                const void* quals, const void* ins_q, const void* del_q,
                const void* gcp_q, const void* read_u8,
                const void* read_lens, const void* haps,
                const void* hap_lens, const void* base_bits,
                const int* order, void* scratch, void* hap_scratch,
                int npairs, int rpad, int hpad, void* out) {
  if (plan.smem > 48 * 1024 - kStaticSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        flat_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(plan.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flat_kernel<KC><<<plan.grid, plan.warps * 32, plan.smem, stream>>>(
      static_cast<const uint8_t*>(quals), static_cast<const uint8_t*>(ins_q),
      static_cast<const uint8_t*>(del_q), static_cast<const uint8_t*>(gcp_q),
      static_cast<const uint8_t*>(read_u8),
      static_cast<const int*>(read_lens), static_cast<const uint8_t*>(haps),
      static_cast<const int*>(hap_lens), static_cast<const int*>(base_bits),
      order, static_cast<float*>(scratch),
      plan.global_hap ? static_cast<int*>(hap_scratch) : nullptr,
      npairs, rpad, hpad, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}


// ---- wire decode: the grouped kernel's planes from a wire job ----
//
// Replaces the decode prologue of `_grouped_wire_call` in
// lorikeet_tpu/ops/pairhmm_pallas.py (:865), which rebuilds the exact flat
// planes of a wire job (ops/pairhmm_pack.py:_compress_dispatch) before the
// grouped kernel runs.  Each qidx byte indexes the 256-entry codebook; the
// u32 there is the lane's (q, iq, dq, gcp) tuple, q in the low byte (the
// JAX u32 view, :851-855).  Each nibble byte holds two bases as symbols,
// the even lane in the low half; the 16-entry symbol table maps them back.
//
// What bounds it: bytes.  It reads 1.5 bytes a read lane and half a byte a
// haplotype base and writes 5 and 1, with a table lookup each, so it runs
// at the memory rate at best.  Design: the codebook (1 KB) and the symbol
// table sit in shared memory; one grid-stride loop over 4-byte words of the
// three inputs in turn (qidx, read_nib, then hap_nib and its tail bytes)
// writes whole words of every output plane.  The planes are torch
// allocations (aligned) and a read row's width is a multiple of 128, so
// qidx and read_nib hold whole words; a haplotype nibble row need not, so
// hap_nib runs as one flat stream whose last 1-3 bytes are decoded alone.
// A separate pass, launched on K2's stream before it; folding the decode
// into K2's staging of a block's haplotype is later work.
__global__ void __launch_bounds__(kDecodeThreads)
wire_decode_kernel(const uint32_t* __restrict__ qidx,
                   const uint32_t* __restrict__ read_nib,
                   const uint8_t* __restrict__ hap_nib,
                   const uint32_t* __restrict__ cb,
                   const uint8_t* __restrict__ sym_tab,
                   long long q_words, long long r_words, long long h_bytes,
                   uint32_t* __restrict__ quals, uint32_t* __restrict__ ins_q,
                   uint32_t* __restrict__ del_q, uint32_t* __restrict__ gcp_q,
                   uint2* __restrict__ read_u8, uint8_t* __restrict__ haps) {
  __shared__ uint32_t cb_s[256];
  __shared__ uint32_t sym_s[16];
  for (int t = threadIdx.x; t < 256; t += blockDim.x) cb_s[t] = cb[t];
  if (threadIdx.x < 16) sym_s[threadIdx.x] = sym_tab[threadIdx.x];
  __syncthreads();
  const long long h_words = h_bytes / 4;
  const long long total = q_words + r_words + h_words + h_bytes % 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < total; i += stride) {
    if (i < q_words) {
      // four lanes: plane p's byte k is byte p of lane k's tuple
      const uint32_t w = qidx[i];
      const uint32_t v0 = cb_s[w & 0xFF], v1 = cb_s[(w >> 8) & 0xFF];
      const uint32_t v2 = cb_s[(w >> 16) & 0xFF], v3 = cb_s[w >> 24];
      uint32_t* planes[4] = {quals, ins_q, del_q, gcp_q};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int sh = 8 * p;
        planes[p][i] = ((v0 >> sh) & 0xFF) | (((v1 >> sh) & 0xFF) << 8)
                       | (((v2 >> sh) & 0xFF) << 16) | ((v3 >> sh) << 24);
      }
      continue;
    }
    long long j = i - q_words;          // a word of read_nib, or of hap_nib
    const bool read = j < r_words;
    if (!read) j -= r_words;
    if (!read && j >= h_words) {
      // a tail byte of hap_nib: two bases
      const long long b = 4 * h_words + (j - h_words);
      const uint32_t v = hap_nib[b];
      haps[2 * b] = static_cast<uint8_t>(sym_s[v & 0xF]);
      haps[2 * b + 1] = static_cast<uint8_t>(sym_s[v >> 4]);
      continue;
    }
    const uint32_t w =
        read ? read_nib[j] : reinterpret_cast<const uint32_t*>(hap_nib)[j];
    // eight bases, nibble k (bits 4k..4k+3) is lane k of the word's span
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lo |= sym_s[(w >> (4 * k)) & 0xF] << (8 * k);
      hi |= sym_s[(w >> (4 * k + 16)) & 0xF] << (8 * k);
    }
    (read ? read_u8 : reinterpret_cast<uint2*>(haps))[j] = make_uint2(lo, hi);
  }
}

}  // namespace

extern "C" {

// Floats of global scratch pairhmm_grouped_launch needs (0 when the read
// strips fit in registers).
long long pairhmm_scratch_floats(int nblocks, int rpad) {
  if (rpad / 32 <= kMaxRegK) return 0;
  return static_cast<long long>(long_grid(nblocks)) * kRowWarps * rpad
         * kNumFields;
}

// Launch the grouped forward on `stream`; returns cudaGetLastError() (0 on
// success).  Pointers are device pointers: tile_tab/hap_tab int32
// [nblocks], hap_lens int32 [n_haps], the five u8 planes [rows, rpad],
// read_lens int32 [rows], haps u8 [n_haps, hpad], base_bits int32 [256],
// scratch f32 [pairhmm_scratch_floats], out f32 [nblocks * 32].
int pairhmm_grouped_launch(const void* tile_tab, const void* hap_tab,
                           const void* hap_lens, const void* quals,
                           const void* ins_q, const void* del_q,
                           const void* gcp_q, const void* read_u8,
                           const void* read_lens, const void* haps,
                           const void* base_bits, void* scratch,
                           int nblocks, int rpad, int hpad, void* out,
                           void* stream) {
  if (nblocks <= 0) return 0;
  if (rpad <= 0 || rpad % 32 != 0 || hpad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(hpad) * sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = rpad / 32;
#define LORIKEET_ARGS tile_tab, hap_tab, hap_lens, quals, ins_q, del_q, \
    gcp_q, read_u8, read_lens, haps, base_bits, scratch, nblocks, rpad, \
    hpad, out
  if (nblocks > INT32_MAX / kQuarters)
    return static_cast<int>(cudaErrorInvalidValue);
  const int units = nblocks * kQuarters;          // one CTA each
  if (K <= 4) return launch<4>(units, smem, s, LORIKEET_ARGS);
  if (K <= 8) return launch<8>(units, smem, s, LORIKEET_ARGS);
  if (K <= kMaxRegK) return launch<kMaxRegK>(units, smem, s, LORIKEET_ARGS);
  return launch<0>(long_grid(nblocks), smem, s, LORIKEET_ARGS);
#undef LORIKEET_ARGS
}

// Floats of global scratch pairhmm_flat_launch needs for the read strips
// of a launch of `npairs` pairs of class `kclass` (0 unless the class is 0),
// and ints it needs for haplotype slices (0 when they fit in shared memory).
long long pairhmm_flat_scratch_floats(int npairs, int rpad, int hpad,
                                      int kclass) {
  if (npairs <= 0 || kclass != 0) return 0;
  const FlatPlan p = flat_plan(npairs, hpad, kclass);
  return static_cast<long long>(p.grid) * p.warps * rpad * kNumFields;
}

long long pairhmm_flat_hap_scratch_ints(int npairs, int rpad, int hpad,
                                        int kclass) {
  if (npairs <= 0) return 0;
  const FlatPlan p = flat_plan(npairs, hpad, kclass);
  return p.global_hap ? static_cast<long long>(p.grid) * p.warps * hpad : 0;
}

// Launch the flat forward for one class on `stream`: pair p = 0..npairs-1
// is read row order[first + p] against the haplotype row of the same index,
// its result out[order[first + p]].  kclass is the strip width K (1, 2, 4,
// 8, 16; every read of the launch has R + 1 <= 32 K) or 0 (scratch strips,
// any length).  Returns cudaGetLastError() (0 on success).  Device
// pointers: the five u8 planes [B, rpad], read_lens int32 [B], haps u8
// [B, hpad], hap_lens int32 [B], base_bits int32 [256], order int32 [B],
// scratch f32 [pairhmm_flat_scratch_floats], hap_scratch int32
// [pairhmm_flat_hap_scratch_ints], out f32 [B].
int pairhmm_flat_launch(const void* quals, const void* ins_q,
                        const void* del_q, const void* gcp_q,
                        const void* read_u8, const void* read_lens,
                        const void* haps, const void* hap_lens,
                        const void* base_bits, const void* order,
                        void* scratch, void* hap_scratch, int kclass,
                        int first, int npairs, int rpad, int hpad,
                        void* out, void* stream) {
  if (npairs <= 0) return 0;
  if (rpad <= 0 || rpad % 32 != 0 || hpad < 0 || first < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const FlatPlan plan = flat_plan(npairs, hpad, kclass);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ord = static_cast<const int*>(order) + first;
#define LORIKEET_ARGS plan, s, quals, ins_q, del_q, gcp_q, read_u8, \
    read_lens, haps, hap_lens, base_bits, ord, scratch, hap_scratch, npairs, \
    rpad, hpad, out
  switch (kclass) {
    case 0: return launch_flat<0>(LORIKEET_ARGS);
    case 1: return launch_flat<1>(LORIKEET_ARGS);
    case 2: return launch_flat<2>(LORIKEET_ARGS);
    case 4: return launch_flat<4>(LORIKEET_ARGS);
    case 8: return launch_flat<8>(LORIKEET_ARGS);
    case kMaxColK: return launch_flat<kMaxColK>(LORIKEET_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LORIKEET_ARGS
}

// Launch the wire decode on `stream`; returns cudaGetLastError() (0 on
// success).  Device pointers: qidx u8 [rows, rpad], read_nib u8
// [rows, rpad / 2], hap_nib u8 [n_haps, hpad / 2], cb u32 [256], sym_tab u8
// [16]; written: quals, ins_q, del_q, gcp_q, read_u8 u8 [rows, rpad] and
// haps u8 [n_haps, hpad] (hpad even), the grouped kernel's inputs.
int pairhmm_wire_decode_launch(const void* qidx, const void* read_nib,
                               const void* hap_nib, const void* cb,
                               const void* sym_tab, long long rows,
                               int rpad, long long n_haps, int hpad,
                               void* quals, void* ins_q, void* del_q,
                               void* gcp_q, void* read_u8, void* haps,
                               void* stream) {
  if (rows < 0 || n_haps < 0 || rpad < 0 || rpad % 128 != 0 || hpad < 0
      || hpad % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long q_words = rows * rpad / 4;
  const long long r_words = rows * rpad / 8;
  const long long h_bytes = n_haps * hpad / 2;
  const long long total = q_words + r_words + h_bytes / 4 + h_bytes % 4;
  if (total == 0) return 0;
  const long long ctas = (total + kDecodeThreads - 1) / kDecodeThreads;
  const int grid = static_cast<int>(ctas < kDecodeCtas ? ctas : kDecodeCtas);
  wire_decode_kernel<<<grid, kDecodeThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(qidx),
      static_cast<const uint32_t*>(read_nib),
      static_cast<const uint8_t*>(hap_nib), static_cast<const uint32_t*>(cb),
      static_cast<const uint8_t*>(sym_tab), q_words, r_words, h_bytes,
      static_cast<uint32_t*>(quals), static_cast<uint32_t*>(ins_q),
      static_cast<uint32_t*>(del_q), static_cast<uint32_t*>(gcp_q),
      static_cast<uint2*>(read_u8), static_cast<uint8_t*>(haps));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
