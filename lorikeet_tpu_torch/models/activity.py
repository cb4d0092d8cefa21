"""Activity profiling: pileup -> ref-vs-any genotype likelihoods -> active
probabilities -> band-pass smoothing -> assembly-region extraction.

Numerics contract (reference/src/haplotype/haplotype_caller_engine.rs):
- parse_record pileup walk (:754-899): per aligned base (or deletion cell,
  qual fixed at 30) with qual >= bq(10) accumulate ref-vs-any GLs
  (:1464-1533 alignment_context_creation, :1534-1560
  update_heterozygous_likelihood with the Jacobian-table het term);
- is_alt = base mismatch or adjacency to an S/I/D cigar element (:1584-1687);
- per-position active prob = biallelic AF-calc QUAL through
  GenotypingEngine::calculate_genotypes with <FAKE_ALT> (:1053-1085 +
  genotyping_engine.rs:80-250): None (prob 0) unless the site is plausible
  and passes the emit threshold, else 1 - 10^(-floor(QUAL)/10);
- band-pass smoothing: normalized Gaussian kernel, sigma 17, filter size 50
  (band_pass_activity_profile.rs:24-101), HQ-soft-clip states multiply mass
  by (2*min(n_hq_clips, 50)+1);
- region extraction: threshold crossing + local-minimum cut sites
  (activity_profile.rs:430-668).

Design: the per-base GL update depends only on (qual, is_alt), so
pileup accumulation is a table-gather scatter-add; the per-position QUAL is a
fully vectorized EM over [positions] arrays.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from lorikeet_tpu_torch.utils.math import approximate_log10_sum_log10

REF_MODEL_DELETION_QUAL = 30
HQ_BASE_QUALITY_SOFTCLIP_THRESHOLD = 28
AVERAGE_HQ_SOFTCLIPS_HQ_BASES_THRESHOLD = 6.0
MAX_FILTER_SIZE = 50
DEFAULT_SIGMA = 17.0
MIN_PROB_TO_KEEP_IN_FILTER = 1e-5
PROBABILITY_TOLERANCE_FOR_DENSITY_CHECK = 0.1


# ---------------------------------------------------------------------------
# Pileup -> ref-vs-any genotype likelihoods
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _gl_update_table(ploidy: int) -> np.ndarray:
    """[256, 2, ploidy+1] GL contribution per (qual, is_alt) — all 256
    possible u8 quals (0xFF = SAM missing-qual sentinel included; indexing
    a 255-row table with it read out of bounds).

    Mirrors update_heterozygous_likelihood: hom terms get lk + log10(ploidy),
    het term i gets approx_log10_sum(ref_lk + log10(ploidy-i), alt_lk + log10(i)).
    """
    n = ploidy + 1
    log10p = np.log10(ploidy)
    table = np.zeros((256, 2, n))
    for q in range(256):
        err_log10 = q / -10.0
        with np.errstate(divide="ignore"):
            prob_log10 = np.log10(1.0 - 10.0 ** (q / -10.0)) if q > 0 else -np.inf
        for alt in (0, 1):
            if alt:
                ref_lk = err_log10 - np.log10(3.0)
                alt_lk = prob_log10
            else:
                ref_lk = prob_log10
                alt_lk = err_log10 - np.log10(3.0)
            table[q, alt, 0] = ref_lk + log10p
            table[q, alt, ploidy] = alt_lk + log10p
            j = ploidy - 1
            for i in range(1, ploidy):
                table[q, alt, i] = approximate_log10_sum_log10(
                    ref_lk + np.log10(j), alt_lk + np.log10(i))
                j -= 1
    table.setflags(write=False)
    return table


def _sc_indel_adjacency(cigar, read_len: int) -> np.ndarray:
    """Boolean per read position: adjacent to a softclip/insertion/deletion
    element (haplotype_caller_engine.rs:1584-1652 semantics)."""
    adj = np.zeros(read_len, bool)
    cursor = 0
    for op, n in cigar:
        if op in "SID":
            if cursor - 1 >= 0:
                adj[cursor - 1] = True          # base just before the element
            after = cursor + (n if op in "SI" else 0)
            if after < read_len:
                adj[after] = True               # base just after the element
        if op in "MIS=X":
            cursor += n
    if read_len:
        # read position 0 is never "adjacent": the reference's scan breaks
        # on past_query_pos before any element can flag it
        # (haplotype_caller_engine.rs:1596-1650)
        adj[0] = False
    return adj


def _count_high_quality_soft_clips(rec, min_qual: int = HQ_BASE_QUALITY_SOFTCLIP_THRESHOLD) -> float:
    n = 0.0
    pos = 0
    for op, ln in rec.cigar:
        if op == "S":
            q = rec.qual[pos:pos + ln]
            n += float(np.count_nonzero(q > min_qual))
            pos += ln
        elif op in "MI=X":
            pos += ln
    return n


@dataclass
class RefVsAnyProfile:
    """Per-position accumulators for one sample over a chunk."""
    gl: np.ndarray            # [L, ploidy+1] float64
    read_counts: np.ndarray   # [L] int32
    ref_depth: np.ndarray     # [L] int32
    nonref_depth: np.ndarray  # [L] int32
    hq_sc_sum: np.ndarray     # [L] float64 (RunningAverage numerator)
    hq_sc_n: np.ndarray       # [L] int32

    @classmethod
    def zeros(cls, length: int, ploidy: int):
        return cls(np.zeros((length, ploidy + 1)), np.zeros(length, np.int32),
                   np.zeros(length, np.int32), np.zeros(length, np.int32),
                   np.zeros(length), np.zeros(length, np.int32))

    def finalize_gls(self, ploidy: int) -> np.ndarray:
        """Subtract read_counts*log10(ploidy) (update_ref_vs_any_results)."""
        return self.gl - self.read_counts[:, None] * np.log10(ploidy)

    def dp(self) -> np.ndarray:
        return self.ref_depth + self.nonref_depth


def accumulate_read(profile: RefVsAnyProfile, rec, ref_seq: np.ndarray,
                    chunk_start: int, chunk_end: int, bq: int, ploidy: int):
    """Add one read's pileup contributions (parse_record semantics).

    ``ref_seq`` must cover the chunk as ref_seq[pos - chunk_start].
    """
    table = _gl_update_table(ploidy)
    adj = _sc_indel_adjacency(rec.cigar, len(rec.seq))
    seq = rec.seq
    qual = rec.qual.astype(np.int64, copy=False)
    pos = rec.pos
    rc = 0
    # per-segment numpy slices instead of a per-base Python loop
    idx_parts, q_parts, alt_parts = [], [], []
    sc_events = []  # (chunk position, read index) where HQ-SC counting triggers

    for ci, (op, n) in enumerate(rec.cigar):
        if op == "D":
            lo = max(chunk_start - pos, 0)
            hi = min(chunk_end - pos, n)
            if hi > lo:
                idx_parts.append(np.arange(pos + lo - chunk_start,
                                           pos + hi - chunk_start))
                q_parts.append(np.full(hi - lo, REF_MODEL_DELETION_QUAL,
                                       np.int64))
                alt_parts.append(np.ones(hi - lo, np.int64))
                # deletion cells (always alt) count HQ soft clips when a
                # neighbouring cigar element is a soft clip
                # (haplotype_caller_engine.rs:1537-1548 qpos=None arm)
                if ((ci > 0 and rec.cigar[ci - 1][0] == "S")
                        or (ci + 1 < len(rec.cigar)
                            and rec.cigar[ci + 1][0] == "S")):
                    for j in range(lo, hi):
                        sc_events.append((pos + j - chunk_start, None))
            pos += n
        elif op == "I":
            if chunk_start <= pos < chunk_end:
                q = qual[rc]
                if q >= bq:
                    base = seq[rc]
                    is_alt = (base != ref_seq[pos - chunk_start]) or adj[rc]
                    idx_parts.append(np.array([pos - chunk_start]))
                    q_parts.append(np.array([q], np.int64))
                    alt_parts.append(np.array([int(is_alt)], np.int64))
                    if is_alt and adj[rc]:
                        sc_events.append((pos - chunk_start, rc))
            rc += n
        elif op in "M=X":
            lo = max(chunk_start - pos, 0)
            hi = min(chunk_end - pos, n)
            if hi > lo:
                p_idx = np.arange(pos + lo - chunk_start, pos + hi - chunk_start)
                q_seg = qual[rc + lo:rc + hi]
                keep = q_seg >= bq
                adj_seg = adj[rc + lo:rc + hi]
                alt_seg = (seq[rc + lo:rc + hi] != ref_seq[p_idx]) | adj_seg
                if keep.any():
                    idx_parts.append(p_idx[keep])
                    q_parts.append(q_seg[keep])
                    alt_parts.append(alt_seg[keep].astype(np.int64))
                    for j in np.flatnonzero(keep & alt_seg & adj_seg):
                        sc_events.append((int(p_idx[j]), rc + lo + int(j)))
            rc += n
            pos += n
        elif op == "S":
            rc += n
        # H and P are ignored

    if not idx_parts:
        return None

    idx = np.concatenate(idx_parts)
    qs = np.concatenate(q_parts)
    alts = np.concatenate(alt_parts)

    if profile is None:
        return idx, qs, alts, _hq_sc_updates(rec, sc_events)

    np.add.at(profile.gl, idx, table[qs, alts])
    np.add.at(profile.read_counts, idx, 1)
    np.add.at(profile.ref_depth, idx, (alts == 0).astype(np.int32))
    np.add.at(profile.nonref_depth, idx, (alts == 1).astype(np.int32))

    for p, n_hq in _hq_sc_updates(rec, sc_events):
        profile.hq_sc_sum[p] += n_hq
        profile.hq_sc_n[p] += 1
    return None


def _hq_sc_updates(rec, sc_events) -> list:
    """(chunk position, hq soft-clip count) pairs for triggering bases.
    HQ soft clips are only counted when the base is adjacent to a SOFTCLIP
    specifically (next_to_soft_clip without indels)."""
    if not sc_events:
        return []
    sc_adj = _sc_only_adjacency(rec.cigar, len(rec.seq))
    out = []
    n_hq = None
    for p, qpos in sc_events:
        # qpos None marks a deletion cell already gated at event creation
        if qpos is None or sc_adj[qpos]:
            if n_hq is None:
                n_hq = _count_high_quality_soft_clips(rec)
            out.append((p, n_hq))
    return out


def accumulate_reads_columnar(profile: RefVsAnyProfile, cols, idx,
                              ref_seq: np.ndarray, chunk_start: int,
                              chunk_end: int, bq: int, ploidy: int) -> bool:
    """Columnar pileup straight from BamReader.columnar buffers — no
    BamRecord objects (same contract as accumulate_reads).  Returns False
    when the native kernel is unavailable."""
    from lorikeet_tpu_torch.native.pileup_native import (
        accumulate_reads_columnar as _native)
    return _native(profile, cols, idx, ref_seq, chunk_start, chunk_end,
                   bq, _gl_update_table(ploidy))


def accumulate_reads(profile: RefVsAnyProfile, recs, ref_seq: np.ndarray,
                     chunk_start: int, chunk_end: int, bq: int, ploidy: int):
    """Batched pileup over many reads: build per-read event arrays, flush
    scatter-adds once (the vectorized form of HOT LOOP 1,
    haplotype_caller_engine.rs:754-899).  Native C++ when the toolchain is
    present, vectorized numpy otherwise."""
    table = _gl_update_table(ploidy)
    from lorikeet_tpu_torch.native.pileup_native import accumulate_reads_native
    if accumulate_reads_native(profile, recs, ref_seq, chunk_start,
                               chunk_end, bq, table):
        return
    idx_all, q_all, alt_all = [], [], []
    for rec in recs:
        ev = accumulate_read(None, rec, ref_seq, chunk_start, chunk_end,
                             bq, ploidy)
        if ev is None:
            continue
        idx, qs, alts, hq = ev
        idx_all.append(idx)
        q_all.append(qs)
        alt_all.append(alts)
        for p, n_hq in hq:
            profile.hq_sc_sum[p] += n_hq
            profile.hq_sc_n[p] += 1
    if not idx_all:
        return
    idx = np.concatenate(idx_all)
    qs = np.concatenate(q_all)
    alts = np.concatenate(alt_all)
    L = profile.read_counts.shape[0]
    updates = table[qs, alts]                       # [N, ploidy+1]
    for g in range(updates.shape[1]):
        profile.gl[:, g] += np.bincount(idx, weights=updates[:, g],
                                        minlength=L)
    profile.read_counts += np.bincount(idx, minlength=L).astype(np.int32)
    profile.ref_depth += np.bincount(idx[alts == 0],
                                     minlength=L).astype(np.int32)
    profile.nonref_depth += np.bincount(idx[alts == 1],
                                        minlength=L).astype(np.int32)


def _sc_only_adjacency(cigar, read_len: int) -> np.ndarray:
    adj = np.zeros(read_len, bool)
    cursor = 0
    for op, n in cigar:
        if op == "S":
            if cursor - 1 >= 0:
                adj[cursor - 1] = True
            if cursor + n < read_len:
                adj[cursor + n] = True
        if op in "MIS=X":
            cursor += n
    if read_len:
        adj[0] = False      # same position-0 quirk as _sc_indel_adjacency
    return adj


# ---------------------------------------------------------------------------
# Per-position active probability (vectorized biallelic AF calc)
# ---------------------------------------------------------------------------

def active_probabilities(
    gls: np.ndarray,            # [S, L, ploidy+1] finalized log10 GLs
    ploidy: int,
    snp_heterozygosity: float = 0.001,
    heterozygosity_stdev: float = 0.01,
    stand_min_conf: float = 25.0,
    max_iters: int = 100,
) -> np.ndarray:
    """Active probability per position (float32 [L]).

    Vectorized equivalent of running GenotypingEngine::calculate_genotypes
    with fake biallelic alleles at every position: Dirichlet-EM allele
    frequencies, QUAL from log10 P(no variant), plausibility + emit
    thresholds, then prob = 1 - 10^(-floor(QUAL)/10).
    """
    S, L, G = gls.shape
    assert G == ploidy + 1
    counts = np.stack([np.arange(ploidy, -1, -1), np.arange(0, ploidy + 1)], axis=1)  # [G,2]
    log10_comb = np.array([
        _log10_binom(ploidy, i) for i in range(G)
    ])
    ref_pseudo = snp_heterozygosity / heterozygosity_stdev ** 2
    alt_pseudo = snp_heterozygosity * ref_pseudo
    prior_pseudo = np.array([ref_pseudo, alt_pseudo])

    log10_af = np.full((L, 2), -np.log10(2.0))
    allele_counts = np.zeros((L, 2))

    def posteriors(g, log10_af_arr):
        # [S, l, G] over the position subset g
        raw = (log10_comb[None, None, :] + g
               + (counts @ log10_af_arr.T).T[None, :, :])
        m = raw.max(axis=2, keepdims=True)
        norm = m + np.log10(np.sum(10.0 ** (raw - m), axis=2, keepdims=True))
        return raw - norm

    # ---- certain-inactive prefilter (exact): QUAL = -10*log10 P(no
    # variant) = 10*Σ_s log10(1 + Σ_{g>=1} 10^{raw_g - raw_0}), and over
    # EVERY EM iterate log10(af_alt/af_ref) <= λmax by pseudo-count
    # algebra (alt counts <= S·ploidy, ref pseudo fixed; the flat init af
    # is covered by the max with 0).  So one vectorized bound pass rules a
    # position out for ALL reachable allele frequencies — at 25-30x
    # coverage >90% of positions are certainly inactive and the EM below
    # (formerly ~1.5 s/Mbp, the dominant smooth_extract cost) never sees
    # them.  Positions ruled out get prob 0, exactly what the full EM
    # would emit (emit_ok False).
    lam_max = max(0.0, np.log10((alt_pseudo + S * ploidy) / ref_pseudo))
    gbonus = log10_comb[1:] + np.arange(1, G) * lam_max
    mx = np.clip((gls[:, :, 1:] + gbonus[None, None, :]).max(axis=2)
                 - gls[:, :, 0], -320.0, 100.0)           # [S, L]
    bound = np.log1p((G - 1) * 10.0 ** mx).sum(axis=0) / np.log(10.0)
    cand = np.flatnonzero(bound >= stand_min_conf * 0.1)

    # EM over the still-active position subset only — most positions
    # converge within a couple of iterations, so the full-width recompute
    # per iteration is almost entirely wasted work
    idx = cand
    for _ in range(max_iters):
        if idx.size == 0:
            break
        post = posteriors(gls[:, idx], log10_af[idx])     # [S, l, G]
        lin = 10.0 ** post
        new_counts = np.einsum("slg,ga->la", lin, counts)
        diff = np.abs(new_counts - allele_counts[idx]).max(axis=1)
        allele_counts[idx] = new_counts
        pseudo = prior_pseudo[None, :] + new_counts
        log10_af[idx] = np.log10(pseudo / pseudo.sum(axis=1, keepdims=True))
        idx = idx[diff > 0.01]

    # non-candidates keep log10_p = 0 (certainly implausible, prob 0)
    log10_p_no_variant = np.zeros(L)
    if cand.size:
        post = posteriors(gls[:, cand], log10_af[cand])
        log10_p_no_variant[cand] = post[:, :, 0].sum(axis=0)

    phred = -10.0 * log10_p_no_variant + 0.0
    plausible = (log10_p_no_variant + 1e-10) < (stand_min_conf * -0.1)
    emit_ok = phred >= stand_min_conf
    qual_u8 = np.clip(np.trunc(phred), 0, 255)
    prob = 1.0 - 10.0 ** (qual_u8 / -10.0)
    return np.where(plausible & emit_ok, prob, 0.0).astype(np.float32)


def _log10_binom(n, k):
    import math
    return (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)) / np.log(10)


# ---------------------------------------------------------------------------
# Band-pass smoothing + region extraction
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def gaussian_kernel(filter_size: int = MAX_FILTER_SIZE, sigma: float = DEFAULT_SIGMA,
                    adaptive: bool = True) -> np.ndarray:
    def make(fs):
        x = np.arange(2 * fs + 1, dtype=np.float64)
        k = np.exp(-((x - fs) ** 2) / (2 * sigma * sigma)) / (sigma * np.sqrt(2 * np.pi))
        return k / k.sum()

    full = make(filter_size)
    if adaptive:
        middle = (len(full) - 1) // 2
        fe = middle
        while fe > 0:
            if full[fe - 1] < MIN_PROB_TO_KEEP_IN_FILTER:
                break
            fe -= 1
        filter_size = middle - fe
    k = make(filter_size)
    k.setflags(write=False)
    return k


def expand_hq_softclip_states(probs: np.ndarray, hq_sc_mean: np.ndarray,
                              max_prob_propagation: int = 50) -> np.ndarray:
    """The reference's discrete HQ-soft-clip state expansion
    (activity_profile_state.rs:17-27 + activity_profile.rs:308-339): a
    position whose HQ-soft-clip mean is >= 6.0 emits its FULL active_prob
    at every position within +/- n (n = min(floor(mean), propagation)),
    and the emitted states SUM into their neighbours
    (incorporate_single_state :263-289; out-of-profile offsets are
    dropped, not clamped).  Vectorized as a variable-width boxcar scatter
    via a difference array — HQ positions are sparse.  The position's own
    state is replaced by the offset-0 member of the expansion, so its
    probability still counts exactly once at its own locus."""
    hq = np.flatnonzero((hq_sc_mean >= AVERAGE_HQ_SOFTCLIPS_HQ_BASES_THRESHOLD)
                        & (probs > 0.0))
    if hq.size == 0:
        return probs
    n = np.minimum(hq_sc_mean[hq], max_prob_propagation).astype(np.int64)
    p = probs[hq]
    L = probs.size
    delta = np.zeros(L + 1)
    # boxcar [i-n, i+n] intersected with the profile: interval clamping IS
    # the reference's drop-out-of-range behaviour (each in-range position
    # gets p once; nothing is relocated)
    np.add.at(delta, np.maximum(hq - n, 0), p)
    np.add.at(delta, np.minimum(hq + n, L - 1) + 1, -p)
    out = probs.copy()
    out[hq] = 0.0                       # replaced by the expansion's own 0
    out += np.cumsum(delta[:-1])
    return out


def band_pass_smooth(raw_probs: np.ndarray, hq_sc_mean: np.ndarray = None,
                     max_prob_propagation: int = 50) -> np.ndarray:
    """Gaussian band-pass of the raw activity (f32 in, f32 out), after the
    discrete HQ-soft-clip state expansion (see expand_hq_softclip_states;
    band_pass_activity_profile.rs smooths the POST-expansion profile)."""
    kernel = gaussian_kernel()
    probs = raw_probs.astype(np.float64)
    if hq_sc_mean is not None:
        probs = expand_hq_softclip_states(probs, hq_sc_mean,
                                          max_prob_propagation)
    sm = np.convolve(probs, kernel[::-1], mode="same")
    # positions with zero raw prob that receive no mass stay exactly 0
    return sm.astype(np.float32)


@dataclass
class RawRegion:
    start: int        # chunk-relative inclusive
    end: int          # chunk-relative inclusive
    is_active: bool
    activity_density: float


def extract_regions(probs: np.ndarray, active_prob_threshold: float = 0.002,
                    min_region_size: int = 50, max_region_size: int = 300) -> list:
    """Carve the smoothed profile into active/inactive regions
    (activity_profile.rs pop_ready_assembly_regions with force_conversion)."""
    regions = []
    n = len(probs)
    cursor = 0
    flags_all = probs > active_prob_threshold
    while cursor < n:
        window = probs[cursor:]
        is_active = bool(flags_all[cursor])
        # find_first_activity_boundary (bounded window: the full-tail
        # comparison per region was O(n^2) over a chunk)
        limit = min(n - cursor, max_region_size)
        diff = np.nonzero(flags_all[cursor:cursor + limit] != is_active)[0]
        end = int(diff[0]) if diff.size else limit
        if is_active and end == max_region_size:
            end = _find_best_cut_site(window, end, min_region_size)
        if end <= 0:
            break
        seg = window[:end]
        density = float(np.count_nonzero(
            seg > PROBABILITY_TOLERANCE_FOR_DENSITY_CHECK)) / end
        regions.append(RawRegion(cursor, cursor + end - 1, bool(is_active), density))
        cursor += end
    return regions


def _find_best_cut_site(probs, end_of_active_region: int, min_region_size: int) -> int:
    min_i = end_of_active_region - 1
    min_p = np.inf
    i = min_i
    while i >= min_region_size:
        cur = probs[i]
        is_min = (i >= 1 and i != len(probs) - 1
                  and cur <= probs[i + 1] and cur < probs[i - 1])
        if cur < min_p and is_min:
            min_p = cur
            min_i = i
        i -= 1
    return min_i + 1
