"""Read x allele likelihood machinery and the pair-HMM likelihood engine.

Counterpart of lorikeet_tpu/calling/likelihoods.py without its compile-
bucket prewarm (nvcc builds each kernel once, at first use: there is no
per-shape compile to warm); the pool's "remote" leg is parallel/pool.py.
Contracts:
- allele_likelihoods.rs: per-sample [alleles, reads] log10 matrices;
  normalize_likelihoods caps each read's worst value at best + cap (:378-447);
  marginalize takes the max over the haplotypes backing each allele (:633);
  filter_poorly_modeled_evidence drops reads whose best likelihood is below a
  per-read threshold (:925).
- pair_hmm_likelihood_calculation_engine.rs: read quality preparation (cap
  base quals at mapq, fix quals < 18 to 6; ins/del quals default 45 adjusted
  by the conservative PCR error model on STR repeats, floors at 6; gcp 10)
  and the static disqualification threshold
  min(2, ceil(len * 0.001)) * -4.0 (:293-320).

The likelihood values come from the grouped CUDA pair-HMM kernel
(ops.pairhmm_cuda) when ``use_cuda`` is set, escalated through
pairhmm_forward_checked for f32-flushed deep negatives, and from the exact
f64 native host kernel otherwise.  That is the one rule for where a pair
batch runs: every batch of a run on cards goes to the card (a ``-t`` pool
worker's through the parent's device service), and only ``--force-cpu``
(``use_cuda`` False) puts the pair-HMM on the host.
"""
from __future__ import annotations

import functools

import numpy as np

from lorikeet_tpu_torch.ops.pairhmm import (
    pairhmm_forward_checked, pairhmm_forward_f64,
)

DEFAULT_INS_QUAL = 45
DEFAULT_DEL_QUAL = 45
DEFAULT_GCP = 10
MIN_USABLE_Q = 6
BASE_QUALITY_SCORE_THRESHOLD = 18
#: cli.rs expected-mismatch-rate-for-read-disqualification default
EXPECTED_ERROR_RATE_PER_BASE = 0.02
LOG10_QUAL_PER_BASE = -4.0

#: (mean, variance) of the per-base log-qual contribution, indexed by
#: baseQ 1..40 — the dynamic read-disqualification lookup table
#: (pair_hmm_likelihood_calculation_engine.rs:23-41).  Threshold over a
#: read = -(sum(means) + K * sqrt(sum(variances))) / 10.
_DYN_QUAL_MEAN = np.array([
    5.996842844, 5.870018422, 5.401558531, 4.818940919, 4.218758304,
    3.646319832, 3.122346753, 2.654731979, 2.244479156, 1.88893867,
    1.583645342, 1.3233807, 1.102785365, 0.916703025, 0.760361881,
    0.629457387, 0.520175654, 0.42918208, 0.353590663, 0.290923699,
    0.23906788, 0.196230431, 0.160897421, 0.131795374, 0.1078567,
    0.088189063, 0.072048567, 0.058816518, 0.047979438, 0.039111985,
    0.031862437, 0.025940415, 0.021106532, 0.017163711, 0.013949904,
    0.011332027, 0.009200898, 0.007467036, 0.006057179, 0.004911394])
_DYN_QUAL_VAR = np.array([
    0.196616587, 1.388545569, 5.641990128, 10.33176216, 14.25799688,
    17.02880749, 18.64537883, 19.27521677, 19.13584613, 18.43922003,
    17.36842261, 16.07088712, 14.65952563, 13.21718577, 11.80207947,
    10.45304833, 9.194183767, 8.038657241, 6.991779595, 6.053379213,
    5.219610436, 4.484302033, 3.839943445, 3.27839108, 2.791361596,
    2.370765375, 2.008921719, 1.698687797, 1.433525748, 1.207526336,
    1.015402928, 0.852465956, 0.714585285, 0.598145851, 0.500000349,
    0.41742159, 0.348056286, 0.289881373, 0.241163527, 0.200422214])


def dynamic_read_qual_threshold(quals: np.ndarray,
                                dynamic_read_qual_constant: float) -> float:
    """log10 disqualification threshold for one read's (prepared) base quals
    (calculate_log10_dynamic_read_qual_threshold,
    pair_hmm_likelihood_calculation_engine.rs:261-290)."""
    idx = np.clip(quals.astype(np.int64), 1, 40) - 1
    s_mean = float(_DYN_QUAL_MEAN[idx].sum())
    s_var = float(_DYN_QUAL_VAR[idx].sum())
    return (s_mean + dynamic_read_qual_constant * np.sqrt(s_var)) * -0.1
MAX_STR_UNIT_LENGTH = 20
MAX_REPEAT_LENGTH = 100
INITIAL_QSCORE = 40.0

#: --pcr-indel-model -> repeat-cap rate factor (PCRErrorModel, pair_hmm_
#: likelihood_calculation_engine.rs:61-90; the enum discriminant IS the
#: rate factor; None disables the repeat scan entirely, :173-175)
PCR_INDEL_MODELS = {"none": None, "hostile": 1.0, "aggressive": 2.0,
                    "conservative": 3.0}


@functools.lru_cache(maxsize=None)
def _pcr_error_cache(rate_factor: float = 3.0) -> np.ndarray:
    # pair_hmm_likelihood_calculation_engine.rs:169-193 (conservative = 3)
    out = np.empty(MAX_REPEAT_LENGTH + 1, np.uint8)
    for rl in range(MAX_REPEAT_LENGTH + 1):
        out[rl] = max(6, int(INITIAL_QSCORE - np.exp(rl / (rate_factor * np.pi)) + 1.0))
    out.setflags(write=False)
    return out


def _run_end(m: np.ndarray) -> np.ndarray:
    """Consecutive-True run length of m ending at each index (vectorized)."""
    n = len(m)
    if n == 0:
        return np.zeros(0, np.int64)
    idx = np.arange(n)
    last_false = np.maximum.accumulate(np.where(~m, idx, -1))
    return np.where(m, idx - last_false, 0)


def repeat_lengths_vector(bases: np.ndarray) -> np.ndarray:
    """Tandem-repeat length at every offset (native C++ when available)."""
    from lorikeet_tpu_torch.ops.repeats_native import repeat_lengths_native
    out = repeat_lengths_native(bases, MAX_STR_UNIT_LENGTH, MAX_REPEAT_LENGTH)
    if out is None:
        out = _repeat_lengths_vector_np(bases)
    return out


def _repeat_lengths_vector_np(bases: np.ndarray) -> np.ndarray:
    """Tandem-repeat length at every offset, vectorized over positions.

    Exact semantics of find_tandem_repeat_units
    (pair_hmm_likelihood_calculation_engine.rs:528-612), derived as follows:
    with m_s[t] = (bases[t+s] == bases[t]) and r_end/r_start its run lengths,
    the backward repeat count of the size-s unit ending at offset i is
    1 + r_end_s[i-s]//s, the forward count of the unit starting at i+1 is
    1 + r_start_s[i+1]//s, units are equal iff r_end_s[i] >= s, and in the
    unequal case the backward extension of the forward unit is
    r_end_{s_fw}[i] // s_fw.  Cross-checked against the scalar version.
    """
    n = len(bases)
    out = np.zeros(n, np.int64)
    if n < 2:
        return np.minimum(np.ones(n, np.int64), MAX_REPEAT_LENGTH)
    idx = np.arange(n)
    smax = min(MAX_STR_UNIT_LENGTH, n - 1)

    r_end = {}
    r_start = {}
    for s in range(1, smax + 1):
        m = bases[s:] == bases[:-s]
        r_end[s] = _run_end(m)
        r_start[s] = _run_end(m[::-1])[::-1]

    def _gather(arr, pos):
        ok = (pos >= 0) & (pos < len(arr))
        return np.where(ok, arr[np.clip(pos, 0, max(len(arr) - 1, 0))], 0), ok

    NOT_FOUND = 0
    bw_s = np.zeros(n, np.int64)
    bw_count = np.ones(n, np.int64)
    fw_s = np.zeros(n, np.int64)
    fw_count = np.where(idx < n - 1, 1, 0).astype(np.int64)
    for s in range(1, smax + 1):
        re_, ok = _gather(r_end[s], idx - s)
        cnt = np.where(ok & (idx + 1 - s >= 0), 1 + re_ // s, 1)
        hit = (bw_s == NOT_FOUND) & (cnt > 1)
        bw_s[hit] = s
        bw_count[hit] = cnt[hit]

        rs_, okf = _gather(r_start[s], idx + 1)
        tryable = (idx + s + 1 <= n) & (idx < n - 1)
        cntf = np.where(tryable, 1 + np.where(okf, rs_, 0) // s, 0)
        hitf = (fw_s == NOT_FOUND) & tryable & (cntf > 1)
        fw_s[hitf] = s
        fw_count[hitf] = cntf[hitf]

    eff_bw_s = np.where(bw_s == NOT_FOUND, 1, bw_s)
    eff_fw_s = np.where(fw_s == NOT_FOUND, 1, fw_s)
    # units equal iff same size and r_end_s[i] >= s
    re_at_i = np.zeros(n, np.int64)
    for s in range(1, smax + 1):
        sel = eff_bw_s == s
        vals, ok = _gather(r_end[s], idx)
        re_at_i[sel] = vals[sel]
    units_equal = (eff_bw_s == eff_fw_s) & (re_at_i >= eff_bw_s) & (idx + 1 - eff_bw_s >= 0)
    # backward extension of the forward unit (unequal case)
    bw2 = np.zeros(n, np.int64)
    for s in range(1, smax + 1):
        sel = eff_fw_s == s
        vals, ok = _gather(r_end[s], idx)
        bw2[sel] = np.where((idx + 1 - s >= 0), vals // s, 0)[sel]

    has_fw = idx < n - 1
    rl = np.where(has_fw,
                  np.where(units_equal, bw_count + fw_count, fw_count + bw2),
                  bw_count)
    return np.minimum(rl, MAX_REPEAT_LENGTH)


def _repeat_length_at(bases: np.ndarray, offset: int) -> int:
    """Tandem-repeat length around offset (find_tandem_repeat_units, compact)."""
    n = len(bases)
    best_bw = 0
    bw_unit = bases[offset:offset + 1]
    for s in range(1, MAX_STR_UNIT_LENGTH + 1):
        if offset + 1 - s < 0:
            break
        unit = bases[offset + 1 - s:offset + 1]
        reps = _count_reps_backward(bases[:offset + 1], unit)
        if reps > 1:
            best_bw = reps
            bw_unit = unit
            break
        best_bw = max(best_bw, reps) if s == 1 else best_bw
    max_rl = best_bw
    if offset < n - 1:
        fw_unit = bases[offset + 1:offset + 2]
        max_fw = 0
        for s in range(1, MAX_STR_UNIT_LENGTH + 1):
            if offset + s + 1 > n:
                break
            unit = bases[offset + 1:offset + 1 + s]
            reps = _count_reps_forward(bases[offset + 1:], unit)
            if reps > 1:
                max_fw = reps
                fw_unit = unit
                break
            if s == 1:
                max_fw = reps
        if fw_unit.tobytes() == bw_unit.tobytes():
            max_rl = best_bw + max_fw
        else:
            bw2 = _count_reps_backward(bases[:offset + 1], fw_unit)
            max_rl = max_fw + bw2
    return min(max_rl, MAX_REPEAT_LENGTH)


def _count_reps_forward(seq: np.ndarray, unit: np.ndarray) -> int:
    s = len(unit)
    reps = 0
    pos = 0
    while pos + s <= len(seq) and np.array_equal(seq[pos:pos + s], unit):
        reps += 1
        pos += s
    return reps


def _count_reps_backward(seq: np.ndarray, unit: np.ndarray) -> int:
    s = len(unit)
    reps = 0
    pos = len(seq)
    while pos - s >= 0 and np.array_equal(seq[pos - s:pos], unit):
        reps += 1
        pos -= s
    return reps


def prepare_read_for_hmm(rec, disable_cap_to_mapq: bool = False,
                         pcr_rate_factor: float = 3.0,
                         gcp_value: int = DEFAULT_GCP,
                         base_quality_score_threshold: int =
                         BASE_QUALITY_SCORE_THRESHOLD):
    """(bases, quals, ins_quals, del_quals, gcps) after engine preparation.

    Also stashes the prepared base quals on the record as ``hmm_quals``
    (the HMMQuals transient attribute the reference keeps for dynamic read
    disqualification, pair_hmm_likelihood_calculation_engine.rs:268-272)."""
    bases = rec.seq
    quals = rec.qual.astype(np.int64)
    if not disable_cap_to_mapq:
        quals = np.minimum(quals, rec.mapq)
    quals = np.where(quals < base_quality_score_threshold, MIN_USABLE_Q, quals)
    n = len(bases)
    iq = np.full(n, DEFAULT_INS_QUAL, np.int64)
    dq = np.full(n, DEFAULT_DEL_QUAL, np.int64)
    cache = _pcr_error_cache(pcr_rate_factor) \
        if pcr_rate_factor is not None else None
    # PCR error model: cap indel quals by repeat content (vectorized;
    # apply_pcr_error_model caps position i-1 by the repeat length at i-1)
    if cache is not None and n > 1:
        rls = repeat_lengths_vector(bases)[:n - 1]
        caps = cache[rls].astype(np.int64)
        iq[:n - 1] = np.minimum(iq[:n - 1], caps)
        dq[:n - 1] = np.minimum(dq[:n - 1], caps)
    iq = np.where(iq < MIN_USABLE_Q, MIN_USABLE_Q, iq)
    dq = np.where(dq < MIN_USABLE_Q, MIN_USABLE_Q, dq)
    gcp = np.full(n, gcp_value, np.uint8)
    quals = quals.astype(np.uint8)
    rec.hmm_quals = quals
    return (bases, quals, iq.astype(np.uint8), dq.astype(np.uint8), gcp)


def prepare_reads_for_hmm_batch(recs: list, disable_cap_to_mapq: bool = False,
                                pcr_rate_factor: float = 3.0,
                                gcp_value: int = DEFAULT_GCP,
                                base_quality_score_threshold: int =
                                BASE_QUALITY_SCORE_THRESHOLD) -> list:
    """Batched prepare_read_for_hmm over a whole region's reads: one
    concatenated qual/STR pass and one native repeats crossing instead of
    per-read numpy + ctypes calls.  Identical outputs (conformance-tested)."""
    if not recs:
        return []
    n_reads = len(recs)
    lens = np.fromiter((len(r.seq) for r in recs), np.int64, n_reads)
    offs = np.zeros(n_reads + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    total = int(offs[-1])
    quals = np.concatenate([r.qual for r in recs]).astype(np.int64) \
        if total else np.zeros(0, np.int64)
    if not disable_cap_to_mapq:
        mapqs = np.repeat(
            np.fromiter((r.mapq for r in recs), np.int64, n_reads), lens)
        quals = np.minimum(quals, mapqs)
    quals = np.where(quals < base_quality_score_threshold, MIN_USABLE_Q,
                     quals)
    iq = np.full(total, DEFAULT_INS_QUAL, np.int64)
    dq = np.full(total, DEFAULT_DEL_QUAL, np.int64)
    cache = _pcr_error_cache(pcr_rate_factor) \
        if pcr_rate_factor is not None else None
    if cache is not None and total:
        from lorikeet_tpu_torch.ops.repeats_native import repeat_lengths_batch_native
        concat = np.concatenate([r.seq for r in recs])
        rls = repeat_lengths_batch_native(
            concat, offs, MAX_STR_UNIT_LENGTH, MAX_REPEAT_LENGTH)
        if rls is None:
            rls = np.concatenate(
                [_repeat_lengths_vector_np(r.seq) for r in recs])
        caps = cache[rls].astype(np.int64)
        # per read, position i-1 is capped by the repeat length at i-1 and
        # the final offset is exempt (apply_pcr_error_model semantics)
        notlast = np.ones(total, bool)
        notlast[offs[1:] - 1] = False
        iq = np.where(notlast, np.minimum(iq, caps), iq)
        dq = np.where(notlast, np.minimum(dq, caps), dq)
    iq = np.maximum(iq, MIN_USABLE_Q).astype(np.uint8)
    dq = np.maximum(dq, MIN_USABLE_Q).astype(np.uint8)
    quals = np.maximum(quals, 0).astype(np.uint8)
    gcp = np.full(total, gcp_value, np.uint8)
    out = []
    for k, rec in enumerate(recs):
        lo, hi = int(offs[k]), int(offs[k + 1])
        q = quals[lo:hi]
        rec.hmm_quals = q
        out.append((rec.seq, q, iq[lo:hi], dq[lo:hi], gcp[lo:hi]))
    return out


class AlleleLikelihoods:
    """Per-sample log10 likelihood matrices over (alleles x reads)."""

    def __init__(self, alleles: list, reads_by_sample: dict):
        self.alleles = list(alleles)
        self.reads_by_sample = {s: list(v) for s, v in reads_by_sample.items()}
        self.values = {s: np.zeros((len(self.alleles), len(v)))
                       for s, v in self.reads_by_sample.items()}
        self.filtered_reads = {s: [] for s in self.reads_by_sample}

    @property
    def samples(self):
        return sorted(self.reads_by_sample)

    def normalize_likelihoods(self, cap: float, symmetric: bool = True):
        """Cap each read's worst likelihood at best + cap
        (allele_likelihoods.rs:378-447).  ``cap = -inf`` disables.  With
        ``symmetric`` the best may be the reference allele; otherwise only
        alt alleles compete (disable-symmetric-hmm-normalizing)."""
        if cap == -np.inf:
            return
        for s, mat in self.values.items():
            if mat.shape[0] <= 1 or mat.shape[1] == 0:
                continue
            if symmetric:
                best = mat.max(axis=0)
            else:
                non_ref = [i for i, a in enumerate(self.alleles)
                           if not getattr(a, "is_ref", False)]
                best = mat[non_ref].max(axis=0) if non_ref else mat.max(axis=0)
            floor = best + cap
            np.maximum(mat, floor[None, :], out=mat)

    def filter_poorly_modeled_evidence(
            self, dynamic: bool = True,
            dynamic_read_qual_constant: float = 1.0,
            expected_error_rate: float = EXPECTED_ERROR_RATE_PER_BASE):
        """Drop reads whose best likelihood falls below the disqualification
        threshold (allele_likelihoods.rs:925 +
        pair_hmm_likelihood_calculation_engine.rs:226-320).

        Static (``dynamic=False``): min(2, ceil(len*rate)) * -4.
        Dynamic (reference default): min(lookup-table threshold over the
        prepared HMM quals, ceil(len*rate) * -4) — uncapped static arm.
        """
        for s in list(self.reads_by_sample):
            reads = self.reads_by_sample[s]
            mat = self.values[s]
            if not reads:
                continue
            if dynamic:
                lens = np.fromiter((len(r) for r in reads), np.int64,
                                   len(reads))
                static = np.ceil(lens * expected_error_rate) \
                    * LOG10_QUAL_PER_BASE
                # batched dynamic threshold: one concatenated table lookup
                # + segment sums instead of a per-read python round trip
                # (identical to dynamic_read_qual_threshold per read)
                qs = [np.asarray(getattr(r, "hmm_quals", r.qual))
                      for r in reads]
                qlens = np.fromiter((len(q) for q in qs), np.int64, len(qs))
                offs = np.zeros(len(qs) + 1, np.int64)
                np.cumsum(qlens, out=offs[1:])
                if int(offs[-1]):
                    idx = np.clip(np.concatenate(qs).astype(np.int64),
                                  1, 40) - 1
                    # clamp segment starts into range (a trailing empty
                    # read would index past the buffer); empty segments
                    # are zeroed below either way
                    seg = np.minimum(offs[:-1], int(offs[-1]) - 1)
                    s_mean = np.add.reduceat(_DYN_QUAL_MEAN[idx], seg)
                    s_var = np.add.reduceat(_DYN_QUAL_VAR[idx], seg)
                    # reduceat wraps on empty segments; zero them explicitly
                    empty = qlens == 0
                    s_mean[empty] = 0.0
                    s_var[empty] = 0.0
                else:
                    s_mean = np.zeros(len(qs))
                    s_var = np.zeros(len(qs))
                dyn = (s_mean + dynamic_read_qual_constant
                       * np.sqrt(s_var)) * -0.1
                thresholds = np.minimum(static, dyn)
            else:
                thresholds = np.array([
                    min(2.0, np.ceil(len(r) * expected_error_rate))
                    * LOG10_QUAL_PER_BASE for r in reads])
            keep = mat.max(axis=0) >= thresholds
            self.filtered_reads[s] = [r for r, k in zip(reads, keep) if not k]
            self.reads_by_sample[s] = [r for r, k in zip(reads, keep) if k]
            self.values[s] = mat[:, keep]

    def marginalize(self, allele_mapper: dict) -> "AlleleLikelihoods":
        """Haplotype likelihoods -> allele likelihoods via per-read max over
        each allele's haplotypes (allele_likelihoods.rs:633)."""
        new_alleles = list(allele_mapper.keys())
        out = AlleleLikelihoods(new_alleles, self.reads_by_sample)
        for s, mat in self.values.items():
            new_mat = np.full((len(new_alleles), mat.shape[1]), -np.inf)
            for ai, allele in enumerate(new_alleles):
                hap_idx = allele_mapper[allele]
                if hap_idx:
                    new_mat[ai] = mat[hap_idx, :].max(axis=0)
            out.values[s] = new_mat
        return out

    def retain_evidence(self, predicate):
        """Keep only reads passing predicate (overlap window etc.)."""
        for s in list(self.reads_by_sample):
            reads = self.reads_by_sample[s]
            keep = np.array([predicate(r) for r in reads], bool) \
                if reads else np.zeros(0, bool)
            self.reads_by_sample[s] = [r for r, k in zip(reads, keep) if k]
            self.values[s] = self.values[s][:, keep]

    def retain_evidence_masks(self, masks: dict):
        """retain_evidence with a precomputed boolean mask per sample —
        the per-event overlap window reduces to two numpy compares when
        the caller holds pos/end arrays (engine.genotype_region does)."""
        for s in list(self.reads_by_sample):
            reads = self.reads_by_sample[s]
            keep = masks[s]
            if keep.all():
                continue
            self.reads_by_sample[s] = [r for r, k in zip(reads, keep) if k]
            self.values[s] = self.values[s][:, keep]

    def best_allele_per_read(self, sample):
        mat = self.values[sample]
        if mat.size == 0:
            return np.zeros(0, np.int64)
        return mat.argmax(axis=0)


#: "ties" = best within this log10 margin of the runner-up
#: (allele_likelihoods.rs:17 LOG_10_INFORMATIVE_THRESHOLD)
LOG10_INFORMATIVE_THRESHOLD = 0.2


def search_best_alleles(mat: np.ndarray, priorities=None,
                        threshold: float = LOG10_INFORMATIVE_THRESHOLD):
    """Per-read (best_index, likelihood, confidence) for an [A, R] matrix
    with the reference's near-tie priority break
    (allele_likelihoods.rs:457-553 search_best_allele + :1043
    best_alleles_tie_breaking): the likelihood-best allele wins outright
    unless the runner-up is within ``threshold``, in which case the
    highest-``priorities`` allele among ALL candidates within threshold of
    the best takes over (equal priority keeps the likelihood-best; the
    displaced best becomes the runner-up, so an override's confidence goes
    negative).  Reference priority (ref=1, alt=0) reproduces GATK's
    reference-tie preference in AD/BQ; realignment uses
    ref_term + (1 - cigar_elements) (assembly_based_caller_utils.rs:187)."""
    n_alleles, n_reads = mat.shape
    if n_alleles == 0 or n_reads == 0:
        return (np.zeros(n_reads, np.int64), np.full(n_reads, -np.inf),
                np.zeros(n_reads))
    best = mat.argmax(axis=0)                     # first max wins
    best_lk = mat[best, np.arange(n_reads)]
    if n_alleles == 1:
        # runner-up is -inf -> confidence +inf (BestAllele::new semantics)
        return best, best_lk, np.full(n_reads, np.inf)
    masked = mat.copy()
    masked[best, np.arange(n_reads)] = -np.inf
    second = masked.argmax(axis=0)
    second_lk = masked[second, np.arange(n_reads)]
    confidence = np.where(np.abs(best_lk - second_lk) < 2.3e-16, 0.0,
                          best_lk - second_lk)
    if priorities is not None:
        pri = np.asarray(priorities)
        for r in np.flatnonzero(best_lk - second_lk < threshold).tolist():
            # faithful scalar replay of the reference's re-break loop
            b, s = int(best[r]), int(second[r])
            bp, sp = pri[b], pri[s]
            for a in range(n_alleles):
                if a == b or (best_lk[r] - mat[a, r]) > threshold:
                    continue
                if pri[a] > bp:
                    s, b = b, a
                    sp, bp = bp, pri[a]
                elif pri[a] > sp:
                    s, sp = a, pri[a]
            best[r] = b
            lk = mat[b, r]
            slk = mat[s, r] if s != b else -np.inf
            best_lk[r] = lk
            confidence[r] = 0.0 if abs(lk - slk) < 2.3e-16 else lk - slk
    return best, best_lk, confidence


def build_pairs(haplotypes: list, reads_by_sample: dict,
                pcr_rate_factor: float = 3.0,
                gcp_value: int = DEFAULT_GCP,
                base_quality_score_threshold: int =
                BASE_QUALITY_SCORE_THRESHOLD,
                disable_cap_to_mapq: bool = False):
    """Prepared (hap, read...) operand tuples + (sample, allele, read)
    index for every pair."""
    hap_arrays = [np.frombuffer(h.bases, np.uint8) for h in haplotypes]
    pairs = []
    index = []  # (sample, allele_idx, read_idx)
    for s in sorted(reads_by_sample):
        prepped = prepare_reads_for_hmm_batch(
            reads_by_sample[s], pcr_rate_factor=pcr_rate_factor,
            gcp_value=gcp_value,
            base_quality_score_threshold=base_quality_score_threshold,
            disable_cap_to_mapq=disable_cap_to_mapq)
        for r_idx, (bases, q, iq, dq, gcp) in enumerate(prepped):
            for a_idx, hap in enumerate(hap_arrays):
                pairs.append((hap, bases, q, iq, dq, gcp))
                index.append((s, a_idx, r_idx))
    return pairs, index


#: batches dispatched to the device vs the host kernel in this process (a
#: silent device bypass must be visible in the stage split, not inferred
#: from timings); "remote" counts the pool workers' batches that the
#: parent's device service ran (parallel.pool), and "host" includes the
#: workers' own, added as their results come back
DISPATCH_COUNTS = {"device": 0, "host": 0, "remote": 0}


def resolve_use_cuda(use_cuda: bool | None) -> bool:
    """The one rule for where the pair-HMM runs: ``None`` means the card,
    as ``True`` does, and only ``False`` selects the f64 host kernel."""
    return True if use_cuda is None else bool(use_cuda)


def compute_pair_likelihoods(pairs: list, use_cuda: bool = None) -> np.ndarray:
    """log10 likelihood per packed pair.  With ``use_cuda`` (or ``None``,
    which means the same) every batch runs on the grouped kernel, its table
    blocks split over the run's device list (parallel.sharding.get_devices:
    an error when it names a card and there is none), and is then checked
    once by pairhmm_forward_checked; with ``False`` the exact f64 native
    host kernel computes it."""
    if not pairs:
        return np.zeros(0)
    if resolve_use_cuda(use_cuda):
        from lorikeet_tpu_torch.ops.pairhmm_cuda import pairhmm_forward_grouped
        from lorikeet_tpu_torch.parallel.sharding import get_devices
        DISPATCH_COUNTS["device"] += 1
        raw = pairhmm_forward_grouped(pairs, get_devices())
        return pairhmm_forward_checked(raw, pairs)
    DISPATCH_COUNTS["host"] += 1
    return pairhmm_forward_f64(pairs)


def assemble_likelihoods(haplotypes: list, reads_by_sample: dict,
                         lks: np.ndarray, index: list,
                         mismapping_cap: float = -4.5,
                         symmetric: bool = True,
                         dynamic_disqualification: bool = True,
                         dynamic_read_qual_constant: float = 1.0,
                         expected_error_rate: float =
                         EXPECTED_ERROR_RATE_PER_BASE) -> AlleleLikelihoods:
    """Scatter computed pair likelihoods into the per-sample matrices and
    apply normalization (cap = log10 error prob of the phred global read
    mismapping rate, default 45 -> -4.5) + read disqualification."""
    result = AlleleLikelihoods(haplotypes, reads_by_sample)
    for (s, a_idx, r_idx), lk in zip(index, lks):
        result.values[s][a_idx, r_idx] = lk
    result.normalize_likelihoods(mismapping_cap, symmetric)
    result.filter_poorly_modeled_evidence(
        dynamic_disqualification, dynamic_read_qual_constant,
        expected_error_rate)
    return result


def compute_read_likelihoods(haplotypes: list, reads_by_sample: dict,
                             use_cuda: bool = None) -> AlleleLikelihoods:
    """Pair-HMM likelihoods for every (read, haplotype) pair, batched on
    device, with engine-level quality preparation, normalization (cap
    -45/10) and static read disqualification."""
    pairs, index = build_pairs(haplotypes, reads_by_sample)
    if not pairs:
        return AlleleLikelihoods(haplotypes, reads_by_sample)
    lks = compute_pair_likelihoods(pairs, use_cuda)
    return assemble_likelihoods(haplotypes, reads_by_sample, lks, index)
