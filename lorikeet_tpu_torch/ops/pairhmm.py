"""Pair-HMM forward: the exact f64 host reference and the f32 escalation.

The numpy parts of lorikeet_tpu/ops/pairhmm.py, which the JAX package keeps
in a module that imports jax.  Numerics contract (per (read, haplotype)
pair, the log10 total probability of the read arising from the haplotype):

  states M/I/D over (read_len+1) x (hap_len+1); free deletions on row 0
  (D[0,j] = K/hap_len); transition probs per read row i from phred quals:
     mm = 1 - min(1, eps_ins + eps_del); m->i = eps(insQ); m->d = eps(delQ);
     i->m = d->m = 1 - eps(gcp); i->i = d->d = eps(gcp)
  prior[i,j] = 1-eps(q) on base match or either base 'N', else eps(q)/3
  result = log10(sum_j M[end,j] + I[end,j]) - log10(K)

The f32 device kernel (ops/pairhmm_cuda.py) reports rows it may have
flushed; :func:`pairhmm_forward_checked` recomputes them here in f64.
"""
from __future__ import annotations

import numpy as np

TRISTATE_CORRECTION = 3.0
_INITIAL_CONDITION = 2.0 ** 1020
_INITIAL_CONDITION_LOG10 = np.log10(_INITIAL_CONDITION)
_NBASE = ord("N")


def _transition_probs(ins_q: np.ndarray, del_q: np.ndarray, gcp: np.ndarray):
    """Per-read-position transition probabilities, float64.

    Returns (mm, im, mi, ii, md, dd) each of shape [read_len].
    mm uses 1 - min(1, eps_i + eps_d): identical to the reference's
    Jacobian-table path for integer phred scores.
    """
    eps_i = 10.0 ** (np.asarray(ins_q, np.float64) / -10.0)
    eps_d = 10.0 ** (np.asarray(del_q, np.float64) / -10.0)
    eps_g = 10.0 ** (np.asarray(gcp, np.float64) / -10.0)
    mm = 1.0 - np.minimum(1.0, eps_i + eps_d)
    im = 1.0 - eps_g
    return mm, im, eps_i, eps_g, eps_d, eps_g


def pairhmm_forward_np(
    hap: np.ndarray,
    read: np.ndarray,
    quals: np.ndarray,
    ins_quals: np.ndarray,
    del_quals: np.ndarray,
    gcps: np.ndarray,
    use_tristate: bool = True,
) -> float:
    """Exact float64 forward log10-likelihood for one (hap, read) pair.

    Arrays are uint8: hap/read are ASCII bases, quals are raw phred values.
    """
    from scipy.signal import lfilter

    hap = np.asarray(hap, np.uint8)
    read = np.asarray(read, np.uint8)
    H = hap.size
    R = read.size
    mm, im, mi, ii, md, dd = _transition_probs(ins_quals, del_quals, gcps)

    eps = 10.0 ** (np.asarray(quals, np.float64) / -10.0)
    match_p = 1.0 - eps
    mis_p = eps / (TRISTATE_CORRECTION if use_tristate else 1.0)
    # prior[i, j] for i in 1..R, j in 1..H
    is_match = ((read[:, None] == hap[None, :]) | (read[:, None] == _NBASE)
                | (hap[None, :] == _NBASE))
    prior = np.where(is_match, match_p[:, None], mis_p[:, None])

    M = np.zeros((R + 1, H + 1))
    I = np.zeros((R + 1, H + 1))
    D = np.zeros((R + 1, H + 1))
    D[0, :] = _INITIAL_CONDITION / H

    for i in range(1, R + 1):
        M[i, 1:] = prior[i - 1] * (
            M[i - 1, :-1] * mm[i - 1] + (I[i - 1, :-1] + D[i - 1, :-1]) * im[i - 1]
        )
        I[i, 1:] = M[i - 1, 1:] * mi[i - 1] + I[i - 1, 1:] * ii[i - 1]
        # D[i, j] = M[i, j-1]*md + D[i, j-1]*dd : first-order linear recurrence in j
        drive = M[i, :-1] * md[i - 1]
        D[i, 1:] = lfilter([1.0], [1.0, -dd[i - 1]], drive)

    final = np.sum(M[R, 1:]) + np.sum(I[R, 1:])
    return float(np.log10(final) - _INITIAL_CONDITION_LOG10)


# Below this log10 the f32 device kernel may have flushed deep DP cells
# (one per-diagonal scale cannot span >38 decades); mirror GKL's f32->f64
# escalation by recomputing those pairs exactly on the host.
F32_SUSPECT_LOG10 = -28.0

#: rows checked / rows recomputed in f64 by pairhmm_forward_checked in this
#: process (the escalation share a run reports; reset by the caller)
ESCALATIONS = {"checked": 0, "escalated": 0}


def pairhmm_forward_checked(results, pairs):
    """Escalate suspicious f32 results to the exact f64 host path.

    ``results``: np.ndarray [B] from the device kernel; ``pairs``: the packed
    (hap, read, q, iq, dq, gcp) tuples in batch order.  Returns the corrected
    float64 array.
    """
    results = np.asarray(results, np.float64).copy()
    # log10 likelihoods are strictly <= 0: positives, NaNs or infs mean the
    # device path returned garbage for those rows — recompute them exactly
    suspect = np.nonzero((results <= F32_SUSPECT_LOG10) | (results > 0.0)
                         | ~np.isfinite(results))[0]
    ESCALATIONS["checked"] += results.size
    ESCALATIONS["escalated"] += suspect.size
    if suspect.size:
        results[suspect] = pairhmm_forward_f64([pairs[k] for k in suspect])
    return results


def pairhmm_forward_f64(pairs) -> np.ndarray:
    """Exact f64 log10 likelihoods of a pair list: the threaded native
    batch kernel, or per-pair :func:`pairhmm_forward_np` without it."""
    from lorikeet_tpu_torch.ops.pairhmm_native import pairhmm_forward_native_batch
    exact = pairhmm_forward_native_batch(pairs)
    if exact is None:
        exact = np.array([pairhmm_forward_np(*p) for p in pairs])
    return exact


def pack_pairhmm_batch(pairs, r_pad_to=None, h_pad_to=None):
    """Pack a list of (hap, read, q, iq, dq, gcp) uint8-array tuples into
    padded batch arrays (reads/haps padded to the max length, optionally
    rounded up to ``*_pad_to`` multiples)."""
    B = len(pairs)
    Rmax = max(len(p[1]) for p in pairs)
    Hmax = max(len(p[0]) for p in pairs)
    if callable(r_pad_to):
        Rmax = r_pad_to(Rmax)
    elif r_pad_to:
        Rmax = -(-Rmax // r_pad_to) * r_pad_to
    if h_pad_to:
        Hmax = -(-Hmax // h_pad_to) * h_pad_to
    out = {
        "haps": np.zeros((B, Hmax), np.uint8),
        "hap_lens": np.zeros(B, np.int32),
        "reads": np.zeros((B, Rmax), np.uint8),
        "read_lens": np.zeros(B, np.int32),
        "quals": np.zeros((B, Rmax), np.uint8),
        "ins_quals": np.zeros((B, Rmax), np.uint8),
        "del_quals": np.zeros((B, Rmax), np.uint8),
        "gcps": np.zeros((B, Rmax), np.uint8),
    }
    for k, (hap, read, q, iq, dq, gcp) in enumerate(pairs):
        H, R = len(hap), len(read)
        out["haps"][k, :H] = hap
        out["hap_lens"][k] = H
        out["reads"][k, :R] = read
        out["read_lens"][k] = R
        out["quals"][k, :R] = q
        out["ins_quals"][k, :R] = iq
        out["del_quals"][k, :R] = dq
        out["gcps"][k, :R] = gcp
    return out
