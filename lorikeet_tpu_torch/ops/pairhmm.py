"""Pair-HMM forward: the exact f64 host reference, the batched wavefront
and the f32 escalation.

Counterpart of lorikeet_tpu/ops/pairhmm.py.  Numerics contract (per (read,
haplotype) pair, the log10 total probability of the read arising from the
haplotype):

  states M/I/D over (read_len+1) x (hap_len+1); free deletions on row 0
  (D[0,j] = K/hap_len); transition probs per read row i from phred quals:
     mm = 1 - min(1, eps_ins + eps_del); m->i = eps(insQ); m->d = eps(delQ);
     i->m = d->m = 1 - eps(gcp); i->i = d->d = eps(gcp)
  prior[i,j] = 1-eps(q) on base match or either base 'N', else eps(q)/3
  result = log10(sum_j M[end,j] + I[end,j]) - log10(K)

The f32 device kernel (ops/pairhmm_cuda.py) reports rows it may have
flushed; :func:`pairhmm_forward_checked` recomputes them here in f64.
:func:`pairhmm_forward_batch` is the JAX package's ``lax.scan`` wavefront
(renormalised by 1/peak on every diagonal) as plain torch ops; torch is
imported inside it, so the numpy-only pool workers that import this module
never load it.
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


def pairhmm_forward_batch(
    haps,       # [B, Hmax] uint8 bases (pad value arbitrary != 'N')
    hap_lens,   # [B] int32
    reads,      # [B, Rmax] uint8 bases
    read_lens,  # [B] int32
    quals,      # [B, Rmax] uint8 phred base quals
    ins_quals,  # [B, Rmax] uint8
    del_quals,  # [B, Rmax] uint8
    gcps,       # [B, Rmax] uint8
    unroll: int = 1,
    device=None,
):
    """Batched forward log10-likelihoods, a [B] float32 tensor on ``device``.

    Wavefront over anti-diagonals d = i + j, one loop step each; the state
    vectors are indexed by read position i (lanes 0..Rmax, lane 0 the
    boundary row) and every diagonal is divided by its interior peak, as
    the JAX package's ``_pairhmm_jit`` does.  Inputs are numpy arrays or
    tensors.  ``device`` None means the inputs' device when ``haps`` is a
    tensor, else the card (an error without one); ``"cpu"`` runs on the
    host.  ``unroll`` is the JAX signature's scan unroll, which a Python
    loop has no use for.
    """
    import torch

    from lorikeet_tpu_torch.device import require_cuda

    del unroll
    if device is None:
        device = haps.device if torch.is_tensor(haps) else require_cuda()
    device = torch.device(device)

    def tensor(x, dtype):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               device=device).to(dtype)

    u8, i32, f32 = torch.uint8, torch.int32, torch.float32
    haps, reads = tensor(haps, u8), tensor(reads, u8)
    hap_lens, read_lens = tensor(hap_lens, i32), tensor(read_lens, i32)
    B, Rmax = reads.shape
    Hmax = haps.shape[1]

    def eps(q):
        return torch.pow(10.0, tensor(q, f32) / -10.0)

    def pad1(x):  # [B, Rmax] -> [B, Rmax + 1], lane 0 (boundary row) zero
        return torch.nn.functional.pad(x, (1, 0))

    e, eps_i, eps_d, eps_g = eps(quals), eps(ins_quals), eps(del_quals), \
        eps(gcps)
    t_mm = pad1(1.0 - torch.clamp(eps_i + eps_d, max=1.0))
    t_im = pad1(1.0 - eps_g)
    t_mi, t_ii, t_md = pad1(eps_i), pad1(eps_g), pad1(eps_d)
    t_dd = t_ii
    p_match = pad1(1.0 - e)
    p_mis = pad1(e / TRISTATE_CORRECTION)
    read_pad = pad1(reads)
    read_n = read_pad == _NBASE

    lane = torch.arange(Rmax + 1, device=device)
    boundary = (lane == 0)[None, :]
    is_end_row = lane[None, :] == read_lens[:, None]
    b0 = (1.0 / hap_lens.to(f32))[:, None]

    def shift(x):  # out[:, i] = x[:, i - 1], out[:, 0] = 0
        return torch.nn.functional.pad(x[:, :-1], (1, 0))

    zeros = torch.zeros((B, Rmax + 1), dtype=f32, device=device)
    m1, i1, d1 = zeros, zeros, torch.where(boundary, b0, zeros)
    m2, i2, d2 = zeros, zeros, zeros
    hap_diag = torch.zeros((B, Rmax + 1), dtype=u8, device=device)
    bval, acc = b0, zeros
    log10_scale = torch.zeros(B, dtype=f32, device=device)
    for d in range(1, Rmax + Hmax + 1):
        # lane i holds hap[d - i - 1]; hap[d - 1] enters at lane 0 (clipped
        # past Hmax: those cells are masked out of the sum)
        hap_diag = torch.cat([haps[:, min(d - 1, Hmax - 1), None],
                              hap_diag[:, :-1]], dim=1)
        match = (read_pad == hap_diag) | read_n | (hap_diag == _NBASE)
        prior = torch.where(match, p_match, p_mis)
        m_new = prior * (shift(m2) * t_mm + (shift(i2) + shift(d2)) * t_im)
        i_new = shift(m1) * t_mi + shift(i1) * t_ii
        d_new = m1 * t_md + d1 * t_dd
        # row 0: M = I = 0, D the boundary value
        m_new = m_new.masked_fill(boundary, 0.0)
        i_new = i_new.masked_fill(boundary, 0.0)
        d_new = torch.where(boundary, bval, d_new)
        # the last read row's M + I for j = d - read_len in [1, hap_len]
        j_here = d - read_lens
        valid = ((j_here >= 1) & (j_here <= hap_lens))[:, None] & is_end_row
        acc = acc + torch.where(valid, m_new + i_new, zeros)
        # divide the live state by the diagonal's interior peak (the
        # boundary row left out; see the JAX package's _pairhmm_jit)
        interior = torch.maximum(m_new, torch.maximum(
            i_new, d_new.masked_fill(boundary, 0.0)))
        peak = torch.maximum(interior.amax(dim=1, keepdim=True),
                             acc.amax(dim=1, keepdim=True))
        scale = torch.where(peak > 0, peak, torch.ones_like(peak))
        inv = 1.0 / scale
        m2, i2, d2 = m1 * inv, i1 * inv, d1 * inv
        m1, i1, d1 = m_new * inv, i_new * inv, d_new * inv
        acc = acc * inv
        bval = bval * inv
        log10_scale = log10_scale + torch.log10(scale[:, 0])
    total = acc.sum(dim=1)
    return torch.log10(torch.clamp(total, min=torch.finfo(f32).tiny)) \
        + log10_scale


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
