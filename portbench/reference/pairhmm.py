"""The pair-HMM forward likelihood in plain PyTorch, for any floating type.

The model of GATK's PairHMM (Li and Durbin's profile HMM as GATK writes
it; Poplin et al. 2018, "Scaling accurate genetic variant discovery to
tens of thousands of samples"), with the transition rules that the port
documents for its kernels: for read base i with base quality q, insertion
quality iq, deletion quality dq and gap continuation penalty g, each a
Phred value p giving 10^(-p/10),

    prior     = 1 - e(q) where read and haplotype bases match, e(q)/3 else
                (N matches every base; other bytes match by equality)
    M[i][j]   = prior * ((1 - min(e(iq) + e(dq), 1)) M[i-1][j-1]
                         + (1 - e(g)) (I[i-1][j-1] + D[i-1][j-1]))
    I[i][j]   = e(iq) M[i-1][j] + e(g) I[i-1][j]
    D[i][j]   = e(dq) M[i][j-1] + e(g) D[i][j-1]
    D[0][j]   = 1 / H for j = 0 .. H; the rest of row 0 and column 0 is 0
    result    = log10 sum_j (M[R][j] + I[R][j])

computed anti-diagonal by anti-diagonal over a batch of pairs, each
diagonal rescaled by a power of two so that no type underflows.  Imports
nothing of the program: it is handed bases and qualities and nothing the
program derived from them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

#: byte classes of the base comparison: A C G T by letter (either case),
#: every other letter by itself, N and n match everything (class -1)
_CLASS = np.arange(256, dtype=np.int64)
_CLASS[np.arange(ord("a"), ord("z") + 1)] -= 32
_CLASS[[ord("N"), ord("n")]] = -1


def _phred(values: np.ndarray) -> np.ndarray:
    return 10.0 ** (-values.astype(np.float64) / 10.0)


def forward_log10(pairs: list, dtype=torch.float64, device="cpu",
                  chunk: int = 2048) -> np.ndarray:
    """log10 likelihood (float64 [len(pairs)]) of each (hap, read, q, iq,
    dq, gcp) pair of u8 arrays, computed in ``dtype`` on ``device``: pairs
    of similar size go in one batch of at most ``chunk``."""
    out = np.empty(len(pairs))
    size = np.array([len(p[0]) + len(p[1]) for p in pairs])
    order = np.argsort(size, kind="stable")
    for lo in range(0, len(pairs), chunk):
        idx = order[lo:lo + chunk]
        out[idx] = _batch([pairs[k] for k in idx], dtype, device)
    return out


def _pad(rows: list, width: int, fill=0) -> np.ndarray:
    out = np.full((len(rows), width), fill, np.asarray(rows[0]).dtype)
    for k, r in enumerate(rows):
        out[k, :len(r)] = r
    return out


def _batch(pairs: list, dtype, device) -> np.ndarray:
    n = len(pairs)
    R = np.array([len(p[1]) for p in pairs])
    H = np.array([len(p[0]) for p in pairs])
    rmax, hmax = int(R.max()), int(H.max())

    def per_row(k):                    # [n, rmax + 1], row 0 unused
        v = np.zeros((n, rmax + 1))
        v[:, 1:] = _pad([_phred(np.asarray(p[k])) for p in pairs], rmax)
        return v

    e_q, e_i, e_d, e_g = per_row(2), per_row(3), per_row(4), per_row(5)

    def t(v):
        return torch.as_tensor(v, device=device).to(dtype)

    match, mismatch = t(1.0 - e_q), t(e_q / 3.0)
    mm = t(1.0 - np.minimum(e_i + e_d, 1.0))
    gm = t(1.0 - e_g)
    mi, md, gg = t(e_i), t(e_d), t(e_g)
    read_cls = np.full((n, rmax + 1), -2, np.int64)
    read_cls[:, 1:] = _pad([_CLASS[np.asarray(p[1])] for p in pairs], rmax,
                           -2)
    hap_cls = _pad([_CLASS[np.asarray(p[0])] for p in pairs], hmax, -3)
    read_cls = torch.as_tensor(read_cls, device=device)
    # haplotype base of row i on diagonal d is hap[d - i - 1]: read it
    # from a reversed, padded copy with one slice a diagonal
    pad = rmax + 1
    hap_rev = torch.full((n, hmax + 2 * pad), -3, dtype=torch.int64,
                         device=device)
    hap_rev[:, pad:pad + hmax] = torch.as_tensor(hap_cls[:, ::-1].copy(),
                                                 device=device)
    rows = torch.arange(rmax + 1, device=device)
    Rt = torch.as_tensor(R, device=device)
    Ht = torch.as_tensor(H, device=device)
    zero = torch.zeros((n, rmax + 1), dtype=dtype, device=device)
    boundary = (1.0 / Ht.to(torch.float64)).to(dtype)
    m1, i1, d1 = zero, zero, zero.clone()     # diagonal d - 1
    d1[:, 0] = boundary                       # D[0][0]
    m2, i2, d2 = zero, zero, zero             # diagonal d - 2
    acc = torch.zeros(n, dtype=dtype, device=device)
    log2_scale = torch.zeros(n, dtype=torch.float64, device=device)
    shift = lambda x: torch.nn.functional.pad(x[:, :-1], (1, 0))  # noqa
    for d in range(1, rmax + hmax + 1):
        j = d - rows                                   # column of row i
        # hap index d - i - 1 = (hmax - 1 - (d - i - 1)) in the reversed
        # copy, offset by pad
        lo = pad + hmax - d
        hb = hap_rev[:, lo:lo + rmax + 1]
        same = (read_cls == hb) | (read_cls == -1) | (hb == -1)
        prior = torch.where(same, match, mismatch)
        m = prior * (mm * shift(m2) + gm * (shift(i2) + shift(d2)))
        i = mi * shift(m1) + gg * shift(i1)
        dd = md * m1 + gg * d1
        live = (j >= 1)[None, :] & (rows >= 1)[None, :]
        m = torch.where(live, m, 0.0)
        i = torch.where(live, i, 0.0)
        dd = torch.where(live, dd, 0.0)
        dd[:, 0] = torch.where(d <= Ht, boundary, 0.0)
        end = (Rt[:, None] == rows[None, :]) & ((d - rows) <= Ht[:, None])
        acc = acc + torch.where(end & live, m + i, 0.0).sum(1)
        m2, i2, d2, m1, i1, d1 = m1, i1, d1, m, i, dd
        peak = torch.stack([m1.amax(1), i1.amax(1), d1.amax(1), m2.amax(1),
                            i2.amax(1), d2.amax(1), acc]).amax(0)
        _, e = torch.frexp(peak.float())
        e = torch.where(peak > 0, e, 0)
        f = torch.ldexp(torch.ones_like(peak), -e.to(dtype))[:, None]
        m1, i1, d1, m2, i2, d2 = (x * f for x in (m1, i1, d1, m2, i2, d2))
        acc = acc * f[:, 0]
        boundary = boundary * f[:, 0]
        log2_scale += e.double()
    total = acc.double().cpu().numpy()
    with np.errstate(divide="ignore"):
        return np.log10(total) + log2_scale.cpu().numpy() * math.log10(2.0)
