"""The flat pair-HMM kernel's column schedule, emulated in numpy f32.

``csrc/pairhmm.cu:sweep_cols`` runs one (read, haplotype) pair on a warp:
lane l holds the K read rows ``l * K + k - off`` (k = 0..K-1, ``off = L * K
- R - 1`` slots above the boundary row, L = ceil((R + 1) / K) lanes in use,
so row R is the last slot of lane L - 1) and, at step s, computes column
``j = s - l`` of all of them, top to bottom.  This module repeats that
order step by step, lane by lane and slot by slot, with the kernel's
operands: the strip head's row above arrives from lane l - 1 as the value
that lane computed on the step before (column j) and is kept one more step
as column j - 1; every row of a lane meets haplotype base ``hap_w[s - l -
1]``; the last row's M + I is summed from the fixed slot; and every 8
steps all M/I/D the warp carries (the boundary row's D excluded) and the
sum are scaled by 2^(127 - e).  Reads of 512 bases or more (class 0) run
the anti-diagonal sweep in the kernel, and here the plain version.

It is a test aid, like ``testkit/sw_split.py``, on no path: the CPU tests
hold it against the plain version and the JAX package, so that an index
error of the schedule shows before the kernel runs on a card.  Each
operation is the kernel's, in the kernel's order, without FMA contraction.
"""
from __future__ import annotations

import numpy as np

from lorikeet_tpu_torch.ops import pairhmm_cuda as pc

F32 = np.float32
LANES = 32


def _shfl_up(x: np.ndarray) -> np.ndarray:
    """``__shfl_up_sync(.., x, 1)`` over the lane axis (1): lane 0 keeps its
    own value."""
    up = x.copy()
    up[:, 1:] = x[:, :-1]
    return up


def sweep_cols_np(arrays: dict, rows: np.ndarray, K: int) -> np.ndarray:
    """f32 log10 likelihoods of the pairs ``rows`` of a flat batch
    (:func:`pairhmm_cuda.pack_flat_inputs`' arrays), all of class ``K``,
    in the kernel's column schedule."""
    rows = np.asarray(rows, np.int64)
    P = rows.size
    R = arrays["read_lens"][rows].astype(np.int64)
    H = arrays["hap_lens"][rows].astype(np.int64)
    if np.any(R + 1 > LANES * K):
        raise ValueError(f"a read of {int(R.max())} bases in class K={K}")
    lut = pc._BASE_BITS
    eps_of = pc._EPS_OF_PHRED
    rpad = arrays["quals"].shape[1]
    lane = np.arange(LANES)
    L = (R + K) // K                                        # [P]
    off = L * K - (R + 1)
    i = lane[None, :, None] * K + np.arange(K)[None, None, :] \
        - off[:, None, None]                                # [P, 32, K]
    ok = (i >= 1) & (i <= R[:, None, None])
    cols = np.clip(i, 0, rpad - 1)

    def plane(name):
        return arrays[name][rows[:, None, None], cols]

    def eps(name):
        return np.where(ok, eps_of[plane(name)], F32(0))

    eq, mi, md = eps("quals"), eps("ins_q"), eps("del_q")
    gg = np.where(ok, eps_of[plane("gcp_q")],
                  np.where(i == 0, F32(1), F32(0)))
    pmatch = F32(1) - eq
    pmis = eq * pc._THIRD
    mm = F32(1) - np.minimum(F32(1), mi + md)
    omg = F32(1) - gg
    rb = np.where(ok, lut[plane("read_u8")], 0)
    bval = F32(1) / np.maximum(H, 1).astype(F32)            # [P]
    M = np.zeros((P, LANES, K), F32)
    I = np.zeros_like(M)
    D = np.where(i == 0, bval[:, None, None], F32(0)).astype(F32)
    hm = np.zeros((P, LANES), F32)
    hs = np.zeros_like(hm)
    acc = np.zeros_like(hm)
    ls = np.zeros(P, np.int64)
    end_lane = lane[None, :] == (L - 1)[:, None]            # [P, 32]
    zslot = np.where(lane[None, :] == 0, off[:, None], -1)  # [P, 32]
    hpad = arrays["haps"].shape[1]
    hap_bits = lut[arrays["haps"][rows]] if hpad else np.zeros((P, 1), int)
    nsteps = pc.flat_steps(R, H, np.full(P, K))
    for s in range(1, int(nsteps.max(initial=0)) + 1):
        live = (s <= nsteps)[:, None]                       # [P, 1]
        up_m = _shfl_up(M[:, :, K - 1])
        up_i = _shfl_up(I[:, :, K - 1])
        up_d = _shfl_up(D[:, :, K - 1])
        j = s - lane[None, :]
        in_hap = (j >= 1) & (j <= H[:, None])               # [P, 32]
        hb = np.where(in_hap, np.take_along_axis(
            hap_bits, np.clip(j - 1, 0, hap_bits.shape[1] - 1), 1), 0)
        am = up_m
        ai = np.where(lane[None, :] == 0, F32(0), up_i)
        pm, ps = hm, hs
        new_hm, new_hs = up_m, up_i + up_d
        nM, nI, nD = M.copy(), I.copy(), D.copy()
        for k in range(K):
            prior = np.where((rb[:, :, k] & hb) != 0, pmatch[:, :, k],
                             pmis[:, :, k])
            m_new = prior * (pm * mm[:, :, k] + ps * omg[:, :, k])
            i_new = am * mi[:, :, k] + ai * gg[:, :, k]
            d_new = M[:, :, k] * md[:, :, k] + D[:, :, k] * gg[:, :, k]
            pm, ps = M[:, :, k], I[:, :, k] + D[:, :, k]
            nM[:, :, k], nI[:, :, k], nD[:, :, k] = m_new, i_new, d_new
            am, ai = m_new, i_new
        n_acc = np.where(end_lane & in_hap,
                         acc + (nM[:, :, K - 1] + nI[:, :, K - 1]), acc)
        M = np.where(live[:, :, None], nM, M)
        I = np.where(live[:, :, None], nI, I)
        D = np.where(live[:, :, None], nD, D)
        hm = np.where(live, new_hm, hm)
        hs = np.where(live, new_hs, hs)
        acc = np.where(live, n_acc, acc)
        if s % pc.GROUP == 0:
            dv = np.where(np.arange(K)[None, None, :] == zslot[:, :, None],
                          F32(0), D)
            peak = np.maximum(acc.max(1), np.maximum(
                M, np.maximum(I, dv)).max((1, 2)))
            peak = np.where(peak > 0, peak, F32(1)).astype(F32)
            e = (peak.view(np.int32) >> 23) & 0xFF
            inv = ((254 - e) << 23).astype(np.int32).view(F32)
            scale = np.where(nsteps >= s, inv, F32(1))      # live pairs only
            M = M * scale[:, None, None]
            I = I * scale[:, None, None]
            D = D * scale[:, None, None]
            hm, hs, acc = (x * scale[:, None] for x in (hm, hs, acc))
            ls = ls + np.where(nsteps >= s, e - 127, 0)
    total = np.maximum(acc[np.arange(P), L - 1], F32(pc._FLT_MIN))
    return (np.log10(total.astype(np.float64)).astype(F32)
            + ls.astype(F32) * pc._LOG10_2)


def flat_schedule_forward(arrays: dict) -> np.ndarray:
    """f32 [B] in input order for a flat batch, class by class as the
    kernel's launches run it (``arrays["groups"]``): the column schedule for
    classes 1..16, the plain version's anti-diagonal sweep for class 0."""
    out = np.zeros(arrays["read_lens"].shape[0], F32)
    order = arrays["order"].astype(np.int64)
    for K, lo, hi in arrays["groups"]:
        rows = order[lo:hi]
        if K:
            out[rows] = sweep_cols_np(arrays, rows, K)
        else:
            names = (*pc._PLANES, "read_lens", "haps", "hap_lens")
            t = pc.to_tensors({k: arrays[k][rows] for k in names}, "cpu")
            out[rows] = pc.pairhmm_flat_torch(t).numpy()
    return out
