"""Batched Smith-Waterman on a CUDA card: packer, plain torch version, kernel.

Counterpart of lorikeet_tpu/ops/sw_pallas.py.  Every (CIGAR, offset) is
bit-identical to lorikeet_tpu.ops.smith_waterman.align, the native aligner.

- :func:`align_batch_cuda` is the batch entry point with the contract of
  ``align_batch_pallas``: the exact-substring shortcut for SOFTCLIP and
  IGNORE, refs longer than :data:`MAX_REF_LEN` on the scalar ``align``,
  every other pair on SW_DEVICE.  :data:`SW_COUNTS` says where each pair
  went.
- :func:`sw_align_torch` is the plain torch version: the TPU kernel's
  anti-diagonal wavefront on [B, R+1] int32 tensors (lane = ref row), then a
  batched traceback by gathers, with the run-length tail on the host.
- :func:`sw_align` runs the hand-written kernel (``csrc/sw.cu``) for tensors
  on a CUDA device and the plain version only for tensors on the CPU.  It
  never falls back: a failed build or launch raises.
- The kernel has two forms, chosen per pair by :func:`sw_form`: a warp per
  pair for alternates up to :data:`WARP_MAX_ALT` bases (every realignment
  pair of short reads) and a CTA per pair for longer ones.
  :func:`pack_pairs` orders the table by form, so a mixed batch is two
  launches, and every result comes back in the caller's order.
- :func:`align_batch_rows` routes a batch as ``align_batch_cuda`` does and
  hands only the kernel's packed chunks to a runner, which gives back each
  chunk's CIGARs in :func:`compact`'s form: a pool worker sends its span's
  haplotype pairs so to the parent's card.  Importing this module loads no
  torch (the functions that need it import it), so those workers use it.
"""
from __future__ import annotations

import ctypes

import numpy as np

from lorikeet_tpu_torch.ops.smith_waterman import (
    MATRIX_MIN_CUTOFF, OverhangStrategy, SWParameters, _CIGAR_OPS, _to_bytes,
    align,
)

#: longest ref the kernel takes: ref_len + 1 rows of 7 int32 of shared
#: memory each must fit the 232,448 bytes a CTA may use on an H100
#: (8192 rows take 229,376).  The TPU kernel's cap was 2047, a VMEM bound.
MAX_REF_LEN = 8191
#: longest alt of the warp form: 32 lanes of at most 16 columns, less one
WARP_MAX_ALT = 511
#: torch device the batched path runs on.  Tests set it to "cpu" to run the
#: kernel's plain torch version through the same path.
SW_DEVICE = "cuda"
#: pairs of align_batch_cuda by route: the batched path (kernel, or plain
#: version on the CPU), the exact-substring shortcut, refs over the cap
SW_COUNTS = {"device": 0, "shortcut": 0, "scalar_long": 0}
#: kernel launches made by sw_align in this process, and the same split by
#: form (a warp per pair for alts up to WARP_MAX_ALT, a CTA per pair above)
SW_LAUNCHES = 0
SW_FORM_LAUNCHES = {"warp": 0, "cta": 0}

#: bytes of kernel scratch per chunk (backtrack slabs); larger batches are
#: split into several chunks
SCRATCH_BUDGET = 1 << 30
#: bytes of the plain version's diagonal-major backtrack tensor per chunk
PLAIN_BT_BUDGET = 1 << 29

#: the host sizes of pack_pairs' arrays that the kernel wrapper allocates
#: and launches from (beside the table and the sequences)
HOST_SIZES = ("n_warp", "rows_max", "warp_max", "cta_max", "scratch_len",
              "cigar_len")

_LOW = -(2 ** 30)        # LOW_INIT of the native aligner
_MIN32 = -(2 ** 31)
_OPS = ("M", "I", "D")   # traceback states 0, 1, 2


def sw_form(ref_len, alt_len):
    """The kernel form a pair takes: "warp" (one warp per pair, the alt's
    columns in registers) or "cta" (one CTA per pair).  Works on ints and on
    numpy arrays (then an array of the two words)."""
    del ref_len                 # both forms take every ref up to the cap
    return np.where(np.asarray(alt_len) <= WARP_MAX_ALT, "warp", "cta")[()]


def warp_strip(alt_len):
    """Alt columns a lane holds in the warp form: 4, 8 or 16."""
    alt_len = np.asarray(alt_len)
    return np.where(alt_len <= 128, 4, np.where(alt_len <= 256, 8, 16))[()]


def _scratch_bytes(ref_len, alt_len):
    """Bytes of kernel scratch per pair, a multiple of 32.  Warp form: the
    int16 backtrack slab [steps][32 lanes][K] with steps = ref_len +
    (alt_len - 1) // K.  CTA form: the int32 backtrack slab plus the last
    column and last row."""
    ref_len, alt_len = np.asarray(ref_len), np.asarray(alt_len)
    k = warp_strip(alt_len)
    warp = (ref_len + (alt_len - 1) // k) * 64 * k
    cta = -(-4 * ((ref_len + 1) * (alt_len + 1) + ref_len + alt_len + 2)
            // 32) * 32
    return np.where(sw_form(ref_len, alt_len) == "warp", warp, cta)[()]


def pack_pairs(pairs) -> dict:
    """(ref, alt) byte pairs as one byte array and an int64 table
    [B, 6] of ref_off, ref_len, alt_off, alt_len, scratch_off (bytes),
    cigar_off, with the warp-form pairs first: row p is pairs[order[p]] and
    the first ``n_warp`` rows take the warp form.  Plus the host sizes the
    kernel wrapper allocates and launches from."""
    refs = [_to_bytes(r) for r, _ in pairs]
    alts = [_to_bytes(a) for _, a in pairs]
    rl = np.fromiter(map(len, refs), np.int64, len(refs))
    al = np.fromiter(map(len, alts), np.int64, len(alts))
    if not pairs:
        raise ValueError("sw: empty batch")
    if rl.min() <= 0 or al.min() <= 0:
        raise ValueError("sw: non-empty sequences required")
    is_cta = sw_form(rl, al) == "cta"
    order = np.argsort(is_cta, kind="stable")
    rl, al = rl[order], al[order]
    n_warp = int(len(order) - is_cta.sum())
    ref_off = np.concatenate([[0], np.cumsum(rl + al)[:-1]])
    alt_off = ref_off + rl
    scratch = _scratch_bytes(rl, al)
    cig = rl + al + 4
    meta = np.stack([ref_off, rl, alt_off, al,
                     np.cumsum(scratch) - scratch, np.cumsum(cig) - cig], 1)
    seqs = np.frombuffer(bytearray().join(
        s for k in order.tolist() for s in (refs[k], alts[k])), np.uint8)
    return {"seqs": seqs, "meta": meta, "order": order, "n_warp": n_warp,
            "rows_max": int(rl.max()) + 1,
            # (ref_len + 1, alt_len) maxima of each form's rows
            "warp_max": (int(rl[:n_warp].max(initial=0)) + 1,
                         int(al[:n_warp].max(initial=0))),
            "cta_max": (int(rl[n_warp:].max(initial=0)) + 1,
                        int(al[n_warp:].max(initial=0))),
            "scratch_len": int(scratch.sum()), "cigar_len": int(cig.sum())}


def to_tensors(arrays: dict, device) -> dict:
    """The packed arrays on ``device`` (host sizes stay as they are): the
    table and the sequences cross in one buffer and one copy, and ``meta``
    and ``seqs`` are views of it.  ``meta_host`` keeps the host's table for
    decoding."""
    import torch
    meta, seqs = arrays["meta"], arrays["seqs"]
    buf = np.empty(meta.nbytes + seqs.nbytes, np.uint8)
    buf[:meta.nbytes] = meta.reshape(-1).view(np.uint8)
    buf[meta.nbytes:] = seqs
    dev = torch.from_numpy(buf).to(device)
    out = {k: v for k, v in arrays.items() if k not in ("meta", "seqs")}
    out["meta"] = dev[:meta.nbytes].view(torch.int64).view(meta.shape)
    out["seqs"] = dev[meta.nbytes:]
    out["meta_host"] = meta
    return out


def _caller_order(t: dict, results: list) -> list:
    """Per-row results of the packed table -> the caller's pair order."""
    out = [None] * len(results)
    for k, r in zip(t["order"].tolist(), results):
        out[k] = r
    return out


def _host_tail(strategy, seg, states, steps, p1, p2):
    """sw.cpp's run-length loop over a walked path (states 0/1/2 and step
    lengths, end to start) and the strategy tail: (cigar, offset)."""
    lce = []
    if seg > 0 and strategy == OverhangStrategy.SOFTCLIP:
        lce.append(("S", seg))
        seg = 0
    state = 0
    for st, n in zip(states, steps):
        if st == state:
            seg += n
        else:
            if seg > 0:
                lce.append((_OPS[state], seg))
            seg, state = n, st
    if strategy == OverhangStrategy.SOFTCLIP:
        lce.append((_OPS[state], seg))
        if p2 > 0:
            lce.append(("S", p2))
        offset = p1
    elif strategy == OverhangStrategy.IGNORE:
        lce.append((_OPS[state], seg + p2))
        offset = p1 - p2
    else:
        lce.append((_OPS[state], seg))
        if p1 > 0:
            lce.append(("D", p1))
        elif p2 > 0:
            lce.append(("I", p2))
        offset = 0
    lce.reverse()
    return lce, offset


def _plain_chunk(seqs, meta, parameters, strategy):
    """DP, start points and traceback of one chunk of pairs (plain torch)."""
    import torch
    i32 = torch.int32
    dev = seqs.device
    w_match, w_mis = parameters.match_value, parameters.mismatch_penalty
    w_open, w_ext = parameters.gap_open_penalty, parameters.gap_extend_penalty
    B = meta.shape[0]
    R = meta[:, 1:2]
    A = meta[:, 3:4]
    rows = int(R.max()) + 1
    ndiag = int((R + A).max())
    lane = torch.arange(rows, device=dev)[None, :]
    last = seqs.numel() - 1
    in_ref = (lane >= 1) & (lane <= R)
    ref = torch.where(in_ref, seqs[(meta[:, 0:1] + lane - 1).clamp(0, last)]
                      .to(i32), -1)
    weight = torch.tensor([w_mis, w_match], dtype=i32, device=dev)
    ramp = strategy in (OverhangStrategy.INDEL, OverhangStrategy.LEADING_INDEL)

    def shift(x, fill):
        """x moved one lane up (row i reads row i-1), ``fill`` at lane 0."""
        out = torch.roll(x, 1, 1)
        out[:, 0] = fill
        return out

    zeros = torch.zeros(B, rows, dtype=i32, device=dev)
    low = torch.full((B, rows), _LOW, dtype=i32, device=dev)
    s1 = s2 = zeros                       # sw on diagonals d-1 and d-2
    bv, gv = low, zeros                   # best_gap_v, its length (d-1)
    bh, gh = low, zeros                   # best_gap_h, its length (per row)
    bt = torch.zeros(B, ndiag + 1, rows, dtype=i32, device=dev)
    last_col = torch.full((B, rows), _MIN32, dtype=i32, device=dev)
    last_row = torch.full((B, ndiag + 1), _MIN32, dtype=i32, device=dev)
    r_idx = R.clamp(max=rows - 1)
    for d in range(1, ndiag + 1):
        j = d - lane
        active = in_ref & (j >= 1) & (j <= A)
        alt = seqs[(meta[:, 2:3] + j - 1).clamp(0, last)].to(i32)
        step_diag = shift(s2, 0) + weight[(ref == alt).long()]
        prev_gap_v = shift(s1, 0) + w_open             # sw(i-1, j) + open
        bv_ext = shift(bv, _LOW) + w_ext
        down = torch.maximum(prev_gap_v, bv_ext)
        kd = torch.where(prev_gap_v > bv_ext, 1, shift(gv, 0) + 1)
        prev_gap_h = s1 + w_open                       # sw(i, j-1) + open
        bh_ext = bh + w_ext
        right = torch.maximum(prev_gap_h, bh_ext)
        ki = torch.where(prev_gap_h > bh_ext, 1, gh + 1)
        # priority diag >= right >= down
        take_diag = (step_diag >= down) & (step_diag >= right)
        take_right = ~take_diag & (right >= down)
        chosen = torch.where(take_diag, step_diag,
                             torch.where(take_right, right, down))
        btr = torch.where(take_diag, 0, torch.where(take_right, -ki, kd))
        new_s = torch.where(active, chosen.clamp(min=MATRIX_MIN_CUTOFF), 0)
        # row 0 (lane 0) and column 0 (lane d) hold the boundary values
        edge = w_open + (d - 1) * w_ext if ramp else 0
        new_s[:, 0] = edge
        if d < rows:
            new_s[:, d] = edge
        bt[:, d] = torch.where(active, btr, 0)
        last_col = torch.where(active & (j == A), new_s, last_col)
        last_row[:, d] = new_s.gather(1, r_idx)[:, 0]
        bv = torch.where(active, down, _LOW)
        gv = torch.where(active, kd, 0)
        bh = torch.where(active, right, _LOW)
        gh = torch.where(active, ki, 0)
        s2, s1 = s1, new_s

    # start point (sw.cpp: best last-column row, later i wins; then unless
    # LEADING_INDEL the last row, greater or equal and closer to the corner)
    R1, A1 = R[:, 0], A[:, 0]
    seg = torch.zeros(B, dtype=torch.int64, device=dev)
    if strategy == OverhangStrategy.INDEL:
        p1, p2 = R1.clone(), A1.clone()
    else:
        col = torch.where(in_ref, last_col, _MIN32)
        m0 = col.amax(1)
        p1 = torch.where(col == m0[:, None], lane, 0).amax(1)
        p2 = A1.clone()
        if strategy != OverhangStrategy.LEADING_INDEL:
            jr = torch.arange(ndiag + 1, device=dev)[None, :] - R   # column j
            cand = (jr >= 1) & (jr <= A)
            rowv = torch.where(cand, last_row, _MIN32)
            mstar = rowv.amax(1)
            cand &= rowv == mstar[:, None]
            big = 1 << 40
            # least distance to the corner, earliest j at equal distance
            key = torch.where(cand, (R - jr).abs() * (ndiag + 2) + jr, big)
            kmin = key.amin(1)
            dstar, jstar = kmin // (ndiag + 2), kmin % (ndiag + 2)
            take = (mstar > m0) | ((mstar == m0) & (dstar < (p1 - p2).abs()))
            p1 = torch.where(take, R1, p1)
            p2 = torch.where(take, jstar, p2)
            seg = torch.where(take, A1 - jstar, seg)

    # batched traceback: one gather per step, every pair at once
    flat = bt.view(B, -1)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    states, steps = [], []
    for it in range(int((p1 + p2).max())):
        if it % 32 == 0 and bool(done.all()):
            break
        at = ((p1 + p2) * rows + p1).clamp(min=0)
        btr = flat.gather(1, at[:, None])[:, 0].long()
        is_del, is_ins = btr > 0, btr < 0
        st = torch.where(is_del, 2, torch.where(is_ins, 1, 0))
        n = torch.where(is_del | is_ins, btr.abs(), 1)
        states.append(torch.where(done, -1, st))
        steps.append(n)
        p1 = torch.where(done | is_ins, p1, p1 - n)
        p2 = torch.where(done | is_del, p2, p2 - n)
        done |= (p1 <= 0) | (p2 <= 0)
    states = torch.stack(states, 1).cpu().numpy()
    steps = torch.stack(steps, 1).cpu().numpy()
    seg, p1, p2 = (x.cpu().numpy() for x in (seg, p1, p2))
    out = []
    for b in range(B):
        k = int(np.argmax(states[b] < 0)) if (states[b] < 0).any() \
            else states.shape[1]
        out.append(_host_tail(strategy, int(seg[b]), states[b, :k].tolist(),
                              steps[b, :k].tolist(), int(p1[b]), int(p2[b])))
    return out


def sw_align_torch(t: dict, parameters: SWParameters,
                   strategy: int) -> list:
    """Plain torch version: (cigar, offset) per packed pair, computed on the
    device of ``t``'s tensors.  Pairs run in chunks whose diagonal-major
    backtrack tensor stays under PLAIN_BT_BUDGET bytes."""
    return _caller_order(t, _plain_rows(t, parameters, strategy))


def _plain_rows(t: dict, parameters: SWParameters, strategy: int) -> list:
    """:func:`sw_align_torch`'s results in table order."""
    import torch
    meta = t["meta"]
    m = meta.cpu().numpy()
    rl, al = m[:, 1], m[:, 3]
    order = np.argsort(rl + al, kind="stable")
    results = [None] * len(order)
    lo = 0
    while lo < len(order):
        hi, rows = lo, 0
        while hi < len(order):
            k = order[hi]     # sorted: this pair has the most diagonals yet
            size = (hi + 1 - lo) * (int(rl[k] + al[k]) + 1) \
                * (max(rows, int(rl[k])) + 1) * 4
            if hi > lo and size > PLAIN_BT_BUDGET:
                break
            rows = max(rows, int(rl[k]))
            hi += 1
        idx = order[lo:hi]
        chunk = _plain_chunk(t["seqs"], meta[torch.from_numpy(idx).to(
            meta.device)], parameters, strategy)
        for k, r in zip(idx, chunk):
            results[k] = r
        lo = hi
    return results


_KERNEL = None


def _kernel() -> ctypes.CDLL:
    global _KERNEL
    if _KERNEL is None:
        from lorikeet_tpu_torch.ops._build import load
        lib = load("sw")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.sw_launch.argtypes = [vp] * 5 + [ci] * 8 + [vp]
        lib.sw_launch.restype = ci
        for fn in (lib.sw_max_rows, lib.sw_warp_max_alt):
            fn.argtypes = []
            fn.restype = ci
        lib.sw_scratch_bytes.argtypes = [ci, ci]
        lib.sw_scratch_bytes.restype = ctypes.c_longlong
        if (lib.sw_max_rows(), lib.sw_warp_max_alt()) != (MAX_REF_LEN + 1,
                                                          WARP_MAX_ALT):
            raise RuntimeError(
                f"csrc/sw.cu takes {lib.sw_max_rows()} rows and alts to "
                f"{lib.sw_warp_max_alt()} on a warp; sw_cuda has "
                f"MAX_REF_LEN {MAX_REF_LEN}, WARP_MAX_ALT {WARP_MAX_ALT}")
        # the slab sizes the packer lays out are the ones the kernel writes
        for ref_len, alt_len in ((1, 1), (600, 128), (600, 129), (77, 256),
                                 (77, 257), (MAX_REF_LEN, WARP_MAX_ALT),
                                 (600, WARP_MAX_ALT + 1), (3, 3000)):
            if lib.sw_scratch_bytes(ref_len, alt_len) != _scratch_bytes(
                    ref_len, alt_len):
                raise RuntimeError(
                    f"csrc/sw.cu and sw_cuda._scratch_bytes disagree at ref "
                    f"{ref_len}, alt {alt_len}")
        _KERNEL = lib
    return _KERNEL


def _check_inputs(t: dict) -> None:
    import torch
    seqs, meta = t["seqs"], t["meta"]
    for name, x, dtype, ndim in (("seqs", seqs, torch.uint8, 1),
                                 ("meta", meta, torch.int64, 2)):
        if x.device != seqs.device or x.dtype != dtype or x.dim() != ndim \
                or not x.is_contiguous():
            raise ValueError(f"sw input {name}: want contiguous {ndim}-d "
                             f"{dtype} on {seqs.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if meta.shape[1] != 6 or meta.shape[0] == 0:
        raise ValueError(f"sw meta shape {tuple(meta.shape)}: want [B>0, 6]")
    if not 2 <= t["rows_max"] <= MAX_REF_LEN + 1:
        raise ValueError(f"sw: ref of {t['rows_max'] - 1} bases, the kernel "
                         f"takes 1..{MAX_REF_LEN}")


def sw_kernel_launch(t: dict, parameters: SWParameters,
                     strategy: int) -> torch.Tensor:
    """Launch csrc/sw.cu on the CUDA tensors of ``t``, once per form present
    in the table: returns one int32 tensor on the card, the [B, 2] (length,
    offset) table of the packed rows followed by the CIGAR codes."""
    import torch
    global SW_LAUNCHES
    dev = t["seqs"].device
    if dev.type != "cuda":
        raise ValueError(f"sw_kernel_launch: tensors on {dev}, want cuda")
    _check_inputs(t)
    lib = _kernel()
    B, n_warp = t["meta"].shape[0], t["n_warp"]
    scratch = torch.empty(t["scratch_len"], dtype=torch.uint8, device=dev)
    out = torch.empty(2 * B + t["cigar_len"], dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for form, lo, hi, (rows_max, alt_max) in (
                ("warp", 0, n_warp, t["warp_max"]),
                ("cta", n_warp, B, t["cta_max"])):
            if hi == lo:
                continue
            # table rows lo.. (6 int64 each), the CIGAR codes behind the
            # 2 * B int32 of (length, offset), and rows lo.. of those
            rc = lib.sw_launch(
                t["seqs"].data_ptr(), t["meta"].data_ptr() + 48 * lo,
                scratch.data_ptr(), out.data_ptr() + 8 * B,
                out.data_ptr() + 8 * lo, hi - lo, rows_max, alt_max,
                parameters.match_value, parameters.mismatch_penalty,
                parameters.gap_open_penalty, parameters.gap_extend_penalty,
                int(strategy), stream)
            if rc != 0:
                raise RuntimeError(
                    f"sw kernel launch failed: CUDA error {rc} (B={hi - lo}, "
                    f"rows={rows_max}, alt={alt_max})")
            SW_LAUNCHES += 1
            SW_FORM_LAUNCHES[form] += 1
    return out


def compact(out: np.ndarray, meta: np.ndarray) -> tuple:
    """The kernel's output on the host -> (the [B, 2] int32 (length,
    offset) of each table row, the rows' CIGAR codes back to back in row
    order): each row's codes cut from the room ``meta`` gave it, by one
    gather."""
    B = meta.shape[0]
    head = out[:2 * B].reshape(B, 2)
    n = head[:, 0].astype(np.int64)
    starts = np.repeat(meta[:, 5] - (np.cumsum(n) - n), n)
    return head, out[2 * B:][starts + np.arange(starts.size)]


def encode_rows(rows: list) -> tuple:
    """(cigar, offset) per table row -> the (head, codes) of
    :func:`compact`, as the kernel would have written them."""
    head = np.array([(len(c), off) for c, off in rows],
                    np.int32).reshape(-1, 2)
    codes = np.array([(n << 4) | _CIGAR_OPS.index(op)
                      for c, _ in rows for op, n in c], np.int32)
    return head, codes


def decode_rows(head: np.ndarray, codes: np.ndarray, order) -> list:
    """:func:`compact`'s (head, codes) -> (cigar, offset) per pair in the
    caller's order (``order``: pack_pairs'), decoded as
    smith_waterman.align decodes the native codes."""
    codes = codes.view(np.uint32).tolist()
    out = [None] * len(order)
    at = 0
    for k, (n, offset) in zip(np.asarray(order).tolist(), head.tolist()):
        out[k] = ([(_CIGAR_OPS[c & 0xF], c >> 4) for c in codes[at:at + n]],
                  offset)
        at += n
    return out


def decode(out: np.ndarray, t: dict) -> list:
    """The kernel's output on the host -> (cigar, offset) per pair in the
    caller's order, decoded as smith_waterman.align decodes the native
    codes."""
    return decode_rows(*compact(out, t["meta_host"]), t["order"])


def sw_align_rows(t: dict, parameters: SWParameters, strategy: int) -> tuple:
    """:func:`sw_align` in the form of :func:`compact` (rows in table
    order): the kernel's output cut to its CIGARs on a CUDA device (one
    copy back), the plain version's results encoded on the CPU."""
    dev = t["seqs"].device
    if dev.type == "cpu":
        return encode_rows(_plain_rows(t, parameters, strategy))
    if dev.type != "cuda":
        raise ValueError(f"sw_align_rows: unsupported device {dev}")
    return compact(sw_kernel_launch(t, parameters, strategy).cpu().numpy(),
                   t["meta_host"])


def sw_align(t: dict, parameters: SWParameters, strategy: int) -> list:
    """(cigar, offset) per pair, in the order ``pack_pairs`` was given, on
    the device of ``t``'s tensors: the CUDA kernel for a CUDA device (one
    copy back: lengths, offsets and CIGAR codes in one buffer), the plain
    version (:func:`sw_align_torch`) for the CPU."""
    return decode_rows(*sw_align_rows(t, parameters, strategy), t["order"])


def chunk_runner(device, parameters: SWParameters, strategy: int):
    """The ``run_chunks`` of :func:`align_batch_rows` that runs each chunk
    on ``device`` in this process."""
    return lambda chunks: [sw_align_rows(to_tensors(c, device), parameters,
                                         strategy) for c in chunks]


def split_batch(pairs, parameters: SWParameters,
                overhang_strategy: int = OverhangStrategy.SOFTCLIP,
                counts=None) -> tuple:
    """align_batch_cuda's routes, on the host: (the results, the
    exact-substring shortcut's and the scalar ``align``'s of refs over
    MAX_REF_LEN filled in and None elsewhere, the chunks [(indices into
    ``pairs``, pack_pairs' arrays)] of the pairs for the kernel, each under
    SCRATCH_BUDGET bytes of scratch).  Counts each route in ``counts``
    (SW_COUNTS' keys) where given."""
    if counts is None:
        counts = dict.fromkeys(SW_COUNTS, 0)
    results = [None] * len(pairs)
    todo = []
    for k, (ref, alt) in enumerate(pairs):
        ref_b, alt_b = _to_bytes(ref), _to_bytes(alt)
        assert ref_b and alt_b, "non-empty sequences required"
        if overhang_strategy in (OverhangStrategy.SOFTCLIP,
                                 OverhangStrategy.IGNORE):
            idx = ref_b.rfind(alt_b)
            if idx >= 0:
                counts["shortcut"] += 1
                results[k] = ([("M", len(alt_b))], idx)
                continue
        if len(ref_b) > MAX_REF_LEN:
            counts["scalar_long"] += 1
            results[k] = align(ref_b, alt_b, parameters, overhang_strategy)
            continue
        todo.append((k, ref_b, alt_b))
    counts["device"] += len(todo)
    chunks = []
    lo = 0
    while lo < len(todo):
        hi, used = lo, 0
        while hi < len(todo):
            need = int(_scratch_bytes(len(todo[hi][1]), len(todo[hi][2])))
            if hi > lo and used + need > SCRATCH_BUDGET:
                break
            used += need
            hi += 1
        chunk = todo[lo:hi]
        chunks.append(([k for k, _, _ in chunk],
                       pack_pairs([(r, a) for _, r, a in chunk])))
        lo = hi
    return results, chunks


def align_batch_rows(pairs, parameters: SWParameters, overhang_strategy: int,
                     run_chunks, counts=None) -> tuple:
    """align_batch_cuda with the kernel's chunks handed to
    ``run_chunks([pack_pairs' arrays])``, which returns
    :func:`sw_align_rows`' (head, codes) for each: where the batch goes
    to another process, only the arrays travel.  Numpy only.  Each route
    is counted in ``counts`` where given.  Returns (the results, the pairs
    the chunks held)."""
    results, chunks = split_batch(pairs, parameters, overhang_strategy,
                                  counts)
    if chunks:
        for (idx, arrays), (head, codes) in zip(
                chunks, run_chunks([a for _, a in chunks])):
            for k, res in zip(idx, decode_rows(head, codes,
                                                arrays["order"])):
                results[k] = res
    return results, sum(len(idx) for idx, _ in chunks)


def align_batch_cuda(pairs, parameters: SWParameters,
                     overhang_strategy: int = OverhangStrategy.SOFTCLIP,
                     device=None) -> list:
    """(cigar, offset) per (reference, alternate) pair, bit-identical to
    smith_waterman.align.  The batched pairs run on ``device`` (default
    SW_DEVICE) in chunks of at most SCRATCH_BUDGET bytes of scratch."""
    import torch
    device = torch.device(SW_DEVICE if device is None else device)
    if device.type == "cuda":
        from lorikeet_tpu_torch.device import require_cuda
        require_cuda()
    return align_batch_rows(
        pairs, parameters, overhang_strategy,
        chunk_runner(device, parameters, overhang_strategy), SW_COUNTS)[0]
