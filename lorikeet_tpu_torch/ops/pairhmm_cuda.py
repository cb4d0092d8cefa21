"""Pair-HMM forward on a CUDA card, grouped and flat: packers, torch twin,
kernels.

Counterpart of lorikeet_tpu/ops/pairhmm_pallas.py: its grouped path
(``pack_grouped_inputs`` + ``_kernel_grouped`` over ``_dp_sweep``) and its
flat path (``pack_pallas_inputs`` + ``_kernel``, ``pairhmm_forward_pallas``
and ``pairhmm_forward_sharded``).  A region's pairs are the cross product of
its reads and haplotypes, so the grouped packer ships each read and each
haplotype once and a table of blocks drives the sweep: block b runs read
tile ``tile_tab[b]`` (32 read rows) against haplotype row ``hap_tab[b]``.
The flat form is one row per pair: read row p against haplotype row p.

- :func:`prepare_grouped_jobs` builds those tables and planes on the host,
  sized to the work (no fixed dispatch shapes, no pad blocks); it lives in
  ``ops/pairhmm_pack.py``, which imports no torch.
- :func:`pairhmm_sweep_torch` is the plain torch version of the sweep: the
  TPU kernel's ``_dp_sweep`` in torch ops on [rows, Rpad] tensors.
- :func:`pairhmm_grouped_cuda` launches the hand-written kernel
  (``csrc/pairhmm.cu``) for tensors on a CUDA device, and takes the plain
  version only for tensors on the CPU.  It never falls back: a failed build
  or launch raises.
- :func:`enqueue_grouped_jobs` / :func:`readback_grouped` split a batch
  over a list of devices: each takes a contiguous share of the table
  blocks (``parallel.hosts.even_shares``) and the whole read and haplotype
  planes.  Every block is computed alone at the batch's own Rpad and
  Hmax, so each pair's value does not depend on how many devices share
  the batch.
- :func:`pack_flat_inputs`, :func:`pairhmm_flat_torch` and
  :func:`pairhmm_flat_cuda` are the same three for the flat kernel, whose
  pairs run in classes of read length (:func:`flat_classes`), a launch each;
  :func:`pairhmm_forward_flat` is its entry point on padded batch arrays and
  :func:`pairhmm_forward_sharded` splits the pairs over the ranks of a
  ``torch.distributed`` group.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from lorikeet_tpu_torch.device import device_list
from lorikeet_tpu_torch.ops.pairhmm import TRISTATE_CORRECTION
# the grouped packer is numpy only and lives apart, so that a pool worker
# packs its batches without importing torch; its names stay importable here
from lorikeet_tpu_torch.ops.pairhmm_pack import (  # noqa: F401
    GROUP_BLOCK_B, _PLANES, _round_up, prepare_grouped_jobs,
)

# One-hot base-bit encoding.  The N-aware base match ((r == h) | r == N |
# h == N) collapses to one AND + compare when every base maps to a bit and N
# maps to all bits.  IUPAC codes get distinct bits (the reference matches by
# byte equality, not IUPAC intersection); lowercase folds to uppercase; every
# other byte shares one "unknown" bit; byte 0 (padding) maps to no bits.
_BASE_BITS = np.zeros(256, np.int32)
for _i, _ch in enumerate(b"ACGT"):
    _BASE_BITS[_ch] = 1 << _i
for _i, _ch in enumerate(b"RYSWKMBDHVU="):
    _BASE_BITS[_ch] = 1 << (4 + _i)
_BASE_BITS[_BASE_BITS == 0] = 1 << 20
for _ch in range(ord("a"), ord("z") + 1):
    _BASE_BITS[_ch] = _BASE_BITS[_ch - 32]
_BASE_BITS[ord("N")] = _BASE_BITS[ord("n")] = (1 << 21) - 1
_BASE_BITS[0] = 0

#: diagonals per power-of-two renormalisation (8 steps decay at most
#: ~1e-44, above the f32 denormal floor)
GROUP = 8
#: strip widths (read rows a lane) of the flat kernel's column schedule
FLAT_CLASSES = (1, 2, 4, 8, 16)
#: the flat kernel's classes in launch order; 0 holds reads of 512 bases or
#: more, on the anti-diagonal sweep with scratch strips
FLAT_ORDER = FLAT_CLASSES + (0,)

#: kernel launches made by pairhmm_grouped_cuda in this process
LAUNCHES = 0
#: the same launches by position in the device list they ran for
CARD_LAUNCHES = {}
#: kernel launches made by pairhmm_flat_cuda in this process
FLAT_LAUNCHES = 0

_LN10_OVER_M10 = np.float32(-np.log(10.0) / 10.0)
_THIRD = np.float32(1.0 / TRISTATE_CORRECTION)
_LOG10_2 = np.float32(np.log10(2.0))
_FLT_MIN = float(np.finfo(np.float32).tiny)
#: eps of every phred byte, expf(q * f32(-ln10/10)) correctly rounded: the
#: plain version reads it instead of calling torch.exp, so its eps is the
#: same on every device and does not depend on which exp implementation a
#: torch build picks
_EPS_OF_PHRED = np.exp((np.arange(256, dtype=np.float32) * _LN10_OVER_M10)
                       .astype(np.float64)).astype(np.float32)


def to_tensors(arrays: dict, device) -> dict:
    """The packed arrays as tensors on ``device``, plus the base-bit
    table the kernel and the plain version both read.  What is not an
    array (the flat packer's ``groups``) stays on the host as it is."""
    t = {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray)
         else v for k, v in arrays.items()}
    t["base_bits"] = torch.from_numpy(_BASE_BITS).to(device)
    return t


def pairhmm_sweep_torch(t: dict) -> torch.Tensor:
    """Plain torch version of the grouped sweep: f32 [nblocks * 32], one
    value per (block, tile row), on the device of the inputs.  Pad rows
    (read length 0) yield a value that no pair reads."""
    dev = t["quals"].device
    tile = GROUP_BLOCK_B
    rows = (t["tile_tab"].long()[:, None] * tile
            + torch.arange(tile, device=dev)).reshape(-1)
    hrow = t["hap_tab"].long().repeat_interleave(tile)
    return _sweep_rows({p: t[p][rows] for p in _PLANES},
                       t["read_lens"].long()[rows], t["hap_lens"].long()[hrow],
                       t["haps"][hrow], t["base_bits"])


def pairhmm_flat_torch(t: dict) -> torch.Tensor:
    """Plain torch version of the flat sweep: f32 [B], read row p against
    haplotype row p, on the device of the inputs."""
    if t["quals"].shape[0] == 0:
        return torch.zeros(0, dtype=torch.float32, device=t["quals"].device)
    return _sweep_rows({p: t[p] for p in _PLANES}, t["read_lens"].long(),
                       t["hap_lens"].long(), t["haps"], t["base_bits"])


def _sweep_rows(planes: dict, read_lens, hap_lens, haps, lut) -> torch.Tensor:
    """The sweep both plain versions share, one pair per row: the TPU
    kernel's ``_dp_sweep`` written with torch ops on [TB, Rpad] tensors.
    ``planes`` holds the five u8 read planes [TB, Rpad], ``haps`` u8
    [TB, Hmax], ``read_lens`` / ``hap_lens`` int64 [TB].  State shifts are
    ``torch.roll`` along the read axis, the renormalisation exponent is read
    through ``.view(torch.int32)``."""
    f32 = torch.float32
    quals = planes["quals"]
    dev = quals.device
    tb, rpad = quals.shape
    R = read_lens[:, None]                                    # [TB, 1]
    H = hap_lens[:, None]
    hap_bits = lut[haps.long()]                               # [TB, Hmax]
    hmax = hap_bits.shape[1]
    lane = torch.arange(rpad, device=dev)[None, :]
    ok = (lane >= 1) & (lane <= R)
    eps_of_phred = torch.from_numpy(_EPS_OF_PHRED).to(dev)

    def eps_of(name):
        return torch.where(ok, eps_of_phred[planes[name].long()], 0.0)

    eps = eps_of("quals")
    tmi = eps_of("ins_q")
    tmd = eps_of("del_q")
    eg = eps_of("gcp_q")
    tmm = 1.0 - torch.clamp(tmi + tmd, max=1.0)
    tim = 1.0 - eg
    tii = eg
    tdd = eg
    pm = 1.0 - eps
    px = eps * torch.tensor(_THIRD, device=dev)
    rp = torch.where(ok, lut[planes["read_u8"].long()], 0)
    boundary = lane == 0
    is_end_row = lane == R
    b0 = 1.0 / H.clamp(min=1).to(f32)                         # [TB, 1]

    zeros = torch.zeros(tb, rpad, dtype=f32, device=dev)
    no_base = torch.zeros(tb, 1, dtype=torch.int32, device=dev)
    m1 = i1 = sm = si = sd = acc = zeros
    d1 = torch.where(boundary, b0, 0.0)
    hapd = torch.zeros(tb, rpad, dtype=torch.int32, device=dev)
    bval = b0
    ls = torch.zeros(tb, 1, dtype=torch.int32, device=dev)
    roll = lambda x: torch.roll(x, 1, 1)     # noqa: E731
    ndiag = int(((R + H + GROUP - 1) // GROUP * GROUP).max())
    for d in range(1, ndiag + 1):
        # row i on diagonal d meets haplotype base d - i - 1: a shift
        # register fed with hap[d - 1] at the boundary lane
        hapd = roll(hapd)
        hapd[:, :1] = hap_bits[:, d - 1:d] if d - 1 < hmax else no_base
        prior = torch.where((rp & hapd) != 0, pm, px)
        m_new = prior * (sm * tmm + (si + sd) * tim)
        new_sm = roll(m1)
        new_si = roll(i1)
        i_new = new_sm * tmi + new_si * tii
        d_new = torch.where(boundary, bval, m1 * tmd + d1 * tdd)
        j0 = d - R - 1                                         # column - 1
        valid = (j0 >= 0) & (j0 < H) & is_end_row
        acc = acc + torch.where(valid, m_new + i_new, 0.0)
        sm, si, sd = new_sm, new_si, roll(d1)
        m1, i1, d1 = m_new, i_new, d_new
        if d % GROUP == 0:
            interior = torch.maximum(
                m1, torch.maximum(i1, torch.where(boundary, 0.0, d1)))
            peak = torch.maximum(interior.amax(1, keepdim=True),
                                 acc.amax(1, keepdim=True))
            peak = torch.where(peak > 0, peak, 1.0)
            e = (peak.view(torch.int32) >> 23) & 0xFF
            inv = ((254 - e) << 23).view(f32)                  # 2^(127-e)
            m1, i1, d1 = m1 * inv, i1 * inv, d1 * inv
            sm, si, sd = sm * inv, si * inv, sd * inv
            bval = bval * inv
            acc = acc * inv
            ls = ls + (e - 127)
    total = torch.clamp(acc.sum(1), min=_FLT_MIN)
    # log10 in f64 rounded to f32: a correctly rounded log10f
    return (torch.log10(total.double()).to(f32)
            + ls[:, 0].to(f32) * torch.tensor(_LOG10_2, device=dev))


_KERNEL = None


def _kernel() -> ctypes.CDLL:
    global _KERNEL
    if _KERNEL is None:
        from lorikeet_tpu_torch.ops._build import load
        lib = load("pairhmm")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pairhmm_grouped_launch.argtypes = [vp] * 12 + [ci] * 3 + [vp, vp]
        lib.pairhmm_grouped_launch.restype = ci
        lib.pairhmm_scratch_floats.argtypes = [ci, ci]
        lib.pairhmm_scratch_floats.restype = ctypes.c_longlong
        lib.pairhmm_flat_launch.argtypes = [vp] * 12 + [ci] * 5 + [vp, vp]
        lib.pairhmm_flat_launch.restype = ci
        for fn in (lib.pairhmm_flat_scratch_floats,
                   lib.pairhmm_flat_hap_scratch_ints):
            fn.argtypes = [ci, ci, ci, ci]
            fn.restype = ctypes.c_longlong
        _KERNEL = lib
    return _KERNEL


_DTYPES = {"tile_tab": torch.int32, "hap_tab": torch.int32,
           "hap_lens": torch.int32, "read_lens": torch.int32,
           "haps": torch.uint8, "base_bits": torch.int32,
           "order": torch.int32,
           **{p: torch.uint8 for p in _PLANES}}
_GROUPED_NAMES = ("tile_tab", "hap_tab", "hap_lens", *_PLANES, "read_lens",
                  "haps", "base_bits")
_FLAT_NAMES = (*_PLANES, "read_lens", "haps", "hap_lens", "base_bits",
               "order")


def _check_tensors(t: dict, names) -> tuple:
    """Device, dtype, contiguity and plane shapes of the named inputs;
    returns (rows, rpad)."""
    dev = t["quals"].device
    for name in names:
        x, dtype = t[name], _DTYPES[name]
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"pairhmm input {name}: want contiguous {dtype} "
                             f"on {dev}, got {x.dtype} on {x.device}")
    rows, rpad = t["quals"].shape
    for p in _PLANES:
        if t[p].shape != (rows, rpad):
            raise ValueError(f"pairhmm plane {p} shape {tuple(t[p].shape)}")
    if t["read_lens"].shape != (rows,) or t["base_bits"].shape != (256,) \
            or t["haps"].ndim != 2 \
            or t["haps"].shape[0] != t["hap_lens"].shape[0]:
        raise ValueError("pairhmm tables and planes disagree in shape")
    return rows, rpad


def _check_inputs(t: dict) -> None:
    rows, rpad = _check_tensors(t, _GROUPED_NAMES)
    if rpad % 128 or rows % GROUP_BLOCK_B:
        raise ValueError(f"pairhmm planes {tuple(t['quals'].shape)}: rows "
                         f"must be a multiple of {GROUP_BLOCK_B}, Rpad of 128")
    if t["tile_tab"].shape != t["hap_tab"].shape:
        raise ValueError("pairhmm tables and planes disagree in shape")


def _check_flat_inputs(t: dict) -> None:
    rows, rpad = _check_tensors(t, _FLAT_NAMES)
    if rpad % 32 or t["haps"].shape[0] != rows:
        raise ValueError(f"flat pairhmm planes {tuple(t['quals'].shape)}, "
                         f"haps {tuple(t['haps'].shape)}: Rpad must be a "
                         "multiple of 32, one haplotype row per read row")
    groups = t["groups"]
    starts = [0] + [hi for _, _, hi in groups]
    if t["order"].shape != (rows,) or starts[-1] != rows or any(
            k not in FLAT_ORDER or lo != a
            for (k, lo, _), a in zip(groups, starts)):
        raise ValueError(f"flat pairhmm order {tuple(t['order'].shape)} and "
                         f"groups {groups}: the groups must cover the {rows} "
                         "rows in turn, one class of FLAT_ORDER each")


def pairhmm_grouped_cuda(t: dict, card: int = 0) -> torch.Tensor:
    """Grouped forward, f32 [nblocks * 32], on the device of ``t``'s
    tensors: the CUDA kernel for a CUDA device, the plain version
    (:func:`pairhmm_sweep_torch`) for the CPU.  ``card`` is the position
    in the device list the launch runs for (CARD_LAUNCHES)."""
    global LAUNCHES
    dev = t["quals"].device
    if dev.type == "cpu":
        return pairhmm_sweep_torch(t)
    if dev.type != "cuda":
        raise ValueError(f"pairhmm_grouped_cuda: unsupported device {dev}")
    _check_inputs(t)
    lib = _kernel()
    nblocks = t["tile_tab"].numel()
    rpad = t["quals"].shape[1]
    hpad = t["haps"].shape[1]
    out = torch.empty(nblocks * GROUP_BLOCK_B, dtype=torch.float32,
                      device=dev)
    scratch = torch.empty(max(1, lib.pairhmm_scratch_floats(nblocks, rpad)),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pairhmm_grouped_launch(
            *(t[k].data_ptr() for k in _GROUPED_NAMES),
            scratch.data_ptr(), nblocks, rpad, hpad, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pairhmm kernel launch failed on {dev}: CUDA "
                           f"error {rc} (nblocks={nblocks}, Rpad={rpad}, "
                           f"Hmax={hpad})")
    LAUNCHES += 1
    CARD_LAUNCHES[card] = CARD_LAUNCHES.get(card, 0) + 1
    return out


def pairhmm_forward_grouped(pairs, devices) -> np.ndarray:
    """Forward log10 likelihoods (f32 values as float64) [len(pairs)] for a
    flat (hap, read, q, iq, dq, gcp) pair list on ``devices`` (a device or
    a list of them): the host half (:func:`prepare_grouped_jobs`) and the
    device half (:func:`enqueue_grouped_jobs`, :func:`readback_grouped`) in
    turn."""
    if not pairs:
        return np.zeros(0)
    devices = device_list(devices)
    arrays, out_pos = prepare_grouped_jobs(pairs)
    return readback_grouped(enqueue_grouped_jobs(arrays, out_pos, devices))


def enqueue_grouped_jobs(arrays: dict, out_pos: np.ndarray, devices,
                         streams=None) -> tuple:
    """Device half, without waiting.  The table blocks are split over
    ``devices`` (a device or a list of them) in contiguous shares
    (``parallel.hosts.even_shares``, the larger first), and
    device i gets its share of ``tile_tab`` / ``hap_tab`` with the whole
    read and haplotype planes.  For each non-empty share, under device i
    and on ``streams[i]`` (its current stream when None): the copies in
    from pinned memory, the grouped kernel, the copy of the share's values
    back to pinned memory, and an event.  On a CPU device the plain
    version runs at once.  Returns the handle that
    :func:`readback_grouped` waits on."""
    from lorikeet_tpu_torch.parallel.hosts import even_shares
    devices = device_list(devices)
    streams = streams or [None] * len(devices)
    nblocks = arrays["tile_tab"].size
    shares = []
    host = None
    for card, (device, stream, (lo, hi)) in enumerate(zip(
            devices, streams, even_shares(nblocks, len(devices)))):
        if hi == lo:
            continue
        share = {**arrays, "tile_tab": arrays["tile_tab"][lo:hi],
                 "hap_tab": arrays["hap_tab"][lo:hi]}
        if device.type == "cpu":
            shares.append((pairhmm_grouped_cuda(
                to_tensors(share, device), card), None))
            continue
        if host is None:
            host = {k: torch.from_numpy(v).pin_memory()
                    for k, v in arrays.items()}
            host["base_bits"] = torch.from_numpy(_BASE_BITS).pin_memory()
        stream = stream or torch.cuda.current_stream(device)
        # the kernel launches on the current stream of the current device:
        # the copies, the launch and the copy back must all be issued under
        # this device and this stream, or the copy back could race the
        # kernel
        with torch.cuda.device(device), torch.cuda.stream(stream):
            t = {k: (v[lo:hi] if k in ("tile_tab", "hap_tab") else v)
                 .to(device, non_blocking=True) for k, v in host.items()}
            vals = pairhmm_grouped_cuda(t, card)
            out = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
            out.copy_(vals, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        shares.append((out, done))
    return shares, out_pos


def readback_grouped(handle: tuple) -> np.ndarray:
    """Waits for an :func:`enqueue_grouped_jobs` handle: every device's
    share, joined in block order, then each pair's value (f32 as
    float64)."""
    shares, out_pos = handle
    for _, done in shares:
        if done is not None:
            done.synchronize()
    flat = torch.cat([out for out, _ in shares]).numpy()
    return flat[out_pos].astype(np.float64)


# ---- flat: one row per pair ----

def _flat_rank(read_lens) -> np.ndarray:
    """Index into :data:`FLAT_ORDER` of each read length's class."""
    R = np.asarray(read_lens, np.int64)
    return np.searchsorted(32 * np.array(FLAT_CLASSES), R + 1)


def flat_classes(read_lens) -> np.ndarray:
    """The flat kernel's class of each read length: the smallest strip
    width K of :data:`FLAT_CLASSES` with 32 K >= R + 1 (the read's rows and
    the boundary row fill at most 32 lanes), 0 for reads of 512 bases or
    more (scratch strips, the anti-diagonal sweep)."""
    return np.array(FLAT_ORDER)[_flat_rank(read_lens)]


def flat_steps(read_lens, hap_lens, kclass) -> np.ndarray:
    """Steps the flat kernel takes for each pair: H + L - 1 with L =
    ceil((R + 1) / K) lanes in use for class K, R + H diagonals for class 0,
    both rounded up to GROUP."""
    R = np.asarray(read_lens, np.int64)
    H = np.asarray(hap_lens, np.int64)
    k = np.asarray(kclass, np.int64)
    lanes = -(-(R + 1) // np.maximum(k, 1))
    return _round_up(np.where(k > 0, H + lanes - 1, R + H), GROUP)


def pack_flat_inputs(haps, hap_lens, reads, read_lens, quals, ins_quals,
                     del_quals, gcps) -> dict:
    """Padded batch arrays (``pack_pairhmm_batch``'s layout: haps [B, Hmax],
    reads and the four quality planes [B, Rmax], lengths [B]) as the flat
    kernel's operands: the five u8 planes [B, Rpad] with the read at
    columns 1..R (column 0 is the boundary row), ``haps`` u8 [B, Hmax] and
    int32 ``read_lens`` / ``hap_lens`` [B].  Exactly B rows, in input
    order: no slabs, no pad pairs.

    The pairs' schedule: int32 ``order`` [B] lists the rows class by class
    (:func:`flat_classes`, stable), within a class the most steps
    (:func:`flat_steps`) first, so that a launch's last wave holds its
    shortest pairs; ``groups`` is one (K, start, stop) slice of ``order``
    per class present, one kernel launch each."""
    reads = np.asarray(reads, np.uint8)
    B, rmax = reads.shape
    rpad = _round_up(rmax + 1, 32)
    arrays = {}
    for name, src in zip(_PLANES, (quals, ins_quals, del_quals, gcps, reads)):
        plane = np.zeros((B, rpad), np.uint8)
        plane[:, 1:rmax + 1] = np.asarray(src, np.uint8)
        arrays[name] = plane
    arrays["read_lens"] = np.ascontiguousarray(read_lens, np.int32)
    arrays["haps"] = np.ascontiguousarray(haps, np.uint8)
    arrays["hap_lens"] = np.ascontiguousarray(hap_lens, np.int32)
    rank = _flat_rank(arrays["read_lens"])
    steps = flat_steps(arrays["read_lens"], arrays["hap_lens"],
                       np.array(FLAT_ORDER)[rank])
    order = np.lexsort((-steps, rank))
    arrays["order"] = order.astype(np.int32)
    ranks, starts, counts = np.unique(rank[order], return_index=True,
                                      return_counts=True)
    arrays["groups"] = tuple(
        (int(FLAT_ORDER[r]), int(a), int(a + n))
        for r, a, n in zip(ranks, starts, counts))
    return arrays


def pairhmm_flat_cuda(t: dict) -> torch.Tensor:
    """Flat forward, f32 [B] in input order, on the device of ``t``'s
    tensors: the CUDA kernel for a CUDA device, one launch per class of
    ``t["groups"]``; the plain version (:func:`pairhmm_flat_torch`) for the
    CPU."""
    global FLAT_LAUNCHES
    dev = t["quals"].device
    if dev.type == "cpu":
        return pairhmm_flat_torch(t)
    if dev.type != "cuda":
        raise ValueError(f"pairhmm_flat_cuda: unsupported device {dev}")
    _check_flat_inputs(t)
    lib = _kernel()
    npairs, rpad = t["quals"].shape
    hpad = t["haps"].shape[1]
    out = torch.empty(npairs, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for kclass, lo, hi in t["groups"]:
            n = hi - lo
            scratch = torch.empty(max(1, lib.pairhmm_flat_scratch_floats(
                n, rpad, hpad, kclass)), dtype=torch.float32, device=dev)
            hap_scratch = torch.empty(max(1, lib.pairhmm_flat_hap_scratch_ints(
                n, rpad, hpad, kclass)), dtype=torch.int32, device=dev)
            rc = lib.pairhmm_flat_launch(
                *(t[k].data_ptr() for k in _FLAT_NAMES), scratch.data_ptr(),
                hap_scratch.data_ptr(), kclass, lo, n, rpad, hpad,
                out.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(
                    f"flat pairhmm kernel launch failed: CUDA error {rc} "
                    f"(class K={kclass}, {n} pairs, Rpad={rpad}, Hmax={hpad})")
            FLAT_LAUNCHES += 1
    return out


def _forward_flat_tensor(arrays: dict, device) -> torch.Tensor:
    device = torch.device(device)
    if device.type == "cuda":
        from lorikeet_tpu_torch.device import require_cuda
        require_cuda()
    return pairhmm_flat_cuda(to_tensors(arrays, device))


def pairhmm_forward_flat(haps, hap_lens, reads, read_lens, quals, ins_quals,
                         del_quals, gcps, device="cuda") -> np.ndarray:
    """Batched forward log10 likelihoods, f32 [B], of read b against
    haplotype b: the contract of the JAX package's
    ``pairhmm_forward_pallas``.  One kernel launch per read-length class
    present on a CUDA ``device``; the plain version on ``"cpu"``."""
    arrays = pack_flat_inputs(haps, hap_lens, reads, read_lens, quals,
                              ins_quals, del_quals, gcps)
    return _forward_flat_tensor(arrays, device).cpu().numpy()


def rank_share(n: int, group=None) -> tuple:
    """(lo, hi, per, world): this rank's contiguous share [lo, hi) of n
    items, ``per`` = ceil(n / world) items a rank.  World size 1 when
    ``torch.distributed`` has no initialised group."""
    from lorikeet_tpu_torch.parallel.hosts import group_rank_world
    rank, world = group_rank_world(group)
    per = -(-n // world)
    lo = min(n, rank * per)
    return lo, min(n, lo + per), per, world


def pairhmm_forward_sharded(haps, hap_lens, reads, read_lens, quals,
                            ins_quals, del_quals, gcps, device="cuda",
                            group=None) -> np.ndarray:
    """:func:`pairhmm_forward_flat` over the ranks of a ``torch.distributed``
    group: each rank sweeps a contiguous share of the pairs with the flat
    kernel and the shares are gathered in order (``all_gather`` into a
    padded tensor, cut to B), so every rank returns all B values.  With no
    group initialised this is world size 1 and equals
    :func:`pairhmm_forward_flat`."""
    B = len(read_lens)
    lo, hi, per, world = rank_share(B, group)
    local = torch.zeros(per, dtype=torch.float32, device=torch.device(device))
    if hi > lo:
        cut = [np.asarray(a)[lo:hi] for a in (
            haps, hap_lens, reads, read_lens, quals, ins_quals, del_quals,
            gcps)]
        local[:hi - lo] = _forward_flat_tensor(pack_flat_inputs(*cut), device)
    if world == 1:
        return local.cpu().numpy()
    import torch.distributed as dist
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts)[:B].cpu().numpy()
