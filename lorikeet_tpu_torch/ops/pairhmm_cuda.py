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
- A job the packer encoded in the wire form (``arrays["mode"] ==
  "wire"``, ``ops/pairhmm_pack.py:_compress_dispatch``) is decoded on each
  device of the list before the grouped kernel runs there:
  :func:`wire_decode_torch` is the plain version, :func:`wire_decode_cuda`
  launches ``wire_decode_kernel`` (the decode of the JAX package's
  ``_grouped_wire_call``).  ``LORIKEET_WIRE_COMPRESS`` (``auto``, ``1``,
  ``0``) decides whether the parent packs its own batches so
  (:func:`_wire_enabled`: under ``auto``, when the measured host-to-card
  rate, :func:`_link_bps`, is below 2 GB/s), and a pool's workers theirs.
- :func:`pack_flat_inputs`, :func:`pairhmm_flat_torch` and
  :func:`pairhmm_flat_cuda` are the same three for the flat kernel, whose
  pairs run in classes of read length (:func:`flat_classes`), a launch each;
  :func:`pairhmm_forward_flat` is its entry point on padded batch arrays and
  :func:`pairhmm_forward_sharded` splits the pairs over the ranks of a
  ``torch.distributed`` group.
"""
from __future__ import annotations

import ctypes
import os
import time

import numpy as np
import torch

from lorikeet_tpu_torch.device import device_list
from lorikeet_tpu_torch.ops.pairhmm import TRISTATE_CORRECTION
# the grouped packer is numpy only and lives apart, so that a pool worker
# packs its batches without importing torch; its names stay importable here
from lorikeet_tpu_torch.ops.pairhmm_pack import (  # noqa: F401
    GROUP_BLOCK_B, WIRE_NAMES, _PLANES, _round_up, grouped_strip,
    prepare_grouped_jobs, row_width, useful_cells,
)
from lorikeet_tpu_torch.utils.progress import global_stage

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
#: kernel launches made by wire_decode_cuda in this process
WIRE_LAUNCHES = 0
#: grouped jobs enqueued in this process by the form they came in: a job
#: whose values overflow the wire tables comes flat (a mode, not a fallback)
WIRE_COUNTS = {"wire": 0, "flat": 0}
#: the measured host-to-card rate, bytes/s (None: not measured yet)
_LINK_BPS = [None]

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


def _tensor(v: np.ndarray) -> torch.Tensor:
    """A host array as a tensor; u32 (the wire codebook) as its int32 view,
    which every torch build moves and indexes."""
    return torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)


def to_tensors(arrays: dict, device) -> dict:
    """The packed arrays as tensors on ``device``, plus the base-bit
    table the kernel and the plain version both read.  What is not an
    array (the flat packer's ``groups``, a grouped job's ``mode``) stays on
    the host as it is."""
    t = {k: _tensor(v).to(device) if isinstance(v, np.ndarray) else v
         for k, v in arrays.items()}
    t["base_bits"] = torch.from_numpy(_BASE_BITS).to(device)
    return t


def _wire_enabled() -> bool:
    """Whether the parent packs its own grouped batches, and a pool it
    starts has its workers pack theirs, in the wire form:
    ``LORIKEET_WIRE_COMPRESS`` 1 / 0 forces it on / off; ``auto`` (the
    default) turns it on when the measured host-to-card rate is below
    2 GB/s, the JAX package's crossover."""
    mode = os.environ.get("LORIKEET_WIRE_COMPRESS", "auto")
    if mode == "auto":
        bps = _link_bps()
        return bool(bps) and bps < 2e9
    return mode != "0"


def _link_bps() -> float:
    """The host-to-card rate in bytes/s, measured once a process: a 4 MB
    copy from pageable host memory to the first card of the device list,
    best of 2.  0.0 when the process has no card (the rate is moot)."""
    if _LINK_BPS[0] is None:
        rate = 0.0
        if torch.cuda.is_available():
            from lorikeet_tpu_torch.parallel.sharding import get_devices
            cards = [d for d in get_devices() if d.type == "cuda"]
            if cards:
                buf = torch.zeros(4 << 20, dtype=torch.uint8)
                best = float("inf")
                for _ in range(2):
                    torch.cuda.synchronize(cards[0])
                    t0 = time.perf_counter()
                    buf.to(cards[0])
                    torch.cuda.synchronize(cards[0])
                    best = min(best, time.perf_counter() - t0)
                rate = buf.numel() / max(best, 1e-6)
        _LINK_BPS[0] = rate
    return _LINK_BPS[0]


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
        ll = ctypes.c_longlong
        lib.pairhmm_wire_decode_launch.argtypes = [vp] * 5 + [ll, ci, ll, ci] \
            + [vp] * 7
        lib.pairhmm_wire_decode_launch.restype = ci
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
           **{p: torch.uint8 for p in _PLANES},
           **{w: torch.uint8 for w in WIRE_NAMES}, "cb": torch.int32}
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


def wire_decode_torch(t: dict) -> dict:
    """Plain torch version of the wire decode: the five u8 read planes
    [rows, Rpad] and ``haps`` u8 [n_haps, Hpad] of a wire job's tensors
    (``ops/pairhmm_pack.py:_compress_dispatch``), on their device.  The
    codebook ``cb`` is the int32 view of the u32 words: a plane's byte is
    masked after the shift, so the sign does not reach it."""
    sym = t["sym_tab"]

    def unnib(p):
        return torch.stack([p & 0xF, p >> 4], dim=-1).reshape(p.shape[0], -1)

    v = t["cb"][t["qidx"].long()]
    out = {name: ((v >> (8 * k)) & 0xFF).to(torch.uint8)
           for k, name in enumerate(_PLANES[:4])}
    out["read_u8"] = sym[unnib(t["read_nib"]).long()]
    out["haps"] = sym[unnib(t["hap_nib"]).long()]
    return out


def _check_wire_inputs(t: dict) -> tuple:
    """Device, dtype, contiguity and shapes of a wire job's tensors;
    returns (rows, Rpad, n_haps, Hpad)."""
    dev = t["qidx"].device
    for name in WIRE_NAMES:
        x, dtype = t[name], _DTYPES[name]
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"wire decode input {name}: want contiguous "
                             f"{dtype} on {dev}, got {x.dtype} on "
                             f"{x.device}")
    rows, rpad = t["qidx"].shape
    n_haps, half = t["hap_nib"].shape
    if rpad % 128 or t["read_nib"].shape != (rows, rpad // 2) \
            or t["cb"].shape != (256,) or t["sym_tab"].shape != (16,):
        raise ValueError(f"wire decode inputs disagree in shape: qidx "
                         f"{tuple(t['qidx'].shape)}, read_nib "
                         f"{tuple(t['read_nib'].shape)}, cb "
                         f"{tuple(t['cb'].shape)}, sym_tab "
                         f"{tuple(t['sym_tab'].shape)}")
    return rows, rpad, n_haps, 2 * half


def wire_decode_cuda(t: dict) -> dict:
    """The wire decode (:func:`wire_decode_torch`'s result) on the device of
    ``t``'s tensors: ``wire_decode_kernel`` for a CUDA device, launched on
    its current stream, the plain version for the CPU.  It never falls
    back: a failed build or launch raises."""
    global WIRE_LAUNCHES
    dev = t["qidx"].device
    if dev.type == "cpu":
        return wire_decode_torch(t)
    if dev.type != "cuda":
        raise ValueError(f"wire_decode_cuda: unsupported device {dev}")
    rows, rpad, n_haps, hpad = _check_wire_inputs(t)
    lib = _kernel()
    out = {p: torch.empty((rows, rpad), dtype=torch.uint8, device=dev)
           for p in _PLANES}
    out["haps"] = torch.empty((n_haps, hpad), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pairhmm_wire_decode_launch(
            *(t[k].data_ptr() for k in WIRE_NAMES), rows, rpad, n_haps, hpad,
            *(out[k].data_ptr() for k in (*_PLANES, "haps")), stream)
    if rc != 0:
        raise RuntimeError(f"wire decode launch failed on {dev}: CUDA error "
                           f"{rc} (rows={rows}, Rpad={rpad}, haps={n_haps}, "
                           f"Hpad={hpad})")
    WIRE_LAUNCHES += 1
    return out


def _planes(t: dict) -> dict:
    """The grouped kernel's inputs from a job's tensors: a wire job's
    planes decoded on its device, a flat job's as they are."""
    if t.get("mode") != "wire":
        return t
    return {**t, **wire_decode_cuda(t)}


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


def pairhmm_forward_grouped(pairs, devices, wire=None) -> np.ndarray:
    """Forward log10 likelihoods (f32 values as float64) [len(pairs)] for a
    flat (hap, read, q, iq, dq, gcp) pair list on ``devices`` (a device or
    a list of them): the host half (:func:`prepare_grouped_jobs`, in the
    wire form when ``wire`` asks for it; None: :func:`_wire_enabled`) and
    the device half (:func:`enqueue_grouped_jobs`,
    :func:`readback_grouped`) in turn."""
    if not pairs:
        return np.zeros(0)
    devices = device_list(devices)
    arrays, out_pos = prepare_grouped_jobs(pairs, wire)
    return readback_grouped(enqueue_grouped_jobs(arrays, out_pos, devices))


def enqueue_grouped_jobs(arrays: dict, out_pos: np.ndarray, devices,
                         streams=None) -> tuple:
    """Device half, without waiting.  The table blocks are split over
    ``devices`` (a device or a list of them) in contiguous shares
    (``parallel.hosts.even_shares``, the larger first), and
    device i gets its share of ``tile_tab`` / ``hap_tab`` with the whole
    read and haplotype planes.  For each non-empty share, under device i
    and on ``streams[i]`` (its current stream when None): the copies in
    from pinned memory, a wire job's decode (:func:`wire_decode_cuda`, the
    whole planes on each device), the grouped kernel, the copy of the
    share's values back to pinned memory, and an event.  On a CPU device
    the plain versions run at once.  Returns the handle that
    :func:`readback_grouped` waits on."""
    from lorikeet_tpu_torch.parallel.hosts import even_shares
    # the pinning, the copies in, the launches and the copies out, enqueued
    with global_stage("k2.enqueue") as attrs:
        if attrs is not None:
            attrs.update(strip=grouped_strip(row_width(arrays)),
                         cells=useful_cells(arrays))
        devices = device_list(devices)
        streams = streams or [None] * len(devices)
        mode = arrays.get("mode", "flat")
        WIRE_COUNTS[mode] += 1
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
                    _planes(to_tensors(share, device)), card), None))
                continue
            if host is None:
                host = {k: _tensor(v).pin_memory() for k, v in arrays.items()
                        if isinstance(v, np.ndarray)}
                host["base_bits"] = torch.from_numpy(_BASE_BITS).pin_memory()
            stream = stream or torch.cuda.current_stream(device)
            # the kernels launch on the current stream of the current device:
            # the copies, the decode, the launch and the copy back must all be
            # issued under this device and this stream, or one could race the
            # next
            with torch.cuda.device(device), torch.cuda.stream(stream):
                t = {k: (v[lo:hi] if k in ("tile_tab", "hap_tab") else v)
                     .to(device, non_blocking=True) for k, v in host.items()}
                t["mode"] = mode
                vals = pairhmm_grouped_cuda(_planes(t), card)
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
    with global_stage("k2.readback"):
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
