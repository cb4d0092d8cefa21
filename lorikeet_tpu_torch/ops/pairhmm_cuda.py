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

- :func:`pack_grouped_inputs` builds those tables and planes on the host,
  sized to the work (no fixed dispatch shapes, no pad blocks).
- :func:`pairhmm_sweep_torch` is the plain torch version of the sweep: the
  TPU kernel's ``_dp_sweep`` in torch ops on [rows, Rpad] tensors.
- :func:`pairhmm_grouped_cuda` launches the hand-written kernel
  (``csrc/pairhmm.cu``) for tensors on a CUDA device, and takes the plain
  version only for tensors on the CPU.  It never falls back: a failed build
  or launch raises.
- :func:`pack_flat_inputs`, :func:`pairhmm_flat_torch` and
  :func:`pairhmm_flat_cuda` are the same three for the flat kernel, whose
  pairs run in classes of read length (:func:`flat_classes`), a launch each;
  :func:`pairhmm_forward_flat` is its entry point on padded batch arrays and
  :func:`pairhmm_forward_sharded` splits the pairs over the ranks of a
  ``torch.distributed`` group.
"""
from __future__ import annotations

import ctypes
from operator import itemgetter

import numpy as np
import torch

from lorikeet_tpu_torch.ops.pairhmm import TRISTATE_CORRECTION

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
#: read rows per table block (the kernel's tile height)
GROUP_BLOCK_B = 32
#: strip widths (read rows a lane) of the flat kernel's column schedule
FLAT_CLASSES = (1, 2, 4, 8, 16)
#: the flat kernel's classes in launch order; 0 holds reads of 512 bases or
#: more, on the anti-diagonal sweep with scratch strips
FLAT_ORDER = FLAT_CLASSES + (0,)

#: kernel launches made by pairhmm_grouped_cuda in this process
LAUNCHES = 0
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

_PLANES = ("quals", "ins_q", "del_q", "gcp_q", "read_u8")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _row_scatter(rows: np.ndarray, lens: np.ndarray, width: int,
                 col0: int) -> np.ndarray:
    """Flat indices into a [*, width] array of the ragged rows of lengths
    ``lens`` laid at columns col0.. of rows ``rows``, in the order
    ``np.concatenate`` lists their elements."""
    lens = lens.astype(np.int64)
    first = np.cumsum(lens) - lens
    # element e of row k lands at rows[k] * width + col0 + (e - first[k])
    return np.repeat(rows.astype(np.int64) * width + col0 - first, lens) \
        + np.arange(int(lens.sum()))


def _first_seen(ids: np.ndarray) -> tuple:
    """(rank, first): ``rank[k]`` numbers the distinct values of ``ids`` in
    the order they first appear, ``first[r]`` is where value r first
    stands."""
    _, first, inverse = np.unique(ids, return_index=True, return_inverse=True)
    by_first = np.argsort(first, kind="stable")
    rank = np.empty_like(by_first)
    rank[by_first] = np.arange(by_first.size)
    return rank[inverse.reshape(-1)], first[by_first]


def pack_grouped_inputs(pairs):
    """Dedup a flat (hap, read, q, iq, dq, gcp) pair list into grouped
    tables.  Reads sharing an identical haplotype set (one region's reads)
    tile together; each read and haplotype is packed once.  Reads and
    haplotypes are told apart by object identity, and the tables are built
    with array operations over the whole list: nothing here iterates over
    the pairs in Python.

    Returns ``(arrays, out_pos)``: ``arrays`` holds int32 ``tile_tab`` /
    ``hap_tab`` [nblocks], int32 ``hap_lens`` [n_haps], u8 ``haps``
    [n_haps, Hmax], the five u8 read planes ``quals``, ``ins_q``, ``del_q``,
    ``gcp_q``, ``read_u8`` [rows, Rpad] (lane 0 is the boundary row, lanes
    1..R the read), and int32 ``read_lens`` [rows] (0 on the pad rows that
    fill a group's last tile).  Block b's result for tile row r lands at
    flat position b * 32 + r; ``out_pos[k]`` is that position for pairs[k]
    (duplicate pairs share one cell)."""
    tile = GROUP_BLOCK_B
    n = len(pairs)
    hap_of, hap_first = _first_seen(np.fromiter(
        map(id, map(itemgetter(0), pairs)), np.int64, n))
    read_of, read_first = _first_seen(np.fromiter(
        map(id, map(itemgetter(1), pairs)), np.int64, n))
    n_haps, n_reads = hap_first.size, read_first.size

    # the distinct (read, hap) cells, sorted by read then hap: a read's
    # cells are its haplotype set (over every region that holds it)
    cells, cell_of = np.unique(read_of * n_haps + hap_of, return_inverse=True)
    cell_hap = cells % n_haps
    n_set = np.bincount(cells // n_haps, minlength=n_reads)   # haps per read
    set0 = np.cumsum(n_set) - n_set

    # group reads by identical haplotype set: the region structure.  A read
    # shared by overlapping regions tiles alone against the union of their
    # haps: correct for every pair, merely less dense.  Sets are compared
    # element by element, one pass per set position over all reads.
    group_of = n_set
    for k in range(int(n_set.max())):
        hap_k = np.where(k < n_set, cell_hap[np.minimum(set0 + k,
                                                        cells.size - 1)], -1)
        _, group_of = np.unique(group_of * (n_haps + 1) + hap_k + 1,
                                return_inverse=True)
    group_of, group_first = _first_seen(group_of.reshape(-1))
    by_group = np.argsort(group_of, kind="stable")    # reads, group by group
    g_reads = np.bincount(group_of)
    in_group = np.empty(n_reads, np.int64)            # a read's row in its group
    in_group[by_group] = np.arange(n_reads) - np.repeat(
        np.cumsum(g_reads) - g_reads, g_reads)
    g_tiles = -(-g_reads // tile)
    g_tile0 = np.cumsum(g_tiles) - g_tiles
    g_haps = n_set[group_first]
    g_blocks = g_tiles * g_haps
    g_block0 = np.cumsum(g_blocks) - g_blocks
    n_rows = int(g_tiles.sum()) * tile
    row_of = g_tile0[group_of] * tile + in_group

    # blocks in (group, tile, hap) order
    n_blocks = int(g_blocks.sum())
    blk_group = np.repeat(np.arange(g_blocks.size), g_blocks)
    local = np.arange(n_blocks) - g_block0[blk_group]
    tile_tab = g_tile0[blk_group] + local // g_haps[blk_group]
    hap_tab = cell_hap[set0[group_first[blk_group]] + local % g_haps[blk_group]]

    cell_read = cells // n_haps
    cell_group = group_of[cell_read]
    cell_block = g_block0[cell_group] \
        + (in_group[cell_read] // tile) * g_haps[cell_group] \
        + np.arange(cells.size) - set0[cell_read]
    out_pos = (cell_block * tile + in_group[cell_read] % tile)[
        cell_of.reshape(-1)]

    rows = [pairs[k] for k in read_first.tolist()]    # one pair per read
    reads = [p[1] for p in rows]
    lens = np.fromiter(map(len, reads), np.int64, n_reads)
    read_lens = np.zeros(n_rows, np.int32)
    read_lens[row_of] = lens
    rpad = _round_up(int(lens.max()) + 1, 128)
    arrays = {"tile_tab": tile_tab.astype(np.int32),
              "hap_tab": hap_tab.astype(np.int32)}
    at = _row_scatter(row_of, lens, rpad, 1)      # one index for all planes
    for name, j in zip(_PLANES, (2, 3, 4, 5, 1)):     # q, iq, dq, gcp, read
        plane = np.zeros(n_rows * rpad, np.uint8)
        plane[at] = np.concatenate([p[j] for p in rows])
        arrays[name] = plane.reshape(n_rows, rpad)
    arrays["read_lens"] = read_lens
    hap_list = [pairs[k][0] for k in hap_first.tolist()]
    hap_lens = np.fromiter(map(len, hap_list), np.int32, n_haps)
    hmax = int(hap_lens.max())
    haps = np.zeros(n_haps * hmax, np.uint8)
    haps[_row_scatter(np.arange(n_haps), hap_lens, hmax, 0)] = \
        np.concatenate(hap_list)
    arrays["hap_lens"] = hap_lens
    arrays["haps"] = haps.reshape(n_haps, hmax)
    return arrays, out_pos


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


def pairhmm_grouped_cuda(t: dict) -> torch.Tensor:
    """Grouped forward, f32 [nblocks * 32], on the device of ``t``'s
    tensors: the CUDA kernel for a CUDA device, the plain version
    (:func:`pairhmm_sweep_torch`) for the CPU."""
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
        raise RuntimeError(f"pairhmm kernel launch failed: CUDA error {rc} "
                           f"(nblocks={nblocks}, Rpad={rpad}, Hmax={hpad})")
    LAUNCHES += 1
    return out


def pairhmm_forward_grouped(pairs, device) -> np.ndarray:
    """Forward log10 likelihoods (f32 values as float64) [len(pairs)] for a
    flat (hap, read, q, iq, dq, gcp) pair list on ``device``."""
    if not pairs:
        return np.zeros(0)
    device = torch.device(device)
    if device.type == "cuda":
        from lorikeet_tpu_torch.device import require_cuda
        require_cuda()
    arrays, out_pos = pack_grouped_inputs(pairs)
    flat = pairhmm_grouped_cuda(to_tensors(arrays, device))
    pos = torch.from_numpy(out_pos).to(device)
    return flat[pos].cpu().numpy().astype(np.float64)


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
