"""Host half of the grouped pair-HMM dispatch: numpy only, no torch.

The packer of ``ops/pairhmm_cuda.py``'s grouped kernel (counterpart of
``pack_grouped_inputs`` in lorikeet_tpu/ops/pairhmm_pallas.py) and its wire
codec (``_compress_dispatch`` there).  It sits in a
module of its own so that a ``-t`` pool worker, which packs its span's pair
batch for the parent's card, never imports torch: a worker then starts in
about a second instead of paying for torch's CUDA libraries
(parallel/pool.py).

The wire form of a job ships the read and haplotype bases as 4-bit symbols
against a 16-entry symbol table and each read lane's (q, iq, dq, gcp) tuple
as a u8 index into a 256-entry u32 codebook: 1.5 bytes a lane and half a
byte a haplotype base instead of 5 and 1.  The card decodes it back to the
exact planes (``pairhmm_cuda.wire_decode_cuda``) before the grouped kernel
runs, so the likelihoods are those of the flat job bit for bit.  A job whose
values overflow either table goes flat.
"""
from __future__ import annotations

from operator import itemgetter

import numpy as np

#: read rows per table block (the kernel's tile height)
GROUP_BLOCK_B = 32

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


def prepare_grouped_jobs(pairs, wire=None) -> tuple:
    """Host half of the grouped dispatch: a pool worker runs it on its own
    CPU and ships the arrays to the parent's card, where
    ``pairhmm_cuda.enqueue_grouped_jobs`` takes them.  Dedups a flat
    (hap, read, q, iq, dq, gcp) pair list into grouped tables
    (:func:`pack_grouped_tables`), then encodes them in the wire form when
    ``wire`` asks for it (:func:`_compress_dispatch`; None: the card's link
    decides, ``pairhmm_cuda._wire_enabled``, which only the parent asks:
    a pool worker is handed the parent's verdict, parallel/pool.py).

    Returns ``(arrays, out_pos)``: ``arrays`` is the job, its ``"mode"``
    (``"wire"`` or ``"flat"``) beside its arrays; ``out_pos[k]`` is the
    flat position of pairs[k]'s value (see :func:`pack_grouped_tables`)."""
    arrays, out_pos = pack_grouped_tables(pairs)
    if wire is None:
        # the gate measures the card's link: torch, so the parent's only
        from lorikeet_tpu_torch.ops.pairhmm_cuda import _wire_enabled
        wire = _wire_enabled()
    mode, arrays = _compress_dispatch(arrays, wire)
    return {"mode": mode, **arrays}, out_pos


def pack_grouped_tables(pairs) -> tuple:
    """Dedups a flat (hap, read, q, iq, dq, gcp) pair list into grouped
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


def row_width(arrays: dict) -> int:
    """A grouped job's row width Rpad (lanes a read row holds), flat or
    wire."""
    return (arrays["qidx"] if arrays.get("mode") == "wire"
            else arrays["quals"]).shape[1]


def grouped_strip(rpad: int) -> int:
    """The strip the grouped kernel launches for rows of width ``rpad``
    (``pairhmm_grouped_launch`` in csrc/pairhmm.cu): the register strip of
    4, 8 or 16 rows that holds K = rpad / 32 rows, or 0, the scratch
    strips, past 16."""
    k = rpad // GROUP_BLOCK_B
    return next((c for c in (4, 8, 16) if k <= c), 0)


def useful_cells(arrays: dict) -> int:
    """DP cells a grouped job's pairs need: for each (tile, haplotype)
    block, the tile's read bases times the haplotype's bases."""
    tiles = arrays["read_lens"].reshape(-1, GROUP_BLOCK_B).sum(
        1, dtype=np.int64)
    return int((tiles[arrays["tile_tab"]]
                * arrays["hap_lens"][arrays["hap_tab"]]).sum())



# ---- the wire form (counterpart of _compress_dispatch and its caches) ----

_SYM_CAP = 16


class _SortedCodeCache:
    """Incremental sorted value->index cache: encoding is a searchsorted
    against known keys (new values extend the key set); the per-dispatch
    codebook ships the full key table.  Misses beyond `cap` disable the
    encoding for that dispatch."""

    def __init__(self, cap, dtype):
        self.cap = cap
        self.keys = np.zeros(1, dtype)      # 0 = the pad value

    def encode(self, flat):
        pos = np.searchsorted(self.keys, flat)
        hit = self.keys[np.minimum(pos, self.keys.size - 1)] == flat
        if not hit.all():
            new = np.unique(flat[~hit])
            keys = np.union1d(self.keys, new)
            if keys.size > self.cap:
                return None
            self.keys = keys
            pos = np.searchsorted(self.keys, flat)
        return pos

    def table(self):
        t = np.zeros(self.cap, self.keys.dtype)
        t[:self.keys.size] = self.keys
        return t


#: the process's codebooks: they only grow, so a worker's jobs share one
#: key set and every job ships its whole table (the decode is stateless)
_qual_codes = _SortedCodeCache(256, np.uint32)
_base_codes = _SortedCodeCache(_SYM_CAP, np.uint8)

#: what a wire job holds in place of the five read planes and ``haps``
WIRE_NAMES = ("qidx", "read_nib", "hap_nib", "cb", "sym_tab")


def _nibble_pack(syms):
    return (syms[:, 0::2] | (syms[:, 1::2] << 4)).astype(np.uint8)


def _compress_dispatch(arrays: dict, wire: bool) -> tuple:
    """(mode, arrays): ``"wire"`` replaces the five u8 read planes and
    ``haps`` with u8 ``qidx`` [rows, Rpad] (each lane's codebook index),
    ``read_nib`` [rows, Rpad / 2] and ``hap_nib`` [n_haps, Hpad / 2]
    (symbol nibbles, lane 2j in the low half of byte j; Hpad is ``haps``'
    width rounded up to even), u32 ``cb`` [256] (the (q, iq, dq, gcp) tuple
    of a lane as one little-endian word, q in the low byte) and u8
    ``sym_tab`` [16]; the tables and the lengths stay as they are.
    ``"flat"`` returns ``arrays`` unchanged: when ``wire`` is false, or when
    the batch's values overflow the 16 symbols or 256 tuples the process's
    caches can hold.  Pad lanes and rows are zero and encode to code 0 /
    symbol 0 (both caches hold key 0 at index 0)."""
    if not wire:
        return "flat", arrays
    reads, haps = arrays["read_u8"], arrays["haps"]
    rows, rpad = reads.shape
    n_haps, hmax = haps.shape
    hpad = hmax + (hmax & 1)
    sy = _base_codes.encode(np.concatenate([reads.ravel(), haps.ravel()]))
    if sy is None:
        return "flat", arrays
    hap_sy = np.zeros((n_haps, hpad), np.uint8)
    hap_sy[:, :hmax] = sy[reads.size:].reshape(n_haps, hmax)
    # (q, iq, dq, gcp) tuples as one u32 view: interleave once, no
    # per-plane u32 temporaries
    tup = np.ascontiguousarray(np.stack(
        [arrays["quals"], arrays["ins_q"], arrays["del_q"], arrays["gcp_q"]],
        axis=-1)).view(np.uint32)[..., 0]
    qc = _qual_codes.encode(tup.ravel())
    if qc is None:
        return "flat", arrays
    out = {k: v for k, v in arrays.items() if k not in (*_PLANES, "haps")}
    out.update(
        qidx=qc.astype(np.uint8).reshape(rows, rpad),
        read_nib=_nibble_pack(sy[:reads.size].astype(np.uint8)
                              .reshape(rows, rpad)),
        hap_nib=_nibble_pack(hap_sy), cb=_qual_codes.table(),
        sym_tab=_base_codes.table())
    return "wire", out
