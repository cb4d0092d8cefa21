"""The port's pair-HMM against the JAX package, on the CPU.

``pairhmm_sweep_torch`` (the plain torch version of the CUDA kernel, which
``pairhmm_grouped_cuda`` takes for CPU tensors) runs through the port's
packer on the cases of tests/test_pairhmm_pallas.py and on the batches the
card tests give the kernel (tests/test_torch_cuda.py), and is held:
- against the exact f64 ``pairhmm_forward_np`` at 2e-3 (the bound the TPU
  kernel holds), after the f64 escalation of flushed rows;
- against the TPU kernel in interpret mode at 1e-4 on rows above -28: both
  are the same f32 sweep, so only f32 exp/log10 from two libraries differ.
The ported numpy parts must equal the JAX package's exactly.
``compute_pair_likelihoods`` sends every batch to the device list (CPU
devices in the cards' place) unless ``use_cuda`` is False, and to the f64
host kernel then: the one rule for where a pair batch runs.
"""
import functools

import numpy as np
import pytest
import torch

import lorikeet_tpu.ops.pairhmm as jph
from lorikeet_tpu.ops.pairhmm_pallas import (
    pairhmm_forward_grouped as jax_grouped,
)
import lorikeet_tpu_torch.ops.pairhmm as tph
from lorikeet_tpu_torch.calling import likelihoods as tlk
from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
from test_torch_cuda import (KERNEL_READ_LENS, PAD_ROW_READ_LENS,
                             _kernel_batch, _pad_row_batch)
from test_torch_hybrid import _mixed_batch
from test_torch_wire import _pairs

BASES = np.frombuffer(b"ACGT", np.uint8)
DEVICE_TOL = 1e-4     # torch twin vs interpret-mode TPU kernel (f32 both)
EXACT_TOL = 2e-3      # f32 kernel vs exact f64 (tests/test_pairhmm_pallas.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version's tensors here are small: several test workers
    each running torch's default thread pool only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(rng, hap, read, q_lo=10):
    R = len(read)
    return (hap, read, rng.integers(q_lo, 40, R).astype(np.uint8),
            rng.integers(30, 46, R).astype(np.uint8),
            rng.integers(30, 46, R).astype(np.uint8),
            np.full(R, 10, np.uint8))


def _ambiguous_pairs():
    """N in read and hap, IUPAC bytes matching by byte equality, an
    unknown byte ('X') on both sides (test_pairhmm_pallas.py:102, :153)."""
    rng = np.random.default_rng(23)
    hap = BASES[rng.integers(0, 4, 40)]
    read = hap[3:23].copy()
    hap[10] = ord("N")
    read[4] = ord("N")
    hap2 = BASES[rng.integers(0, 4, 36)]
    read2 = hap2[2:20].copy()
    hap2[8] = ord("R")
    read2[6] = ord("A")
    hap3 = BASES[rng.integers(0, 4, 36)]
    read3 = hap3[1:19].copy()
    hap3[5] = ord("R")
    read3[4] = ord("R")
    hap3[12] = ord("N")
    read3[11] = ord("R")
    hap4 = BASES[rng.integers(0, 4, 36)]
    hap4[9] = ord("X")
    read4 = hap4[3:27].copy()
    read5 = hap4[2:30].copy()
    read5[[3, 10]] = ord("N")
    read5[7] = ord("r")                  # lowercase folds to 'R'
    return [_pair(rng, h, r) for h, r in
            [(hap, read), (hap2, read2), (hap3, read3), (hap4, read4),
             (hap4, read5)]]


def _multilane_pairs():
    """R > 127: a 256-wide read axis (test_pairhmm_pallas.py:57)."""
    rng = np.random.default_rng(11)
    pairs = []
    for H, R in [(300, 150), (200, 151), (280, 140)]:
        hap = BASES[rng.integers(0, 4, H)]
        read = hap[7:7 + R].copy()
        read[rng.integers(0, R)] = BASES[rng.integers(0, 4)]
        pairs.append(_pair(rng, hap, read))
    return pairs


def _long_duplicate_pairs():
    """A 500 bp read, three identical tuples (test_pairhmm_pallas.py:211)
    plus a shallower 500 bp pair that stays above the escalation bound."""
    rng = np.random.default_rng(0)
    hap = BASES[rng.integers(0, 4, 700)]
    read = hap[100:600].copy()
    for _ in range(25):
        read[int(rng.integers(0, 500))] = BASES[int(rng.integers(0, 4))]
    q = np.full(500, 30, np.uint8)
    o = np.full(500, 45, np.uint8)
    g = np.full(500, 10, np.uint8)
    clean = hap[150:650].copy()
    return [(hap, read, q, o, o, g)] * 3 + [(hap, clean, q, o, o, g)]


def _region_pairs(seed=5):
    """Region-shaped cross products (test_pairhmm_pallas.py:241)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(3):
        H = int(rng.integers(150, 400))
        bh = BASES[rng.integers(0, 4, H)]
        haps = [bh] + [bh.copy() for _ in range(2)]
        for h in haps[1:]:
            h[int(rng.integers(0, H))] = BASES[int(rng.integers(0, 4))]
        for _ in range(int(rng.integers(5, 40))):
            R = int(rng.integers(40, 130))
            lo = int(rng.integers(0, H - R))
            read = bh[lo:lo + R].copy()
            q = np.full(R, 30, np.uint8)
            o = np.full(R, 45, np.uint8)
            g = np.full(R, 10, np.uint8)
            for h in haps:
                pairs.append((h, read, q, o, o, g))
    return pairs


def _pad_rows(read_len):
    return _pad_row_batch(np.random.default_rng(7000 + read_len), read_len)


CASES = {"ambiguous": _ambiguous_pairs, "multilane": _multilane_pairs,
         "long_duplicates": _long_duplicate_pairs, "region": _region_pairs,
         **{f"kernel_{n}": functools.partial(_kernel_batch, n)
            for n in KERNEL_READ_LENS},
         **{f"pad_rows_{n}": functools.partial(_pad_rows, n)
            for n in PAD_ROW_READ_LENS}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_exact_f64(case):
    pairs = CASES[case]()
    raw = pc.pairhmm_forward_grouped(pairs, "cpu")
    want = np.array([tph.pairhmm_forward_np(*p) for p in pairs])
    deep = want <= tph.F32_SUSPECT_LOG10
    np.testing.assert_allclose(raw[~deep], want[~deep], atol=EXACT_TOL)
    got = tph.pairhmm_forward_checked(raw, pairs)
    np.testing.assert_allclose(got, want, atol=EXACT_TOL)


@pytest.mark.parametrize("seed", [5, 9])
def test_twin_matches_jax_interpret_kernel(seed):
    pairs = _region_pairs(seed)
    got = pc.pairhmm_forward_grouped(pairs, "cpu")
    want = jax_grouped(pairs, interpret=True)
    keep = want > tph.F32_SUSPECT_LOG10
    assert keep.all()
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=DEVICE_TOL)


def test_duplicates_share_one_cell_and_long_read_escalates():
    pairs = _long_duplicate_pairs()
    arrays, out_pos = pc.prepare_grouped_jobs(pairs)
    assert out_pos[0] == out_pos[1] == out_pos[2] != out_pos[3]
    got = pc.pairhmm_forward_grouped(pairs, "cpu")
    assert np.all(np.isfinite(got)) and got[0] == got[1] == got[2]
    # the deep pair lands in the escalation zone, like the TPU kernel's
    assert got[0] < tph.F32_SUSPECT_LOG10 < got[3]


def test_packer_tables():
    """One read tile per group of <= 32 reads, blocks tile-major over the
    group's haps, pad rows of length 0, each read and hap packed once."""
    pairs = _region_pairs(7)
    arrays, out_pos = pc.prepare_grouped_jobs(pairs)
    reads = {id(p[1]) for p in pairs}
    haps = {id(p[0]) for p in pairs}
    assert arrays["haps"].shape[0] == len(haps) == arrays["hap_lens"].size
    assert int((arrays["read_lens"] > 0).sum()) == len(reads)
    rows, rpad = arrays["quals"].shape
    assert rows % pc.GROUP_BLOCK_B == 0 and rpad % 128 == 0
    assert rpad > max(len(p[1]) for p in pairs)
    nblocks = arrays["tile_tab"].size
    # distinct (read, hap) pairs get distinct cells
    assert len(set(out_pos.tolist())) == len({(id(p[1]), id(p[0]))
                                              for p in pairs})
    assert out_pos.max() < nblocks * pc.GROUP_BLOCK_B
    for k, (hap, read, q, iq, dq, gcp) in enumerate(pairs):
        b, r = divmod(int(out_pos[k]), pc.GROUP_BLOCK_B)
        row = arrays["tile_tab"][b] * pc.GROUP_BLOCK_B + r
        h = arrays["hap_tab"][b]
        L = len(read)
        assert arrays["read_lens"][row] == L
        np.testing.assert_array_equal(arrays["read_u8"][row, 1:L + 1], read)
        np.testing.assert_array_equal(arrays["quals"][row, 1:L + 1], q)
        np.testing.assert_array_equal(arrays["gcp_q"][row, 1:L + 1], gcp)
        assert arrays["read_u8"][row, 0] == 0
        assert arrays["hap_lens"][h] == len(hap)
        np.testing.assert_array_equal(arrays["haps"][h, :len(hap)], hap)


def test_base_bits_match_tpu_kernel_encoding():
    """The port's table is the TPU kernel's in-kernel encoding (byte 0 has
    no bits; all lowercase letters fold)."""
    import jax.numpy as jnp
    from lorikeet_tpu.ops.pairhmm_pallas import _base_bits_jnp
    codes = np.arange(256, dtype=np.uint8)
    want = np.asarray(_base_bits_jnp(jnp.asarray(codes)))
    np.testing.assert_array_equal(pc._BASE_BITS, want)


def test_numpy_parts_equal_jax_package():
    rng = np.random.default_rng(3)
    pairs = _ambiguous_pairs() + _multilane_pairs()
    for p in pairs:
        assert tph.pairhmm_forward_np(*p) == jph.pairhmm_forward_np(*p)
        np.testing.assert_array_equal(
            np.stack(tph._transition_probs(*p[3:6])),
            np.stack(jph._transition_probs(*p[3:6])))
    for kw in ({}, {"r_pad_to": 32, "h_pad_to": 64},
               {"r_pad_to": lambda r: r + 5}):
        a = tph.pack_pairhmm_batch(pairs, **kw)
        b = jph.pack_pairhmm_batch(pairs, **kw)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    raw = np.array([jph.pairhmm_forward_np(*p) for p in pairs])
    raw += rng.normal(0, 1e-4, raw.size)
    raw[[0, 3]] = [-40.0, 0.5]
    raw[5] = np.nan
    np.testing.assert_array_equal(tph.pairhmm_forward_checked(raw, pairs),
                                  jph.pairhmm_forward_checked(raw, pairs))
    assert tph.TRISTATE_CORRECTION == jph.TRISTATE_CORRECTION
    assert tph.F32_SUSPECT_LOG10 == jph.F32_SUSPECT_LOG10


def test_escalation_counter_counts_suspect_rows():
    pairs = _ambiguous_pairs()
    raw = np.array([tph.pairhmm_forward_np(*p) for p in pairs])
    raw[1] = np.inf
    before = dict(tph.ESCALATIONS)
    tph.pairhmm_forward_checked(raw, pairs)
    assert tph.ESCALATIONS["checked"] - before["checked"] == len(pairs)
    assert tph.ESCALATIONS["escalated"] - before["escalated"] == 1


def test_wrapper_takes_plain_version_only_on_cpu(monkeypatch):
    pairs = _region_pairs(5)[:40]
    arrays, out_pos = pc.prepare_grouped_jobs(pairs)
    t = pc.to_tensors(arrays, "cpu")
    launches = pc.LAUNCHES
    got = pc.pairhmm_grouped_cuda(t)
    assert pc.LAUNCHES == launches            # no kernel launched on CPU
    torch.testing.assert_close(got, pc.pairhmm_sweep_torch(t), rtol=0,
                               atol=0)
    # a CUDA request without a card raises; it never falls back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pc.pairhmm_forward_grouped(pairs, "cuda")


def _long_read_pairs():
    """Three region pairs and a 700-base read against a 900-base
    haplotype."""
    return _pairs(seed=11, n_regions=1, reads_per=2)[:3] \
        + [(BASES[np.arange(900) % 4], BASES[np.arange(700) % 4],
            *(np.full(700, v, np.uint8) for v in (30, 45, 45, 10)))]


#: a batch of each class a card run gives K2: the cases above, a long read
#: beside short ones, one pair alone, 150-base rows beside long-read
#: segments on the 16-row strip (Rpad 384) and 11 table blocks with pad rows
DISPATCH_CASES = {
    **{k: CASES[k] for k in ("ambiguous", "multilane", "long_duplicates",
                             "region")},
    "long_reads": _long_read_pairs,
    "one_pair": lambda: _pairs(seed=12)[:1],
    "wide_rows": lambda: _mixed_batch(np.random.default_rng(384),
                                      (260, 301, 383)),
    "pad_rows": functools.partial(_pad_rows, 100)}


@pytest.mark.parametrize("use_cuda", [True, None, False],
                         ids=["cuda", "default", "host"])
@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_compute_pair_likelihoods_routes_every_batch_to_device(
        monkeypatch, case, use_cuda):
    """One batch, one step of DISPATCH_COUNTS: the device list's K2 (CPU
    devices in the cards' place) for True and None, the f64 host kernel
    for False; either way the JAX package's exact f64 values."""
    from lorikeet_tpu_torch.parallel import sharding
    monkeypatch.setattr(sharding, "_DEVICES", [torch.device("cpu")])
    monkeypatch.setattr(tlk, "DISPATCH_COUNTS",
                        dict.fromkeys(tlk.DISPATCH_COUNTS, 0))
    pairs = DISPATCH_CASES[case]()
    got = tlk.compute_pair_likelihoods(pairs, use_cuda=use_cuda)
    side = "host" if use_cuda is False else "device"
    assert tlk.DISPATCH_COUNTS == {"device": 0, "host": 0, "remote": 0,
                                   side: 1}
    want = np.array([jph.pairhmm_forward_np(*p) for p in pairs])
    np.testing.assert_allclose(got, want, atol=EXACT_TOL)


# ---- the packer: tables from the whole pair list at once ----

def _reads(rng, ref, n, lo=20, hi=120):
    out = []
    for _ in range(n):
        R = int(rng.integers(lo, min(hi, len(ref)) + 1))
        at = int(rng.integers(0, len(ref) - R + 1))
        read = ref[at:at + R].copy()
        read[int(rng.integers(0, R))] = BASES[int(rng.integers(0, 4))]
        out.append(_pair(rng, None, read, q_lo=25)[1:])
    return out


def _haps(rng, n, H):
    ref = BASES[rng.integers(0, 4, H)]
    haps = [ref] + [ref.copy() for _ in range(n - 1)]
    for h in haps[1:]:
        h[int(rng.integers(0, H))] = BASES[int(rng.integers(0, 4))]
    return haps


def _ragged_pairs():
    """Read lengths 1 to 126 in one region, haplotypes of three lengths."""
    rng = np.random.default_rng(31)
    haps = _haps(rng, 2, 200) + _haps(rng, 1, 131)
    reads = _reads(rng, haps[0], 9, lo=1, hi=126) \
        + _reads(rng, haps[0], 1, lo=1, hi=1)
    return [(h, *r) for r in reads for h in haps]


def _duplicate_pairs():
    """The same tuple object several times, apart and in a row."""
    pairs = _ragged_pairs()[:12]
    return pairs + [pairs[3], pairs[3], pairs[0]] + pairs[5:7]


def _shared_read_pairs():
    """One read under two haplotype sets (overlapping regions): it tiles
    against the union, the regions' own reads against their own sets."""
    rng = np.random.default_rng(37)
    haps_a, haps_b = _haps(rng, 3, 180), _haps(rng, 2, 150)
    reads_a = _reads(rng, haps_a[0], 4, hi=100)
    reads_b = _reads(rng, haps_b[0], 3, hi=100)
    shared = _reads(rng, haps_a[0], 1, hi=100)[0]
    pairs = [(h, *r) for r in reads_a + [shared] for h in haps_a]
    pairs += [(h, *r) for r in [shared] + reads_b for h in haps_b]
    return pairs


def _single_pair():
    return _ragged_pairs()[:1]


def _pad_row_pairs():
    """70 reads of one region: three tiles, the last with 26 pad rows; a
    second region of 32 reads fills its tile exactly."""
    rng = np.random.default_rng(41)
    haps = _haps(rng, 2, 160)
    more = _haps(rng, 3, 140)
    return [(h, *r) for r in _reads(rng, haps[0], 70, hi=90) for h in haps] \
        + [(h, *r) for r in _reads(rng, more[0], 32, hi=90) for h in more]


PACKER_CASES = {"ragged": _ragged_pairs, "duplicates": _duplicate_pairs,
                "shared_read": _shared_read_pairs, "single": _single_pair,
                "pad_rows": _pad_row_pairs}


def _flat_values(pairs):
    a = tph.pack_pairhmm_batch(pairs)
    t = pc.to_tensors(pc.pack_flat_inputs(
        a["haps"], a["hap_lens"], a["reads"], a["read_lens"], a["quals"],
        a["ins_quals"], a["del_quals"], a["gcps"]), "cpu")
    return pc.pairhmm_flat_torch(t).numpy().astype(np.float64)


@pytest.mark.parametrize("case", sorted(PACKER_CASES))
def test_packer_values_equal_flat_version(case):
    """Every pair's value through the grouped tables equals the flat plain
    version's on the same pair: both run the same f32 sweep, and the wider
    padding of the grouped planes only adds diagonals that rescale by
    powers of two."""
    pairs = PACKER_CASES[case]()
    got = pc.pairhmm_forward_grouped(pairs, "cpu")
    assert got.shape == (len(pairs),) and np.all(np.isfinite(got))
    np.testing.assert_array_equal(got, _flat_values(pairs))


@pytest.mark.parametrize("case", sorted(PACKER_CASES))
def test_packer_values_match_jax_grouped_path(case):
    pairs = PACKER_CASES[case]()
    got = pc.pairhmm_forward_grouped(pairs, "cpu")
    want = jax_grouped(pairs, interpret=True)
    keep = want > tph.F32_SUSPECT_LOG10
    assert keep.any()
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=EXACT_TOL)


@pytest.mark.parametrize("case", sorted(PACKER_CASES))
def test_packer_ships_each_read_and_hap_once(case):
    pairs = PACKER_CASES[case]()
    arrays, out_pos = pc.prepare_grouped_jobs(pairs)
    reads = {id(p[1]): p for p in pairs}
    haps = {id(p[0]): p[0] for p in pairs}
    tile = pc.GROUP_BLOCK_B
    assert arrays["haps"].shape[0] == len(haps)
    assert int((arrays["read_lens"] > 0).sum()) == len(reads)
    assert arrays["quals"].shape[0] % tile == 0
    # one cell per distinct (read, hap), shared by its duplicates
    cells = {}
    for k, p in enumerate(pairs):
        assert cells.setdefault((id(p[1]), id(p[0])), out_pos[k]) == out_pos[k]
    assert len(set(cells.values())) == len(cells)
    # each cell's block names the pair's own read row and haplotype
    for k, (hap, read, q, iq, dq, gcp) in enumerate(pairs):
        b, r = divmod(int(out_pos[k]), tile)
        row = arrays["tile_tab"][b] * tile + r
        h = arrays["hap_tab"][b]
        L = len(read)
        assert arrays["read_lens"][row] == L
        np.testing.assert_array_equal(arrays["read_u8"][row, 1:L + 1], read)
        np.testing.assert_array_equal(arrays["ins_q"][row, 1:L + 1], iq)
        np.testing.assert_array_equal(arrays["del_q"][row, 1:L + 1], dq)
        assert not arrays["quals"][row, L + 1:].any()
        np.testing.assert_array_equal(arrays["haps"][h, :len(hap)], hap)
    # a tile's blocks cover exactly the haplotype set of its reads
    for t in np.unique(arrays["tile_tab"]):
        tile_haps = sorted(arrays["hap_tab"][arrays["tile_tab"] == t])
        assert len(set(tile_haps)) == len(tile_haps)


def test_shared_read_tiles_against_the_union():
    pairs = _shared_read_pairs()
    arrays, out_pos = pc.prepare_grouped_jobs(pairs)
    shared = pairs[4 * 3][1]                  # fifth read of region a
    assert sum(p[1] is shared for p in pairs) == 5
    rows = {int(arrays["tile_tab"][p // 32]) * 32 + int(p % 32)
            for p, pr in zip(out_pos, pairs) if pr[1] is shared}
    assert len(rows) == 1                     # shipped once
    tile = rows.pop() // 32
    assert int((arrays["tile_tab"] == tile).sum()) == 5     # 3 + 2 haps
    assert arrays["tile_tab"].size == 3 + 5 + 2
