"""The port's wire path against the JAX package, on the CPU.

The wire form of a grouped pair-HMM job (``ops/pairhmm_pack.py``) ships
4-bit base symbols and a u8 codebook index a read lane; the card decodes it
back to the exact planes (``pairhmm_cuda.wire_decode_cuda``, whose plain
version ``wire_decode_torch`` runs here).  Held here, with seeded numpy
inputs:
- the code caches give the JAX package's keys and tables over the same
  stream of arrays, and a wire job's tables are the ones the JAX package's
  ``_compress_dispatch`` ships for the same pairs;
- the plain decode gives the packed planes bit for bit (with and without N,
  an odd haplotype width), and a batch that overflows 16 symbols or 256
  tuples goes flat, as in the JAX package;
- wire likelihoods equal flat ones bit for bit, over a device list too,
  and are within 1e-4 of the JAX package's grouped path in interpret mode
  with its wire form forced on;
- the ``LORIKEET_WIRE_COMPRESS`` gate gives the JAX package's verdict;
- the JAX package's host/device router is not ported: its variable set,
  a batch still goes to the device list.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lorikeet_tpu.ops.pairhmm_pallas as P
from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
from lorikeet_tpu_torch.ops import pairhmm_pack as pk
from lorikeet_tpu_torch.ops.pairhmm import F32_SUSPECT_LOG10

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
DEVICE_TOL = 1e-4     # plain version vs interpret-mode TPU kernel (f32 both)
BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def fresh_codes(monkeypatch):
    """Both packages' code caches start empty in every test: they are
    process-wide and only grow, so the wire / flat outcome of a batch would
    otherwise depend on the tests that ran before it."""
    monkeypatch.setattr(pk, "_qual_codes", pk._SortedCodeCache(256, np.uint32))
    monkeypatch.setattr(pk, "_base_codes",
                        pk._SortedCodeCache(pk._SYM_CAP, np.uint8))
    monkeypatch.setattr(P, "_qual_codes", P._SortedCodeCache(256, np.uint32))
    monkeypatch.setattr(P, "_base_codes",
                        P._SortedCodeCache(P._SYM_CAP, np.uint8))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(seed=0, n_regions=3, reads_per=9, haps_per=3, with_n=False,
           odd_hmax=None):
    """Region-shaped cross products: each region's reads against its
    haplotypes, qualities from a few values.  ``odd_hmax`` True / False
    makes the widest haplotype odd / even."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n_regions):
        H = int(rng.integers(40, 90))
        base_hap = BASES[rng.integers(0, 4, H)]
        haps = [base_hap]
        for _ in range(haps_per - 1):
            h = base_hap.copy()
            h[int(rng.integers(0, H))] = BASES[int(rng.integers(0, 4))]
            haps.append(h)
        for _ in range(reads_per):
            R = int(rng.integers(20, H - 1))
            lo = int(rng.integers(0, H - R))
            read = base_hap[lo:lo + R].copy()
            if with_n:
                read[int(rng.integers(0, R))] = ord("N")
                haps[-1][int(rng.integers(0, H))] = ord("N")
            q = rng.choice([20, 30, 40], R).astype(np.uint8)
            iq = rng.choice([45, 40], R).astype(np.uint8)
            row = (read, q, iq, np.full(R, 45, np.uint8),
                   np.full(R, 10, np.uint8))
            pairs.extend((h,) + row for h in haps)
    hmax = max(len(p[0]) for p in pairs)
    if odd_hmax is not None and hmax % 2 != odd_hmax:
        pairs.append((BASES[rng.integers(0, 4, hmax + 1)],) + pairs[0][1:])
    return pairs


def _overflow_pairs(kind):
    """Pairs whose values overflow one wire table: 20 distinct read bytes
    (> 16 symbols), or random qualities (> 256 (q, iq, dq, gcp) tuples)."""
    rng = np.random.default_rng(2)
    hap = BASES[rng.integers(0, 4, 80)]
    pairs = []
    for _ in range(40):
        R = 60
        read = hap[:R].copy()
        q = np.full(R, 30, np.uint8)
        iq = np.full(R, 45, np.uint8)
        if kind == "symbols":
            read[rng.integers(0, R, 3)] = np.frombuffer(
                b"ACGTNRYSWKMBDHVXZacg", np.uint8)[rng.integers(0, 20, 3)]
        else:
            q = rng.integers(2, 93, R).astype(np.uint8)
            iq = rng.integers(2, 93, R).astype(np.uint8)
        pairs.append((hap, read, q, iq, np.full(R, 45, np.uint8),
                      np.full(R, 10, np.uint8)))
    return pairs


# ---- the codec ----

@pytest.mark.parametrize("cap, dtype, hi", [(256, np.uint32, 1 << 32),
                                            (256, np.uint32, 300),
                                            (16, np.uint8, 20)],
                         ids=["u32_wide", "u32_repeats", "u8_symbols"])
def test_code_cache_matches_jax(cap, dtype, hi):
    """The same stream of arrays through both caches: the same codes (or
    the same overflow, at the same array), keys and table each step."""
    rng = np.random.default_rng(cap + hi % 1000)
    mine, theirs = pk._SortedCodeCache(cap, dtype), P._SortedCodeCache(
        cap, dtype)
    outcomes = []
    for step in range(12):
        flat = rng.integers(0, hi, 3 + 5 * step, dtype=np.uint64) \
            .astype(dtype)
        a, b = mine.encode(flat), theirs.encode(flat)
        assert (a is None) == (b is None)
        outcomes.append(a is not None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(mine.keys[a], flat)
        np.testing.assert_array_equal(mine.keys, theirs.keys)
        np.testing.assert_array_equal(mine.table(), theirs.table())
        assert mine.table().dtype == dtype and mine.table().shape == (cap,)
    assert outcomes[0]
    if hi != 300:                  # distinct values outgrow the table
        assert not all(outcomes)


@pytest.mark.parametrize("odd_hmax", [False, True], ids=["even", "odd"])
@pytest.mark.parametrize("with_n", [False, True], ids=["acgt", "with_n"])
def test_wire_round_trip_bit_exact(with_n, odd_hmax):
    """The plain decode of a wire job gives the flat job's five planes, and
    its haplotypes with one zero column more when the widest is odd; the
    job ships the codebook and symbol table the JAX package ships for the
    same pairs, and the tables and lengths of the flat job."""
    pairs = _pairs(seed=1 + with_n, with_n=with_n, odd_hmax=odd_hmax)
    flat, pos_f = pk.prepare_grouped_jobs(pairs, wire=False)
    wire, pos_w = pk.prepare_grouped_jobs(pairs, wire=True)
    assert flat["mode"] == "flat" and wire["mode"] == "wire"
    np.testing.assert_array_equal(pos_f, pos_w)
    rows, rpad = flat["quals"].shape
    n_haps, width = flat["haps"].shape
    assert width % 2 == odd_hmax
    hpad = width + odd_hmax
    assert {k: (v.shape, v.dtype) for k, v in wire.items()
            if k in pk.WIRE_NAMES} == {
        "qidx": ((rows, rpad), np.uint8),
        "read_nib": ((rows, rpad // 2), np.uint8),
        "hap_nib": ((n_haps, hpad // 2), np.uint8),
        "cb": ((256,), np.uint32), "sym_tab": ((16,), np.uint8)}
    for k in ("tile_tab", "hap_tab", "read_lens", "hap_lens"):
        np.testing.assert_array_equal(wire[k], flat[k])
    assert not set(pk._PLANES) & set(wire) and "haps" not in wire
    dec = pc.wire_decode_cuda(pc.to_tensors(wire, CPU))
    for name in pk._PLANES:
        np.testing.assert_array_equal(dec[name].numpy(), flat[name])
    haps = dec["haps"].numpy()
    assert haps.shape == (n_haps, hpad)
    np.testing.assert_array_equal(haps[:, :width], flat["haps"])
    assert not haps[:, width:].any()
    # the JAX package's wire payload for the same pairs: the same tables
    dispatches, _, _, _ = P.pack_grouped_inputs(pairs)
    (_, operands, used), = dispatches
    mode, payload = P._compress_dispatch(operands, used, wire=True)
    assert mode == "wire"
    np.testing.assert_array_equal(wire["cb"], payload[3])
    np.testing.assert_array_equal(wire["sym_tab"], payload[4])


@pytest.mark.parametrize("kind", ["symbols", "tuples"])
def test_overflow_goes_flat(kind):
    """More than 16 symbols or 256 tuples: the job goes flat, as the JAX
    package's does, is counted as a flat job, and gives the values of a
    flat job."""
    pairs = _overflow_pairs(kind)
    job, _ = pk.prepare_grouped_jobs(pairs, wire=True)
    assert job["mode"] == "flat" and "quals" in job and "qidx" not in job
    dispatches, _, _, _ = P.pack_grouped_inputs(pairs)
    modes = {P._compress_dispatch(ops, used, wire=True)[0]
             for _, ops, used in dispatches}
    assert modes == {"flat"}
    before = dict(pc.WIRE_COUNTS)
    got = pc.pairhmm_forward_grouped(pairs, CPU, wire=True)
    assert pc.WIRE_COUNTS == {"wire": before["wire"],
                              "flat": before["flat"] + 1}
    np.testing.assert_array_equal(got, pc.pairhmm_forward_grouped(
        pairs, CPU, wire=False))


@pytest.mark.parametrize("n_devices", [1, 3])
@pytest.mark.parametrize("seed, with_n", [(3, False), (4, True)])
def test_wire_likelihoods_equal_flat_and_jax(seed, with_n, n_devices):
    """Over one CPU device or three (each decodes the whole planes, then
    sweeps its share of the blocks): wire values equal flat values bit for
    bit, and the JAX package's grouped path in interpret mode with its
    wire form on within 1e-4.  No card, so no decode kernel launch."""
    pairs = _pairs(seed=seed, n_regions=2, reads_per=5, haps_per=2,
                   with_n=with_n, odd_hmax=True)
    devices = [CPU] * n_devices
    flat = pc.pairhmm_forward_grouped(pairs, devices, wire=False)
    before, launches = dict(pc.WIRE_COUNTS), pc.WIRE_LAUNCHES
    wire = pc.pairhmm_forward_grouped(pairs, devices, wire=True)
    assert pc.WIRE_COUNTS["wire"] == before["wire"] + 1
    assert pc.WIRE_LAUNCHES == launches
    assert wire.dtype == np.float64 and np.array_equal(wire, flat)
    want = np.asarray(P.pairhmm_forward_grouped(pairs, interpret=True,
                                                wire=True))
    keep = want > F32_SUSPECT_LOG10
    assert keep.sum() >= len(pairs) // 2
    np.testing.assert_allclose(wire[keep], want[keep], rtol=0,
                               atol=DEVICE_TOL)


def test_decode_wrapper_takes_plain_version_only_on_cpu(monkeypatch):
    """On CPU tensors the plain version, no launch counted; a wire job for
    a card without one raises, it never decodes on the host."""
    pairs = _pairs(seed=6)
    wire, _ = pk.prepare_grouped_jobs(pairs, wire=True)
    t = pc.to_tensors(wire, CPU)
    launches = pc.WIRE_LAUNCHES
    got = pc.wire_decode_cuda(t)
    assert pc.WIRE_LAUNCHES == launches
    want = pc.wire_decode_torch(t)
    assert all(torch.equal(got[k], want[k]) for k in want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pc.pairhmm_forward_grouped(pairs, "cuda", wire=True)


@pytest.mark.parametrize("mode, link, want", [
    ("auto", 50e6, True), ("auto", 1.9e9, True), ("auto", 8e9, False),
    ("auto", 0.0, False), ("1", 8e9, True), ("0", 50e6, False)])
def test_wire_gate(monkeypatch, mode, link, want):
    """LORIKEET_WIRE_COMPRESS: auto compresses below 2 GB/s of measured
    link (never without a card, rate 0), 1 / 0 force it: as the JAX
    package's gate under the same setting and rate."""
    monkeypatch.setenv("LORIKEET_WIRE_COMPRESS", mode)
    monkeypatch.setattr(pc, "_LINK_BPS", [link])
    monkeypatch.setattr(P, "_WIRE_COMPRESS", mode)
    monkeypatch.setattr(P, "_LINK_BPS", [link])
    assert pc._wire_enabled() is want
    assert P._wire_enabled() is want
    job, _ = pk.prepare_grouped_jobs(_pairs(seed=7), wire=None)
    assert job["mode"] == ("wire" if want else "flat")


def test_link_rate_without_a_card(monkeypatch):
    """No card: the rate is 0.0 (measured once), so auto ships flat."""
    monkeypatch.delenv("LORIKEET_WIRE_COMPRESS", raising=False)
    monkeypatch.setattr(pc, "_LINK_BPS", [None])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pc._link_bps() == 0.0 and pc._LINK_BPS == [0.0]
    assert pc._wire_enabled() is False
    assert pk.prepare_grouped_jobs(_pairs(seed=8))[0]["mode"] == "flat"


# ---- the variables of the deleted router ----

ROUTE_PROBE = """
import numpy as np
import torch
from lorikeet_tpu_torch.calling import likelihoods as L
from lorikeet_tpu_torch.parallel import sharding
sharding._DEVICES = [torch.device("cpu")]
hap = np.frombuffer(b"ACGT" * 12, np.uint8)
read = hap[5:25].copy()
row = tuple(np.full(20, v, np.uint8) for v in (30, 45, 45, 10))
L.compute_pair_likelihoods([(hap, read, *row)])
print(L.DISPATCH_COUNTS["device"], L.DISPATCH_COUNTS["host"])
"""


@pytest.mark.parametrize("setting", ["host", "auto"])
def test_route_variables_are_not_read(setting):
    """The port has one rule for where a pair batch runs: with
    LORIKEET_PALLAS_ROUTE set (it is not read) a batch of a fresh process
    with ``use_cuda`` None goes to the device list, a CPU stand-in for the
    card here, and never to the host kernel."""
    env = {**os.environ, "LORIKEET_PALLAS_ROUTE": setting}
    res = subprocess.run([sys.executable, "-c", ROUTE_PROBE],
                         capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["1", "0"]
