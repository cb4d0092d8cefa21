"""``--devices N`` in the port, on the CPU: the device list, the grouped
pair-HMM (K2) split over it, the activity chain split by position over it,
and a whole ``call`` over eight devices, against the JAX package's mesh.

CPU devices stand in for the cards (``sharding.visible_cards``), so the
kernels' plain versions run on them through the same split:
- ``configure_devices`` resolves the specs ``configure_mesh`` resolves
  (tests/test_mesh_pipeline.py), and is an error above the visible count
  and without a card;
- K2's values over n = 1, 2, 3, 8 devices are equal to one device's, bit
  for bit, with duplicate pairs and with fewer table blocks than devices;
  over eight they agree with the JAX package's grouped kernel (interpret
  mode) over eight devices at 1e-4;
- the activity chain over n = 2, 3, 8 devices is within 1e-6 of one
  device's, within 2e-3 of the f64 host chain and within 1e-4 of the JAX
  chain over an 8-device mesh (``ACTIVITY_CASES`` of
  tests/test_torch_parallel.py);
- ``run_call`` over eight devices writes the JAX package's 8-device mesh
  VCF (interpret mode), header aside.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import lorikeet_tpu.calling.engine as jengine
import lorikeet_tpu.calling.likelihoods as jlk
from lorikeet_tpu.ops.pairhmm_pallas import (
    pairhmm_forward_grouped as jax_grouped,
)
from lorikeet_tpu.parallel import pipeline as jpipe
from lorikeet_tpu.parallel import sharding as jshard
from lorikeet_tpu.processing import run_call as jax_run_call
import lorikeet_tpu_torch.calling.engine as tengine
from lorikeet_tpu_torch.models.activity import (
    active_probabilities, band_pass_smooth,
)
from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
from lorikeet_tpu_torch.parallel import pipeline as tpipe
from lorikeet_tpu_torch.parallel import sharding as tshard
import lorikeet_tpu_torch.processing as tproc

from test_mesh_pipeline import tiny_fixture  # noqa: F401  (a fixture)
from test_torch_call import cpu_cards
from test_torch_pairhmm import _long_duplicate_pairs, _region_pairs
from test_torch_parallel import ACTIVITY_CASES

DEVICE_TOL = 1e-4     # plain version vs interpret-mode TPU kernel (f32 both)
SPLIT_TOL = 1e-6      # activity chain split by position vs one device
ACT_JAX_TOL = 1e-4    # f32 chain in torch vs f32 chain in jax
ACT_HOST_TOL = 2e-3   # f32 chain vs the f64 host chain
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions' tensors here are small: several test workers
    each running torch's default thread pool only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("spec, n", [
    (None, 1), (0, 1), (1, 1), ("1", 1), ("none", 1), (4, 4), ("4", 4),
    ("auto", 8), ("8", 8)])
def test_configure_devices_specs(monkeypatch, spec, n):
    """configure_mesh's specs (tests/test_mesh_pipeline.py): None / 0 / 1
    one device, N the first N, 'auto' every visible one; the list is then
    the process's."""
    cpu_cards(monkeypatch, 8)
    assert tshard.get_devices() == [CPU]           # before configuring
    assert tshard.configure_devices(spec) == [CPU] * n
    assert tshard.get_devices() == [CPU] * n
    # --force-cpu leaves the list as the CPU, whatever the spec
    assert tshard.configure_devices(spec, on_card=False) == [CPU]


def test_configure_devices_above_the_visible_count(monkeypatch):
    cpu_cards(monkeypatch, 8)
    for spec in (9, "9"):
        with pytest.raises(ValueError, match="--devices 9: only 8"):
            tshard.configure_devices(spec)
    for spec in ("two", -1):
        with pytest.raises(ValueError, match="--devices"):
            tshard.configure_devices(spec)


def test_configure_devices_without_a_card(monkeypatch):
    """No card and no --force-cpu: every spec is an error that names CUDA,
    never a quiet run on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(tshard, "_DEVICES", None)
    for spec in ("auto", 1, "4"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tshard.configure_devices(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        tshard.get_devices()
    assert tshard.configure_devices("4", on_card=False) == [CPU]


def _duplicated_region_pairs():
    pairs = _region_pairs(5)
    return pairs + pairs[:5] + pairs[40:43]


SPLIT_CASES = {"region": _duplicated_region_pairs,
               "few_blocks": _long_duplicate_pairs}


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_grouped_split_is_bit_identical(monkeypatch, case, n):
    """Each device sweeps a contiguous share of the table blocks against
    the whole planes: the values equal one device's bit for bit, and every
    non-empty share ran on its own position of the list."""
    pairs = SPLIT_CASES[case]()
    arrays, _ = pc.prepare_grouped_jobs(pairs)
    nblocks = arrays["tile_tab"].size
    one = pc.pairhmm_forward_grouped(pairs, CPU)
    shares = []
    real = pc.pairhmm_grouped_cuda
    monkeypatch.setattr(
        pc, "pairhmm_grouped_cuda",
        lambda t, card=0: shares.append((card, t["tile_tab"].numel()))
        or real(t, card))
    got = pc.pairhmm_forward_grouped(pairs, [CPU] * n)
    assert got.dtype == np.float64 and np.array_equal(got, one)
    assert [c for c, _ in shares] == list(range(min(n, nblocks)))
    assert sum(b for _, b in shares) == nblocks
    if case == "few_blocks":
        assert nblocks < n or n == 1


def test_grouped_split_matches_jax_mesh():
    """Eight devices against the JAX package's grouped dispatch over eight
    devices (interpret mode)."""
    pairs = _duplicated_region_pairs()
    got = pc.pairhmm_forward_grouped(pairs, [CPU] * 8)
    want = jax_grouped(pairs, interpret=True, devices=jax.devices()[:8])
    np.testing.assert_allclose(got, want, rtol=0, atol=DEVICE_TOL)


_JAX_MESH = {}


def _jax_mesh_chain(case):
    """JAX's smoothed_activity_device under an 8-device mesh, once a
    case."""
    if case not in _JAX_MESH:
        gls, hq, ploidy = ACTIVITY_CASES[case]()
        try:
            jshard.set_mesh(jshard.make_mesh(jax.devices()[:8]))
            _JAX_MESH[case] = np.asarray(
                jpipe.smoothed_activity_device(gls, hq, ploidy))
        finally:
            jshard.set_mesh(None)
    return _JAX_MESH[case]


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("case", sorted(ACTIVITY_CASES))
def test_activity_chain_split_over_devices(case, n):
    gls, hq, ploidy = ACTIVITY_CASES[case]()
    one = tpipe.smoothed_activity_device(gls, hq, ploidy, devices=CPU)
    got = tpipe.smoothed_activity_device(gls, hq, ploidy, devices=[CPU] * n)
    assert got.dtype == np.float32 and got.shape == (gls.shape[1],)
    assert got.max() > 0.01
    np.testing.assert_allclose(got, one, rtol=0, atol=SPLIT_TOL)
    host = band_pass_smooth(active_probabilities(gls, ploidy), hq)
    np.testing.assert_allclose(got, host, rtol=0, atol=ACT_HOST_TOL)
    if case != "ends":
        # the JAX chain pads the axis and smooths the right end's
        # expansion mass back in; the port follows the host there
        # (tests/test_torch_parallel.py)
        np.testing.assert_allclose(got, _jax_mesh_chain(case), rtol=0,
                                   atol=ACT_JAX_TOL)


def test_run_call_over_8_devices_matches_jax_mesh(tiny_fixture, tmp_path,  # noqa: F811
                                                   monkeypatch):
    """`call --devices 8` through the port (the plain K2 over eight CPU
    devices) writes the records the JAX package writes over its 8-device
    mesh (interpret mode), as tests/test_mesh_pipeline.py compares its
    mesh run with its one-device run."""
    monkeypatch.setattr(jlk, "PALLAS_INTERPRET", True)
    fasta, bam = tiny_fixture
    try:
        jcfg = jengine.CallerConfig(use_pallas=True)
        jcfg.devices = "8"
        vj = jax_run_call(fasta, [bam], str(tmp_path / "jax"), jcfg)
        assert jshard.get_mesh().devices.size == 8
    finally:
        jshard.set_mesh(None)
    cpu_cards(monkeypatch, 8)
    cards = []
    real = pc.pairhmm_grouped_cuda
    monkeypatch.setattr(pc, "pairhmm_grouped_cuda",
                        lambda t, card=0: cards.append(card) or real(t, card))
    cfg = tengine.CallerConfig(use_cuda=True)
    cfg.devices = "8"
    vt = tproc.run_call(fasta, [bam], str(tmp_path / "torch"), cfg)
    assert tshard.get_devices() == [CPU] * 8
    assert len(set(cards)) > 1 and cfg.device_activity is False
    bj = [ln for ln in open(vj) if not ln.startswith("##")]
    bt = [ln for ln in open(vt) if not ln.startswith("##")]
    assert bj == bt
    assert any(ln.split("\t")[1] == "451" for ln in bt), bt
