"""The flat pair-HMM, the region-batch step and the device activity chain
of the port against the JAX package, on the CPU.

The same arrays, made from a seed with numpy, go through the JAX function
and its counterpart:
- ``pairhmm_forward_flat`` (device "cpu": the plain version) against
  ``pairhmm_forward_pallas(..., interpret=True)`` at 1e-4 (both are the same
  f32 sweep; only f32 exp/log10 of two libraries differ), against the exact
  f64 ``pairhmm_forward_np`` at 2e-3, and against the port's grouped form
  at 1e-5;
- ``region_batch_step`` against the JAX one over a one-device mesh;
- ``smoothed_activity_device`` against the JAX one at 1e-4 and against the
  host chain at 2e-3 (the bound tests/test_mesh_pipeline.py holds the JAX
  chain to), on that file's arrays;
- world size 2 over gloo, in two processes, against world size 1, with an
  HQ expansion at an inner stretch edge and at the genome's two ends.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from lorikeet_tpu.ops.pairhmm_pallas import pairhmm_forward_pallas
from lorikeet_tpu.parallel import pipeline as jpipe
from lorikeet_tpu.parallel import sharding as jshard
import lorikeet_tpu_torch.ops.pairhmm as tph
from lorikeet_tpu_torch.models.activity import (
    active_probabilities, band_pass_smooth,
)
from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
from lorikeet_tpu_torch.parallel import pipeline as tpipe
from lorikeet_tpu_torch.parallel import sharding as tshard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = np.frombuffer(b"ACGT", np.uint8)
DEVICE_TOL = 1e-4     # plain version vs interpret-mode TPU kernel (f32 both)
EXACT_TOL = 2e-3      # f32 sweep vs exact f64
FORM_TOL = 1e-5       # flat vs grouped in the port: the same sweep
ACT_JAX_TOL = 1e-4    # f32 chain in torch vs f32 chain in jax
ACT_HOST_TOL = 2e-3   # f32 chain vs the f64 host chain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: several test workers each running
    torch's default thread pool only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ragged_pairs(seed=31):
    """Ragged reads and haplotypes with N, IUPAC and lowercase bytes; read
    lengths on both sides of a 32-lane and a 128-lane edge."""
    rng = np.random.default_rng(seed)
    pairs = []
    for R, H in [(1, 1), (1, 40), (20, 20), (31, 50), (32, 64), (33, 90),
                 (60, 61), (100, 240), (127, 300), (128, 129), (150, 310)]:
        hap = BASES[rng.integers(0, 4, H)].copy()
        lo = int(rng.integers(0, H - R + 1))
        read = hap[lo:lo + R].copy()
        if R > 4:
            read[int(rng.integers(0, R))] = BASES[int(rng.integers(0, 4))]
            read[int(rng.integers(0, R))] = ord("N")
            read[int(rng.integers(0, R))] = ord("r")
            hap[int(rng.integers(0, H))] = ord("N")
            hap[int(rng.integers(0, H))] = ord("R")
            hap[int(rng.integers(0, H))] = ord("g")
        pairs.append((hap, read, rng.integers(10, 40, R).astype(np.uint8),
                      rng.integers(30, 46, R).astype(np.uint8),
                      rng.integers(30, 46, R).astype(np.uint8),
                      np.full(R, 10, np.uint8)))
    return pairs


def _batch_args(pairs):
    a = tph.pack_pairhmm_batch(pairs)
    return (a["haps"], a["hap_lens"], a["reads"], a["read_lens"], a["quals"],
            a["ins_quals"], a["del_quals"], a["gcps"])


def test_flat_matches_pallas_interpret_and_f64():
    pairs = _ragged_pairs()
    args = _batch_args(pairs)
    got = pc.pairhmm_forward_flat(*args, device="cpu")
    assert got.dtype == np.float32 and got.shape == (len(pairs),)
    want = np.asarray(pairhmm_forward_pallas(*args, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=DEVICE_TOL)
    # the f64 reference matches bases by byte equality and the device
    # sweep folds lowercase to uppercase first: fold before asking it
    upper = lambda a: np.frombuffer(a.tobytes().upper(), np.uint8)  # noqa
    exact = np.array([tph.pairhmm_forward_np(upper(p[0]), upper(p[1]), *p[2:])
                      for p in pairs])
    assert exact.min() > tph.F32_SUSPECT_LOG10
    np.testing.assert_allclose(got, exact, rtol=0, atol=EXACT_TOL)


def test_flat_matches_grouped_in_the_port():
    pairs = _ragged_pairs(seed=32)
    flat = pc.pairhmm_forward_flat(*_batch_args(pairs), device="cpu")
    grouped = pc.pairhmm_forward_grouped(pairs, "cpu")
    np.testing.assert_allclose(flat, grouped, rtol=0, atol=FORM_TOL)


def test_pack_flat_inputs_layout():
    pairs = _ragged_pairs()[:4]
    arrays = pc.pack_flat_inputs(*_batch_args(pairs))
    rmax = max(len(p[1]) for p in pairs)
    assert arrays["quals"].shape == (4, -(-(rmax + 1) // 32) * 32)
    for k, (hap, read, q, iq, dq, g) in enumerate(pairs):
        R, H = len(read), len(hap)
        for name, src in zip(("quals", "ins_q", "del_q", "gcp_q", "read_u8"),
                             (q, iq, dq, g, read)):
            row = arrays[name][k]
            assert row[0] == 0 and not row[R + 1:].any()
            assert np.array_equal(row[1:R + 1], src)
        assert np.array_equal(arrays["haps"][k, :H], hap)
        assert arrays["read_lens"][k] == R and arrays["hap_lens"][k] == H
    t = pc.to_tensors(arrays, "cpu")
    pc._check_flat_inputs(t)
    t["haps"] = t["haps"][:3]
    t["hap_lens"] = t["hap_lens"][:3]
    with pytest.raises(ValueError, match="one haplotype row per read row"):
        pc._check_flat_inputs(t)
    t = pc.to_tensors(arrays, "cpu")
    t["read_lens"] = t["read_lens"].long()
    with pytest.raises(ValueError, match="read_lens"):
        pc._check_flat_inputs(t)


def test_flat_on_cuda_device_needs_a_card(monkeypatch):
    """On a CUDA device the entry point launches the kernel or raises: it
    never takes the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pc.pairhmm_forward_flat(*_batch_args(_ragged_pairs()[:2]),
                                device="cuda")


def test_sharded_at_world_size_one_is_flat():
    args = _batch_args(_ragged_pairs(seed=33))
    assert pc.rank_share(11) == (0, 11, 11, 1)
    np.testing.assert_array_equal(
        pc.pairhmm_forward_sharded(*args, device="cpu"),
        pc.pairhmm_forward_flat(*args, device="cpu"))


def test_region_batch_step_matches_jax():
    args = jshard.demo_inputs(n_pairs=16, n_samples=2)
    targs = tshard.demo_inputs(n_pairs=16, n_samples=2)
    for a, b in zip(args, targs):
        assert np.array_equal(a, b)
    mesh = jshard.make_mesh(jax.devices()[:1])
    lk_j, total_j = jshard.region_batch_step(mesh, interpret=True)(*args)
    lk_t, total_t = tshard.region_batch_step(None, device="cpu")(*targs)
    np.testing.assert_allclose(lk_t, np.asarray(lk_j), rtol=0,
                               atol=DEVICE_TOL)
    assert total_t.shape == (8, 8)
    np.testing.assert_allclose(total_t, np.asarray(total_j), rtol=0,
                               atol=1e-5)
    sid, dep = args[8], args[9]
    want = np.zeros((8, 8), np.float32)
    np.add.at(want, sid, dep)
    np.testing.assert_allclose(total_t, want, rtol=0, atol=1e-5)


def _planted_sites():
    rng = np.random.default_rng(4)
    S, L, ploidy = 3, 700, 2
    gls = rng.normal(-0.5, 0.4, (S, L, ploidy + 1))
    gls[:, 100] = np.array([-28.0, -4.0, 0.0])
    gls[:, 401] = np.array([-35.0, -6.0, -0.5])
    hq = np.zeros(L)
    hq[95:105] = 9.0                          # triggers the state expansion
    return gls, hq, ploidy


def _slow_convergence():
    rng = np.random.default_rng(11)
    S, L, ploidy = 12, 1500, 2
    gls = np.stack([rng.normal(-0.32, 0.02, (S, L)),
                    rng.normal(-0.30, 0.02, (S, L)),
                    rng.normal(-6.0, 0.5, (S, L))], axis=2)
    for pos in (200, 750, 751, 1290):
        for s in range(S // 2):
            gls[s, pos] = [-3.2, 0.0, -1.1]
        for s in range(S // 2, S):
            gls[s, pos] = [0.0, -0.4, -7.0]
    return gls, np.zeros(L), ploidy


def _halo_straddling():
    rng = np.random.default_rng(13)
    S, ploidy, L = 2, 2, 2048
    gls = rng.normal(-0.5, 0.3, (S, L, ploidy + 1))
    shard = L // 8
    for b in range(1, 8):
        for off in range(-3, 4):
            gls[:, b * shard + off] = np.array([-30.0, -3.0, 0.0])
    hq = np.zeros(L)
    hq[shard - 3:shard + 4] = 9.0
    return gls, hq, ploidy


def _both_ends():
    """Active sites and HQ expansion at the first and last positions of an
    axis that the JAX chain pads (700 -> 1024) and the port does not.  The
    expansion at the right end stays inside the profile."""
    rng = np.random.default_rng(17)
    S, L, ploidy = 2, 700, 2
    gls = rng.normal(-0.5, 0.3, (S, L, ploidy + 1))
    for pos in (0, 1, 7, 650, 698, 699):
        gls[:, pos] = np.array([-30.0, -3.0, 0.0])
    hq = np.zeros(L)
    hq[7] = 30.0                              # reaches past the left end
    hq[650] = 40.0                            # 650 + 40 stays below L
    return gls, hq, ploidy


ACTIVITY_CASES = {"planted": _planted_sites, "slow": _slow_convergence,
                  "halo": _halo_straddling, "ends": _both_ends}


@pytest.mark.parametrize("case", sorted(ACTIVITY_CASES))
def test_activity_chain_matches_jax_and_host(case):
    gls, hq, ploidy = ACTIVITY_CASES[case]()
    jshard.set_mesh(None)
    want = jpipe.smoothed_activity_device(gls, hq, ploidy)
    got = tpipe.smoothed_activity_device(gls, hq, ploidy, devices="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.max() > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=ACT_JAX_TOL)
    host = band_pass_smooth(active_probabilities(gls, ploidy), hq)
    np.testing.assert_allclose(got, host, rtol=0, atol=ACT_HOST_TOL)


def test_activity_expansion_past_the_right_end_follows_the_host():
    """An HQ expansion that reaches past the last (or the first) position is
    dropped there, as on the host (the reference drops out-of-profile
    offsets).  The JAX chain pads the axis, keeps the right end's mass in
    the padding and smooths it back in, so it is not the yardstick for this
    case."""
    gls, hq, ploidy = _both_ends()
    hq[698] = 30.0
    hq[2] = 30.0
    got = tpipe.smoothed_activity_device(gls, hq, ploidy, devices="cpu")
    host = band_pass_smooth(active_probabilities(gls, ploidy), hq)
    np.testing.assert_allclose(got, host, rtol=0, atol=ACT_HOST_TOL)
    # the position-split form cuts the expansion at the same two positions
    split = tpipe.sharded_smoothed_activity(gls, hq, ploidy, device="cpu")
    np.testing.assert_allclose(split, got, rtol=0, atol=1e-6)


def test_activity_pieces_match_jax():
    gls, hq, ploidy = _planted_sites()
    g32 = gls.astype(np.float32)
    probs_j = np.asarray(jpipe.active_probabilities_jax(
        jax.numpy.asarray(g32), ploidy, n_iters=100))
    probs_t = tpipe.active_probabilities_torch(
        torch.from_numpy(g32), ploidy, n_iters=100)
    np.testing.assert_allclose(probs_t.numpy(), probs_j, rtol=0, atol=1e-6)
    assert (probs_t > 0).sum() >= 2
    exp_j = np.asarray(jpipe._expand_hq_jax(
        jax.numpy.asarray(probs_j), jax.numpy.asarray(hq, np.float32), 50))
    exp_t = tpipe._expand_hq_torch(
        probs_t, torch.from_numpy(hq.astype(np.float32)), 50)
    np.testing.assert_allclose(exp_t.numpy(), exp_j, rtol=0, atol=1e-6)
    x = np.random.default_rng(0).random(400).astype(np.float32)
    from lorikeet_tpu_torch.models.activity import gaussian_kernel
    want = np.convolve(x.astype(np.float64), gaussian_kernel(), mode="same")
    np.testing.assert_allclose(
        tpipe._band_pass_torch(torch.from_numpy(x)).numpy(), want,
        rtol=0, atol=1e-6)


def test_sharded_activity_step_matches_jax():
    rng = np.random.default_rng(0)
    S, L, ploidy = 2, 512, 2
    gls = rng.normal(-1.0, 0.5, (S, L, ploidy + 1)).astype(np.float32)
    gls[:, 255] = np.array([-30.0, -3.0, 0.0])
    depths = rng.integers(0, 30, (S, L)).astype(np.float32)
    mesh = jshard.make_mesh(jax.devices()[:1])
    sm_j, tot_j = jpipe.sharded_activity_step(mesh, ploidy)(gls, depths)
    sm_t, tot_t = tpipe.sharded_activity_step(None, ploidy, device="cpu")(
        gls, depths)
    assert sm_t.max() > 0.01
    np.testing.assert_allclose(sm_t, np.asarray(sm_j), rtol=0,
                               atol=ACT_JAX_TOL)
    np.testing.assert_allclose(tot_t, np.asarray(tot_j), rtol=0, atol=1e-3)


def test_dryrun_on_the_cpu():
    from lorikeet_tpu_torch.parallel.dryrun import dryrun
    dryrun(1, device="cpu")
    with pytest.raises(ValueError, match="world size"):
        dryrun(2, device="cpu")


GLOO_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {tests!r})
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
from lorikeet_tpu_torch.parallel import pipeline, sharding
import test_torch_parallel as tp

pairs = tp._ragged_pairs(seed=34)            # 11 pairs: an uneven split
args = tp._batch_args(pairs)
step_args = sharding.demo_inputs(n_pairs=13, n_samples=3)
gls, hq, ploidy = tp._halo_straddling()
end_gls, end_hq, _ = tp._both_ends()         # HQ expansion past both ends
end_hq[2] = end_hq[698] = 30.0
depths = np.random.default_rng(5).integers(0, 30, gls.shape[:2]).astype(
    np.float32)


def run():
    lk = pc.pairhmm_forward_sharded(*args, device="cpu")
    lk2, total = sharding.region_batch_step(None, device="cpu")(*step_args)
    sm, dep = pipeline.sharded_activity_step(None, ploidy, device="cpu")(
        gls, depths)
    full = pipeline.sharded_smoothed_activity(gls, hq, ploidy, device="cpu")
    ends = pipeline.sharded_smoothed_activity(end_gls, end_hq, ploidy,
                                              device="cpu")
    return dict(lk=lk, lk2=lk2, total=total, sm=sm, dep=dep, full=full,
                ends=ends)


one = run() if rank == 0 else None           # world size 1: no group yet
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2)
assert pc.rank_share(11) == ((0, 6, 6, 2) if rank == 0 else (6, 11, 6, 2))
two = run()
dist.barrier()
dist.destroy_process_group()
if rank == 0:
    for key in ("lk", "lk2", "dep"):
        assert np.array_equal(one[key], two[key]), key
    assert np.allclose(one["total"], two["total"], rtol=0, atol=1e-6)
    for key in ("sm", "full", "ends"):
        assert one[key].max() > 0.01
        assert np.allclose(one[key], two[key], rtol=0, atol=1e-6), key
    single = pipeline.smoothed_activity_device(gls, hq, ploidy,
                                               devices="cpu")
    assert np.allclose(single, two["full"], rtol=0, atol=1e-6)
    single = pipeline.smoothed_activity_device(end_gls, end_hq, ploidy,
                                               devices="cpu")
    for got in (one["ends"], two["ends"]):
        assert np.allclose(single, got, rtol=0, atol=1e-6)
    open(out, "w").write("ok")
"""


def test_world_size_two_over_gloo(tmp_path):
    """Two processes over gloo (a file:// store, no port): the sharded
    pair-HMM, the region-batch step and the sharded activity step give
    what world size 1 gives."""
    script = tmp_path / "worker.py"
    script.write_text(GLOO_WORKER.format(tests=os.path.join(REPO, "tests")))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    store, out = str(tmp_path / "store"), str(tmp_path / "ok")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), store, out], env=env,
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    assert os.path.exists(out)


def test_native_libraries_are_keyed_to_sources_and_machine(monkeypatch):
    """The host libraries build into the port's build directory, under a
    name that changes with the CPU, so a copied tree rebuilds by itself."""
    import lorikeet_tpu_torch.native as native
    from lorikeet_tpu_torch.ops.smith_waterman import (
        NEW_SW_PARAMETERS, OverhangStrategy, align,
    )
    assert align(b"ACGTACGTTT", b"ACGTCGTTT", NEW_SW_PARAMETERS,
                 OverhangStrategy.SOFTCLIP) is not None
    built = [f for f in os.listdir(native.BUILD_DIR)
             if f.startswith("libsw_host_") and f.endswith(".so")]
    assert built and native.BUILD_DIR.endswith(
        os.path.join("lorikeet_tpu_torch", "build"))
    pkg_dir = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(pkg_dir) if f.endswith(".so")]
    src = [os.path.join(pkg_dir, "sw.cpp")]
    here = native._digest(src, [])
    assert f"libsw_host_{here}.so" in built
    monkeypatch.setattr(native, "_MACHINE", native.machine_key() + " avx9")
    assert native._digest(src, []) != here
