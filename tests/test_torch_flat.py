"""The flat pair-HMM kernel's column schedule and its packer, on the CPU.

``testkit/flat_schedule.py`` repeats ``csrc/pairhmm.cu:sweep_cols`` step by
step, lane by lane and slot by slot in numpy f32.  The same pairs, made
from a seed with numpy, go through it, the port's plain version
(``pairhmm_flat_torch``, the anti-diagonal sweep) and the JAX package's
``pairhmm_forward_pallas`` in interpret mode: within 1e-5 on rows above
F32_SUSPECT_LOG10, and within 2e-3 of the exact f64 kernel after the
escalation rule.  Read lengths sit on both sides of every class edge
(32 K >= R + 1 for K = 1, 2, 4, 8, 16), haplotypes are empty, one base,
shorter than the read and much longer, with N, IUPAC and unknown bytes.
The packer's classes, order and groups are checked on their own.
"""
import numpy as np
import pytest
import torch

from lorikeet_tpu.ops.pairhmm_pallas import pairhmm_forward_pallas
from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
from lorikeet_tpu_torch.ops.pairhmm import (
    F32_SUSPECT_LOG10, pack_pairhmm_batch, pairhmm_forward_checked,
    pairhmm_forward_f64,
)
from lorikeet_tpu_torch.testkit.flat_schedule import (
    flat_schedule_forward, sweep_cols_np,
)

KERNEL_TOL = 1e-5     # the column schedule vs the anti-diagonal sweep, f32
EXACT_TOL = 2e-3      # after the escalation rule vs the exact f64 kernel
BASES = np.frombuffer(b"ACGT", np.uint8)
ODD = np.frombuffer(b"NRYX", np.uint8)      # N, IUPAC, unknown
READ_LENS = (1, 31, 32, 63, 64, 127, 128, 255, 511)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(rng, R, H):
    hap = BASES[rng.integers(0, 4, H)].copy()
    if H >= R:
        lo = int(rng.integers(0, H - R + 1))
        read = hap[lo:lo + R].copy()
    else:
        read = BASES[rng.integers(0, 4, R)].copy()
    read[rng.integers(0, R, 2)] = BASES[rng.integers(0, 4, 2)]
    if R > 4:
        read[rng.integers(0, R, 2)] = ODD[rng.integers(0, 4, 2)]
    if H > 4:
        hap[rng.integers(0, H, 2)] = ODD[rng.integers(0, 4, 2)]
    # long reads get high qualities, so that most stay above the escalation
    # bound and are compared at the kernel's tolerance
    q_lo = 10 if R < 200 else 30
    return (hap, read, rng.integers(q_lo, 41, R).astype(np.uint8),
            rng.integers(30, 46, R).astype(np.uint8),
            rng.integers(30, 46, R).astype(np.uint8),
            np.full(R, 10, np.uint8))


def _batch_args(pairs):
    a = pack_pairhmm_batch(pairs)
    return (a["haps"], a["hap_lens"], a["reads"], a["read_lens"], a["quals"],
            a["ins_quals"], a["del_quals"], a["gcps"])


def _hap_lens(R):
    """Empty, one base, shorter than the read, much longer."""
    return (0, 1, max(1, R // 2), 3 * R + 40)


@pytest.mark.parametrize("R", READ_LENS)
def test_schedule_matches_plain_pallas_and_f64(R):
    rng = np.random.default_rng(600 + R)
    pairs = [_pair(rng, R, H) for H in _hap_lens(R)]
    pairs += [_pair(rng, R, R + 20) for _ in range(2)]
    args = _batch_args(pairs)
    arrays = pc.pack_flat_inputs(*args)
    got = flat_schedule_forward(arrays)
    assert got.dtype == np.float32 and got.shape == (len(pairs),)
    assert np.all(np.isfinite(got))
    plain = pc.pairhmm_flat_torch(pc.to_tensors(arrays, "cpu")).numpy()
    want = np.asarray(pairhmm_forward_pallas(*args, interpret=True))
    keep = plain > F32_SUSPECT_LOG10
    assert keep.sum() >= 3
    np.testing.assert_allclose(got[keep], plain[keep], rtol=0,
                               atol=KERNEL_TOL)
    np.testing.assert_allclose(got[keep], want[keep], rtol=0,
                               atol=KERNEL_TOL)
    exact = pairhmm_forward_f64(pairs)
    np.testing.assert_allclose(pairhmm_forward_checked(got, pairs), exact,
                               rtol=0, atol=EXACT_TOL)


def test_flat_classes_at_every_edge():
    R = np.array([0, 1, 30, 31, 32, 63, 64, 127, 128, 255, 256, 511, 512,
                  3000])
    assert pc.flat_classes(R).tolist() == [1, 1, 1, 1, 2, 2, 4, 4, 8, 8, 16,
                                           16, 0, 0]
    # lanes in use: ceil((R + 1) / K) <= 32, and the steps H + L - 1
    assert pc.flat_steps([31, 32, 90, 511], [66, 66, 66, 66],
                         [1, 2, 4, 16]).tolist() == [104, 88, 88, 104]
    assert pc.flat_steps([600], [66], [0]).tolist() == [672]


def _ragged(seed, n, r_hi=600, h_hi=700):
    rng = np.random.default_rng(seed)
    return [_pair(rng, int(rng.integers(1, r_hi)), int(rng.integers(0, h_hi)))
            for _ in range(n)]


def test_pack_flat_order_and_groups():
    pairs = _ragged(1, 60)
    arrays = pc.pack_flat_inputs(*_batch_args(pairs))
    R = arrays["read_lens"].astype(np.int64)
    H = arrays["hap_lens"].astype(np.int64)
    order = arrays["order"]
    assert order.dtype == np.int32
    assert sorted(order.tolist()) == list(range(len(pairs)))
    kclass = pc.flat_classes(R)
    present = [k for k in pc.FLAT_ORDER if (kclass == k).any()]
    assert [g[0] for g in arrays["groups"]] == present       # one per class
    assert arrays["groups"][0][1] == 0
    assert arrays["groups"][-1][2] == len(pairs)
    for (k, lo, hi), nxt in zip(arrays["groups"],
                                arrays["groups"][1:] + ((None, None, None),)):
        assert nxt[1] in (None, hi)
        rows = order[lo:hi]
        assert (kclass[rows] == k).all() and hi - lo == (kclass == k).sum()
        steps = pc.flat_steps(R[rows], H[rows], kclass[rows])
        assert (np.diff(steps) <= 0).all()            # most steps first
        ties = np.diff(steps) == 0                    # stable among ties
        assert (np.diff(rows)[ties] > 0).all()
    pc._check_flat_inputs(pc.to_tensors(arrays, "cpu"))


def test_pack_flat_empty_and_single_class():
    arrays = pc.pack_flat_inputs(
        np.zeros((0, 4), np.uint8), np.zeros(0, np.int32),
        np.zeros((0, 3), np.uint8), np.zeros(0, np.int32),
        *(np.zeros((0, 3), np.uint8) for _ in range(4)))
    assert arrays["groups"] == () and arrays["order"].shape == (0,)
    pc._check_flat_inputs(pc.to_tensors(arrays, "cpu"))
    assert pc.pairhmm_flat_cuda(pc.to_tensors(arrays, "cpu")).shape == (0,)
    rng = np.random.default_rng(2)
    pairs = [_pair(rng, int(r), 90) for r in (64, 100, 127, 70)]
    arrays = pc.pack_flat_inputs(*_batch_args(pairs))
    assert arrays["groups"] == ((4, 0, 4),)


def test_pack_flat_rejects_bad_groups():
    arrays = pc.pack_flat_inputs(*_batch_args(_ragged(3, 12, r_hi=200)))
    for groups in (arrays["groups"][:-1], ((3, 0, 12),),
                   ((1, 0, 5), (2, 6, 12))):
        t = pc.to_tensors({**arrays, "groups": groups}, "cpu")
        with pytest.raises(ValueError, match="groups"):
            pc._check_flat_inputs(t)


def test_results_come_back_in_input_order():
    """A batch of every class, with duplicate tuples, in the order the
    launches run it, against each pair swept alone: the emulation takes a
    pair's own step count, so the values are equal; the plain version
    agrees within the kernel's tolerance."""
    pairs = _ragged(4, 30)
    pairs += [pairs[3], pairs[17], pairs[3]]
    arrays = pc.pack_flat_inputs(*_batch_args(pairs))
    assert len(arrays["groups"]) >= 5
    assert not np.array_equal(arrays["order"], np.arange(len(pairs)))
    got = flat_schedule_forward(arrays)
    alone = np.array([flat_schedule_forward(
        pc.pack_flat_inputs(*_batch_args([p])))[0] for p in pairs])
    np.testing.assert_array_equal(got, alone)
    plain = pc.pairhmm_forward_flat(*_batch_args(pairs), device="cpu")
    keep = plain > F32_SUSPECT_LOG10
    np.testing.assert_allclose(got[keep], plain[keep], rtol=0,
                               atol=KERNEL_TOL)


def test_sweep_cols_rejects_a_read_past_its_class():
    rng = np.random.default_rng(5)
    arrays = pc.pack_flat_inputs(*_batch_args(
        [_pair(rng, 31, 40), _pair(rng, 32, 40)]))
    assert arrays["groups"] == ((1, 0, 1), (2, 1, 2))
    sweep_cols_np(arrays, [0], 1)
    with pytest.raises(ValueError, match="class K=1"):
        sweep_cols_np(arrays, [1], 1)


def test_grouped_tables_pass_their_own_check():
    """The flat operands' ``order`` is not asked of the grouped tables."""
    rng = np.random.default_rng(6)
    pairs = [_pair(rng, 50, 120) for _ in range(5)]
    t = pc.to_tensors(pc.prepare_grouped_jobs(pairs)[0], "cpu")
    pc._check_inputs(t)
    assert "order" not in t
