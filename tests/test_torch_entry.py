"""The batched pair-HMM wavefront (K5), `entry()`, `initialize_distributed`
and `global_stage` of the port against the JAX package, on the CPU.

- ``ops.pairhmm.pairhmm_forward_batch`` (torch ops, device "cpu") against
  the JAX package's ``pairhmm_forward_batch`` (XLA on the CPU) at 1e-4 in
  log10 on batches made from a seed with numpy (ragged lengths, N bases),
  and, after the f64 escalation of rows in the f32 flush zone, against the
  exact ``pairhmm_forward_np`` at 2e-3 (the bound of
  tests/test_pairhmm.py);
- ``entry.entry(device="cpu")`` against ``__graft_entry__.entry()``: the
  same example arrays and ``fn(*args)`` within 1e-4;
- ``initialize_distributed`` in two processes over gloo on localhost: each
  sees its own (rank, 2), and ``host_shard`` splits a genome list as the
  JAX package's does under LORIKEET_PROCESS_INDEX / COUNT;
- ``global_stage`` accumulates seconds when GLOBAL_STAGES is a dict and
  leaves nothing behind when it is None.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import __graft_entry__
from lorikeet_tpu.ops import pairhmm as jph
from lorikeet_tpu.parallel import hosts as jhosts
from lorikeet_tpu_torch import entry as tentry
from lorikeet_tpu_torch.ops import pairhmm as tph
from lorikeet_tpu_torch.utils import progress

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOL = 1e-4       # torch f32 wavefront vs XLA f32 wavefront
EXACT_TOL = 2e-3     # f32 wavefront (escalated) vs exact f64
BASES = np.frombuffer(b"ACGT", np.uint8)


def _random_pairs(seed, n=24, with_n=True):
    """Ragged reads (3-90 bases) and haplotypes (5-120) with N bases,
    random quals; some reads copied from a window of their haplotype with
    errors, some fully random (the deep low-likelihood regime)."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTN" if with_n else b"ACGT", np.uint8)
    pairs = []
    for k in range(n):
        H = int(rng.integers(5, 121))
        R = int(rng.integers(3, 91))
        hap = alphabet[rng.integers(0, len(alphabet), H)]
        if k % 2 and R <= H:
            start = int(rng.integers(0, H - R + 1))
            read = hap[start:start + R].copy()
            read[rng.integers(0, R, 2)] = BASES[rng.integers(0, 4, 2)]
        else:
            read = alphabet[rng.integers(0, len(alphabet), R)]
        pairs.append((hap, read, rng.integers(6, 41, R).astype(np.uint8),
                      rng.integers(10, 50, R).astype(np.uint8),
                      rng.integers(10, 50, R).astype(np.uint8),
                      rng.integers(5, 20, R).astype(np.uint8)))
    return pairs


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_forward_batch_matches_jax(seed):
    pairs = _random_pairs(seed, with_n=seed != 3)
    batch = tph.pack_pairhmm_batch(pairs)
    got = tph.pairhmm_forward_batch(**batch, device="cpu")
    want = np.asarray(jph.pairhmm_forward_batch(**batch))
    assert got.dtype == torch.float32 and got.shape == (len(pairs),)
    assert np.abs(got.numpy() - want).max() <= JAX_TOL


def test_forward_batch_escalated_matches_f64():
    pairs = _random_pairs(7)
    batch = tph.pack_pairhmm_batch(pairs)
    raw = tph.pairhmm_forward_batch(**batch, device="cpu").numpy()
    got = tph.pairhmm_forward_checked(raw, pairs)
    want = np.array([tph.pairhmm_forward_np(*p) for p in pairs])
    assert np.abs(got - want).max() < EXACT_TOL
    # most rows stay above the flush zone and are the wavefront's own
    assert np.abs(raw - want)[raw > tph.F32_SUSPECT_LOG10].max() < EXACT_TOL
    assert (raw > tph.F32_SUSPECT_LOG10).sum() >= len(pairs) // 2


def test_forward_batch_takes_the_tensors_device():
    """Tensors in: the result lies on their device; numpy in with no
    device named: the card, an error without one."""
    batch = tph.pack_pairhmm_batch(_random_pairs(8, n=5))
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tph.pairhmm_forward_batch(**tensors)
    assert got.device.type == "cpu"
    assert torch.equal(got, tph.pairhmm_forward_batch(**batch,
                                                      device="cpu"))


def test_forward_batch_without_a_card_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = tph.pack_pairhmm_batch(_random_pairs(9, n=3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tph.pairhmm_forward_batch(**batch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()


def test_entry_matches_jax_entry():
    jfn, jargs = __graft_entry__.entry()
    fn, args = tentry.entry(device="cpu")
    assert len(args) == 8 and len(jargs) == 9
    for mine, theirs in zip(args, jargs):
        assert mine.dtype == theirs.dtype
        assert np.array_equal(mine, theirs)
    got = fn(*args)
    want = np.asarray(jfn(*jargs))
    assert got.shape == (32,) and got.device.type == "cpu"
    assert np.all(np.isfinite(want)) and np.all(want < 0)
    assert np.abs(got.numpy() - want).max() <= JAX_TOL


def test_global_stage_accumulates_only_when_on(monkeypatch):
    monkeypatch.setattr(progress, "GLOBAL_STAGES", None)
    with progress.global_stage("pairhmm"):
        pass
    assert progress.GLOBAL_STAGES is None
    monkeypatch.setattr(progress, "GLOBAL_STAGES", {"pairhmm": 1.0})
    for _ in range(2):
        with progress.global_stage("pairhmm"):
            time.sleep(0.01)
    with pytest.raises(ValueError):
        with progress.global_stage("genotype"):
            raise ValueError("the stage still counts")
    assert progress.GLOBAL_STAGES["pairhmm"] >= 1.02
    assert progress.GLOBAL_STAGES["genotype"] >= 0.0


DIST_WORKER = """
import json, sys
import torch.distributed as dist
from lorikeet_tpu_torch.parallel.hosts import (
    host_shard, initialize_distributed)
coordinator, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
got = initialize_distributed(coordinator, 2, rank, device="cpu")
assert dist.get_backend() == "gloo"
dist.barrier()
shard = host_shard(list(range(7)))
dist.destroy_process_group()
with open(out, "w") as fh:
    json.dump({"context": list(got), "shard": shard}, fh)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_distributed_over_gloo(tmp_path, monkeypatch):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for key in ("LORIKEET_PROCESS_INDEX", "LORIKEET_PROCESS_COUNT"):
        env.pop(key, None)
    coordinator = f"127.0.0.1:{_free_port()}"
    outs = [str(tmp_path / f"rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", DIST_WORKER, coordinator, str(r), outs[r]],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    monkeypatch.setenv("LORIKEET_PROCESS_COUNT", "2")
    for rank, path in enumerate(outs):
        with open(path) as fh:
            seen = json.load(fh)
        assert seen["context"] == [rank, 2]
        monkeypatch.setenv("LORIKEET_PROCESS_INDEX", str(rank))
        assert seen["shard"] == jhosts.host_shard(list(range(7)))


def test_initialize_distributed_without_coordinator_is_a_no_op(monkeypatch):
    from lorikeet_tpu_torch.parallel.hosts import initialize_distributed
    monkeypatch.delenv("LORIKEET_PROCESS_INDEX", raising=False)
    monkeypatch.delenv("LORIKEET_PROCESS_COUNT", raising=False)
    assert initialize_distributed() == (0, 1)
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_distributed("127.0.0.1:1", 1, 0)
