"""The pool's shared-memory transport of pair batches
(lorikeet_tpu_torch.parallel.shm) on the CPU.

A worker copies each pair batch into a segment it owns and sends only the
batch's header; the parent's device service maps the batch while it
enqueues it.  The service runs the plain versions here (CPU devices in the
cards' place), as in ``test_torch_pool.py``.  Checked: a pooled ``call``'s
VCF against the serial run's, every batch through a segment; the arrays
``enqueue_grouped_jobs`` is handed against those the worker packed, flat
and wire; a segment grown for a larger batch; a killed worker's
replacement on a segment of its own, and no descriptor left in the parent
once the pool is shut down.
"""
import gc
import multiprocessing as mp
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from lorikeet_tpu_torch import processing as tproc
from lorikeet_tpu_torch.calling.engine import (
    CallerConfig, HaplotypeCallerEngine,
)
from lorikeet_tpu_torch.io.bam import open_bam
from lorikeet_tpu_torch.io.fasta import FastaReader
from lorikeet_tpu_torch.ops import pairhmm_cuda
from lorikeet_tpu_torch.ops import pairhmm_pack as pk
from lorikeet_tpu_torch.ops import sw_cuda
from lorikeet_tpu_torch.parallel import pool as pool_mod
from lorikeet_tpu_torch.parallel import sharding
from lorikeet_tpu_torch.parallel import shm
from lorikeet_tpu_torch.testkit.dataset import simulate_dataset


@pytest.fixture(autouse=True)
def _fresh_pools():
    """Each test starts its own workers (fresh code caches, fresh
    segments) on one torch thread, and leaves no pool behind."""
    pool_mod.shutdown_pool()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    pool_mod.shutdown_pool()


@pytest.fixture
def plain_devices(monkeypatch):
    cpu = [torch.device("cpu")]
    monkeypatch.setattr(sharding, "visible_cards", lambda: cpu)
    monkeypatch.setattr(sharding, "_DEVICES", cpu)
    monkeypatch.setattr(sw_cuda, "SW_DEVICE", "cpu")
    monkeypatch.setattr(pool_mod, "WORKER_COUNTS",
                        dict.fromkeys(pool_mod.WORKER_COUNTS, 0))


@pytest.fixture(scope="module")
def genome80(tmp_path_factory):
    """One span of 80 kb at two samples; 15x keeps the plain versions'
    batches small."""
    return simulate_dataset(str(tmp_path_factory.mktemp("g80")), 80, 2, 15.0,
                            seed=2)


def _key(calls):
    return [(c.tid, c.start, tuple(a.bases for a in c.alleles),
             tuple(tuple(g.alleles[i].bases for i in range(len(g.alleles)))
                   for g in c.genotypes), c.log10_p_error)
            for c in calls]


def _open(fasta, bams):
    return FastaReader(fasta), [open_bam(p) for p in bams]


def test_pooled_call_vcf_equals_serial(genome80, plain_devices, monkeypatch,
                                       tmp_path):
    """A pooled `call -t 2` with the device service writes the serial
    run's VCF byte for byte, and every pair batch went through a
    segment."""
    fasta, bams, _ = genome80
    monkeypatch.setattr(tproc, "_pool_worthwhile", lambda *a: True)
    out = {}
    for threads in (1, 2):
        res = tproc.start_engine("call", [fasta], bams,
                                 str(tmp_path / f"t{threads}"),
                                 CallerConfig(use_cuda=True, threads=threads))
        ((out[threads],),) = [res.values()]
    with open(out[1]["vcf"], "rb") as a, open(out[2]["vcf"], "rb") as b:
        assert a.read() == b.read()
    assert out[1]["n_calls"] > 0
    counts = pool_mod.WORKER_COUNTS
    assert counts["lk_shm_batches"] == counts["lk_batches"] > 0


def _worker_job(fasta, bams, cfg, span, wire):
    """The batch a fresh worker packs for ``span``, packed here as
    ``_worker_main`` does."""
    engine = HaplotypeCallerEngine(cfg)
    engine.genotyping._upstream_dels = []
    engine.genotyping.deletion_checks = []
    fr, readers = _open(fasta, bams)
    _, works = tproc._call_span(fr, readers, "contig1", cfg, engine, *span,
                                defer=True)
    return pk.prepare_grouped_jobs([p for w in works for p in w.pairs],
                                   wire=wire)


@pytest.mark.parametrize("setting, form", [("0", "flat"), ("1", "wire")])
def test_service_sees_the_worker_batch(genome80, plain_devices, monkeypatch,
                                       setting, form):
    """``enqueue_grouped_jobs`` in the service is handed the keys, dtypes,
    shapes and values that ``prepare_grouped_jobs`` made in the worker,
    in the flat and the wire form."""
    fasta, bams, _ = genome80
    monkeypatch.setenv("LORIKEET_WIRE_COMPRESS", setting)
    seen, spans = [], []
    real = pairhmm_cuda.enqueue_grouped_jobs

    def watch(arrays, out_pos, *rest):
        seen.append(({k: np.array(v) if isinstance(v, np.ndarray) else v
                      for k, v in arrays.items()}, np.array(out_pos)))
        return real(arrays, out_pos, *rest)

    monkeypatch.setattr(pairhmm_cuda, "enqueue_grouped_jobs", watch)
    submit = pool_mod.SpanWorkerPool.submit
    monkeypatch.setattr(pool_mod.SpanWorkerPool, "submit",
                        lambda self, contig, span, *a, **k:
                        spans.append(span) or submit(self, contig, span,
                                                     *a, **k))
    cfg = CallerConfig(use_cuda=True, threads=2)
    fr, readers = _open(fasta, bams)
    pool = pool_mod.get_pool(fasta, bams, cfg, 2, device_service=True)
    pooled = tproc.call_contig(fr, readers, "contig1", cfg,
                               HaplotypeCallerEngine(cfg), pool=pool)
    assert pooled.calls and len(spans) == 1 and len(seen) == 1
    # the worker started with empty code caches: so does this packing
    monkeypatch.setattr(pk, "_qual_codes", pk._SortedCodeCache(256, np.uint32))
    monkeypatch.setattr(pk, "_base_codes",
                        pk._SortedCodeCache(pk._SYM_CAP, np.uint8))
    arrays, out_pos = _worker_job(fasta, bams, cfg, spans[0], pool.wire)
    got, got_pos = seen[0]
    assert arrays["mode"] == got["mode"] == form
    assert got.keys() == arrays.keys()
    for k, v in arrays.items():
        if isinstance(v, np.ndarray):
            assert (got[k].dtype, got[k].shape) == (v.dtype, v.shape), k
            assert np.array_equal(got[k], v), k
    assert got_pos.dtype == out_pos.dtype
    assert np.array_equal(got_pos, out_pos)
    assert pool_mod.WORKER_COUNTS["lk_shm_batches"] == 1


def _job(rng, rows):
    """A batch shaped as the packer's: arrays of several dtypes and
    ranks, an empty one, a non-array entry, and ``out_pos``."""
    arrays = {"mode": "flat",
              "tile_tab": rng.integers(0, 99, rows // 32, dtype=np.int32),
              "quals": rng.integers(0, 255, (rows, 161), dtype=np.uint8),
              "cb": rng.integers(0, 2**32, 7, dtype=np.uint32),
              "empty": np.zeros((0, 3), np.int32),
              "read_lens": rng.integers(0, 160, rows, dtype=np.int32)}
    return arrays, rng.integers(0, rows, rows * 2, dtype=np.int64)


def _fds():
    return len(os.listdir("/proc/self/fd"))


def test_segment_grows_and_keeps_values(monkeypatch):
    """A batch larger than the segment makes a new one, which the header
    announces with its descriptor; the service drops the old one. A
    batch that fits reuses the segment. Every batch reads back exactly."""
    monkeypatch.setattr(shm, "MIN_BYTES", 4096)
    rng = np.random.default_rng(0)
    a, b = mp.get_context("spawn").Pipe()
    worker, service = shm.WorkerSegment(), shm.ServiceSegments()
    fds = _fds()
    try:
        idents, held = [], []
        for tid, rows in enumerate((64, 512, 128)):
            arrays, out_pos = _job(rng, rows)
            worker.send(a, (arrays, out_pos), tid)
            kind, header, got_tid = b.recv()
            assert (kind, got_tid) == ("lk", tid)
            batch = service.receive(b, header)
            assert batch.arrays.keys() == arrays.keys()
            assert batch.arrays["mode"] == "flat"
            for k, v in arrays.items():
                if isinstance(v, np.ndarray):
                    assert batch.arrays[k].dtype == v.dtype
                    assert np.array_equal(batch.arrays[k], v), k
                    assert batch.arrays[k].ctypes.data % shm.ALIGN == 0
            assert np.array_equal(batch.out_pos, out_pos)
            batch.close()
            idents.append((header["segment"], header["new"]))
            held.append(_fds())
        # the second batch (eight times the first) did not fit
        assert [new for _, new in idents] == [True, True, False]
        assert idents[0][0] != idents[1][0] == idents[2][0]
        # one segment held on each side: the old one's descriptors closed
        assert fds < held[0] == held[1] == held[2]
    finally:
        worker.close()
        service.close()
        a.close()
        b.close()
    assert _fds() == fds - 2


def test_a_view_kept_past_the_enqueue_is_an_error():
    a, b = mp.get_context("spawn").Pipe()
    worker, service = shm.WorkerSegment(), shm.ServiceSegments()
    try:
        worker.send(a, _job(np.random.default_rng(1), 64), 0)
        batch = service.receive(b, b.recv()[1])
        kept = batch.arrays["quals"]
        with pytest.raises(RuntimeError, match="outlived its enqueue"):
            batch.close()
        del kept
        batch.close()
    finally:
        worker.close()
        service.close()
        a.close()
        b.close()


def test_killed_worker_replacement_and_no_descriptor_left(
        genome80, plain_devices, monkeypatch):
    """SIGKILL the pool's one worker mid-span: its replacement reruns the
    span and ships the batch through a segment of its own; the calls are
    the serial run's.  Once the pool is shut down the parent holds no more
    descriptors than before it started."""
    fasta, bams, _ = genome80
    cfg = CallerConfig(use_cuda=True, threads=1)
    serial = tproc.call_contig(*_open(fasta, bams), "contig1", cfg,
                               HaplotypeCallerEngine(cfg))
    # a first pool's start opens what the process keeps (the spawn
    # context's resource tracker): counted before, not left after
    pool_mod.get_pool(fasta, bams, cfg, 1, device_service=True)
    pool_mod.shutdown_pool()
    gc.collect()
    fds = _fds()
    seen = []
    receive = shm.ServiceSegments.receive
    monkeypatch.setattr(shm.ServiceSegments, "receive",
                        lambda self, conn, header:
                        seen.append((header["segment"][0], header["new"]))
                        or receive(self, conn, header))
    pool = pool_mod.get_pool(fasta, bams, cfg, 1, device_service=True)
    first = pool.workers[0].pid
    killed = []

    def killer():
        for _ in range(3000):          # wait for the span to be in flight
            if pool._inflight:
                time.sleep(0.05)       # clear of queue-lock windows
                os.kill(first, signal.SIGKILL)
                killed.append(first)
                return
            time.sleep(0.01)

    t = threading.Thread(target=killer)
    t.start()
    pooled = tproc.call_contig(*_open(fasta, bams), "contig1", cfg,
                               HaplotypeCallerEngine(cfg), pool=pool)
    t.join(timeout=60)
    assert not t.is_alive() and killed
    assert _key(pooled.calls) == _key(serial.calls) and serial.calls
    (replacement,) = [w.pid for w in pool.workers]
    assert replacement != first
    assert (replacement, True) in seen
    assert all(pid in (first, replacement) for pid, _ in seen)
    del pool
    pool_mod.shutdown_pool()
    gc.collect()
    assert _fds() <= fds
