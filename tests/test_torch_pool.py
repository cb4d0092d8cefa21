"""The port's span-worker pool (lorikeet_tpu_torch.parallel.pool) on the CPU.

The workers are spawned processes that hold no card; the parent's device
service runs the plain versions here (CPU devices in the cards' place in
``parallel.sharding``, ``sw_cuda.SW_DEVICE`` set to "cpu"), through the
same requests the cards serve.  Checked: the pooled calls equal the port's
serial path and the JAX package's; the service takes every pair-HMM batch
(and under ``use_cuda_sw`` every SW batch) and the workers compute none on
their own host, whatever the JAX package's router variables say; the pool
key follows the wire gate's variable only; a deletion carried across a span
boundary as the serial loop carries it; reuse across genomes, a SIGKILLed
worker, a worker error, a failing service (an error, never a host result),
the pooled `start_engine` VCF against the JAX package's byte for byte, and
no jax module in the parent or in any worker of a pooled CLI run.
"""
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

import lorikeet_tpu.calling.engine as jengine
from lorikeet_tpu.io.bam import open_bam as jopen_bam
from lorikeet_tpu.io.fasta import FastaReader as JFastaReader
from lorikeet_tpu.processing import call_contig as jcall_contig
from lorikeet_tpu.processing import start_engine as jstart_engine
from lorikeet_tpu_torch.calling import likelihoods as tlk
from lorikeet_tpu_torch.calling.engine import (
    CallerConfig, HaplotypeCallerEngine,
)
from lorikeet_tpu_torch.io.bam import open_bam
from lorikeet_tpu_torch.io.fasta import FastaReader
from lorikeet_tpu_torch.ops import pairhmm_cuda
from lorikeet_tpu_torch.ops import sw_cuda
from lorikeet_tpu_torch.parallel import pool as pool_mod
from lorikeet_tpu_torch.parallel import sharding
from lorikeet_tpu_torch import processing as tproc
from lorikeet_tpu_torch.testkit.dataset import simulate_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run in this process; several test processes each
    running torch's default thread pool only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    pool_mod.shutdown_pool()


@pytest.fixture
def plain_devices(monkeypatch):
    """The card's kernels replaced by their plain versions, in this
    process, which runs the device service."""
    cpu = [torch.device("cpu")]
    monkeypatch.setattr(sharding, "visible_cards", lambda: cpu)
    monkeypatch.setattr(sharding, "_DEVICES", cpu)
    monkeypatch.setattr(sw_cuda, "SW_DEVICE", "cpu")
    monkeypatch.setattr(tlk, "DISPATCH_COUNTS",
                        dict.fromkeys(tlk.DISPATCH_COUNTS, 0))
    monkeypatch.setattr(sw_cuda, "SW_COUNTS",
                        dict.fromkeys(sw_cuda.SW_COUNTS, 0))
    monkeypatch.setattr(pool_mod, "WORKER_COUNTS",
                        dict.fromkeys(pool_mod.WORKER_COUNTS, 0))


def _key(calls):
    return [(c.tid, c.start, tuple(a.bases for a in c.alleles),
             tuple(tuple(g.alleles[i].bases for i in range(len(g.alleles)))
                   for g in c.genotypes), c.log10_p_error)
            for c in calls]


def _readers(fasta, bams):
    return FastaReader(fasta), [open_bam(p) for p in bams]


def _serial(fasta, bams, cfg):
    fr, readers = _readers(fasta, bams)
    return tproc.call_contig(fr, readers, "contig1", cfg,
                             HaplotypeCallerEngine(cfg))


def _pooled(fasta, bams, cfg, device_service, n=2):
    fr, readers = _readers(fasta, bams)
    pool = pool_mod.get_pool(fasta, bams, cfg, n, device_service)
    return tproc.call_contig(fr, readers, "contig1", cfg,
                             HaplotypeCallerEngine(cfg), pool=pool), pool


@pytest.fixture(scope="module")
def genome260(tmp_path_factory):
    """Three chunk spans of 125 kb at two samples."""
    return simulate_dataset(str(tmp_path_factory.mktemp("g260")), 260, 2,
                            25.0, seed=0)


@pytest.fixture(scope="module")
def genome80(tmp_path_factory):
    """One span; 15x keeps the plain versions' batches small."""
    return simulate_dataset(str(tmp_path_factory.mktemp("g80")), 80, 2, 15.0,
                            seed=2)


@pytest.fixture(scope="module")
def serial80_plain(genome80):
    """The serial port on the plain versions: the reference of the service
    cases (the SW route leaves the calls bit-identical)."""
    fasta, bams, _ = genome80
    mp = pytest.MonkeyPatch()
    mp.setattr(sharding, "_DEVICES", [torch.device("cpu")])
    mp.setattr(sw_cuda, "SW_DEVICE", "cpu")
    before = dict(sw_cuda.SW_COUNTS)
    try:
        res = _serial(fasta, bams, CallerConfig(use_cuda=True,
                                                use_cuda_sw=True))
    finally:
        mp.undo()
    return res, {k: sw_cuda.SW_COUNTS[k] - before[k] for k in before}


def test_pool_without_service_matches_serial_and_jax(genome260):
    fasta, bams, _ = genome260
    cfg = CallerConfig(use_cuda=False, threads=2)
    serial = _serial(fasta, bams, cfg)
    host = dict(tlk.DISPATCH_COUNTS)
    pooled, pool = _pooled(fasta, bams, cfg, device_service=False)
    assert pool._service_thread is None
    # three spans, each one f64 batch in a worker, counted in the parent
    assert tlk.DISPATCH_COUNTS["host"] - host["host"] == 3
    assert _key(pooled.calls) == _key(serial.calls) and serial.calls
    assert pooled.n_regions == serial.n_regions
    assert pooled.depth_pass_rle == serial.depth_pass_rle
    jcfg = jengine.CallerConfig(use_pallas=False)
    jax = jcall_contig(JFastaReader(fasta), [jopen_bam(p) for p in bams],
                       "contig1", jcfg, jengine.HaplotypeCallerEngine(jcfg))
    assert _key(jax.calls) == _key(pooled.calls)
    assert jax.n_regions == pooled.n_regions
    assert jax.depth_pass_rle == pooled.depth_pass_rle


@pytest.mark.parametrize("sw_on_card", [False, True],
                         ids=["pairhmm", "pairhmm_and_sw"])
def test_device_service_runs_every_batch(genome80, serial80_plain,
                                         plain_devices, sw_on_card):
    fasta, bams, _ = genome80
    serial, serial_sw = serial80_plain
    cfg = CallerConfig(use_cuda=True, use_cuda_sw=sw_on_card, threads=2)
    pooled, pool = _pooled(fasta, bams, cfg, device_service=True)
    assert _key(pooled.calls) == _key(serial.calls) and serial.calls
    assert pooled.depth_pass_rle == serial.depth_pass_rle
    # one span: its one pair batch ran in the service, none on a host
    assert tlk.DISPATCH_COUNTS == {"device": 0, "host": 0, "remote": 1}
    assert pool_mod.WORKER_COUNTS["lk_batches"] == 1
    if sw_on_card:
        # every SW pair the serial run sent to the plain version went
        # through the service, in batches the workers sent
        assert sw_cuda.SW_COUNTS == serial_sw and serial_sw["device"] > 0
        assert pool_mod.WORKER_COUNTS["sw_batches"] > 0
    else:
        assert sw_cuda.SW_COUNTS == dict.fromkeys(sw_cuda.SW_COUNTS, 0)
        assert pool_mod.WORKER_COUNTS["sw_batches"] == 0
    for pid in (w.pid for w in pool.workers):
        report = pool_mod.WORKER_REPORTS.get(pid)
        if report is not None:
            assert report["torch_imported"] is False
            assert report["cuda_initialized"] is False
            assert report["foreign_modules"] == []


@pytest.mark.parametrize("n_devices, activity", [(2, False), (1, True),
                                                 (2, True)],
                         ids=["two_devices", "act", "two_devices_act"])
def test_service_over_devices_and_activity(genome80, plain_devices,
                                           monkeypatch, n_devices, activity):
    """The service splits each pair batch over the run's device list (two
    CPU devices here: both positions launch) and, when the run takes the
    device activity chain, runs every span's chain for the workers ("act"
    requests) over the same list; the calls are the serial run's on the
    same list, and the workers import no torch."""
    fasta, bams, _ = genome80
    monkeypatch.setattr(sharding, "_DEVICES", [torch.device("cpu")]
                        * n_devices)
    cfg = CallerConfig(use_cuda=True, threads=2)
    cfg.device_activity = activity
    serial = _serial(fasta, bams, cfg)
    cards, lens, lanes = [], [], []
    real = pairhmm_cuda.pairhmm_grouped_cuda

    def grouped(t, card=0):
        # copies: a view of the batch's segment may not outlive its enqueue
        cards.append(card)
        lens.append(t["read_lens"].clone())
        lanes.append(t["quals"].numel())
        return real(t, card)

    monkeypatch.setattr(pairhmm_cuda, "pairhmm_grouped_cuda", grouped)
    try:
        pooled, pool = _pooled(fasta, bams, cfg, device_service=True)
    finally:
        pool_mod.shutdown_pool()
    assert _key(pooled.calls) == _key(serial.calls) and serial.calls
    assert pooled.n_regions == serial.n_regions
    assert pooled.depth_pass_rle == serial.depth_pass_rle
    assert sorted(set(cards)) == list(range(n_devices))
    # each device's share holds the batch's whole planes
    counts = dict(pool_mod.WORKER_COUNTS)
    hap = {k: counts.pop(k) for k in ("hap_cigars", "hap_sw", "hap_sw_card")}
    asm = {k: counts.pop(k) for k in ("asm_graphs", "asm_native_zip")}
    # a call runs no strain layer
    strain = ("strain_contexts", "strain_clustered", "strain_groups",
              "strain_strains")
    assert {k: counts.pop(k) for k in strain} == dict.fromkeys(strain, 0)
    assert counts == {"lk_batches": 1, "lk_shm_batches": 1,
                      "sw_batches": 0, "act_spans": int(activity),
                      "hsw_batches": 0,
                      "lk_rows": int((lens[0] > 0).sum()),
                      "lk_long_rows": 0,
                      "lk_slots": lanes[0],
                      "lk_bases": int(lens[0].sum())}
    # CPU devices in the cards' place: the haplotype SW on the workers'
    # hosts
    assert hap["hap_cigars"] >= hap["hap_sw"] > 0 == hap["hap_sw_card"]
    # every graph the workers took to the seq-graph step zipped in C++
    assert asm["asm_native_zip"] == asm["asm_graphs"] > 0
    reports = [pool_mod.WORKER_REPORTS.get(w.pid) for w in pool.workers]
    assert any(reports)
    assert not any(r["torch_imported"] for r in reports if r)


def test_pool_reused_across_genomes(genome260, tmp_path):
    fasta1, bams1, _ = genome260
    cfg = CallerConfig(use_cuda=False, threads=2)
    pool1 = pool_mod.get_pool(fasta1, bams1, cfg, 2, device_service=False)
    pids = [w.pid for w in pool1.workers]
    fasta2, bams2, _ = simulate_dataset(str(tmp_path), 60, 2, 25.0, seed=3)
    pooled, pool2 = _pooled(fasta2, bams2, cfg, device_service=False)
    assert pool2 is pool1
    assert [w.pid for w in pool2.workers] == pids   # same live workers
    assert _key(pooled.calls) == _key(_serial(fasta2, bams2, cfg).calls)


def test_pool_survives_worker_kill(genome260):
    """Crash tolerance: SIGKILL one worker mid-span; its span is requeued
    onto the survivor, a replacement is spawned, and the calls are those of
    the serial path."""
    fasta, bams, _ = genome260
    cfg = CallerConfig(use_cuda=False, threads=2)
    serial = _serial(fasta, bams, cfg)
    fr, readers = _readers(fasta, bams)
    pool = pool_mod.get_pool(fasta, bams, cfg, 2, device_service=False)
    killed = []

    def killer():
        for _ in range(3000):          # wait for a span to be in flight
            if pool._inflight:
                wid = next(iter(pool._inflight.values()))
                time.sleep(0.05)       # clear of queue-lock windows
                os.kill(pool._wid_proc[wid].pid, signal.SIGKILL)
                killed.append(wid)
                return
            time.sleep(0.01)

    t = threading.Thread(target=killer)
    t.start()
    pooled = tproc.call_contig(fr, readers, "contig1", cfg,
                               HaplotypeCallerEngine(cfg), pool=pool)
    t.join(timeout=60)
    assert not t.is_alive()
    assert killed, "killer never saw an in-flight span"
    assert _key(pooled.calls) == _key(serial.calls)
    assert pooled.depth_pass_rle == serial.depth_pass_rle
    # capacity restored: the dead worker was replaced
    assert sum(w.is_alive() for w in pool.workers) == 2


BOUNDARY = 4000


@pytest.fixture(scope="module")
def boundary_deletions(tmp_path_factory):
    """A deletion in sample 0 ending each of the first three 4 kb spans and
    a SNP in sample 1 inside it, past the span boundary.  With assembly
    regions of at most 100 bp the SNP's region starts at the boundary, so
    the serial loop gives it the spanning-deletion allele only through the
    deletion that its one engine carries over from the span before."""
    import numpy as np

    from lorikeet_tpu_torch.io.bam_writer import write_bam
    from lorikeet_tpu_torch.testkit.simulate import Variant, simulate_reads
    tmp = str(tmp_path_factory.mktemp("boundary"))
    length = 4 * BOUNDARY
    rng = np.random.default_rng(0)
    ref = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, length)].copy()
    fasta = os.path.join(tmp, "ref.fna")
    with open(fasta, "w") as fh:
        fh.write(">contig1\n" + ref.tobytes().decode() + "\n")
    dels, snps = [], []
    for k, (n, off) in enumerate([(70, 60), (80, 70), (100, 85)], 1):
        p = BOUNDARY * k - 54
        dels.append(Variant(p, bytes(ref[p:p + n + 1]), bytes(ref[p:p + 1])))
        q = p + off
        alt = b"ACGT"[(b"ACGT".index(ref[q]) + 1) % 4]
        snps.append(Variant(q, bytes(ref[q:q + 1]), bytes([alt])))
    bams = []
    for s, variants in enumerate((dels, snps)):
        recs = simulate_reads(ref, variants, coverage=20, seed=7 + s,
                              sample=f"sample{s}")
        bams.append(os.path.join(tmp, f"sample{s}.bam"))
        write_bam(bams[-1], ["contig1"], [length],
                  sorted(recs, key=lambda r: (r.tid, r.pos)))
    return fasta, bams, dels


@pytest.mark.parametrize("device_service", [False, True],
                         ids=["host", "service"])
def test_deletion_carried_across_span_boundary(boundary_deletions,
                                               plain_devices, monkeypatch,
                                               device_service):
    """A worker's span starts from the upstream deletions the serial loop
    would carry into it: the three SNPs that each boundary deletion covers
    carry the spanning-deletion allele '*' at -t 2 as at -t 1 (only a
    covering deletion emitted upstream makes it real), by rerunning those
    three spans."""
    fasta, bams, dels = boundary_deletions
    monkeypatch.setattr(tproc, "_chunk_size", lambda n, cfg: BOUNDARY)
    monkeypatch.setattr(pool_mod, "SPAN_RERUNS", {"spans": 0})
    cfg = CallerConfig(use_cuda=device_service, max_assembly_region_size=100,
                       threads=2)
    serial = _serial(fasta, bams, cfg)
    # the three deletions (left-aligned, so compared by length), each
    # followed by the SNP it covers, with '*'
    assert [len(c.alleles[0]) for c in serial.calls] \
        == [n for d in dels for n in (len(d.ref), 1)]
    assert all(any(a.is_span_del for a in c.alleles)
               for c in serial.calls[1::2])
    pooled, _ = _pooled(fasta, bams, cfg, device_service=device_service)
    assert pool_mod.SPAN_RERUNS == {"spans": 3}
    if device_service:
        # four spans and the three reruns, each one batch on the service
        assert tlk.DISPATCH_COUNTS["remote"] == 4 + 3
    assert _key(pooled.calls) == _key(serial.calls)
    assert pooled.n_regions == serial.n_regions
    assert pooled.depth_pass_rle == serial.depth_pass_rle


def test_act_requests_follow_the_pending_reply(boundary_deletions,
                                              plain_devices, monkeypatch):
    """Four 4 kb spans over two workers with the pair-HMM and the activity
    chain on the service: a worker's "act" request for its next span goes
    out while the reply to its last "lk" request is still due, so that
    reply is taken first.  Calls, spans' chains and batches as serial."""
    fasta, bams, _ = boundary_deletions
    monkeypatch.setattr(tproc, "_chunk_size", lambda n, cfg: BOUNDARY)
    monkeypatch.setattr(pool_mod, "SPAN_RERUNS", {"spans": 0})
    monkeypatch.setattr(pool_mod, "WORKER_REPORTS", {})
    cfg = CallerConfig(use_cuda=True, max_assembly_region_size=100,
                       threads=2)
    cfg.device_activity = True
    serial = _serial(fasta, bams, cfg)
    try:
        pooled, _ = _pooled(fasta, bams, cfg, device_service=True)
    finally:
        pool_mod.shutdown_pool()
    spans = 4 + pool_mod.SPAN_RERUNS["spans"]
    assert pool_mod.WORKER_COUNTS["act_spans"] == spans
    assert pool_mod.WORKER_COUNTS["lk_batches"] == spans
    assert tlk.DISPATCH_COUNTS["remote"] == spans
    assert _key(pooled.calls) == _key(serial.calls) and serial.calls
    assert pooled.depth_pass_rle == serial.depth_pass_rle
    reports = list(pool_mod.WORKER_REPORTS.values())
    assert reports and not any(r["torch_imported"] for r in reports)


def test_carry_deletions_replays_the_engine_check():
    """carry_deletions prunes and tests as _covered_by_upstream_deletion
    does: another contig or a site past a deletion's end drops it, a site
    at its start is not covered, and a dropped deletion covers nothing
    after."""
    carried = [(0, 100, 130), (0, 90, 95)]
    assert pool_mod.carry_deletions(carried, []) == (carried, False)
    assert pool_mod.carry_deletions(carried, [(0, 100)]) \
        == ([(0, 100, 130)], False)
    assert pool_mod.carry_deletions(carried, [(0, 96), (0, 120)]) \
        == ([(0, 100, 130)], True)
    assert pool_mod.carry_deletions(carried, [(0, 140), (0, 120)]) \
        == ([], False)
    assert pool_mod.carry_deletions(carried, [(1, 120)]) == ([], False)


def test_worker_error_surfaces(genome80):
    fasta, bams, _ = genome80
    cfg = CallerConfig(use_cuda=False, threads=1)
    pool = pool_mod.get_pool(fasta, bams, cfg, 1, device_service=False)
    tid = pool.submit("no_such_contig", (0, 1000, 0, 1000))
    with pytest.raises(RuntimeError, match="span worker failed"):
        pool.gather([tid])


def _fail(*args, **kwargs):
    raise RuntimeError("simulated CUDA launch failure")


@pytest.mark.parametrize("route", ["pairhmm", "sw"])
def test_failed_service_fails_the_run(genome80, plain_devices, monkeypatch,
                                      route):
    """No fallback: a service whose launch raises makes the worker raise
    and gather raise in the parent; no span result comes back, and no
    worker computed the batch on its own host."""
    fasta, bams, _ = genome80
    if route == "pairhmm":
        monkeypatch.setattr(pairhmm_cuda, "enqueue_grouped_jobs", _fail)
        cfg = CallerConfig(use_cuda=True, threads=2)
    else:
        monkeypatch.setattr(sw_cuda, "align_batch_cuda", _fail)
        cfg = CallerConfig(use_cuda=False, use_cuda_sw=True, threads=2)
    try:
        with pytest.raises(RuntimeError, match="device service failed") \
                as err:
            _pooled(fasta, bams, cfg, device_service=True)
        assert "simulated CUDA launch failure" in str(err.value)
        assert tlk.DISPATCH_COUNTS["remote"] == 0
        assert pool_mod.WORKER_COUNTS == dict.fromkeys(
            pool_mod.WORKER_COUNTS, 0)
    finally:
        pool_mod.shutdown_pool()


def _jax_f64_calls(fasta, bams):
    jcfg = jengine.CallerConfig(use_pallas=False)
    return jcall_contig(JFastaReader(fasta), [jopen_bam(p) for p in bams],
                        "contig1", jcfg,
                        jengine.HaplotypeCallerEngine(jcfg)).calls


@pytest.mark.parametrize("setting, form", [
    ("1", "wire"), ("0", "flat"), (None, "flat")],
    ids=["forced_on", "forced_off", "auto_no_card"])
def test_wire_jobs_give_the_serial_and_jax_calls(genome80, serial80_plain,
                                                 plain_devices, monkeypatch,
                                                 setting, form):
    """The workers pack in the form the parent's gate gives them
    (LORIKEET_WIRE_COMPRESS; under auto the parent's link, which a process
    without a card does not have: flat), and the service decodes a wire
    job on the device before the sweep: the calls are the serial run's on
    the same (plain) kernels exactly, and the JAX package's f64 run's with
    QUAL within compare's 0.1 (same sites, alleles and genotypes)."""
    fasta, bams, _ = genome80
    serial, _ = serial80_plain
    if setting is None:
        monkeypatch.delenv("LORIKEET_WIRE_COMPRESS", raising=False)
    else:
        monkeypatch.setenv("LORIKEET_WIRE_COMPRESS", setting)
    monkeypatch.setattr(pairhmm_cuda, "WIRE_COUNTS", {"wire": 0, "flat": 0})
    jobs = []
    real = pairhmm_cuda.enqueue_grouped_jobs
    monkeypatch.setattr(pairhmm_cuda, "enqueue_grouped_jobs",
                        lambda a, *r: jobs.append(a["mode"]) or real(a, *r))
    cfg = CallerConfig(use_cuda=True, threads=2)
    try:
        pooled, pool = _pooled(fasta, bams, cfg, device_service=True)
    finally:
        pool_mod.shutdown_pool()
    assert _key(pooled.calls) == _key(serial.calls) and serial.calls
    # one batch, one job in the gate's form
    assert jobs == [form] and pool.wire == (form == "wire")
    assert pairhmm_cuda.WIRE_COUNTS == {"wire": form == "wire",
                                        "flat": form == "flat"}
    jax = _jax_f64_calls(fasta, bams)
    assert [k[:4] for k in _key(jax)] == [k[:4] for k in _key(pooled.calls)]
    assert max(abs(a[4] - b[4]) * 10 for a, b in zip(
        _key(jax), _key(pooled.calls))) <= 0.1


@pytest.mark.parametrize("setting", ["local", "auto"],
                         ids=["remote_local", "remote_auto"])
def test_every_worker_batch_reaches_the_service(genome80, serial80_plain,
                                                plain_devices, monkeypatch,
                                                setting):
    """LORIKEET_REMOTE_ROUTE, which the port does not read, set in the
    workers' environment: each worker's pair batch still goes to the
    device service, none runs on a worker's host, and the calls are the
    serial run's on the same (plain) kernels."""
    fasta, bams, _ = genome80
    serial, _ = serial80_plain
    pool_mod.shutdown_pool()            # workers spawned with the setting
    monkeypatch.setenv("LORIKEET_REMOTE_ROUTE", setting)
    cfg = CallerConfig(use_cuda=True, threads=2)
    try:
        pooled, pool = _pooled(fasta, bams, cfg, device_service=True)
    finally:
        pool_mod.shutdown_pool()
    assert _key(pooled.calls) == _key(serial.calls) and serial.calls
    assert pool_mod.WORKER_COUNTS["lk_batches"] == 1
    assert tlk.DISPATCH_COUNTS == {"device": 0, "host": 0, "remote": 1}
    reports = list(pool_mod.WORKER_REPORTS.values())
    assert reports and not any(r["torch_imported"] for r in reports)


@pytest.mark.parametrize("variable, settings, new", [
    ("LORIKEET_REMOTE_ROUTE", ("remote", "local"), False),
    ("LORIKEET_WIRE_COMPRESS", ("0", "1"), True)],
    ids=["remote_route", "wire_compress"])
def test_pool_key_follows_the_wire_variable_only(genome80, monkeypatch,
                                                 variable, settings, new):
    """A pool is kept for one setting of the one variable it reads when it
    starts, the wire gate's: changing it between two calls gives a new
    pool, changing another variable of the JAX package's router the same
    one."""
    fasta, bams, _ = genome80
    cfg = CallerConfig(use_cuda=False, threads=1)
    monkeypatch.setenv(variable, settings[0])
    try:
        first = pool_mod.get_pool(fasta, bams, cfg, 1, device_service=False)
        monkeypatch.setenv(variable, settings[1])
        second = pool_mod.get_pool(fasta, bams, cfg, 1,
                                   device_service=False)
        assert (second is not first) is new
    finally:
        pool_mod.shutdown_pool()


def test_pooled_start_engine_vcf_equals_jax(genome260, tmp_path,
                                            monkeypatch):
    fasta, bams, _ = genome260
    monkeypatch.setattr(tproc, "_pool_worthwhile", lambda *a: True)
    pools = []
    real = tproc._call_contigs_pooled
    monkeypatch.setattr(tproc, "_call_contigs_pooled",
                        lambda *a: pools.append(a[-1]) or real(*a))
    out = tproc.start_engine("call", [fasta], bams, str(tmp_path / "port"),
                             CallerConfig(use_cuda=False, threads=2))
    jout = jstart_engine("call", [fasta], bams, str(tmp_path / "jax"),
                         jengine.CallerConfig(use_pallas=False, threads=1))
    assert len(pools) == 1 and pools[0].n_workers == 2
    assert pools[0]._service_thread is None
    (res,), (jres,) = out.values(), jout.values()
    with open(res["vcf"], "rb") as a, open(jres["vcf"], "rb") as b:
        assert a.read() == b.read()
    assert res["n_calls"] == jres["n_calls"] > 0


POOLED_CLI = """
import sys
sys.path.insert(0, {tests!r})
from lorikeet_tpu_torch import processing
import torch
from lorikeet_tpu_torch.calling import likelihoods
from lorikeet_tpu_torch.ops import sw_cuda
from lorikeet_tpu_torch.parallel import pool, sharding
from lorikeet_tpu_torch.cli import main
processing._pool_worthwhile = lambda *a: True
sharding.visible_cards = lambda: [torch.device("cpu")]
sw_cuda.SW_DEVICE = "cpu"
rc = main({args!r})
reports = list(pool.WORKER_REPORTS.values())
assert rc == 0 and reports, (rc, reports)
assert {{r["pid"] for r in reports}} <= {{w.pid for p in pool._POOLS.values()
                                      for w in p.workers}}
assert likelihoods.DISPATCH_COUNTS["remote"] > 0
assert pool.WORKER_COUNTS["sw_batches"] > 0
for r in reports:
    assert r["foreign_modules"] == [] and r["cuda_initialized"] is False, r
    assert r["torch_imported"] is False, r
bad = [m for m in sys.modules if m.split('.')[0] in
       ('jax', 'jaxlib', 'lorikeet_tpu', 'bench_e2e')]
assert not bad, f'imported: {{bad}}'
print("ok")
"""


def test_pooled_cli_run_imports_no_jax(tmp_path):
    """A pooled `call` with the service (plain versions) in a fresh
    interpreter: neither the parent nor any worker holds a module of jax or
    of the JAX package, and no worker imported torch or initialised
    CUDA."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_call import simulate_fixture
    fasta, bams, _ = simulate_fixture(str(tmp_path), length=3000,
                                      coverage=12, error_rate=0.01)
    args = ["call", "-t", "2", "--pallas-sw", "-r", fasta, "-b", *bams,
            "-o", str(tmp_path / "out")]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", POOLED_CLI.format(
            tests=os.path.join(REPO, "tests"), args=args)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=240)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


def test_cli_default_threads(tmp_path):
    """`call` with no -t (the default 8): without a card an error that names
    it; with --force-cpu the -t 1 VCF."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_call import simulate_fixture
    fasta, bams, _ = simulate_fixture(str(tmp_path), length=1500, coverage=12)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""

    def cli(out, *extra):
        return subprocess.run(
            [sys.executable, "-m", "lorikeet_tpu_torch.cli", "call", *extra,
             "-r", fasta, "-b", *bams, "-o", str(tmp_path / out)],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=240)

    res = cli("card")
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    res = cli("t8", "--force-cpu")
    assert res.returncode == 0, res.stderr
    t1 = tproc.start_engine("call", [fasta], bams, str(tmp_path / "t1"),
                            CallerConfig(use_cuda=False, threads=1))
    assert (tmp_path / "t8" / "ref" / "ref.vcf").read_bytes() \
        == open(t1["ref"]["vcf"], "rb").read()
