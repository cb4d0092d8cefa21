"""The port's span recorder (``utils/progress.py``) on the CPU.

- off (``GLOBAL_STAGES`` None), a site records nothing and keeps nothing;
- on, spans nest by the open span of their thread, sub-stages become one
  record each a span, and the stage totals are the sums of the spans;
- a pooled ``call -t 2`` (CPU devices in the cards' place, the service on
  the parent's plain K2) gives ``worker.task`` spans from two worker
  processes on the parent's clock, each between its task's submit and the
  end of its ``pool.gather``; the pair-HMM stage is its four parts; the
  VCF is the same with spans on and off; ``--profile-dir`` writes the
  parent's, the service's and the workers' rows into one trace.
"""
import json
import os
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from lorikeet_tpu_torch import cli
from lorikeet_tpu_torch import processing as tproc
from lorikeet_tpu_torch.io.bam_writer import write_bam
from lorikeet_tpu_torch.parallel import pool as tpool
from lorikeet_tpu_torch.parallel import sharding as tshard
from lorikeet_tpu_torch.testkit.simulate import Variant, simulate_reads
from lorikeet_tpu_torch.utils import progress

#: the pair-HMM stage's parts, each also added to ``pairhmm``
PAIRHMM_PARTS = ("lk.pack", "lk.send", "lk.reply_wait", "lk.checked",
                 "lk.local")


@pytest.fixture
def spans_on(monkeypatch):
    monkeypatch.setattr(progress, "GLOBAL_STAGES", {})
    monkeypatch.setattr(progress, "SPANS", None)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s[0], []).append(s)
    return out


def test_off_records_nothing_and_keeps_nothing(monkeypatch):
    monkeypatch.setattr(progress, "GLOBAL_STAGES", None)
    monkeypatch.setattr(progress, "SPANS", None)

    def sites():
        with progress.global_stage("a", tid=1) as attrs:
            assert attrs is None
            with progress.substage("s"):
                pass
            progress.add_span("w", time.perf_counter_ns())
            progress.annotate(kind="lk")

    sites()
    # one shared context for every off site: no object a call
    assert progress.global_stage("a") is progress.substage("b")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            sites()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == progress.__file__
             and d.size_diff > 0]
    assert grown == []
    assert progress.SPANS is None and progress.GLOBAL_STAGES is None
    assert progress.take_spans() is None


def test_spans_nest_and_stages_are_their_sums(spans_on):
    t_wait = time.perf_counter_ns()
    with progress.global_stage("task", tid=7) as attrs:
        attrs["contig"] = "c0"
        progress.add_span("wait", t_wait)
        with progress.global_stage("prep", into="whole"):
            for _ in range(3):
                with progress.substage("assemble"):
                    time.sleep(0.002)
                with progress.substage("pairs"):
                    pass
        with progress.global_stage("pack", into="whole"):
            time.sleep(0.001)
        progress.annotate(done=True)

    def service():
        with progress.global_stage("svc"):
            pass

    with progress.global_stage("recv"):
        thread = threading.Thread(target=service, name="svc-t")
        thread.start()
        thread.join(timeout=10)
    assert not thread.is_alive()

    spans = progress.SPANS
    named = _by_name(spans)
    (task,) = named["task"]
    (prep,) = named["prep"]
    (assemble,) = named["assemble"]
    assert task[3] == 0 and task[5] == {"tid": 7, "contig": "c0",
                                        "done": True}
    assert named["wait"][0][3] == task[4] and named["wait"][0][1] == t_wait
    assert prep[3] == task[4] and named["pack"][0][3] == task[4]
    # one record a sub-stage and span, laid end to end from its start
    assert assemble[3] == prep[4] and assemble[5]["count"] == 3
    assert named["pairs"][0][5]["count"] == 3
    assert assemble[1] == prep[1]
    assert named["pairs"][0][1] == assemble[2] <= prep[2]
    assert assemble[2] - assemble[1] >= 3 * 2_000_000
    # the other thread's stack is its own
    (svc,) = named["svc"]
    assert named["recv"][0][3] == 0 and svc[3] == 0
    assert svc[6][2] == "svc-t"
    assert {s[6][2] for s in spans if s[0] != "svc"} == {
        threading.current_thread().name}
    assert all(s[6][0] == os.getpid() and s[6][1] is None for s in spans)

    stages = progress.GLOBAL_STAGES
    for name in ("task", "prep", "pack", "wait", "recv", "svc"):
        assert stages[name] == sum((s[2] - s[1]) * 1e-9
                                   for s in named[name]), name
    for name in ("assemble", "pairs"):
        assert stages[name] == pytest.approx(
            (named[name][0][2] - named[name][0][1]) * 1e-9, rel=1e-9)
    assert stages["whole"] == pytest.approx(stages["prep"] + stages["pack"],
                                            rel=1e-12)
    assert progress.take_spans() is spans and progress.SPANS is None


def test_to_trace_offsets_and_cuts():
    where = (5, 2, "MainThread")
    spans = [("a", 1_000_000, 3_000_000, 0, 1, {"k": 1}, where),
             ("b", 3_500_000, 9_000_000, 1, 2, {}, where),
             ("c", 9_500_000, 9_600_000, 0, 3, {}, where)]
    out = progress.to_trace(spans, 100.0, window=(2100.0, 9200.0))
    assert [(s["name"], s["t0"], s["t1"]) for s in out] == [
        ("a", 2100.0, 3100.0), ("b", 3600.0, 9100.0)]
    assert out[1] == {"name": "b", "t0": 3600.0, "t1": 9100.0, "pid": 5,
                      "wid": 2, "thread": "MainThread", "id": 2,
                      "parent": 1, "attrs": {}}
    assert len(progress.to_trace(spans, 0.0)) == 3


def _genome(tmp, n_contigs=4, length=3000, seed=5):
    """A FASTA of ``n_contigs`` contigs (one pool span each) and two
    samples' BAMs at 20x, a SNP every 250-450 bp."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    names = [f"c{c}" for c in range(n_contigs)]
    refs, recs = [], [[], []]
    for c in range(n_contigs):
        ref = bases[rng.integers(0, 4, length)].copy()
        variants, pos = [], 300
        while pos < length - 300:
            alt = b"ACGT"[(b"ACGT".index(ref[pos]) + 1) % 4]
            variants.append(Variant(pos, bytes(ref[pos:pos + 1]),
                                    bytes([alt])))
            pos += int(rng.integers(250, 450))
        refs.append(ref)
        for s in range(2):
            for r in simulate_reads(ref, variants, coverage=20,
                                    read_length=100, seed=11 + s + 10 * c,
                                    allele_fraction=0.5, sample=f"s{s}",
                                    error_rate=0.001):
                r.tid = c
                recs[s].append(r)
    fasta = os.path.join(tmp, "ref.fna")
    with open(fasta, "w") as fh:
        for name, ref in zip(names, refs):
            fh.write(f">{name}\n{ref.tobytes().decode()}\n")
    bams = []
    for s in range(2):
        recs[s].sort(key=lambda r: (r.tid, r.pos))
        bams.append(os.path.join(tmp, f"s{s}.bam"))
        write_bam(bams[-1], names, [length] * n_contigs, recs[s])
    return fasta, bams


def _linked(src, dest):
    """The genome's files under ``dest`` by the same names: new input
    paths, which a pool worker opens anew (``bam_open``)."""
    os.makedirs(dest)
    for name in os.listdir(src):
        if name.startswith(("ref.", "s0.", "s1.")):
            os.link(os.path.join(src, name), os.path.join(dest, name))
    return os.path.join(dest, "ref.fna"), [os.path.join(dest, f"s{s}.bam")
                                           for s in range(2)]


def _call(args, out):
    assert cli.main([*args, "-o", out]) == 0
    with open(os.path.join(out, "ref", "ref.vcf"), "rb") as fh:
        return fh.read()


def test_pooled_call_spans(tmp_path, monkeypatch, capsys):
    _genome(str(tmp_path))
    monkeypatch.setattr(tproc, "_pool_worthwhile", lambda *a: True)
    monkeypatch.setattr(tshard, "visible_cards",
                        lambda: [torch.device("cpu")])
    monkeypatch.setattr(tshard, "_DEVICES", None)
    monkeypatch.setattr(progress, "GLOBAL_STAGES", None)
    monkeypatch.setattr(progress, "SPANS", None)
    submitted = {}
    real_submit = tpool.SpanWorkerPool.submit

    def submit(self, *args, **kwargs):
        t = time.perf_counter_ns()
        tid = real_submit(self, *args, **kwargs)
        submitted[tid] = t
        return tid

    monkeypatch.setattr(tpool.SpanWorkerPool, "submit", submit)

    def args(name):
        fasta_j, bams_j = _linked(str(tmp_path), str(tmp_path / name))
        return ["call", "-t", "2", "-r", fasta_j, "-b", *bams_j]

    try:
        off = _call(args("off"), str(tmp_path / "off_out"))  # starts the pool
        assert progress.SPANS is None
        progress.GLOBAL_STAGES = {}
        on = _call(args("on"), str(tmp_path / "on_out"))
        tpool.shutdown_pool()               # the workers' last spans
        stages, spans = progress.GLOBAL_STAGES, progress.SPANS
        progress.GLOBAL_STAGES = progress.SPANS = None
        profiled = _call([*args("prof_in"), "--profile-dir",
                          str(tmp_path / "prof")], str(tmp_path / "prof_out"))
    finally:
        tpool.shutdown_pool()
    capsys.readouterr()
    assert on == off == profiled and off.count(b"\n") > 20

    named = _by_name(spans)
    tasks = named["worker.task"]
    assert len(tasks) == 4 and len({s[6][0] for s in tasks}) == 2
    assert {s[6][1] for s in tasks} == {0, 1}
    assert os.getpid() not in {s[6][0] for s in tasks}
    gathers = named["pool.gather"]
    for s in tasks:
        tid = s[5]["tid"]
        (gather,) = [g for g in gathers if tid in g[5]["tids"]]
        assert submitted[tid] <= s[1] < s[2] <= gather[2]
        finish = [f for f in named["worker.finish"] if f[5]["tid"] == tid]
        assert len(finish) == 1 and finish[0][6] == s[6]
    (call,) = named["call"]
    assert call[5] == {"genomes": ["ref"]}
    assert all(call[1] <= g[1] and g[2] <= call[2] for g in gathers)
    for name in ("bam_open", "profile", "smooth_extract", "region_prep",
                 "finalize", "assemble", "pairs", "genotype",
                 "worker.wait_task", "service.recv", "service.enqueue",
                 "service.reply", "k2.enqueue",
                 "k2.readback", "genome.outputs"):
        assert named.get(name), name
    assert "pairhmm_genotype" not in stages
    # the service's "lk" requests carry their task's tid
    lk_tids = {s[5]["tid"] for s in named["service.recv"]
               if s[5].get("kind") == "lk"}
    assert lk_tids == {s[5]["tid"] for s in tasks}
    assert {s[6][2] for s in named["k2.enqueue"]} == {"device-service"}
    # the pair-HMM stage is its parts, from the same readings
    assert stages["pairhmm"] == pytest.approx(
        sum(stages.get(k, 0.0) for k in PAIRHMM_PARTS), rel=1e-9)
    assert stages["lk.reply_wait"] > 0 and stages["lk.pack"] > 0
    # every worker's time from its first task to the pool's close is in
    # a span that has no parent: a wait, a task or a task's end
    for pid in {s[6][0] for s in tasks}:
        top = sorted((s[1], s[2]) for s in spans
                     if s[6][0] == pid and s[3] == 0)
        gaps = sum(max(0, b0 - a1) for (_, a1), (b0, _)
                   in zip(top, top[1:]))
        assert gaps < 0.05 * (top[-1][1] - top[0][0]), (pid, gaps)

    with open(tmp_path / "prof" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    rows = {e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "thread_name"
            and e["args"]["name"].startswith("spans: ")}
    assert "spans: main process, MainThread" in rows
    assert "spans: main process, device-service" in rows
    assert {r.split(",")[0] for r in rows} >= {
        "spans: pool worker 0", "spans: pool worker 1"}
    span_events = [e for e in events if e.get("cat") == "lorikeet_span"]
    assert {"worker.task", "k2.enqueue", "pool.gather"} <= {
        e["name"] for e in span_events}
    (mark,) = [e for e in events if e.get("name") == progress.PROFILE_MARK
               and e.get("cat") == "user_annotation"]
    assert all(mark["ts"] <= e["ts"] and e["ts"] + e["dur"]
               <= mark["ts"] + mark["dur"] for e in span_events)
    assert progress.GLOBAL_STAGES is None and progress.SPANS is None


def test_t1_path_genotype_span(tmp_path, monkeypatch, capsys, spans_on):
    """At -t 1 (no pool) the spans run in the parent's own threads, and
    genotyping is the same ``genotype`` span as in a pool worker."""
    fasta, bams = _genome(str(tmp_path), n_contigs=1)
    monkeypatch.setattr(tshard, "visible_cards",
                        lambda: [torch.device("cpu")])
    monkeypatch.setattr(tshard, "_DEVICES", None)
    _call(["call", "-t", "1", "-r", fasta, "-b", *bams],
          str(tmp_path / "out"))
    capsys.readouterr()
    named = _by_name(progress.SPANS)
    (genotype,) = named["genotype"]
    (prep,) = named["region_prep"]
    (call,) = named["call"]
    assert call[1] <= prep[1] < prep[2] <= genotype[1] < genotype[2] \
        <= call[2]
    assert genotype[6][0] == os.getpid() and genotype[6][1] is None
    assert "pairhmm_genotype" not in progress.GLOBAL_STAGES
    assert progress.GLOBAL_STAGES["pairhmm"] > 0
