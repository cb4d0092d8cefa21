"""The readers of the program's spans and of their stages, on a synthetic
run record, with the value worked out by hand and nothing where there is
nothing to read; and the program's spans put on a trace's clock."""
import sys
import types

import pytest

from portbench.lib import spans
from portbench.tests.test_metrics import read, record  # noqa: F401

#: the readers of the program's spans and their sub-stages
SPAN_METRICS = (
    "processing.bam_open_ms_per_kbp", "processing.finalize_ms_per_kbp",
    "processing.assembly_ms_per_kbp", "processing.pairs_ms_per_kbp",
    "processing.genotype_ms_per_kbp", "likelihoods.pack_ms_per_kbp",
    "likelihoods.reply_wait_ms_per_kbp", "pool.send_ms_per_batch",
    "pool.service_recv_ms_per_batch", "pool.service_busy_pct",
    "pool.worker_idle_pct", "k2.enqueue_ms_per_batch",
    "k2.readback_ms_per_batch")


def _span(name, t0, t1, pid=1, wid=None, thread="MainThread", **attrs):
    return {"name": name, "t0": t0, "t1": t1, "pid": pid, "wid": wid,
            "thread": thread, "id": 0, "parent": 0, "attrs": attrs}


@pytest.fixture
def spanned(record):  # noqa: F811
    """The record with the stages and spans of a traced run of the program
    that records them: in the 10,000 us window, the device service's
    spans, three workers' and one of the program's main thread."""
    svc = {"thread": "device-service"}
    record["stages"].update({
        "bam_open": 2.0, "finalize": 4.0, "assemble": 10.0, "pairs": 3.0,
        "genotype": 6.0, "lk.pack": 1.0, "lk.reply_wait": 8.0,
        "lk.send": 2.0})
    record["spans"] = [
        _span("call", 1000.0, 11000.0),
        _span("service.recv", 2000.0, 2300.0, kind="lk", **svc),
        _span("k2.enqueue", 2300.0, 2500.0, **svc),
        _span("k2.readback", 3000.0, 3600.0, **svc),
        _span("service.recv", 5000.0, 5100.0, kind="lk", **svc),
        _span("k2.enqueue", 5100.0, 5500.0, **svc),
        _span("service.recv", 6000.0, 6500.0, kind="act", **svc),
        _span("worker.wait_task", 1000.0, 3000.0, 10, 0),
        _span("worker.task", 3000.0, 11000.0, 10, 0),
        _span("assemble", 6000.0, 7000.0, 10, 0),
        _span("worker.wait_task", 1000.0, 2000.0, 11, 1),
        _span("worker.task", 2000.0, 9000.0, 11, 1),
        _span("assemble", 6200.0, 6400.0, 11, 1),
        _span("worker.wait_task", 9000.0, 11000.0, 11, 1),
        _span("worker.wait_task", 1000.0, 11000.0, 12, 2)]
    return record


def test_program_span_readers(spanned):
    # stages over 200 kbp, ms a kbp
    assert read("processing.bam_open_ms_per_kbp", spanned) == 10.0
    assert read("processing.finalize_ms_per_kbp", spanned) == 20.0
    assert read("processing.assembly_ms_per_kbp", spanned) == 50.0
    assert read("processing.pairs_ms_per_kbp", spanned) == 15.0
    assert read("processing.genotype_ms_per_kbp", spanned) == 30.0
    assert read("likelihoods.pack_ms_per_kbp", spanned) == 5.0
    assert read("likelihoods.reply_wait_ms_per_kbp", spanned) == 40.0
    # 2 s of sends over 40 "lk" requests
    assert read("pool.send_ms_per_batch", spanned) == 50.0
    # "lk" reads of 300 and 100 us (the "act" one left out)
    assert read("pool.service_recv_ms_per_batch", spanned) == 0.2
    assert read("k2.enqueue_ms_per_batch", spanned) == pytest.approx(0.3)
    assert read("k2.readback_ms_per_batch", spanned) == pytest.approx(0.6)
    # the service's union: [2000, 2500), [3000, 3600), [5000, 5500),
    # [6000, 6500) = 2100 of 10000 us
    assert read("pool.service_busy_pct", spanned) == pytest.approx(21.0)
    # waits 2000 + 1000 + 2000 + 10000 us over 3 workers x 10000 us
    assert read("pool.worker_idle_pct", spanned) == pytest.approx(50.0)


def test_span_readers_nothing_to_read(record, monkeypatch):  # noqa: F811
    """Nothing to read: a program that records no spans (the record has
    none, and no stage of theirs), or a run without a trace."""
    monkeypatch.delitem(sys.modules, spans.PROGRESS, raising=False)
    record["spans"] = None
    for name in SPAN_METRICS:
        assert read(name, record) is None, name
    del record["spans"]
    for name in SPAN_METRICS:
        assert read(name, record) is None, name
    del record["trace"]
    for name in SPAN_METRICS:
        assert read(name, dict(record, stages={})) is None, name


def _program(monkeypatch, raw, to_trace=True):
    """A stand-in for the program's span recorder holding ``raw``."""
    from lorikeet_tpu_torch.utils import progress
    fake = types.SimpleNamespace(SPANS=raw)
    if to_trace:
        fake.to_trace = progress.to_trace
    monkeypatch.setitem(sys.modules, spans.PROGRESS, fake)


def _raw(name, t0_us, t1_us, wid=None, thread="MainThread", **attrs):
    """A span as the program keeps it, its times in ns on its own clock."""
    return (name, int(t0_us * 1e3), int(t1_us * 1e3), 0, 0, attrs,
            (7 if wid is None else 70 + wid, wid, thread))


def test_program_spans_on_the_trace_clock(record, monkeypatch):  # noqa: F811
    """The trace annotates job 0 at 1000 us (test_metrics' trace); the
    program's last `call` span, its clock 50,000 us behind, is that job's.
    An older run's `call` and a span after the window are left out, and a
    span that crosses the window's end is cut there."""
    _program(monkeypatch, [
        _raw("call", 100.0, 900.0),                # an older run's job
        _raw("call", 51000.0, 56900.0),            # job 0
        _raw("k2.enqueue", 52000.0, 52500.0, thread="device-service"),
        _raw("worker.wait_task", 58000.0, 62000.0, wid=0),
        _raw("k2.readback", 70000.0, 70100.0, thread="device-service")])
    got = spans.of(record)
    assert [(s["name"], s["t0"], s["t1"]) for s in got] == [
        ("call", 1000.0, 6900.0), ("k2.enqueue", 2000.0, 2500.0),
        ("worker.wait_task", 8000.0, 11000.0)]
    assert read("k2.enqueue_ms_per_batch", record) == 0.5
    assert read("k2.readback_ms_per_batch", record) is None
    # job 0 lasted 6000 us by the trace, its call 5900 us
    assert spans.clock_skew_ms(record["trace"]) == pytest.approx(0.1)


@pytest.mark.parametrize("raw, to_trace", [
    ([], True),                                    # nothing recorded
    ([_raw("k2.enqueue", 0.0, 1.0)], True),        # no `call` span
    ([_raw("call", 0.0, 1.0)], False),             # a program without spans
])
def test_program_spans_none(record, monkeypatch, raw, to_trace):  # noqa: F811
    _program(monkeypatch, raw, to_trace)
    assert spans.of(record) is None
    assert spans.clock_skew_ms(record["trace"]) is None
