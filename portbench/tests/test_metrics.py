"""Each metric reader on a synthetic run record and a synthetic Chrome
trace: the value worked out by hand, and nothing where there is nothing to
read."""
import json

import pytest

from portbench.lib import cells, trace


def read(name, record):
    return cells.reader(name, cells.ROOT)(record)


def _trace(tmp_path, device, window=(1000.0, 11000.0)):
    """A Chrome trace holding the window's marker, one host span and
    ``device`` [(name, cat, ts, dur)] events (us)."""
    events = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
               "ts": window[0], "dur": window[1] - window[0]},
              {"ph": "X", "cat": "user_annotation", "name": "job 0 mag0",
               "ts": window[0], "dur": 6000.0}]
    events += [{"ph": "X", "cat": c, "name": n, "ts": t, "dur": d}
               for n, c, t, d in device]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.read(str(path))


@pytest.fixture
def record(tmp_path):
    device = [
        ("grouped_kernel", "kernel", 2000.0, 1000.0),
        ("grouped_kernel", "kernel", 2500.0, 1000.0),   # overlaps the first
        ("Memcpy HtoD", "gpu_memcpy", 9000.0, 500.0),
        ("grouped_kernel", "kernel", 10800.0, 400.0),   # cut at the window
        ("grouped_kernel", "kernel", 20000.0, 100.0),   # after the window
    ]
    return {
        "kbp": 200.0, "window_s": 8.0, "setup_s": 20.5,
        "rss_kib": {"parent": 2048 * 1024, "workers": [512 * 1024] * 4},
        "stages": {"region_prep": 30.0, "profile": 4.0,
                   "smooth_extract": 1.0, "pairhmm": 10.0},
        "worker_counts": {"lk_batches": 40, "sw_batches": 0,
                          "act_spans": 0},
        "escalations": {"checked": 1000, "escalated": 25},
        "spawn_s": [0.8, 1.25, 0.9],
        "k2_batches": [{"cells": 67e12 * 1e-3 / 12, "bytes": 1000},
                       {"cells": 0, "bytes": 3.35e12 * 1e-3}],
        "trace": _trace(tmp_path, device)}


def test_end_to_end(record):
    assert read("call_kbp_s", record) == 25.0
    assert read("peak_rss_mib", record) == 4096.0
    assert read("setup_s", record) == 20.5


def test_program_spans_and_counters(record):
    assert read("processing.region_prep_ms_per_kbp", record) == 150.0
    assert read("processing.profile_ms_per_kbp", record) == 25.0
    assert read("likelihoods.pairhmm_ms_per_kbp", record) == 50.0
    assert read("pool.lk_batches_per_kbp", record) == 0.2
    assert read("pool.spawn_s", record) == 1.25
    assert read("likelihoods.escalated_pct", record) == 2.5


def test_device_union_not_sum(record):
    # kernels [2000, 3500) as a union, the copy 500, the last kernel cut
    # to [10800, 11000): 1500 + 500 + 200 of a 10000 us window
    assert trace.busy_us(record["trace"]) == 2200.0
    assert read("device.idle_pct", record) == pytest.approx(78.0)


def test_k2_time_and_roofline(record):
    # K2 in the window: 1000 + 1000 + 200 us, overlaps counted as the
    # kernel ran them; each batch's bound is 1 ms (operations / bytes)
    assert read("k2.kernel_ms_per_kbp", record) == pytest.approx(2.2 / 200)
    assert read("k2_roofline", record) == pytest.approx(2.0 / 2.2 * 100)


def test_nothing_to_read(record):
    empty = dict(record, kbp=0.0, stages={}, spawn_s=[],
                 escalations={"checked": 0, "escalated": 0},
                 worker_counts={"lk_batches": 0})
    del empty["trace"]
    for name in ("call_kbp_s", "processing.region_prep_ms_per_kbp",
                 "processing.profile_ms_per_kbp", "pool.lk_batches_per_kbp",
                 "pool.spawn_s", "likelihoods.pairhmm_ms_per_kbp",
                 "likelihoods.escalated_pct", "k2_roofline",
                 "k2.kernel_ms_per_kbp", "device.idle_pct"):
        assert read(name, empty) is None, name


def test_roofline_silent_without_k2(record, tmp_path):
    record["trace"] = _trace(tmp_path, [("Memcpy", "gpu_memcpy", 2000.0,
                                          10.0)])
    assert read("k2_roofline", record) is None


def test_breakdown(record):
    out = trace.breakdown(record["trace"])
    names = [n for n, _ in out["device_ops"]]
    assert names == ["grouped_kernel", "Memcpy HtoD"]
    gaps = out["idle_gaps"]
    # the longest gap, [3500, 9000), lies partly in the job's span
    assert gaps[0][1] == pytest.approx(5500e-6)
    assert gaps[0][0] == "job 0 mag0"


def test_every_metric_has_a_reader():
    spec = json.load(open(cells.ROOT + "/BENCHMARK.json"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(cells.reader(m["name"], cells.ROOT))
