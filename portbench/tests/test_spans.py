"""A traced run reads the program's spans on the trace's clock: every
metric of them is reported, the program's ``call`` span of a job lies on
the harness's span of that job, and the two clocks agree over the
window."""
import json

from portbench.lib import cells, spans, trace
from portbench.tests import tiny

SPAN_METRICS = [m["name"] for m in json.load(open(
    cells.ROOT + "/BENCHMARK.json"))["per_layer"]
    if m["source"] == "program_span" and "workloads" in m]


def test_traced_run_reads_the_program_spans(tmp_path, monkeypatch):
    seen = []
    real = trace.read
    monkeypatch.setattr(trace, "read",
                        lambda path: seen.append(real(path)) or seen[-1])
    root = tiny.tree(str(tmp_path))
    out = tiny.run(root, "short_clonal", seed=2 ** 33 + 7, traced=True)
    assert out["correct"], out["checks"]
    assert len(SPAN_METRICS) == 13
    for name in SPAN_METRICS:
        assert name in out["metrics"], name

    (timeline,) = seen
    got = spans.program(timeline)
    (job,) = [(a, b) for n, a, b in timeline["host"] if n.startswith("job 0 ")]
    (call,) = [s for s in got if s["name"] == "call"]
    assert abs(call["t0"] - job[0]) <= 2000.0
    assert abs(call["t1"] - job[1]) <= 2000.0
    assert abs(spans.clock_skew_ms(timeline)) < 1.0
    t0, t1 = timeline["window"]
    assert all(t0 <= s["t0"] <= s["t1"] <= t1 for s in got)
    assert {s["thread"] for s in got} >= {"device-service"}
    assert len({s["pid"] for s in got if s["wid"] is not None}) == 2
