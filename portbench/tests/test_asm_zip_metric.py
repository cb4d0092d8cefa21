"""The reader of the assembly graphs' native zip
(``processing.asm_native_zip_pct``): on a synthetic run record, the value
worked out by hand and nothing where there is nothing to read; and on a
tiny traced run on the CPU, every graph of the pool's workers zipped in
C++."""
from portbench.tests import tiny
from portbench.tests.test_metrics import read, record  # noqa: F401

NAME = "processing.asm_native_zip_pct"


def test_asm_native_zip_pct(record):  # noqa: F811
    # a program without the counters
    assert read(NAME, record) is None
    record["worker_counts"].update(asm_graphs=1105, asm_native_zip=1105)
    assert read(NAME, record) == 100.0
    record["worker_counts"]["asm_native_zip"] = 350
    assert read(NAME, record) == 100.0 * 350 / 1105
    record["worker_counts"].update(asm_graphs=0, asm_native_zip=0)
    assert read(NAME, record) is None


def test_tiny_run_reports_every_graph_zipped(tmp_path, monkeypatch):
    from lorikeet_tpu_torch import processing
    from lorikeet_tpu_torch.parallel import pool
    monkeypatch.setattr(processing, "_pool_worthwhile", lambda *a: True)
    root = tiny.tree(str(tmp_path))
    try:
        out = tiny.run(root, "short_strains_dense", traced=True)
    finally:
        pool.shutdown_pool()
    assert out["correct"], out["checks"]
    assert out["metrics"][NAME]["value"] == 100.0


def test_reported_in_every_cell():
    """Every cell assembles: the counter's share lists them all."""
    import json
    import os

    from portbench.lib import cells
    spec = json.load(open(os.path.join(cells.ROOT, "BENCHMARK.json")))
    (metric,) = [m for m in spec["per_layer"] if m["name"] == NAME]
    every = [w["name"] for w in spec["workloads"]]
    assert metric["workloads"] == every
    for cell in every:
        assert NAME in [m["name"] for m in cells.load(cell).per_layer]
