"""The readers of the spans' haplotype SW (``processing.hap_sw_card_pct``,
``processing.hap_sw_ms_per_kbp``): on a synthetic run record, the value
worked out by hand and nothing where there is nothing to read; and on a
tiny traced run on the CPU whose pool workers send that SW to the device
service (the kernel's plain version in the card's place)."""
import pytest

from portbench.tests import tiny
from portbench.tests.test_metrics import read, record  # noqa: F401

METRICS = ("processing.hap_sw_card_pct", "processing.hap_sw_ms_per_kbp")


def test_hap_sw_card_pct(record):  # noqa: F811
    # a program without the counters
    assert read("processing.hap_sw_card_pct", record) is None
    record["worker_counts"].update(hap_cigars=900, hap_sw=400,
                                   hap_sw_card=400)
    assert read("processing.hap_sw_card_pct", record) == 100.0
    record["worker_counts"]["hap_sw_card"] = 100
    assert read("processing.hap_sw_card_pct", record) == 25.0
    record["worker_counts"].update(hap_sw=0, hap_sw_card=0)
    assert read("processing.hap_sw_card_pct", record) is None


def test_hap_sw_ms_per_kbp(record):  # noqa: F811
    assert read("processing.hap_sw_ms_per_kbp", record) is None
    record["stages"]["asm.hap_sw"] = 0.5
    # 500 ms over 200 kbp
    assert read("processing.hap_sw_ms_per_kbp", record) == 2.5


def test_tiny_run_reports_both(tmp_path, monkeypatch):
    import torch

    from lorikeet_tpu_torch import processing
    from lorikeet_tpu_torch.parallel import pool
    monkeypatch.setattr(processing, "_pool_worthwhile", lambda *a: True)
    monkeypatch.setattr(processing, "_hap_sw_device",
                        lambda cfg: torch.device("cpu"))
    root = tiny.tree(str(tmp_path))
    try:
        out = tiny.run(root, "short_strains_dense", traced=True)
    finally:
        pool.shutdown_pool()
    assert out["correct"], out["checks"]
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    assert metrics["processing.hap_sw_card_pct"] == 100.0
    assert 0 < metrics["processing.hap_sw_ms_per_kbp"] \
        < metrics["processing.assembly_ms_per_kbp"]


@pytest.mark.parametrize("name", METRICS)
def test_reported_in_every_cell(name):
    """Every cell runs the haplotype CIGARs on the card: the counter's
    share lists them all, the span's time (like `k2.wide_strip_pct`) is
    reported wherever `call_kbp_s` is."""
    import json
    import os

    from portbench.lib import cells
    spec = json.load(open(os.path.join(cells.ROOT, "BENCHMARK.json")))
    (metric,) = [m for m in spec["per_layer"] if m["name"] == name]
    every = [w["name"] for w in spec["workloads"]]
    assert metric.get("workloads", every) == every
    for cell in every:
        assert name in [m["name"] for m in cells.load(cell).per_layer]
