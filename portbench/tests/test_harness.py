"""The harness: a cell is made of files found by name, a run drives the
program through its CLI and checks every answer, and it refuses to run
without the card or with JAX loaded."""
import json
import os
import subprocess
import sys

import pytest

from portbench.lib import cells, harness
from portbench.tests import tiny

RUN = os.path.join(cells.HERE, "run.py")


def test_new_cell_from_new_files_alone(tmp_path):
    """A configuration, a mix, a metric, a check and a cell added as new
    files and entries become a runnable cell: no file of the harness is
    edited."""
    root = tiny.tree(str(tmp_path))
    bench = os.path.join(root, "portbench")
    config = {**json.load(open(os.path.join(
        bench, "configs", "mag_short_pe150_2s30x.json"))),
        "name": "mag_new", "contig_kbp": 8}
    json.dump(config, open(os.path.join(bench, "configs", "mag_new.json"),
                           "w"))
    json.dump({"why": "a new mix", "genomes": 2, "margin": [500, 500],
               "strains": [{"spacing": [2000, 3000], "snp": 1.0,
                            "deletion": 0.0, "insertion": 0.0,
                            "indel_length": [1, 1]}],
               "fractions": [[1.0], [1.0]]},
              open(os.path.join(bench, "traffic", "snps_only.json"), "w"))
    json.dump({"k2_every_job": True,
               "checks": {"jobs_failed": 0, "vcf_missed": 0, "lk_gap": 0.002,
                          "jobs_judged": 1}},
              open(os.path.join(bench, "limits", "new_cell.json"), "w"))
    with open(os.path.join(bench, "metrics", "jobs_done.py"), "w") as fh:
        fh.write("def read(record):\n    return float(len(record['job_s']))\n")
    with open(os.path.join(bench, "checks", "jobs_judged.py"), "w") as fh:
        fh.write("def read(answers):\n    return len(answers['jobs'])\n")
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["configs"].append({"name": "mag_new", "source": "x",
                            "file": "portbench/configs/mag_new.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "new_cell", "config": "mag_new",
                              "traffic": "snps_only", "chips": 1,
                              "why": "x"})
    spec["end_to_end"].append({"name": "jobs_done", "unit": "jobs",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["new_cell"]})
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))

    out = tiny.run(root, "new_cell", seed=2 ** 40 + 3)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert out["metrics"]["jobs_done"]["value"] == 1.0
    assert set(out["metrics"]) == {"call_kbp_s", "peak_rss_mib", "setup_s",
                                   "jobs_done"}
    assert out["sampled"]["planted"] > 0 and out["sampled"]["lk_rows"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"jobs_failed", "vcf_missed", "lk_gap",
                                  "jobs_judged"}
    assert out["checks"]["jobs_judged"] == {"value": 1, "limit": 1}
    # the metric that names its cells is left out of the others
    other = tiny.run(root, "short_clonal")
    assert "jobs_done" not in other["metrics"]
    assert not harness.foreign_modules()


def test_cell_without_k2(tmp_path):
    """A cell whose limits do not ask for K2 on every job (a path that
    leaves the card out) runs its jobs with none and judges what it
    names."""
    root = tiny.tree(str(tmp_path))
    bench = os.path.join(root, "portbench")
    config = {**json.load(open(os.path.join(
        bench, "configs", "mag_short_pe150_2s30x.json"))),
        "name": "mag_f64",
        "call_args": ["call", "-t", "2", "--force-cpu"]}
    json.dump(config, open(os.path.join(bench, "configs", "mag_f64.json"),
                           "w"))
    json.dump({"k2_every_job": False,
               "checks": {"jobs_failed": 0, "vcf_missed": 0,
                          "vcf_false": 0}},
              open(os.path.join(bench, "limits", "f64_cell.json"), "w"))
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["configs"].append({"name": "mag_f64", "source": "x",
                            "file": "portbench/configs/mag_f64.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "f64_cell", "config": "mag_f64",
                              "traffic": "clonal", "chips": 1, "why": "x"})
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))
    out = tiny.run(root, "f64_cell", seed=5)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert set(out["checks"]) == {"jobs_failed", "vcf_missed", "vcf_false"}


def test_traced_run_reports_the_layers(tmp_path):
    root = tiny.tree(str(tmp_path))
    out = tiny.run(root, "short_clonal", traced=True)
    assert out["correct"], out["checks"]
    assert "processing.region_prep_ms_per_kbp" in out["metrics"]
    assert "pool.spawn_s" in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("loaded,refused", [
    (["lorikeet_tpu_torch.ops"], []),
    (["lorikeet_tpu.ops.pairhmm"], ["lorikeet_tpu.ops.pairhmm"]),
    (["jax"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib.xla_client"]),
    (["lorikeet_tpu_torchx", "jaxfoo"], []),
])
def test_import_check_compares_whole_names(monkeypatch, loaded, refused):
    for name in loaded:
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.foreign_modules() == refused


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the run exits non-zero and prints no result:
    there is no CPU fallback."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, RUN, "--workload", "short_clonal", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=cells.ROOT, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_without_the_program_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder gives no result."""
    import shutil
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cells.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "short_clonal",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300, env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
