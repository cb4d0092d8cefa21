"""The strain layer's spans and counters in a pooled ``genotype -t 2``
(``--force-cpu``) over twelve samples, which takes the UMAP path.

With spans on, the span ``strain`` (its genome, samples and split
contexts) lies inside the command's ``call`` span, in the parent's main
thread, and holds its six parts; the counters (``pool.WORKER_COUNTS``)
give the split contexts, those clustered (no more), the groups and the
strains.  With spans off nothing is recorded, the counters count all the
same and every output file is the one the run with spans wrote."""
import os

import pytest

from lorikeet_tpu_torch import cli
from lorikeet_tpu_torch import processing as tproc
from lorikeet_tpu_torch.parallel import pool as tpool
from lorikeet_tpu_torch.testkit import strains
from lorikeet_tpu_torch.utils import progress

PARTS = ("strain.split", "strain.umap", "strain.hdbscan", "strain.linkage",
         "strain.em", "strain.write")
COUNTERS = ("strain_contexts", "strain_clustered", "strain_groups",
            "strain_strains")


@pytest.fixture(scope="module")
def series(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("series"))
    fasta, bams, _ = strains.time_series_dataset(root, 30_000, samples=12,
                                                 spacing=1000, seed=29)
    return fasta, bams


def _genotype(fasta, bams, out) -> dict:
    args = ["genotype", "-t", "2", "--force-cpu", "--qual-by-depth-filter",
            "8", "-r", fasta, "-b", *bams, "-o", out]
    assert cli.main(args) == 0
    gdir = os.path.join(out, "gseries")
    files = {}
    for name in sorted(os.listdir(gdir)):
        if os.path.isfile(os.path.join(gdir, name)):
            with open(os.path.join(gdir, name), "rb") as fh:
                files[name] = fh.read()
    return files


def test_strain_spans_and_counters(series, tmp_path, monkeypatch, capsys):
    fasta, bams = series
    monkeypatch.setattr(tproc, "_pool_worthwhile", lambda *a: True)
    monkeypatch.setattr(progress, "GLOBAL_STAGES", {})
    monkeypatch.setattr(progress, "SPANS", None)
    monkeypatch.setattr(tpool, "WORKER_COUNTS",
                        dict.fromkeys(tpool.WORKER_COUNTS, 0))
    try:
        on = _genotype(fasta, bams, str(tmp_path / "on"))
        stages, spans = progress.GLOBAL_STAGES, progress.SPANS
        counts_on = {k: tpool.WORKER_COUNTS[k] for k in COUNTERS}
        progress.GLOBAL_STAGES = progress.SPANS = None
        tpool.WORKER_COUNTS.update(dict.fromkeys(tpool.WORKER_COUNTS, 0))
        off = _genotype(fasta, bams, str(tmp_path / "off"))
        assert progress.SPANS is None and progress.GLOBAL_STAGES is None
        counts_off = {k: tpool.WORKER_COUNTS[k] for k in COUNTERS}
    finally:
        tpool.shutdown_pool()
    capsys.readouterr()

    assert on == off
    assert {"gseries.vcf", "gseries_strain_coverages.tsv"} <= set(on)
    mine = [s for s in spans if s[6][:2] == (os.getpid(), None)]
    by_name = {}
    for s in mine:
        by_name.setdefault(s[0], []).append(s)
    (call,) = by_name["call"]
    (layer,) = by_name["strain"]
    assert layer[5] == {"genome": "gseries", "samples": 12,
                        "contexts": counts_on["strain_contexts"]}
    assert call[1] <= layer[1] < layer[2] <= call[2]
    assert layer[6][2] == "MainThread"
    for name in PARTS:
        (part,) = by_name[name]
        assert part[3] == layer[4], name
        assert layer[1] <= part[1] <= part[2] <= layer[2], name
        assert part[6] == layer[6], name
        assert stages[name] > 0, name
    assert sum(stages[n] for n in PARTS) <= stages["strain"]
    assert "genotype" not in {s[0] for s in mine}

    assert counts_on == counts_off
    assert counts_on["strain_contexts"] > 0
    assert 0 < counts_on["strain_clustered"] <= counts_on["strain_contexts"]
    assert counts_on["strain_groups"] >= 2
    assert counts_on["strain_strains"] >= 1
