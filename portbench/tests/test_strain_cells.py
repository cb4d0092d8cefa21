"""The two cells of the strain-genotyping configuration and of the hybrid
clonal mix at a size a CPU test holds.

``genotype_strains12`` keeps its twelve samples and its ``genotype``
command (the tiny tree's ``call -t 2`` would bypass the strain layer),
with two contigs long enough for the three strains to give the strain
layer tens of split contexts: a traced run is correct and reports the
four ``strain.*`` metrics, and each of ``control_strain.py``'s faults is
judged not correct on the checks that have to catch it, as is the
program with its EM, its clustering or its linkage broken.
``hybrid_clonal`` is correct at a size whose K2 batches hold long rows."""
import json

import numpy as np
import pytest

from portbench import control_strain
from portbench.lib import cells
from portbench.tests import tiny

STRAIN_METRICS = [m["name"] for m in json.load(open(
    cells.ROOT + "/BENCHMARK.json"))["per_layer"] if m["layer"] == "strain"]
#: each fault and the checks that have to catch it
CATCHES = {"groups_permuted": ["strain_impure"],
           "abundances_permuted": ["strain_em_gap", "strain_share_gap"],
           "strains_merged": ["strain_count_gap", "strain_share_gap"]}


#: the seed of every genotype run here
SEED = 2 ** 33 + 11


def _genotype_tree(dest: str) -> str:
    """A tiny tree whose genotype cell keeps its command at ``-t 2`` and
    has two contigs of 20 kbp."""
    config = json.load(open(cells.ROOT + "/portbench/configs/"
                            "mag_series_pe150_12s15x.json"))
    args = ["genotype", "-t", "2", *config["call_args"][3:]]
    return tiny.tree(dest, contigs=2, contig_kbp=20, call_args=args)


@pytest.fixture(scope="module")
def genotype_run(tmp_path_factory):
    """(cell, the traced run's result, control_strain's readings)."""
    root = _genotype_tree(str(tmp_path_factory.mktemp("strains")))
    cell = cells.load("genotype_strains12", root)
    kept = {}
    out = tiny.run(root, "genotype_strains12", seed=SEED, traced=True,
                   keep=lambda a: kept.update(control_strain.readings(cell,
                                                                      a)))
    return cell, out, kept


def test_genotype_cell_is_correct_and_traced(genotype_run):
    _, out, _ = genotype_run
    assert out["correct"], out["checks"]
    assert len(STRAIN_METRICS) == 4
    for name in STRAIN_METRICS:
        assert name in out["metrics"], name
    assert out["metrics"]["strain.clustered_pct"]["value"] > 0
    assert out["metrics"]["strain.umap_ms_per_kbp"]["value"] > 0
    assert out["sampled"]["planted"] > 0 and out["sampled"]["missed"] == 0


@pytest.mark.parametrize("fault", control_strain.FAULTS)
def test_strain_fault_is_not_correct(genotype_run, fault):
    cell, _, kept = genotype_run
    got = kept["faults"][fault]
    assert not got["correct"]
    for check in CATCHES[fault]:
        value = got["checks"][check]
        assert not np.isfinite(value) or value > cell.limits["checks"][check]


def _em_rolled(real):
    """``abundance_em`` whose θ is moved one strain on (strain k given
    strain k - 1's; a θ scaled alike in every strain would be normalised
    away where the reference strain is culled)."""
    def em(*args, **kwargs):
        return np.roll(real(*args, **kwargs), 1)
    return em


def _groups_shuffled(real):
    """``cluster_variants`` whose labels are permuted across the
    contexts."""
    def cluster(*args, **kwargs):
        labels, separations = real(*args, **kwargs)
        return np.random.default_rng(0).permutation(labels), separations
    return cluster


def _all_linked(real):
    """``LinkageEngine.run_linkage`` that links every group into one
    strain."""
    def run_linkage(self, *args, **kwargs):
        strains = real(self, *args, **kwargs)
        return [sorted(g for strain in strains for g in strain)]
    return run_linkage


#: the strain layer broken where it computes (the module, the name, the
#: break) and the check that has to catch it
BROKEN = {"em_rolled": ("genotype_mode", "abundance_em", _em_rolled,
                        "strain_em_gap"),
          "groups_shuffled": ("genotype_mode", "cluster_variants",
                              _groups_shuffled, "strain_impure"),
          "all_linked": ("linkage", "LinkageEngine.run_linkage",
                         _all_linked, "strain_count_gap")}


@pytest.mark.parametrize("fault", list(BROKEN))
def test_broken_strain_layer_is_not_correct(tmp_path, monkeypatch, fault):
    import importlib
    module, name, broken, check = BROKEN[fault]
    owner = importlib.import_module(f"lorikeet_tpu_torch.strain.{module}")
    *path, attr = name.split(".")
    for part in path:
        owner = getattr(owner, part)
    monkeypatch.setattr(owner, attr, broken(getattr(owner, attr)))
    root = _genotype_tree(str(tmp_path))
    out = tiny.run(root, "genotype_strains12", seed=SEED)
    assert not out["correct"]
    got = out["checks"][check]
    assert not np.isfinite(got["value"]) or got["value"] > got["limit"]


def test_hybrid_clonal_is_correct(tmp_path):
    root = tiny.tree(str(tmp_path), contig_kbp=30)
    out = tiny.run(root, "hybrid_clonal", seed=2 ** 33 + 5)
    assert out["correct"], out["checks"]
    assert out["sampled"]["planted"] > 0
