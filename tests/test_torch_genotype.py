"""`genotype` through the port with scikit-learn blocked, against the JAX
package's `genotype` with it.

The port clusters split contexts with its own HDBSCAN
(`lorikeet_tpu_torch.strain.hdbscan`); the JAX package with scikit-learn's.
The port runs in a subprocess whose `sys.meta_path` refuses `sklearn`, so
a stray import fails the run.  Three strain mixtures (f64 host pair-HMM):
the genotype golden fixture (2 strains x 4 samples, 24 kb) at -t 1 and -t
2, `bench.py`'s linked fixture (SNPs every 240 bp, 40 kb) and a 12-sample,
3-strain time series (30 kb) that takes the UMAP path above 8 samples.
Every output file must equal the JAX package's byte for byte; the same
contexts through both packages' `cluster_variants` give the same labels,
and separations that differ by the port's scale (the spread a sample:
the JAX package's times the root of the samples).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from lorikeet_tpu_torch.testkit import strains

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DATASETS = {
    "golden": lambda root: strains.genotype_dataset(
        root, length=24_000, n_snps=10, contig="ggold~c1")[:2],
    "linked": lambda root: strains.linked_dataset(root)[:2],
    "series12": lambda root: strains.time_series_dataset(
        root, 30_000, samples=12, spacing=1000, seed=29)[:2],
}
RUNS = [("golden", 1), ("golden", 2), ("linked", 1), ("series12", 1)]

#: put first on sys.meta_path: any import of scikit-learn fails
BLOCK_SKLEARN = """
import sys
class _NoSklearn:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "sklearn":
            raise ImportError("scikit-learn is blocked in this run")
        return None
sys.meta_path.insert(0, _NoSklearn())
"""

PORT_GENOTYPE = BLOCK_SKLEARN + """
import json
from lorikeet_tpu_torch import processing
from lorikeet_tpu_torch.calling.engine import CallerConfig
from lorikeet_tpu_torch.parallel import pool
# the pool's size gate opened: -t 2 runs the span workers on a small genome
processing._pool_worthwhile = lambda *a: True
fasta, bams, outdir, threads = json.loads(sys.argv[1])
try:
    out = processing.start_engine(
        "genotype", [fasta], bams, outdir,
        CallerConfig(use_cuda=False, threads=threads,
                     qual_by_depth_filter=8.0))
finally:
    pool.shutdown_pool()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("sklearn", "jax", "jaxlib", "lorikeet_tpu")]
assert not bad, f"imported: {bad}"
print(json.dumps(out))
"""


def output_files(out: dict) -> dict:
    paths = [out["vcf"], *out["ani"].values(), out["strain_coverages"],
             *out["strain_fastas"]]
    return {os.path.basename(p): p for p in paths}


def read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """name -> (fasta, bams, the JAX package's genotype outputs), each
    dataset simulated and run once."""
    from lorikeet_tpu.calling.engine import CallerConfig
    from lorikeet_tpu.processing import start_engine
    cache = {}

    def get(name):
        if name not in cache:
            root = tmp_path_factory.mktemp(name)
            fasta, bams = DATASETS[name](str(root / "data"))
            (out,) = start_engine(
                "genotype", [fasta], bams, str(root / "jax"),
                CallerConfig(use_pallas=False, threads=1,
                             qual_by_depth_filter=8.0)).values()
            assert "error" not in out, out
            cache[name] = fasta, bams, out
        return cache[name]
    return get


def _port_genotype(fasta, bams, outdir, threads):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run(
        [sys.executable, "-c", PORT_GENOTYPE,
         json.dumps([fasta, bams, outdir, threads])],
        cwd=outdir, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    (out,) = json.loads(res.stdout.strip().splitlines()[-1]).values()
    assert "error" not in out, out
    return out


def _split(vcf, package):
    """The split contexts `run_genotype` clusters, read by ``package``."""
    import importlib
    read_vcf = importlib.import_module(f"{package}.io.vcf").read_vcf
    mode = importlib.import_module(f"{package}.strain.genotype_mode")
    contexts, _, _ = read_vcf(vcf)
    split, _ = mode.split_contexts(contexts, 8.0, min_variant_depth=10)
    return mode, split


@pytest.mark.parametrize("name,threads", RUNS,
                         ids=[f"{n}-t{t}" for n, t in RUNS])
def test_port_genotype_without_sklearn_writes_the_jax_files(
        jax_runs, tmp_path, name, threads):
    fasta, bams, want = jax_runs(name)
    got = _port_genotype(fasta, bams, str(tmp_path), threads)
    got_files, want_files = output_files(got), output_files(want)
    assert sorted(got_files) == sorted(want_files)
    differ = [f for f in sorted(want_files)
              if read(got_files[f]) != read(want_files[f])]
    assert not differ, f"{differ} differ from the JAX package's"
    assert got["n_variant_groups"] == want["n_variant_groups"] >= 2
    # clustering took HDBSCAN (4 split contexts or more), and above 8
    # samples the UMAP layout first
    _, split = _split(got["vcf"], "lorikeet_tpu_torch")
    assert len(split) >= 4
    assert (len(bams) > 8) == (name == "series12")


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_cluster_variants_equals_the_jax_package(jax_runs, name):
    _, _, want = jax_runs(name)
    port, port_split = _split(want["vcf"], "lorikeet_tpu_torch")
    jax_mode, jax_split = _split(want["vcf"], "lorikeet_tpu")
    assert np.array_equal(port.depth_matrix(port_split),
                          jax_mode.depth_matrix(jax_split))
    labels, sep = port.cluster_variants(port_split)
    want_labels, want_sep = jax_mode.cluster_variants(jax_split)
    assert len(labels) >= 4
    assert labels.dtype == np.int64
    assert np.array_equal(labels, want_labels)
    # the port's separations are in spreads a sample: the JAX package's
    # times the root of the samples (strain/genotype_mode.py)
    n_samples = port.depth_matrix(port_split).shape[1]
    assert sep.shape == want_sep.shape
    assert np.allclose(sep, want_sep * np.sqrt(n_samples), rtol=1e-12,
                       atol=0.0)
