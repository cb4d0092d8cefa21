"""`summarise` through the port's CLI against the JAX package's, on the CPU.

Two genomes' VCFs, written by the port's exact f64 `call` on simulated
3 kbp x 2 samples x 20x fixtures, go through both CLIs' `summarise` (ANI
tables, and Hudson Fst with ``--calculate-fst``) at -t 2; every output file
must be equal byte for byte.
"""
import os
import shutil
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lorikeet_tpu.cli import main as jax_main
import lorikeet_tpu_torch.calling.engine as tengine
from lorikeet_tpu_torch.cli import main as torch_main
import lorikeet_tpu_torch.processing as tproc

from test_torch_call import simulate_fixture


@pytest.fixture(scope="module")
def port_vcfs(tmp_path_factory):
    """The port's f64 `call` VCFs of two simulated genomes."""
    root = tmp_path_factory.mktemp("summarise")
    vcfs = []
    for name, seed in (("genome_a", 3), ("genome_b", 8)):
        tmp = root / name
        tmp.mkdir()
        fasta, bams, _ = simulate_fixture(str(tmp), seed=seed)
        vcf = tproc.run_call(fasta, bams, str(tmp / "out"),
                             tengine.CallerConfig(use_cuda=False))
        vcfs.append(str(root / f"{name}.vcf"))
        shutil.copyfile(vcf, vcfs[-1])
    return vcfs


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("fst", [False, True], ids=["ani", "ani_fst"])
def test_summarise_outputs_equal_jax(port_vcfs, tmp_path, capsys, fst):
    extra = ["--calculate-fst"] if fst else []
    outs = {}
    for label, main in (("jax", jax_main), ("torch", torch_main)):
        outs[label] = str(tmp_path / label)
        rc = main(["summarise", "-t", "2", "-i", *port_vcfs, "-o",
                   outs[label], *extra])
        assert rc == 0, label
    capsys.readouterr()
    want, got = _files(outs["jax"]), _files(outs["torch"])
    assert sorted(got) == sorted(want)
    assert [n for n in want if got[n] != want[n]] == []
    # each genome's three ANI tables, and its Fst table when asked
    assert len(want) == 2 * (3 + fst)
    assert all(want.values())
