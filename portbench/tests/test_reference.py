"""The plain reference: it imports nothing of JAX, the JAX package or the
program, it agrees with the program's exact float64 host kernel (a second
witness), and in bfloat16 it reads far from itself in float64."""
import ast
import os

import numpy as np
import pytest
import torch

from portbench.lib import cells
from portbench.reference import pairhmm, truth

FORBIDDEN = {"jax", "jaxlib", "flax", "lorikeet_tpu", "lorikeet_tpu_torch"}


def imported_tops(path: str) -> set:
    """Top-level names of every module a file imports (the part before
    the first dot, compared whole)."""
    tops = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_reference_imports_nothing_of_jax_or_the_program():
    folder = os.path.join(cells.HERE, "reference")
    files = [f for f in os.listdir(folder) if f.endswith(".py")]
    assert "pairhmm.py" in files and "truth.py" in files
    for f in files:
        assert not imported_tops(os.path.join(folder, f)) & FORBIDDEN, f


def test_the_check_compares_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import lorikeet_tpu_torch.ops\nfrom numpy import x\n"
                   "import lorikeet_tpuX\n")
    assert imported_tops(str(src)) == {"lorikeet_tpu_torch", "numpy",
                                       "lorikeet_tpuX"}
    src.write_text("from lorikeet_tpu.ops import y\n")
    assert imported_tops(str(src)) & FORBIDDEN == {"lorikeet_tpu"}


def _pairs(rng, n, rmax=150, hmax=400):
    bases = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for k in range(n):
        h = int(rng.integers(30, hmax))
        r = int(rng.integers(10, rmax))
        hap = bases[rng.integers(0, 4, h)]
        lo = int(rng.integers(0, max(1, h - r)))
        read = hap[lo:lo + r].copy() if h > r else bases[rng.integers(0, 4, r)]
        r = len(read)
        read[rng.integers(0, r, 3)] = bases[rng.integers(0, 4, 3)]
        if k % 5 == 0:
            read[int(rng.integers(0, r))] = ord("N")
        q = rng.integers(6, 41, r).astype(np.uint8)
        iq = np.full(r, 45, np.uint8)
        iq[rng.integers(0, r, 3)] = rng.integers(10, 45, 3)
        out.append((hap, read, q, iq, iq.copy(), np.full(r, 10, np.uint8)))
    return out


def test_agrees_with_the_programs_f64_kernel():
    from lorikeet_tpu_torch.ops.pairhmm import pairhmm_forward_f64
    pairs = _pairs(np.random.default_rng(3), 40)
    got = pairhmm.forward_log10(pairs, chunk=16)
    np.testing.assert_allclose(got, pairhmm_forward_f64(pairs), rtol=0,
                               atol=1e-10)


def test_lower_precision_reads_far():
    pairs = _pairs(np.random.default_rng(4), 30)
    f64 = pairhmm.forward_log10(pairs)
    kept = f64 > -28.0            # the rows the harness compares
    f32 = pairhmm.forward_log10(pairs, torch.float32)[kept]
    bf16 = pairhmm.forward_log10(pairs, torch.bfloat16)[kept]
    assert kept.sum() > 10
    assert np.abs(f32 - f64[kept]).max() < 1e-4
    assert np.abs(bf16 - f64[kept]).max() > 100 * np.abs(
        f32 - f64[kept]).max()


def test_normalize():
    #                                     0123456789012
    ref = np.frombuffer(b"TTTACGCGCGTAC", np.uint8)
    # one CG deleted: anchored on any of the three G's (or A) alike
    want = truth.normalize(ref, 3, b"ACG", b"A")
    assert want == (3, b"ACG", b"A")
    for pos in (5, 7):
        assert truth.normalize(ref, pos, b"GCG", b"G") == want
    # an insertion written with context on its right
    assert truth.normalize(ref, 0, b"TT", b"TGT") == \
        truth.normalize(ref, 0, b"T", b"TG")
    assert truth.normalize(ref, 10, b"T", b"G") == (10, b"T", b"G")


def test_compare_counts(tmp_path):
    contigs = {"c0": np.frombuffer(b"ACGTACGTTTGACCA", np.uint8)}
    planted = [("c0", 2, b"G", b"T", 1), ("c0", 9, b"T", b"TAA", 1)]
    vcf = tmp_path / "x.vcf"
    vcf.write_text("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL"
                   "\tFILTER\tINFO\tFORMAT\ts0\ts1\n"
                   "c0\t3\t.\tG\tT,C\t9\t.\t.\tGT:AD\t0/1:6,3,1:10"
                   "\t1/1:1,9,0\n")
    got = truth.compare(str(vcf), contigs, planted, [[0.3], [0.8]])
    assert {k: got[k] for k in ("planted", "called", "missed", "false")} \
        == {"planted": 2, "called": 2, "missed": 1, "false": 1}
    # the one planted allele called: 3 of sample 0's 10 reads, 9 of 10
    np.testing.assert_allclose(got["share_bias"], [0.0, 0.1], atol=1e-12)


def test_share_without_reads(tmp_path):
    """A sample with no read counts at a planted allele gives no share."""
    contigs = {"c0": np.frombuffer(b"ACGTACGTTTGACCA", np.uint8)}
    vcf = tmp_path / "x.vcf"
    vcf.write_text("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
                   "\ts0\ts1\nc0\t3\t.\tG\tT\t9\t.\t.\tGT:AD\t0/1:0,0"
                   "\t1/1:.\n")
    got = truth.compare(str(vcf), contigs, [("c0", 2, b"G", b"T", 1)],
                        [[0.5], [0.5]])
    assert np.isnan(got["share_bias"]).all() and got["missed"] == 0
