"""Every CLI mode through the port against the JAX package, on the CPU.

A simulated 40 kb genome (one variant per ~2 kb) with two paired short-read
samples at 20x and one long-read BAM of the same variants at 10x
(`testkit/longreads.py`: 2-3 kb reads, 2 % substitutions, quality 22) goes
through both CLIs with `--force-cpu` (the exact f64 host pair-HMM), and
every output file of the two runs must be equal byte for byte.  Logs and
the runs' private state (`.chunks` checkpoints and `.shards-*`, which
pickle each package's own classes) are not outputs.  Cases:

- `call`, `consensus` and `genotype` with `-l` (short and long reads
  mixed), and `summarise` on the mixed `call` VCF;
- the pair-HMM input flags: `--pcr-indel-model none` / `hostile`,
  `--pair-hmm-gap-continuation-penalty 20`,
  `--phred-scaled-global-read-mismapping-rate 30` with
  `--disable-symmetric-hmm-normalizing`, `--use-adaptive-pruning`, and
  `--features-vcf` with the planted truth;
- `--checkpoint` run twice on a two-contig genome, the second run
  resuming from the first's checkpoint of one contig;
- `--parallel-genomes 2` over two genomes;
- a chunk-shard `call` in two processes a package
  (`LORIKEET_PROCESS_INDEX` 0 and 1, `LORIKEET_PROCESS_COUNT` 2) on a
  100 kb genome, two chunks: the gatherer's files must be the JAX
  package's;
- the long-read filter of `processing._read_passes_filters` on records
  around its length and quality limits.
"""
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from lorikeet_tpu.cli import main as jax_main
from lorikeet_tpu_torch.cli import main as torch_main
from lorikeet_tpu_torch.testkit.dataset import (
    simulate_dataset, write_truth_vcf,
)
from lorikeet_tpu_torch.testkit.longreads import (
    add_long_read_bam, simulate_long_reads,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAINS = (("jax", jax_main), ("torch", torch_main))
PACKAGES = (("jax", "lorikeet_tpu"), ("torch", "lorikeet_tpu_torch"))


def _mixed(root, kbp, seed=0):
    """(fasta, short BAMs, long BAM, truth VCF) of a simulated genome."""
    os.makedirs(root, exist_ok=True)
    fasta, bams, truth = simulate_dataset(root, kbp, 2, 20.0, seed=seed)
    long_bam, _ = add_long_read_bam(
        fasta, truth, os.path.join(root, "long0.bam"), 10.0, seed=seed)
    return fasta, bams, long_bam, write_truth_vcf(
        os.path.join(root, "truth.vcf"), fasta, truth)


def _two_genomes(root):
    """Two single-contig genomes of 20 kb, one combined FASTA holding both
    contigs, and two short-read BAMs over both contigs."""
    from lorikeet_tpu_torch.io.bam_writer import write_bam
    from lorikeet_tpu_torch.testkit.simulate import Variant, simulate_reads
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", np.uint8)
    names, refs, variants = ["contigA", "contigB"], [], []
    for _ in names:
        ref = bases[rng.integers(0, 4, 20_000)]
        refs.append(ref)
        variants.append([Variant(p, bytes(ref[p:p + 1]), bytes(
            [b"ACGT"[(b"ACGT".index(ref[p]) + 1) % 4]]))
            for p in range(1500, 19_000, 1700)])
    fastas = []
    for gname, contigs in (("gA", [0]), ("gB", [1]), ("both", [0, 1])):
        path = os.path.join(root, f"{gname}.fna")
        with open(path, "w") as fh:
            for c in contigs:
                fh.write(f">{names[c]}\n{refs[c].tobytes().decode()}\n")
        fastas.append(path)
    bams = []
    for s in range(2):
        recs = [r for t in range(2) for r in simulate_reads(
            refs[t], variants[t], coverage=15.0, seed=100 * s + t, tid=t,
            allele_fraction=0.5, sample=f"sample{s}")]
        bams.append(os.path.join(root, f"sample{s}.bam"))
        write_bam(bams[-1], names, [len(r) for r in refs],
                  sorted(recs, key=lambda r: (r.tid, r.pos)))
    return fastas, bams


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("modes")
    fasta, bams, long_bam, truth_vcf = _mixed(str(root / "mixed"), 40)
    fastas, two_bams = _two_genomes(str(root / "two"))
    return {"fasta": fasta, "bams": bams, "long": long_bam,
            "truth": truth_vcf, "genomes": fastas[:2], "both": fastas[2],
            "two_bams": two_bams, "root": root}


def _files(root) -> dict:
    """{relative path: bytes} of every output file under ``root``."""
    out = {}
    for dirpath, dirs, names in os.walk(root):
        dirs[:] = [d for d in dirs if not d.startswith(".")]
        for n in names:
            if n.endswith(".log"):
                continue
            path = os.path.join(dirpath, n)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _run(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0, argv
    return json.loads(buf.getvalue().strip().splitlines()[-1])["outputs"]


def _assert_same_files(a, b, n_min=1):
    want, got = _files(a), _files(b)
    assert sorted(got) == sorted(want)
    assert [n for n in want if got[n] != want[n]] == []
    assert len(want) >= n_min and all(want.values())


def _genome_args(d):
    return ["--force-cpu", "-t", "1", "-r", d["fasta"], "-b", *d["bams"],
            "-l", d["long"]]


#: (mode, extra flags, files at least: VCF + 3 ANI tables, and what the
#: mode adds)
CASES = {
    "call_mixed": ("call", [], 4),
    "consensus_mixed": ("consensus", [], 5),
    "genotype_mixed": ("genotype", ["--qual-by-depth-filter", "8"], 5),
    "pcr_indel_none": ("call", ["--pcr-indel-model", "none"], 4),
    "pcr_indel_hostile": ("call", ["--pcr-indel-model", "hostile"], 4),
    "gap_continuation_20": (
        "call", ["--pair-hmm-gap-continuation-penalty", "20"], 4),
    "mismapping_30_asymmetric": (
        "call", ["--phred-scaled-global-read-mismapping-rate", "30",
                 "--disable-symmetric-hmm-normalizing"], 4),
    "adaptive_pruning": ("call", ["--use-adaptive-pruning"], 4),
    "features_vcf": ("call", ["--features-vcf", None], 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mode_outputs_equal_jax(data, tmp_path, case):
    mode, extra, n_min = CASES[case]
    extra = [data["truth"] if x is None else x for x in extra]
    outs = {}
    for label, main in MAINS:
        outs[label] = str(tmp_path / label)
        _run(main, [mode, *_genome_args(data), "-o", outs[label], *extra])
    _assert_same_files(outs["jax"], outs["torch"], n_min)


def test_flags_change_what_the_pair_hmm_is_fed(data, tmp_path):
    """Each flag set of CASES moves the port's VCF off the default one, so
    the byte-equal cases above compare runs that took the flags."""
    outs = {}
    for case in ("call_mixed", "pcr_indel_none", "gap_continuation_20",
                 "mismapping_30_asymmetric"):
        mode, extra, _ = CASES[case]
        (out,) = _run(torch_main, [mode, *_genome_args(data), "-o",
                                   str(tmp_path / case), *extra])[
            "genomes"].values()
        with open(out["vcf"], "rb") as fh:
            outs[case] = fh.read()
    assert len(set(outs.values())) == len(outs)


def test_summarise_mixed_vcf_equals_jax(data, tmp_path):
    (out,) = _run(jax_main, ["call", *_genome_args(data), "-o",
                             str(tmp_path / "call")])["genomes"].values()
    outs = {}
    for label, main in MAINS:
        outs[label] = str(tmp_path / label)
        _run(main, ["summarise", "-i", out["vcf"], "-o", outs[label]])
    _assert_same_files(outs["jax"], outs["torch"], 3)


def test_checkpoint_resume_equals_jax(data, tmp_path):
    """--checkpoint on a two-contig genome; the VCF and one contig's
    checkpoint removed; the second run computes that contig, loads the
    other and writes the same files in both packages."""
    outs = {}
    for label, main in MAINS:
        outs[label] = out = str(tmp_path / label)
        argv = ["call", "--force-cpu", "-t", "1", "--checkpoint", "-r",
                data["both"], "-b", *data["two_bams"], "-o", out]
        (first,) = _run(main, argv)["genomes"].values()
        chunks = os.path.join(os.path.dirname(first["vcf"]), ".chunks")
        saved = sorted(n for n in os.listdir(chunks) if n.endswith(".pkl"))
        assert len(saved) == 2, saved
        os.remove(first["vcf"])
        os.remove(os.path.join(chunks, saved[0]))
        (second,) = _run(main, argv)["genomes"].values()
        assert not second.get("cached")
        assert sorted(n for n in os.listdir(chunks)
                      if n.endswith(".pkl")) == saved
    _assert_same_files(outs["jax"], outs["torch"], 4)


def test_parallel_genomes_equals_jax(data, tmp_path):
    outs = {}
    for label, main in MAINS:
        outs[label] = str(tmp_path / label)
        res = _run(main, ["call", "--force-cpu", "-t", "1",
                          "--parallel-genomes", "2", "-r", *data["genomes"],
                          "-b", *data["two_bams"], "-o", outs[label]])
        assert sorted(res["genomes"]) == ["gA", "gB"]
    _assert_same_files(outs["jax"], outs["torch"], 8)


def _env(index=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["JAX_PLATFORMS"] = "cpu"
    if index is not None:
        env.update(LORIKEET_PROCESS_INDEX=str(index),
                   LORIKEET_PROCESS_COUNT="2")
    return env


def chunk_shard_call(package, argv, outdir, timeout=600):
    """`call` of ``package`` in two processes started together, process
    index 0 (the gatherer) and 1, into one output directory; returns the
    gatherer's outputs (the worker's carry no VCF)."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"{package}.cli", *argv, "-o", outdir],
        cwd=REPO, env=_env(index), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for index in (0, 1)]
    outs = [p.communicate(timeout=timeout) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    results = [json.loads(o.strip().splitlines()[-1])["outputs"]["genomes"]
               for o, _ in outs]
    assert all(g.get("vcf") is None and g["role"] == "worker"
               for g in results[1].values())
    return results[0]


def test_two_process_chunk_shard_equals_jax(tmp_path):
    """Three samples make chunks of 83,333 bases, so the 100 kb genome is
    two units, one a process.  The gatherer's files equal the JAX
    package's; whether they equal the one-process run's is the same in
    both packages."""
    fasta, bams, long_bam, _ = _mixed(str(tmp_path / "data"), 100, seed=4)
    argv = ["call", "--force-cpu", "-t", "1", "-r", fasta, "-b", *bams,
            "-l", long_bam]
    sharded, single = {}, {}
    for label, package in PACKAGES:
        sharded[label] = str(tmp_path / f"{label}_shard")
        (gathered,) = chunk_shard_call(package, argv,
                                       sharded[label]).values()
        assert gathered["vcf"] and not any(
            n.startswith(".shards") for n in os.listdir(
                os.path.dirname(gathered["vcf"])))
        single[label] = str(tmp_path / f"{label}_single")
        res = subprocess.run(
            [sys.executable, "-m", f"{package}.cli", *argv, "-o",
             single[label]], cwd=REPO, env=_env(), capture_output=True,
            text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
    _assert_same_files(sharded["jax"], sharded["torch"], 4)
    _assert_same_files(single["jax"], single["torch"], 4)


def test_long_read_filter_equals_jax():
    """The simulated long reads pass; a read under 1,500 bases or under
    mean quality 20 fails in the long-read filter only; both packages'
    filters agree on every record."""
    import lorikeet_tpu.processing as jproc
    import lorikeet_tpu_torch.processing as tproc

    ref = np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(5).integers(0, 4, 12_000)]
    recs = simulate_long_reads(ref, coverage=3.0, seed=5)
    assert recs and all(2000 <= len(r.seq) <= 3000 for r in recs)
    short = simulate_long_reads(ref, coverage=1.0, seed=6)[0]
    short.seq, short.qual = short.seq[:1499], short.qual[:1499]
    short.cigar = [("M", 1499)]
    dull = simulate_long_reads(ref, coverage=1.0, seed=7)[0]
    dull.qual = np.full(len(dull.seq), 19, np.uint8)
    cases = recs + [short, dull]
    for read_type in ("short", "long"):
        got = [tproc._read_passes_filters(r, read_type=read_type)
               for r in cases]
        want = [jproc._read_passes_filters(r, read_type=read_type)
                for r in cases]
        assert got == want
        assert all(got[:len(recs)])
        assert got[-2:] == ([True, True] if read_type == "short"
                            else [False, False])
