"""The CLI's remaining paths through the port against the JAX package, on
the CPU.

A simulated 40 kb genome (seed 0, one variant per ~2 kb) with two paired
short-read samples at 20x goes through both CLIs in-process with
`--force-cpu`, and every output file of the two runs must be equal byte
for byte (logs and hidden directories left out, as in
`test_torch_modes.py`).  Cases:

- `--calculate-dnds --gff-file G --calculate-fst` at -t 1 and -t 2, with
  `testkit/genes.py`'s CDS tiling the contig (and --qual-by-depth-filter
  8, so that the heterozygous SNPs qualify);
- `--limiting-interval` inside the contig, past its end, and as a bare
  number (ignored);
- raw reads through a stub mapper on PATH (`testkit/mapper.py`):
  `--single`, `-1`/`-2`, `--interleaved`, `--longreads` with
  `--longread-mapper ngmlr-ont`, `--bam-file-cache-directory`, and a
  mapper that exits non-zero (both CLIs fail the same way);
- the output cache: a second run reports `"cached": true` and touches no
  file, `--force` rewrites them;
- `--split-bams` over two genomes;
- a chunk-shard gatherer stealing the units of a worker that never ran,
  and of one killed after its first shard;
- `man`, `shell-completion` and `--full-help` / `--full-help-roff`: equal
  but for the help of the flags whose meaning the card changed
  (``CARD_FLAGS``).
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from lorikeet_tpu.cli import main as jax_main
from lorikeet_tpu_torch.cli import main as torch_main
from lorikeet_tpu_torch.testkit.dataset import simulate_dataset
from lorikeet_tpu_torch.testkit.genes import write_gff
from lorikeet_tpu_torch.testkit.longreads import add_long_read_bam
from lorikeet_tpu_torch.testkit.mapper import install_stub_mapper, write_sam
from test_torch_modes import (
    MAINS, PACKAGES, REPO, _assert_same_files, _files, _run, _two_genomes,
)

#: the flags whose help the port rewrote for the card; every other line of
#: the man pages and the full help is the JAX package's
CARD_FLAGS = {"--force-cpu", "--devices", "--profile-dir"}
#: the CallerConfig of the exact f64 host path, in each package's names
HOST_CFG = {"lorikeet_tpu": {"use_pallas": False},
            "lorikeet_tpu_torch": {"use_cuda": False}}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("paths"))
    fasta, bams, truth = simulate_dataset(root, 40, 2, 20.0, seed=0)
    long_bam, _ = add_long_read_bam(fasta, truth,
                                    os.path.join(root, "long0.bam"), 10.0,
                                    seed=0)
    gff = write_gff(os.path.join(root, "genes.gff"), "contig1", 40_000,
                    seed=0)
    fastas, two_bams = _two_genomes(os.path.join(root, "two"))
    return {"root": root, "fasta": fasta, "bams": bams, "truth": truth,
            "long": long_bam, "gff": gff, "genomes": fastas[:2],
            "two_bams": two_bams}


def _args(d, threads=1):
    return ["--force-cpu", "-t", str(threads), "-r", d["fasta"]]


def _body(vcf) -> list:
    with open(vcf) as fh:
        return [line for line in fh if not line.startswith("#")]


def _both(tmp_path, argv_for) -> dict:
    """Run ``argv_for(label, outdir)`` through both CLIs; {label: (outdir,
    outputs)}."""
    outs = {}
    for label, main in MAINS:
        out = str(tmp_path / label)
        outs[label] = (out, _run(main, argv_for(label, out)))
    return outs


# ---- dN/dS and Fst --------------------------------------------------------

def _cds(gff) -> list:
    with open(gff) as fh:
        return [(int(f[3]) - 1, int(f[4]), f[8].split("=")[1])
                for f in (line.rstrip("\n").split("\t") for line in fh
                          if not line.startswith("#"))]


def test_write_gff_tiles_the_contig(data):
    cds = _cds(data["gff"])
    assert 30 <= len(cds) <= 50
    assert all((end - start) % 3 == 0 and start < end <= 40_000
               for start, end, _ in cds)
    assert all(a[1] < b[0] for a, b in zip(cds, cds[1:]))
    with open(data["gff"]) as fh:
        strands = [line.split("\t")[6] for line in fh
                   if not line.startswith("#")]
    assert strands[:4] == ["+", "-", "+", "-"]
    # a planted indel inside a CDS: the frameshift path runs
    assert any(start <= v.pos < end for v in data["truth"]
               if len(v.ref) != len(v.alt) for start, end, _ in cds)


@pytest.mark.parametrize("threads", [1, 2])
def test_dnds_and_fst_equal_jax(data, tmp_path, threads):
    """The planted variants are heterozygous (QD ~12-25): at the default
    --qual-by-depth-filter of 25 the VCF marks most of them QF=false and
    dN/dS counts none, so the run sets the filter to 8."""
    outs = _both(tmp_path, lambda _, out: [
        "call", *_args(data, threads), "-b", *data["bams"], "-o", out,
        "--qual-by-depth-filter", "8", "--calculate-dnds", "--gff-file",
        data["gff"], "--calculate-fst"])
    _assert_same_files(outs["jax"][0], outs["torch"][0], 6)
    (genome,) = outs["torch"][1]["genomes"].values()
    with open(genome["dnds"]) as fh:
        rows = [line.rstrip("\n").split("\t") for line in fh]
    cds = _cds(data["gff"])
    assert [r[0] for r in rows[1:]] == [name for _, _, name in cds]
    snps = rows[0].index("sample0_snps")
    by_gene = {r[0]: int(r[snps]) for r in rows[1:]}
    planted = [name for start, end, name in cds for v in data["truth"]
               if len(v.ref) == len(v.alt) == 1 and start <= v.pos < end]
    assert planted and any(by_gene[name] > 0 for name in planted)
    shifts = rows[0].index("sample0_frameshifts")
    assert any(int(r[shifts]) > 0 for r in rows[1:])
    assert os.path.getsize(genome["fst"])


# ---- --limiting-interval --------------------------------------------------

@pytest.mark.parametrize("interval", ["2000-9000", "50000-60000", "5000"])
def test_limiting_interval_equals_jax(data, tmp_path, interval):
    outs = _both(tmp_path, lambda _, out: [
        "call", *_args(data), "-b", *data["bams"], "-o", out,
        "--limiting-interval", interval])
    _assert_same_files(outs["jax"][0], outs["torch"][0], 4)
    (genome,) = outs["torch"][1]["genomes"].values()
    positions = [int(line.split("\t")[1]) - 1
                 for line in _body(genome["vcf"])]
    if interval == "2000-9000":
        assert positions and all(2000 <= p < 9000 for p in positions)
    elif interval == "50000-60000":
        # past the contig's end: a header and no site
        assert positions == []
    else:
        # a bare number is no interval: the whole contig
        plain = str(tmp_path / "plain")
        (whole,) = _run(torch_main, ["call", *_args(data), "-b",
                                     *data["bams"], "-o", plain])[
            "genomes"].values()
        with open(whole["vcf"], "rb") as a, open(genome["vcf"], "rb") as b:
            assert a.read() == b.read()
        assert any(p >= 9000 for p in positions)


# ---- raw reads through a mapper -------------------------------------------

@pytest.fixture(scope="module")
def mapper(data, tmp_path_factory):
    """Stub `minimap2` and `ngmlr` on a bin directory: each sample's reads
    (under every file name a case gives them) map to the sample BAM's
    records, the long reads to the long-read BAM's."""
    root = tmp_path_factory.mktemp("mapper")
    sams = [write_sam(b, str(root / f"sample{s}.sam"))
            for s, b in enumerate(data["bams"])]
    long_sam = write_sam(data["long"], str(root / "long0.sam"))
    fastq = {}
    for s in range(len(sams)):
        for kind in ("se", "R1", "R2", "il"):
            path = root / "reads" / f"s{s}_{kind}.fq"
            path.parent.mkdir(exist_ok=True)
            path.write_text("@r\nACGT\n+\nIIII\n")
            fastq[(s, kind)] = str(path)
    fastq["long"] = str(root / "reads" / "long0.fq")
    fastq["unrouted"] = str(root / "reads" / "unrouted.fq")
    for key in ("long", "unrouted"):
        with open(fastq[key], "w") as fh:
            fh.write("@r\nACGT\n+\nIIII\n")
    routes = {os.path.basename(fastq[(s, kind)]): sams[s]
              for s in range(len(sams)) for kind in ("se", "R1", "il")}
    bindir = str(root / "bin")
    install_stub_mapper(bindir, "minimap2", routes)
    install_stub_mapper(bindir, "ngmlr", {"long0.fq": long_sam})
    return {"bin": bindir, "fq": fastq, "sams": sams}


def test_write_sam_keeps_every_record(data, mapper):
    from lorikeet_tpu_torch.io.bam import BamReader
    from lorikeet_tpu_torch.io.mapping import parse_sam_stream
    with open(mapper["sams"][0]) as fh:
        refs, lengths, records, _ = parse_sam_stream(fh)
    want = list(BamReader(data["bams"][0]).fetch())
    assert refs == ["contig1"] and lengths == [40_000]
    assert len(records) == len(want) > 0
    for a, b in zip(records, want):
        assert (a.name, a.flag, a.tid, a.pos, a.mapq, a.cigar, a.mate_tid,
                a.mate_pos, a.tlen, a.tags) == (
            b.name, b.flag, b.tid, b.pos, b.mapq, b.cigar, b.mate_tid,
            b.mate_pos, b.tlen, dict(b.tags.items()))
        assert np.array_equal(a.seq, b.seq)
        assert np.array_equal(a.qual, b.qual)
    assert all(r.is_paired and r.mate_pos >= 0 for r in records)


def test_stub_mapper_fails_without_a_route(mapper):
    env = dict(os.environ, PATH=mapper["bin"] + os.pathsep
               + os.environ["PATH"])
    res = subprocess.run(["minimap2", "-a", "ref.fna", mapper["fq"][
        "unrouted"]], capture_output=True, text=True, env=env, timeout=30)
    assert res.returncode == 3 and "no route" in res.stderr
    res = subprocess.run(["minimap2", mapper["fq"][(1, "se")]],
                         capture_output=True, text=True, env=env, timeout=30)
    assert res.returncode == 0
    with open(mapper["sams"][1]) as fh:
        assert res.stdout == fh.read()


def _raw_reads(case, d, fq) -> list:
    if case == "single":
        return ["--single", fq[(0, "se")], fq[(1, "se")]]
    if case == "paired":
        return ["-1", fq[(0, "R1")], fq[(1, "R1")],
                "-2", fq[(0, "R2")], fq[(1, "R2")]]
    if case == "interleaved":
        return ["--interleaved", fq[(0, "il")], fq[(1, "il")]]
    return ["-b", *d["bams"], "--longreads", fq["long"],
            "--longread-mapper", "ngmlr-ont"]


@pytest.mark.parametrize("case", ["single", "paired", "interleaved",
                                  "longreads"])
def test_raw_reads_through_a_mapper_equal_jax(data, mapper, tmp_path,
                                              monkeypatch, case):
    monkeypatch.setenv("PATH", mapper["bin"] + os.pathsep
                       + os.environ["PATH"])
    outs = _both(tmp_path, lambda _, out: [
        "call", *_args(data), *_raw_reads(case, data, mapper["fq"]),
        "-o", out])
    _assert_same_files(outs["jax"][0], outs["torch"][0], 6)
    cached = sorted(os.listdir(os.path.join(outs["torch"][0], "bams")))
    stems = (["long0"] if case == "longreads"
             else [os.path.splitext(os.path.basename(a))[0]
                   for a in _raw_reads(case, data, mapper["fq"])[1:3]])
    assert cached == sorted(f"{s}.bam{x}" for s in stems for x in ("",
                                                                  ".bai"))
    (genome,) = outs["torch"][1]["genomes"].values()
    assert len(_body(genome["vcf"])) > 10


def test_bam_cache_directory_equals_jax(data, mapper, tmp_path,
                                        monkeypatch):
    monkeypatch.setenv("PATH", mapper["bin"] + os.pathsep
                       + os.environ["PATH"])
    outs = _both(tmp_path, lambda label, out: [
        "call", *_args(data), *_raw_reads("single", data, mapper["fq"]),
        "-o", out, "--bam-file-cache-directory",
        str(tmp_path / f"{label}_cache")])
    _assert_same_files(outs["jax"][0], outs["torch"][0], 4)
    _assert_same_files(str(tmp_path / "jax_cache"),
                       str(tmp_path / "torch_cache"), 4)
    assert not os.path.exists(os.path.join(outs["torch"][0], "bams"))


def _outcome(main, argv):
    """("exit", code) or ("raise", exception type, message)."""
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return ("exit", main(argv))
    except SystemExit as exc:
        return ("exit", exc.code)
    except Exception as exc:            # what the CLI lets escape
        return ("raise", type(exc).__name__, str(exc))


def test_failing_mapper_fails_both_alike(data, mapper, tmp_path,
                                         monkeypatch):
    monkeypatch.setenv("PATH", mapper["bin"] + os.pathsep
                       + os.environ["PATH"])
    got = {label: _outcome(main, ["call", *_args(data), "--single",
                                  mapper["fq"]["unrouted"], "-o",
                                  str(tmp_path / label)])
           for label, main in MAINS}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "raise" and got["torch"][1] == "RuntimeError"
    assert "no route" in got["torch"][2]


# ---- the output cache and --force -----------------------------------------

def _stamps(root) -> dict:
    return {n: os.stat(os.path.join(root, n)).st_mtime_ns
            for n in _files(root)}


def test_output_cache_and_force_equal_jax(data, tmp_path):
    firsts = {}
    for label, main in MAINS:
        out = str(tmp_path / label)
        argv = ["call", *_args(data), "-b", *data["bams"], "-o", out]
        first = _run(main, argv)["genomes"]
        assert not any(g.get("cached") for g in first.values())
        firsts[label] = _files(out)
        stamps = _stamps(out)
        second = _run(main, argv)["genomes"]
        assert sorted(second) == sorted(first)
        assert all(g["cached"] is True for g in second.values())
        assert _stamps(out) == stamps and _files(out) == firsts[label]
        forced = _run(main, [*argv, "--force"])["genomes"]
        assert not any(g.get("cached") for g in forced.values())
        moved = _stamps(out)
        assert all(moved[n] > stamps[n] for n in stamps), (label, moved)
        assert _files(out) == firsts[label]
    assert firsts["torch"] == firsts["jax"]


# ---- --split-bams ---------------------------------------------------------

def test_split_bams_equals_jax(data, tmp_path):
    outs = _both(tmp_path, lambda _, out: [
        "call", "--force-cpu", "-t", "1", "--split-bams", "-r",
        *data["genomes"], "-b", *data["two_bams"], "-o", out])
    _assert_same_files(outs["jax"][0], outs["torch"][0], 16)
    split = sorted(os.listdir(os.path.join(outs["torch"][0], "split_bams")))
    assert split == sorted(f"sample{s}_{g}.bam{x}" for s in range(2)
                           for g in ("gA", "gB") for x in ("", ".bai"))
    whole = _run(torch_main, ["call", "--force-cpu", "-t", "1", "-r",
                              *data["genomes"], "-b", *data["two_bams"],
                              "-o", str(tmp_path / "whole")])["genomes"]
    for name, genome in outs["torch"][1]["genomes"].items():
        assert _body(genome["vcf"]) == _body(whole[name]["vcf"]), name
        assert _body(genome["vcf"])


# ---- the chunk-shard gatherer's steal -------------------------------------

def _four_contigs(root):
    """One genome of four 10 kb contigs (four chunk units) and two
    short-read BAMs at 15x with a SNP every 1.7 kb."""
    from lorikeet_tpu_torch.io.bam_writer import write_bam
    from lorikeet_tpu_torch.testkit.simulate import Variant, simulate_reads
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(3)
    bases = np.frombuffer(b"ACGT", np.uint8)
    names = [f"ctg{i}" for i in range(4)]
    refs = [bases[rng.integers(0, 4, 10_000)] for _ in names]
    fasta = os.path.join(root, "four.fna")
    with open(fasta, "w") as fh:
        for name, ref in zip(names, refs):
            fh.write(f">{name}\n{ref.tobytes().decode()}\n")
    bams = []
    for s in range(2):
        recs = []
        for t, ref in enumerate(refs):
            variants = [Variant(p, bytes(ref[p:p + 1]), bytes(
                [b"ACGT"[(b"ACGT".index(ref[p]) + 1) % 4]]))
                for p in range(700, 9_500, 1700)]
            recs += simulate_reads(ref, variants, coverage=15.0,
                                   seed=10 * s + t, tid=t,
                                   allele_fraction=0.5,
                                   sample=f"sample{s}")
        bams.append(os.path.join(root, f"sample{s}.bam"))
        write_bam(bams[-1], names, [len(r) for r in refs],
                  sorted(recs, key=lambda r: (r.tid, r.pos)))
    return fasta, bams


#: process 1 of a chunk-shard run of one package, started alone
SHARD_WORKER = """
import importlib, json, sys
package, fasta, outdir, bams, cfg = sys.argv[1:6]
proc = importlib.import_module(package + ".processing")
engine = importlib.import_module(package + ".calling.engine")
open_bam = importlib.import_module(package + ".io.bam").open_bam
(spec,) = proc.discover_genomes([fasta])
bams = json.loads(bams)
proc.run_genome_sharded(spec, [open_bam(b) for b in bams], outdir,
                        engine.CallerConfig(**json.loads(cfg)),
                        [f"sample{i}" for i in range(len(bams))],
                        process_index=1, process_count=2)
"""


def _gather(package, fasta, bams, outdir, monkeypatch) -> tuple:
    """Process 0 of a chunk-shard run in this process: (outputs, the
    contigs of the spans it computed, in order)."""
    import importlib
    proc = importlib.import_module(f"{package}.processing")
    engine = importlib.import_module(f"{package}.calling.engine")
    open_bam = importlib.import_module(f"{package}.io.bam").open_bam
    (spec,) = proc.discover_genomes([fasta])
    computed = []
    call_span = proc._call_span

    def seen(fasta_, bams_, contig, *args, **kwargs):
        computed.append(contig)
        return call_span(fasta_, bams_, contig, *args, **kwargs)

    with monkeypatch.context() as patch:
        patch.setattr(proc, "_call_span", seen)
        out = proc.run_genome_sharded(
            spec, [open_bam(b) for b in bams], outdir,
            engine.CallerConfig(**HOST_CFG[package]),
            [f"sample{i}" for i in range(len(bams))], process_index=0,
            process_count=2)
    return out, computed


def _kill_after_first_shard(package, fasta, bams, outdir) -> list:
    """Process 1 of ``package`` alone, killed once its first shard lands;
    returns the shard files it left."""
    from test_torch_modes import _env
    os.makedirs(outdir, exist_ok=True)
    worker = subprocess.Popen(
        [sys.executable, "-c", SHARD_WORKER, package, fasta, outdir,
         json.dumps(bams), json.dumps(HOST_CFG[package])],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    deadline = time.time() + 120
    shards = []
    try:
        while not shards:
            assert worker.poll() is None, worker.communicate()[1][-3000:]
            assert time.time() < deadline, "no shard from process 1"
            time.sleep(0.01)
            shards = sorted(n for d in os.listdir(outdir)
                            if d.startswith(".shards-")
                            for n in os.listdir(os.path.join(outdir, d))
                            if n.endswith(".pkl"))
    finally:
        worker.kill()
        worker.communicate(timeout=60)
    return shards


def test_gatherer_steals_a_dead_workers_units(tmp_path, monkeypatch):
    """LORIKEET_SHARD_GRACE 0.2: with no process 1, process 0 computes the
    even units, then steals every odd one; with a process 1 killed after
    its first shard, it steals the rest.  The VCFs are the JAX package's
    and the same in both runs."""
    fasta, bams = _four_contigs(str(tmp_path / "data"))
    monkeypatch.setenv("LORIKEET_SHARD_GRACE", "0.2")
    vcfs = {}
    for label, package in PACKAGES:
        lone, computed = _gather(package, fasta, bams,
                                 str(tmp_path / f"{label}_lone"),
                                 monkeypatch)
        assert computed == ["ctg0", "ctg2", "ctg1", "ctg3"]
        killed_dir = str(tmp_path / f"{label}_killed")
        left = _kill_after_first_shard(package, fasta, bams, killed_dir)
        assert left == ["u000001.pkl"]
        killed, computed = _gather(package, fasta, bams, killed_dir,
                                   monkeypatch)
        assert computed == ["ctg0", "ctg2", "ctg3"]
        assert not any(n.startswith(".shards-")
                       for n in os.listdir(killed_dir))
        with open(lone["vcf"], "rb") as a, open(killed["vcf"], "rb") as b:
            vcfs[label] = a.read()
            assert b.read() == vcfs[label]
        assert len(_body(lone["vcf"])) >= 16
    assert vcfs["torch"] == vcfs["jax"]


# ---- man pages, completion, full help -------------------------------------

def _captured(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = main(argv)
        except SystemExit as exc:
            rc = exc.code
    assert rc == 0, argv
    return buf.getvalue()


def _entries(text: str) -> list:
    """[(flag names, text)] of a man page (roff ``.TP`` items) or an
    argparse help page (option lines and their continuations); lines
    outside an option come with no names."""
    lines, out, k = text.splitlines(), [], 0
    while k < len(lines):
        line = lines[k]
        if line == ".TP" and k + 2 < len(lines):
            names = tuple(n.replace("\\-", "-") for n in
                          re.findall(r"\\fB(.*?)\\fR", lines[k + 1]))
            out.append((names, lines[k + 2]))
            k += 3
        elif re.match(r"  -", line):
            head = re.split(r"\s{2,}", line.strip())[0]
            names = tuple(re.findall(r"(?<![\w-])(--?[\w][\w-]*)", head))
            body = [line]
            k += 1
            while k < len(lines) and re.match(r" {4,}\S", lines[k]):
                body.append(lines[k])
                k += 1
            out.append((names, "\n".join(body)))
        else:
            out.append(((), line))
            k += 1
    return out


def _card_flag_diff(want: str, got: str) -> set:
    """The flags whose entries differ between two pages, once their
    every other line is checked to be the same."""
    a, b = _entries(want), _entries(got)
    assert [n for n, _ in a] == [n for n, _ in b]
    differ = {n for (names, x), (_, y) in zip(a, b) if x != y
              for n in names or ("<text>",)}
    return differ


def test_man_pages_differ_only_in_card_flags(tmp_path):
    pages = {}
    for label, main in MAINS:
        out = tmp_path / label
        written = _captured(main, ["man", "-o", str(out)]).split()
        assert [os.path.basename(p) for p in written] == [
            f"lorikeet-tpu-{c}.1"
            for c in ("call", "consensus", "genotype", "summarise")]
        pages[label] = {os.path.basename(p): open(p).read() for p in written}
        stdout = _captured(main, ["man"])
        assert stdout == "".join(page + "\n"
                                 for page in pages[label].values())
    for name, page in pages["jax"].items():
        want = CARD_FLAGS if name != "lorikeet-tpu-summarise.1" else set()
        assert _card_flag_diff(page, pages["torch"][name]) == want, name
    call = _captured(torch_main, ["man", "call"])
    assert call == pages["torch"]["lorikeet-tpu-call.1"] + "\n"


@pytest.mark.parametrize("shell", ["bash", "zsh"])
def test_shell_completion_equals_jax(tmp_path, shell):
    scripts = {}
    for label, main in MAINS:
        path = tmp_path / f"{label}.{shell}"
        assert _captured(main, ["shell-completion", "--shell", shell, "-o",
                                str(path)]) == ""
        scripts[label] = path.read_text()
        assert _captured(main, ["shell-completion", "--shell", shell]) == \
            scripts[label] + "\n"
    assert scripts["torch"] == scripts["jax"]
    assert "--limiting-interval" in scripts["torch"]


@pytest.mark.parametrize("mode", ["call", "consensus", "genotype",
                                  "summarise"])
@pytest.mark.parametrize("flag", ["--full-help", "--full-help-roff"])
def test_full_help_differs_only_in_card_flags(mode, flag):
    pages = {label: _captured(main, [mode, flag]) for label, main in MAINS}
    want = CARD_FLAGS if mode != "summarise" else set()
    assert _card_flag_diff(pages["jax"], pages["torch"]) == want
    marker = (f"usage: lorikeet-tpu {mode}" if flag == "--full-help"
              else f'.TH "LORIKEET\\-TPU\\-{mode.upper()}"')
    assert marker in pages["torch"]
