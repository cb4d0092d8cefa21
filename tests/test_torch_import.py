"""The port never imports jax, nor anything of the JAX package.

Runs in subprocesses: the test process itself imports jax (conftest.py).
Lazy imports inside functions only show when the code runs, so the CLI's
`call` is run end to end and checked after the run too; and every source
file of the port is searched for an import line that names the JAX package.

The host modules are the port's own copies of the JAX package's (numpy,
ctypes and C++).  Each copy is held to its original here: the same code
once the package's name is put back, comments and docstrings aside.
"""
import ast
import json
import os
import pkgutil
import re
import subprocess
import sys

import pytest

import lorikeet_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(code, cwd=REPO, timeout=240):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=_env(),
                          capture_output=True, text=True, timeout=timeout)


#: run in the subprocess after the port's code: nothing of jax, of the JAX
#: package, of its benchmark script or of scikit-learn (the port clusters
#: with its own HDBSCAN) may have been imported
NO_JAX_PACKAGE = (
    "bad = [m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'lorikeet_tpu', 'bench_e2e', 'sklearn')]\n"
    "assert not bad, f'imported: {bad}'\n")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        lorikeet_tpu_torch.__path__, "lorikeet_tpu_torch."))


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert {"lorikeet_tpu_torch.cli", "lorikeet_tpu_torch.processing",
            "lorikeet_tpu_torch.ops.pairhmm_cuda",
            "lorikeet_tpu_torch.ops.sw_cuda",
            "lorikeet_tpu_torch.parallel.pipeline",
            "lorikeet_tpu_torch.parallel.dryrun",
            "lorikeet_tpu_torch.native.graph_native",
            "lorikeet_tpu_torch.testkit.dataset",
            "lorikeet_tpu_torch.entry",
            "lorikeet_tpu_torch.testkit.longreads"} <= set(mods)
    res = _run("import importlib, sys\n"
               f"for m in {mods!r}: importlib.import_module(m)\n"
               + NO_JAX_PACKAGE + "print('ok')")
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


FIXTURE = """
import sys
sys.path.insert(0, {tests!r})
from test_torch_call import simulate_fixture
fasta, bams, _ = simulate_fixture({tmp!r}, length=1500, coverage=12)
print(fasta, *bams)
"""


def test_cli_call_runs_without_jax(tmp_path):
    res = _run(FIXTURE.format(tests=os.path.join(REPO, "tests"),
                              tmp=str(tmp_path)))
    assert res.returncode == 0, res.stderr
    fasta, *bams = res.stdout.split()
    out = str(tmp_path / "out")
    args = ["call", "-t", "1", "--force-cpu", "-r", fasta, "-b", *bams,
            "-o", out]
    res = _run("import sys\n"
               "from lorikeet_tpu_torch.cli import main\n"
               f"rc = main({args!r})\n"
               + NO_JAX_PACKAGE + "sys.exit(rc)", cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    vcf = tmp_path / "out" / "ref" / "ref.vcf"
    assert any(not line.startswith("#") for line in open(vcf))
    # the module entry point, with the import log showing no jax module
    res = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "lorikeet_tpu_torch.cli",
         *args[:-1], str(tmp_path / "out2")], cwd=str(tmp_path),
        env=_env(), capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    imported = [line.rsplit("|", 1)[-1].strip()
                for line in res.stderr.splitlines()
                if line.startswith("import time:")]
    assert "lorikeet_tpu_torch.processing" in imported
    assert not [m for m in imported
                if m.split(".")[0] in ("jax", "lorikeet_tpu", "bench_e2e")]
    assert open(tmp_path / "out2" / "ref" / "ref.vcf").read() \
        == open(vcf).read()


MIXED_FIXTURE = """
import os
from lorikeet_tpu_torch.testkit.dataset import simulate_dataset
from lorikeet_tpu_torch.testkit.longreads import add_long_read_bam
fasta, bams, truth = simulate_dataset({tmp!r}, {kbp}, 2, 12.0, seed=2)
long_bam, _ = add_long_read_bam(fasta, truth,
                                os.path.join({tmp!r}, "long.bam"), 6.0,
                                seed=2)
print(fasta, long_bam, *bams)
"""


def test_cli_call_with_long_reads_runs_without_jax(tmp_path):
    """`call -b S -l L` (short and long reads mixed), then the check."""
    res = _run(MIXED_FIXTURE.format(tmp=str(tmp_path), kbp=8))
    assert res.returncode == 0, res.stderr
    fasta, long_bam, *bams = res.stdout.split()
    args = ["call", "-t", "1", "--force-cpu", "-r", fasta, "-b", *bams,
            "-l", long_bam, "-o", str(tmp_path / "out")]
    res = _run("import sys\n"
               "from lorikeet_tpu_torch.cli import main\n"
               f"rc = main({args!r})\n"
               + NO_JAX_PACKAGE + "sys.exit(rc)", cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    header = [line for line in open(tmp_path / "out" / "genome" /
                                    "genome.vcf") if line.startswith("#CHROM")]
    assert len(header[0].split("\t")) == 9 + 3


def test_chunk_shard_call_runs_without_jax(tmp_path):
    """Two processes of a chunk-shard `call` (LORIKEET_PROCESS_INDEX 0
    and 1 of 2) on a genome of two chunks; each checks its own modules
    after the run."""
    res = _run(MIXED_FIXTURE.format(tmp=str(tmp_path), kbp=90))
    assert res.returncode == 0, res.stderr
    fasta, long_bam, *bams = res.stdout.split()
    args = ["call", "-t", "1", "--force-cpu", "-r", fasta, "-b", *bams,
            "-l", long_bam, "-o", str(tmp_path / "out")]
    code = ("import sys\n"
            "from lorikeet_tpu_torch.cli import main\n"
            f"rc = main({args!r})\n"
            + NO_JAX_PACKAGE + "sys.exit(rc)")
    procs = []
    for index in (0, 1):
        env = _env()
        env.update(LORIKEET_PROCESS_INDEX=str(index),
                   LORIKEET_PROCESS_COUNT="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=str(tmp_path), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    worker = json.loads(outs[1][0].strip().splitlines()[-1])
    assert worker["outputs"]["genomes"]["genome"]["role"] == "worker"
    assert any(not line.startswith("#") for line in open(
        tmp_path / "out" / "genome" / "genome.vcf"))


GENOTYPE_FIXTURE = """
from lorikeet_tpu_torch.testkit.strains import genotype_dataset
fasta, bams, _ = genotype_dataset({tmp!r}, length=24_000, n_snps=10)
print(fasta, *bams)
"""


def test_cli_genotype_runs_without_jax_or_sklearn(tmp_path):
    """`genotype` on two strains of 10 SNPs: 20 split contexts reach
    clustering (HDBSCAN from 4), and neither scikit-learn nor jax is
    imported."""
    res = _run(GENOTYPE_FIXTURE.format(tmp=str(tmp_path)))
    assert res.returncode == 0, res.stderr
    fasta, *bams = res.stdout.split()
    out = str(tmp_path / "out")
    args = ["genotype", "-t", "1", "--force-cpu", "--qual-by-depth-filter",
            "8", "-r", fasta, "-b", *bams, "-o", out]
    res = _run("import contextlib, io, json, sys\n"
               "from lorikeet_tpu_torch.cli import main\n"
               "from lorikeet_tpu_torch.io.vcf import read_vcf\n"
               "from lorikeet_tpu_torch.strain.genotype_mode import "
               "split_contexts\n"
               "buf = io.StringIO()\n"
               "with contextlib.redirect_stdout(buf):\n"
               f"    rc = main({args!r})\n"
               "(g,) = json.loads(buf.getvalue().strip().splitlines()[-1])"
               "['outputs']['genomes'].values()\n"
               "split, _ = split_contexts(read_vcf(g['vcf'])[0], 8.0)\n"
               "print(len(split), g['n_variant_groups'])\n"
               + NO_JAX_PACKAGE + "sys.exit(rc)", cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    n_split, n_groups = map(int, res.stdout.split()[-2:])
    assert n_split >= 4 and n_groups == 2


def test_cli_refuses_unported_device_flags(tmp_path):
    """--devices 4 and --pallas-sw without a card are errors that name
    CUDA, never a silent host run (--devices N itself is ported)."""
    for extra, rc, msg in ((["--devices", "4"], 1, "CUDA"),
                           (["--pallas-sw"], 1, "CUDA")):
        env = _env()
        env["CUDA_VISIBLE_DEVICES"] = ""
        res = subprocess.run(
            [sys.executable, "-m", "lorikeet_tpu_torch.cli", "call", "-t",
             "1", "-r", "x.fna", "-b", "x.bam", "-o", str(tmp_path), *extra],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=120)
        assert res.returncode == rc and msg in res.stderr, res.stderr


def test_cli_call_without_card_is_an_error(tmp_path):
    """`call` without --force-cpu on a machine with no card exits non-zero
    and says that the card is missing: the default never runs on the host."""
    res = _run(FIXTURE.format(tests=os.path.join(REPO, "tests"),
                              tmp=str(tmp_path)))
    assert res.returncode == 0, res.stderr
    fasta, *bams = res.stdout.split()
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run(
        [sys.executable, "-m", "lorikeet_tpu_torch.cli", "call", "-t", "1",
         "-r", fasta, "-b", *bams, "-o", str(tmp_path / "out")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=240)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and "--force-cpu" in res.stderr
    assert not list(tmp_path.glob("out/*/*.vcf"))


IMPORT_LINE = re.compile(
    r"^\s*(from|import)\s+(lorikeet_tpu|jax|jaxlib|bench_e2e)(\.|\s|$)")


def test_no_source_file_imports_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.dirname(
            lorikeet_tpu_torch.__file__)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 60
    bad = []
    for path in files:
        with open(path) as fh:
            bad += [f"{os.path.relpath(path, REPO)}:{i}: {line.strip()}"
                    for i, line in enumerate(fh, 1)
                    if IMPORT_LINE.match(line)]
    assert not bad, "\n".join(bad)


PORT_DIR = os.path.dirname(lorikeet_tpu_torch.__file__)
ORIGINAL_DIR = os.path.join(REPO, "lorikeet_tpu")
#: files of the same name whose code differs on purpose: the torch
#: counterparts of the JAX modules, the loader that builds into build/, the
#: modules of which the port keeps only the part without jax, and the strain
#: layer's clustering, which imports the port's HDBSCAN for scikit-learn's;
#: and the assembly's graph and the CIGAR helpers, split so that a span
#: computes its regions' haplotype CIGARs together
#: (tests/test_torch_hap_cigar.py holds their outputs to the originals')
NOT_COPIES = {
    "cli.py", "processing.py", "ops/pairhmm.py", "calling/engine.py",
    "calling/likelihoods.py", "calling/realign.py", "parallel/hosts.py",
    "parallel/pipeline.py", "parallel/pool.py", "parallel/sharding.py",
    "native/__init__.py", "utils/progress.py", "strain/genotype_mode.py",
    "assembly/graph.py", "utils/cigar.py",
}


def _shared_files():
    found = []
    for root, dirs, names in os.walk(PORT_DIR):
        dirs[:] = [d for d in dirs if d not in ("build", "__pycache__")]
        for name in names:
            rel = os.path.relpath(os.path.join(root, name), PORT_DIR)
            if name.endswith((".py", ".cpp")) and os.path.exists(
                    os.path.join(ORIGINAL_DIR, rel)):
                found.append(rel.replace(os.sep, "/"))
    return sorted(found)


def _python_code(path, rename, swaps=(), transform=None):
    """The file's syntax tree without docstrings (comments never reach
    it), as text; each of ``swaps`` (old, new) replaces one piece of text
    after the rename, and ``transform`` (an ast.NodeTransformer) rewrites
    the tree."""
    with open(path) as fh:
        text = fh.read()
    if rename:
        text = text.replace("lorikeet_tpu_torch", "lorikeet_tpu")
    for old, new in swaps:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    tree = ast.parse(text)
    if transform is not None:
        tree = transform.visit(tree)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and body \
                and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def _cpp_code(path):
    """The file's tokens between white space, comments removed."""
    with open(path) as fh:
        text = fh.read()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text).split()


def test_the_copies_are_the_files_expected():
    shared = _shared_files()
    assert NOT_COPIES <= set(shared)
    copies = set(shared) - NOT_COPIES
    assert len(copies) >= 55
    assert {"native/pairhmm.cpp", "native/sw.cpp", "io/bai.py",
            "models/af_calc.py", "strain/umap.py", "assembly/seq_graph.py",
            "testkit/simulate.py"} <= copies


@pytest.mark.parametrize("rel", [f for f in _shared_files()
                                 if f not in NOT_COPIES])
def test_copied_host_module_equals_its_original(rel):
    mine = os.path.join(PORT_DIR, rel)
    theirs = os.path.join(ORIGINAL_DIR, rel)
    if rel.endswith(".py"):
        assert _python_code(mine, True) == _python_code(theirs, False)
    else:
        assert _cpp_code(mine) == _cpp_code(theirs)


def _called(node, names) -> bool:
    """Whether ``node`` is a call of a function named one of ``names``."""
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    return getattr(func, "id", getattr(func, "attr", None)) in names


class _Uninstrumented(ast.NodeTransformer):
    """A tree without the port's spans: each ``with global_stage(...)``
    replaced by its body, the calls of ``add_span`` and the clock reads
    they are handed left out, and the imports of those names and of
    ``time``."""

    NAMES = {"global_stage", "add_span"}

    def visit_With(self, node):
        self.generic_visit(node)
        if all(_called(i.context_expr, {"global_stage"})
               for i in node.items):
            return node.body
        return node

    def visit_Expr(self, node):
        return None if _called(node.value, {"add_span"}) else node

    def visit_Assign(self, node):
        return None if _called(node.value, {"perf_counter_ns"}) else node

    def visit_ImportFrom(self, node):
        node.names = [a for a in node.names if a.name not in self.NAMES]
        return node if node.names else None

    def visit_Import(self, node):
        node.names = [a for a in node.names if a.name != "time"]
        return node if node.names else None


#: the port's departures from strain/genotype_mode.py, put into the
#: original: (1) a qualifying multi-allelic site none of whose alleles is
#: kept goes to ``filtered`` whole (the original dropped it from the
#: genotype-mode VCF); (2) the separation's scale is the spread a sample;
#: (3) the read linkage matches each indel's extended alt
#: (strain/link_alleles.py); (4) the outputs count the split contexts and
#: those clustered
GENOTYPE_DEPARTURES = [
    ("""            continue
        for ai, alt in enumerate(alts, start=1):""",
     """            continue
        n_split = len(out)
        for ai, alt in enumerate(alts, start=1):"""),
    ("""            out.append(split)
    return out, filtered""",
     """            out.append(split)
        if len(out) == n_split:
            filtered.append(vc)
    return out, filtered"""),
    ("scale = max(float(np.mean(spreads)), 1e-9)",
     "scale = max(float(np.mean(spreads)) / np.sqrt(X.shape[1]), 1e-9)"),
    ("""    from lorikeet_tpu.strain.linkage import LinkageEngine
""",
     """    from lorikeet_tpu.strain.link_alleles import linkage_contexts
    from lorikeet_tpu.strain.linkage import LinkageEngine
"""),
    ("engine = LinkageEngine(grouped, separations)",
     "engine = LinkageEngine(linkage_contexts(grouped, fasta, "
     "vcf_contigs or contig_names), separations)"),
    ("""outputs = {"n_variant_groups": len(groups)}""",
     """outputs = {"n_variant_groups": len(groups), "n_contexts": len(split),
               "n_clustered": int((labels != -1).sum())}""")]


def test_genotype_mode_differs_from_its_original_only_in_hdbscan():
    """strain/genotype_mode.py is its original's code with one import
    changed, the port's HDBSCAN for scikit-learn's, once the strain
    layer's spans are taken out, and with the port's departures
    (GENOTYPE_DEPARTURES) put into the original."""
    rel = "strain/genotype_mode.py"
    port_import = "from lorikeet_tpu.strain.hdbscan import HDBSCAN"
    port = os.path.join(PORT_DIR, rel)
    original = os.path.join(ORIGINAL_DIR, rel)
    assert _python_code(port, True, transform=_Uninstrumented()) \
        != _python_code(original, False, swaps=GENOTYPE_DEPARTURES)
    assert _python_code(port, True) \
        != _python_code(port, True, transform=_Uninstrumented())
    assert _python_code(port, True, swaps=[
        (port_import, "from sklearn.cluster import HDBSCAN")],
        transform=_Uninstrumented()) \
        == _python_code(original, False, swaps=GENOTYPE_DEPARTURES)
