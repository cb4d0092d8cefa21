"""The port never imports jax.

Runs in subprocesses: the test process itself imports jax (conftest.py).
Lazy imports inside functions (the JAX package has them in realign,
progress, hosts and processing) only show when the code runs, so the CLI's
`call` is run end to end and checked after the run too.
"""
import os
import pkgutil
import subprocess
import sys

import lorikeet_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(code, cwd=REPO, timeout=240):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=_env(),
                          capture_output=True, text=True, timeout=timeout)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        lorikeet_tpu_torch.__path__, "lorikeet_tpu_torch."))


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert {"lorikeet_tpu_torch.cli", "lorikeet_tpu_torch.processing",
            "lorikeet_tpu_torch.ops.pairhmm_cuda",
            "lorikeet_tpu_torch.ops.sw_cuda"} <= set(mods)
    res = _run("import importlib, sys\n"
               f"for m in {mods!r}: importlib.import_module(m)\n"
               "assert 'jax' not in sys.modules, 'jax imported'\n"
               "print('ok')")
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
               "assert 'jax' not in sys.modules, 'jax imported'\n"
               "sys.exit(rc)", cwd=str(tmp_path))
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
    assert not [m for m in imported if m.split(".")[0] == "jax"]
    assert open(tmp_path / "out2" / "ref" / "ref.vcf").read() \
        == open(vcf).read()


def test_cli_refuses_unported_device_flags(tmp_path):
    """--devices 4 is refused; --pallas-sw without a card is an error that
    names CUDA, never a silent host run."""
    for extra, rc, msg in ((["--devices", "4"], 2, "--devices"),
                           (["--pallas-sw"], 1, "CUDA")):
        env = _env()
        env["CUDA_VISIBLE_DEVICES"] = ""
        res = subprocess.run(
            [sys.executable, "-m", "lorikeet_tpu_torch.cli", "call", "-t",
             "1", "-r", "x.fna", "-b", "x.bam", "-o", str(tmp_path), *extra],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=120)
        assert res.returncode == rc and msg in res.stderr, res.stderr
