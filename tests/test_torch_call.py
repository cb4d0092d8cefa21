"""The port's `call` slice against the JAX package, on the CPU.

A simulated 3 kbp x 2 samples x 20x fixture with SNPs and 1-6 bp indels:
- the exact f64 host path writes a byte-identical VCF through both packages;
- the device path (the port's kernel twin on the CPU, the JAX package's
  Pallas kernel in interpret mode) calls the same sites, alleles and
  genotypes with QUAL within 0.1 (docs/benchmarks.md:292-298), and every
  pair-HMM batch went to the device path;
- the batched realignment SW (its plain version on the CPU) leaves the
  f64 VCF byte-identical.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import lorikeet_tpu.calling.engine as jengine
import lorikeet_tpu.calling.likelihoods as jlk
from lorikeet_tpu.io.bam_writer import write_bam
from lorikeet_tpu.parallel.sharding import set_mesh
from lorikeet_tpu.processing import run_call as jax_run_call
from lorikeet_tpu.testkit.simulate import Variant, simulate_reads
import lorikeet_tpu_torch.calling.engine as tengine
import lorikeet_tpu_torch.calling.likelihoods as tlk
import lorikeet_tpu_torch.processing as tproc
from lorikeet_tpu_torch.parallel import pool as tpool
from lorikeet_tpu_torch.parallel import sharding as tshard

QUAL_TOL = 0.1
RENAMED = {"use_pallas": "use_cuda", "use_pallas_sw": "use_cuda_sw"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version's tensors here are small: several test workers
    each running torch's default thread pool only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_cards(monkeypatch, n=1) -> list:
    """``n`` CPU devices in the place of the visible cards: a run's
    ``--devices`` picks from them, and until one configures, the device
    list is the first (the kernels' plain versions run on them)."""
    cards = [torch.device("cpu")] * n
    monkeypatch.setattr(tshard, "visible_cards", lambda: cards)
    monkeypatch.setattr(tshard, "_DEVICES", None)
    return cards


def simulate_fixture(tmp, length=3000, coverage=20, seed=3,
                     error_rate=0.001):
    """FASTA + one BAM per sample, with a SNP or 1-6 bp indel every
    250-450 bp and base errors at ``error_rate``; deterministic in
    ``seed``."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    ref = bases[rng.integers(0, 4, length)].copy()
    variants = []
    pos = 300
    while pos < length - 300:
        r = rng.random()
        if r < 0.6:
            alt = b"ACGT"[(b"ACGT".index(ref[pos]) + 1) % 4]
            variants.append(Variant(pos, bytes(ref[pos:pos + 1]),
                                    bytes([alt])))
        elif r < 0.8:
            n = int(rng.integers(1, 7))
            variants.append(Variant(pos, bytes(ref[pos:pos + n + 1]),
                                    bytes(ref[pos:pos + 1])))
        else:
            n = int(rng.integers(1, 7))
            ins = bytes(bases[rng.integers(0, 4, n)])
            variants.append(Variant(pos, bytes(ref[pos:pos + 1]),
                                    bytes(ref[pos:pos + 1]) + ins))
        pos += int(rng.integers(250, 450))
    fasta = os.path.join(tmp, "ref.fna")
    with open(fasta, "w") as fh:
        fh.write(">c0\n" + ref.tobytes().decode() + "\n")
    bams = []
    for s in range(2):
        recs = simulate_reads(ref, variants, coverage=coverage,
                              read_length=100, seed=11 + s,
                              allele_fraction=0.5, sample=f"s{s}",
                              error_rate=error_rate)
        recs.sort(key=lambda r: r.pos)
        bam = os.path.join(tmp, f"s{s}.bam")
        write_bam(bam, ["c0"], [length], recs)
        bams.append(bam)
    return fasta, bams, variants


@pytest.fixture(scope="module")
def fixture3k(tmp_path_factory):
    return simulate_fixture(str(tmp_path_factory.mktemp("call3k")))


def _sites(vcf):
    out = []
    for line in open(vcf):
        if line.startswith("#"):
            continue
        f = line.rstrip("\n").split("\t")
        out.append(((f[1], f[3], f[4]) + tuple(s.split(":")[0]
                                                for s in f[9:]),
                    float(f[5])))
    return out


def test_f64_path_vcf_byte_identical(fixture3k, tmp_path):
    fasta, bams, truth = fixture3k
    vj = jax_run_call(fasta, bams, str(tmp_path / "jax"),
                      jengine.CallerConfig(use_pallas=False))
    vt = tproc.run_call(fasta, bams, str(tmp_path / "torch"),
                        tengine.CallerConfig(use_cuda=False))
    with open(vj, "rb") as a, open(vt, "rb") as b:
        assert a.read() == b.read()
    assert len(_sites(vt)) >= len(truth) - 1


def test_device_path_matches_jax_interpret(fixture3k, tmp_path, monkeypatch):
    fasta, bams, _ = fixture3k
    monkeypatch.setattr(jlk, "PALLAS_INTERPRET", True)
    cpu_cards(monkeypatch)
    cfg = jengine.CallerConfig(use_pallas=True)
    cfg.devices = 1
    try:
        vj = jax_run_call(fasta, bams, str(tmp_path / "jax"), cfg)
    finally:
        set_mesh(None)
    before = dict(tlk.DISPATCH_COUNTS)
    vt = tproc.run_call(fasta, bams, str(tmp_path / "torch"),
                        tengine.CallerConfig(use_cuda=True))
    assert tlk.DISPATCH_COUNTS["device"] > before["device"]
    assert tlk.DISPATCH_COUNTS["host"] == before["host"]
    sj, st = _sites(vj), _sites(vt)
    assert [k for k, _ in sj] == [k for k, _ in st] and sj
    for (_, qj), (_, qt) in zip(sj, st):
        assert abs(qj - qt) <= QUAL_TOL


def _nondefault_reference_config():
    cfg = jengine.CallerConfig(use_pallas=True, use_pallas_sw=True)
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, bool):
            setattr(cfg, f.name, not v)
        elif isinstance(v, int):
            setattr(cfg, f.name, v + 3)
        elif isinstance(v, float):
            setattr(cfg, f.name, v * 0.5 + 0.25)
        elif isinstance(v, str):
            setattr(cfg, f.name, v + "_x")
    cfg.kmer_sizes = (17, 25)
    cfg.read_types = ["short", "long"]
    cfg.devices = "auto"
    cfg.high_memory = True
    return cfg


def test_config_from_reference_round_trip():
    ref = _nondefault_reference_config()
    port = tengine.CallerConfig.from_reference(ref)
    assert isinstance(port, tengine.CallerConfig)
    for name, value in vars(ref).items():
        assert getattr(port, RENAMED.get(name, name)) == value, name
    back = jengine.CallerConfig(**{
        {v: k for k, v in RENAMED.items()}.get(f.name, f.name):
        getattr(port, f.name) for f in dataclasses.fields(port)})
    assert dataclasses.asdict(back) == dataclasses.asdict(ref)
    assert port.devices == "auto" and port.high_memory is True


def test_config_field_set_parity():
    ref = [f.name for f in dataclasses.fields(jengine.CallerConfig)]
    port = [f.name for f in dataclasses.fields(tengine.CallerConfig)]
    assert [RENAMED.get(n, n) for n in ref] == port
    defaults = jengine.CallerConfig()
    mine = tengine.CallerConfig()
    for n in ref:
        assert getattr(mine, RENAMED.get(n, n)) == getattr(defaults, n), n


def test_start_engine_rejects_threads_up_front(fixture3k, tmp_path,
                                              monkeypatch):
    """-t 2 with the device activity chain is no longer refused: the pool
    workers send each span's chain to the parent's service ("act"), which
    runs it on the run's device (the CPU here, under use_cuda False), and
    the VCF is the -t 1 one.  The workers import no torch."""
    fasta, bams, _ = fixture3k
    monkeypatch.setenv("LORIKEET_DEVICE_ACTIVITY", "1")
    monkeypatch.setattr(tproc, "_pool_worthwhile", lambda *a: True)
    monkeypatch.setattr(tpool, "WORKER_COUNTS",
                        dict.fromkeys(tpool.WORKER_COUNTS, 0))
    monkeypatch.setattr(tpool, "WORKER_REPORTS", {})
    out = {}
    try:
        for t in (1, 2):
            res = tproc.start_engine(
                "call", [fasta], bams, str(tmp_path / f"t{t}"),
                tengine.CallerConfig(use_cuda=False, threads=t))
            (out[t],) = [r["vcf"] for r in res.values()]
    finally:
        tpool.shutdown_pool()
    with open(out[1], "rb") as a, open(out[2], "rb") as b:
        assert a.read() == b.read()
    assert tpool.WORKER_COUNTS["act_spans"] > 0
    reports = list(tpool.WORKER_REPORTS.values())
    assert reports and not any(r["torch_imported"] for r in reports)


def test_start_engine_threads_8_writes_the_t1_vcf(fixture3k, tmp_path):
    """The CLI's default -t 8 is accepted and writes the -t 1 VCF."""
    fasta, bams, _ = fixture3k
    out = {}
    for t in (1, 8):
        res = tproc.start_engine(
            "call", [fasta], bams, str(tmp_path / f"t{t}"),
            tengine.CallerConfig(use_cuda=False, threads=t))
        (out[t],) = [r["vcf"] for r in res.values()]
    with open(out[1], "rb") as a, open(out[8], "rb") as b:
        assert a.read() == b.read()


def test_configure_devices(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tshard, "_DEVICES", None)
    # use_cuda=None means the card: no card is an error, never the host
    cfg = tengine.CallerConfig()
    assert not tproc._cpu_only_backend(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tproc._configure_devices(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlk.compute_pair_likelihoods([object()], None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tproc._configure_devices(tengine.CallerConfig(use_cuda=True))
    cpu = [torch.device("cpu")]
    host = tengine.CallerConfig(use_cuda=False)
    tproc._configure_devices(host)
    assert host.use_cuda is False and tproc._cpu_only_backend(host)
    assert tshard.get_devices() == cpu and host.device_activity is False
    # the tests' switch: the plain version through the same path
    cpu_cards(monkeypatch)
    cfg = tengine.CallerConfig()
    tproc._configure_devices(cfg)
    assert cfg.use_cuda is True and not tproc._cpu_only_backend(cfg)
    # one device, and CPU devices are no cards: the host chain
    assert tshard.get_devices() == cpu and cfg.device_activity is False
    monkeypatch.setenv("LORIKEET_DEVICE_ACTIVITY", "1")
    assert tproc._device_activity(cfg, cpu) is True
    assert tproc._activity_devices(cfg) == cpu
    assert tproc._activity_devices(host) == cpu
    monkeypatch.setenv("LORIKEET_DEVICE_ACTIVITY", "0")
    assert tproc._device_activity(cfg, cpu) is False


def test_device_activity_vcf_matches_jax(fixture3k, tmp_path, monkeypatch):
    """The slice: `call` with the device activity chain (f32 torch ops, on
    the CPU here) and the exact f64 pair-HMM writes the records the JAX
    package writes under the same variable (its jitted chain on the CPU
    backend), as tests/test_mesh_pipeline.py compares them."""
    fasta, bams, truth = fixture3k
    monkeypatch.setenv("LORIKEET_DEVICE_ACTIVITY", "1")
    from lorikeet_tpu_torch.parallel import pipeline
    calls = []
    real = pipeline.smoothed_activity_device
    monkeypatch.setattr(
        pipeline, "smoothed_activity_device",
        lambda *a, **k: calls.append(k["devices"]) or real(*a, **k))
    vj = jax_run_call(fasta, bams, str(tmp_path / "jax"),
                      jengine.CallerConfig(use_pallas=False))
    vt = tproc.run_call(fasta, bams, str(tmp_path / "torch"),
                        tengine.CallerConfig(use_cuda=False))
    assert calls and all(d == [torch.device("cpu")] for d in calls)
    bj = [ln for ln in open(vj) if not ln.startswith("##")]
    bt = [ln for ln in open(vt) if not ln.startswith("##")]
    assert bj == bt
    assert len(_sites(vt)) >= len(truth) - 1


def test_device_sw_vcf_byte_identical(tmp_path, monkeypatch):
    """The slice: `call` with the batched SW (its plain version on the CPU)
    and the exact f64 pair-HMM writes the JAX package's native-SW VCF byte
    for byte.  Base errors at 0.01 send enough reads to the SW."""
    from lorikeet_tpu_torch.ops import sw_cuda
    fasta, bams, _ = simulate_fixture(str(tmp_path), error_rate=0.01)
    monkeypatch.setattr(sw_cuda, "SW_DEVICE", "cpu")
    monkeypatch.setattr(sw_cuda, "SW_COUNTS",
                        dict.fromkeys(sw_cuda.SW_COUNTS, 0))
    vj = jax_run_call(fasta, bams, str(tmp_path / "jax"),
                      jengine.CallerConfig(use_pallas=False))
    vt = tproc.run_call(fasta, bams, str(tmp_path / "torch"),
                        tengine.CallerConfig(use_cuda=False, use_cuda_sw=True))
    with open(vj, "rb") as a, open(vt, "rb") as b:
        assert a.read() == b.read()
    assert sw_cuda.SW_COUNTS["device"] >= 20
    assert sw_cuda.SW_COUNTS["shortcut"] > 0


def test_distributed_context(monkeypatch):
    from lorikeet_tpu_torch.parallel.hosts import distributed_context
    monkeypatch.delenv("LORIKEET_PROCESS_COUNT", raising=False)
    assert distributed_context() == (0, 1)
    monkeypatch.setenv("LORIKEET_PROCESS_INDEX", "2")
    monkeypatch.setenv("LORIKEET_PROCESS_COUNT", "3")
    assert distributed_context() == (2, 3)


def test_maybe_profile_writes_trace(tmp_path):
    import torch
    from lorikeet_tpu_torch.utils.progress import maybe_profile
    with maybe_profile(str(tmp_path / "prof")):
        torch.ones(8).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    with maybe_profile(None):
        pass
