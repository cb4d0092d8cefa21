"""A span's haplotype CIGARs with their SW as one batch
(``processing._span_hap_cigars``), on the CPU.

- On a dense contig of the benchmark's strain mix (``portbench/gen``), the
  span-batched path through the SW kernel's plain version
  (``sw_cuda.SW_DEVICE`` "cpu", ``_hap_sw_device`` giving the CPU) gives,
  region by region, the haplotypes, CIGARs, scores, kmer sizes and order
  of the host path, and both those of the JAX package's span;
- a pair whose padded alternate passes 511 bases (the kernel's CTA form)
  and a span with no pair past the trivial cases (no request sent);
- a pooled ``call -t 2`` whose workers send their spans' haplotype SW to
  the device service (``"hsw"`` in the worker's segment): the VCF of the
  host path, and the counters ``hap_cigars``, ``hap_sw``, ``hap_sw_card``,
  ``asm_graphs`` and ``asm_native_zip``.
"""
import json
import os

import numpy as np
import pytest
import torch

from lorikeet_tpu import processing as jproc
from lorikeet_tpu.calling.engine import CallerConfig as JaxConfig
from lorikeet_tpu.calling.engine import HaplotypeCallerEngine as JaxEngine
from lorikeet_tpu.io.bam import open_bam as jax_open_bam
from lorikeet_tpu.io.fasta import FastaReader as JaxFasta
from lorikeet_tpu.utils.cigar import calculate_cigar as jax_calculate_cigar
from lorikeet_tpu_torch import cli
from lorikeet_tpu_torch import processing as tproc
from lorikeet_tpu_torch.calling.engine import (CallerConfig,
                                               HaplotypeCallerEngine,
                                               RegionDraft)
from lorikeet_tpu_torch.io.bam import open_bam
from lorikeet_tpu_torch.io.fasta import FastaReader
from lorikeet_tpu_torch.ops import pairhmm_cuda, sw_cuda
from lorikeet_tpu_torch.parallel import pool as tpool
from lorikeet_tpu_torch.parallel import sharding as tshard
from lorikeet_tpu_torch.utils.cigar import calculate_cigar, calculate_cigars
from portbench.gen import dataset
from test_torch_hybrid import _exact_sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "portbench", "configs",
                      "mag_short_pe150_2s30x.json")
MIX = os.path.join(ROOT, "portbench", "traffic", "strains_1pct.json")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the plain version's many small operations slow
    down when every test process of a parallel run takes a thread a
    core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """Two dense contigs of 3 kbp: a variant every 50-150 bases from 300
    bases in to 300 from the end."""
    with open(CONFIG) as fh:
        config = {**json.load(fh), "contigs": 2, "contig_kbp": 3}
    with open(MIX) as fh:
        mix = {**json.load(fh), "margin": [300, 300]}
    return dataset.build(str(tmp_path_factory.mktemp("dense")), config,
                         mix, 2 ** 33 + 19, 0)


def _works(data, contig, device, monkeypatch):
    """The RegionWorks of ``contig``'s one span, its haplotype SW on
    ``device`` (None: the native host aligner), and the counts."""
    monkeypatch.setattr(tproc, "_hap_sw_device", lambda cfg: device)
    monkeypatch.setattr(tproc, "HAP_COUNTS",
                        dict.fromkeys(tproc.HAP_COUNTS, 0))
    fasta = FastaReader(data.fasta)
    bams = [open_bam(p) for p in data.bams]
    cfg = CallerConfig()
    n = fasta.length(contig)
    _, works = tproc._call_span(fasta, bams, contig, cfg,
                                HaplotypeCallerEngine(cfg), 0, n,
                                defer=True)
    return works, dict(tproc.HAP_COUNTS)


def _jax_works(data, contig):
    fasta = JaxFasta(data.fasta)
    bams = [jax_open_bam(p) for p in data.bams]
    cfg = JaxConfig()
    n = fasta.length(contig)
    _, works = jproc._call_span(fasta, bams, contig, cfg, JaxEngine(cfg),
                                0, n, defer=True)
    return works


def _haps(works):
    return [(w.window_start, w.active_start, w.active_end,
             [(h.bases, h.cigar, h.score, h.is_ref, h.kmer_size)
              for h in w.haplotypes]) for w in works]


def _pairs(works):
    return [[tuple(x.tobytes() if isinstance(x, np.ndarray) else x
                   for x in p) for p in w.pairs] for w in works]


@pytest.mark.parametrize("contig", ["mag0_c0", "mag0_c1"])
def test_span_batch_equals_host_path(dense, contig, monkeypatch):
    monkeypatch.setattr(sw_cuda, "SW_DEVICE", "cpu")
    host, host_n = _works(dense, contig, None, monkeypatch)
    batched, n = _works(dense, contig, CPU, monkeypatch)
    assert len(host) > 5
    assert _haps(batched) == _haps(host)
    assert _pairs(batched) == _pairs(host)
    assert n["hap_cigars"] == host_n["hap_cigars"] > n["hap_sw"] > 0
    assert n["hap_sw"] == host_n["hap_sw"] == n["hap_sw_card"]
    assert host_n["hap_sw_card"] == 0
    # the JAX package's span: one calculate_cigar a haplotype
    assert _haps(batched) == _haps(_jax_works(dense, contig))


def _pair(rng, n, edits):
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
    alt = ref.copy()
    for at in sorted(rng.choice(np.arange(20, n - 20), edits, False))[::-1]:
        alt = np.concatenate([alt[:at], alt[at + int(rng.integers(1, 4)):]]) \
            if rng.random() < 0.5 else np.concatenate(
                [alt[:at], rng.choice(np.frombuffer(b"ACGT", np.uint8), 2),
                 alt[at:]])
    return ref, alt


def _plain(padded, parameters, strategy):
    results, aligned = sw_cuda.align_batch_rows(
        padded, parameters, strategy,
        sw_cuda.chunk_runner(CPU, parameters, strategy))
    assert aligned == len(padded)
    return results


def test_long_alternate_takes_the_cta_form():
    rng = np.random.default_rng(7)
    pairs = [_pair(rng, 560, 3), _pair(rng, 120, 2), _pair(rng, 505, 4)]
    forms = [sw_cuda.sw_form(r.size + 20, a.size + 20) for r, a in pairs]
    assert forms[0] == "cta" and forms[1] == "warp"
    got, n = calculate_cigars(pairs, _plain)
    assert n == 3
    assert got == [calculate_cigar(r, a) for r, a in pairs]
    assert got == [jax_calculate_cigar(r, a) for r, a in pairs]
    assert all(c is not None for c in got)


def test_span_without_pairs_sends_no_request(monkeypatch):
    """A span whose candidates all take calculate_cigar's trivial cases
    (SNPs of the window's length), and a span with no region: the worker's
    hook never sends."""
    sent = []
    monkeypatch.setattr(tproc, "DEVICE_HAP_SW",
                        lambda *a: sent.append(a) or ([], 0))
    monkeypatch.setattr(tproc, "HAP_COUNTS",
                        dict.fromkeys(tproc.HAP_COUNTS, 0))
    window = np.frombuffer(b"ACGTTGCAAC" * 8, np.uint8)
    snp = bytearray(window.tobytes())
    snp[30] = ord("T") if snp[30] != ord("T") else ord("A")
    draft = RegionDraft(window, 0, 10, 60, 0, {}, None, window.tobytes(),
                        [(1.0, bytes(snp), 25)])
    assert tproc._span_hap_cigars(CallerConfig(), [draft]) == [
        [[("M", window.size)]]]
    assert tproc._span_hap_cigars(CallerConfig(), []) == []
    assert sent == []
    assert tproc.HAP_COUNTS == {"hap_cigars": 1, "hap_sw": 0,
                                "hap_sw_card": 0}
    # the worker's end: no chunk, no request
    assert sw_cuda.align_batch_rows(
        [], None, 0, lambda c: sent.append(c)) == ([], 0)
    assert sent == []


def _pooled_call(data, out, device, monkeypatch):
    # the service's K2 takes its values from the f64 host kernel: K2's
    # plain version is slow on the CPU (the service is a thread of this
    # process, so the stand-in reaches it)
    monkeypatch.setattr(pairhmm_cuda, "pairhmm_sweep_torch", _exact_sweep)
    monkeypatch.setattr(tproc, "_pool_worthwhile", lambda *a: True)
    monkeypatch.setattr(tproc, "_hap_sw_device", lambda cfg: device)
    monkeypatch.setattr(tshard, "visible_cards", lambda: [CPU])
    monkeypatch.setattr(tshard, "_DEVICES", None)
    monkeypatch.setattr(tpool, "WORKER_COUNTS",
                        dict.fromkeys(tpool.WORKER_COUNTS, 0))
    try:
        assert cli.main(["call", "-t", "2", "-r", data.fasta, "-b",
                         *data.bams, "-o", out]) == 0
    finally:
        tpool.shutdown_pool()
    with open(os.path.join(out, "mag0", "mag0.vcf")) as fh:
        body = [line for line in fh if not line.startswith("##")]
    return body, dict(tpool.WORKER_COUNTS)


def test_pooled_call_sends_each_span_one_batch(dense, tmp_path, monkeypatch):
    host, host_n = _pooled_call(dense, str(tmp_path / "host"), None,
                                monkeypatch)
    card, n = _pooled_call(dense, str(tmp_path / "card"), CPU, monkeypatch)
    assert card == host and len(host) > 20
    assert n["hsw_batches"] == 2 and host_n["hsw_batches"] == 0
    assert n["hap_cigars"] == host_n["hap_cigars"] > n["hap_sw"] > 0
    assert n["hap_sw"] == host_n["hap_sw"] == n["hap_sw_card"]
    assert host_n["hap_sw_card"] == 0
    # every graph the workers took to the seq-graph step zipped in C++
    assert n["asm_native_zip"] == n["asm_graphs"] == host_n["asm_graphs"] > 0


# ---- the split modules against their JAX originals -------------------------

def _cigar_cases(rng):
    """(ref, alt) pairs of every kind calculate_cigar meets: trivial (an
    empty alternate, equal lengths with 0-2 mismatches), SNPs past two,
    indels, an alternate clipped at an end (an SW failure) and a wholly
    different one."""
    out = []
    for n in (40, 150, 300, 520):
        ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
        out.append((ref, ref[:0]))
        for k in (0, 1, 2, 4):
            alt = ref.copy()
            at = rng.choice(n, k, replace=False)
            alt[at] = (alt[at] - ord("A") + 1) % 26 + ord("A")
            out.append((ref, alt))
        out.extend((ref, _edit(rng, ref, e)) for e in (1, 2, 5))
        out.append((ref, ref[n // 3:]))
        # 600 bases past the window's end: the SW clips them (a failure)
        out.append((ref, np.concatenate([ref, rng.choice(
            np.frombuffer(b"ACGT", np.uint8), 600)])))
        out.append((ref, rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                    n // 2)))
    return out


def _edit(rng, ref, edits):
    alt = ref
    for at in sorted(rng.choice(np.arange(10, ref.size - 10), edits,
                                False))[::-1]:
        if rng.random() < 0.5:
            alt = np.concatenate([alt[:at], alt[at + int(rng.integers(1, 6)):]])
        else:
            alt = np.concatenate([alt[:at], rng.choice(
                np.frombuffer(b"ACGT", np.uint8), int(rng.integers(1, 6))),
                alt[at:]])
    return alt


@pytest.mark.parametrize("seed", range(4))
def test_calculate_cigar_equals_original(seed):
    pairs = _cigar_cases(np.random.default_rng(seed))
    want = [jax_calculate_cigar(r, a) for r, a in pairs]
    assert any(w is None for w in want)
    assert [calculate_cigar(r, a) for r, a in pairs] == want
    got, n = calculate_cigars(pairs)
    assert got == want and 0 < n < len(pairs)
    assert calculate_cigars(pairs, _plain) == (want, n)
    # equal pairs share one alignment
    got, m = calculate_cigars(pairs + pairs)
    assert got == want + want and m == n


def _reads(rng, haps, read_len=100, depth=12):
    from lorikeet_tpu_torch.io.bam import BamRecord
    out = []
    for h, hap in enumerate(haps):
        for k in range(depth * hap.size // read_len):
            s = int(rng.integers(0, hap.size - read_len + 1))
            out.append(BamRecord(
                name=f"h{h}r{k}", flag=0, tid=0, pos=s, mapq=60,
                cigar=[("M", read_len)], seq=hap[s:s + read_len].copy(),
                qual=np.full(read_len, 30, np.uint8)))
    return out


#: portbench/gen seeds of a dense contig (the benchmark's strain mix)
DENSE_SEEDS = (3141900401, 2 ** 33 + 7, 2 ** 41 + 3)


def _dense_regions(seed, root, monkeypatch):
    """The regions the port's span of one dense 3 kbp contig of ``seed``
    assembles: [(window, reads by sample, assemble_candidates'
    keywords)]."""
    from lorikeet_tpu_torch.calling import engine as tengine
    with open(CONFIG) as fh:
        config = {**json.load(fh), "contigs": 1, "contig_kbp": 3}
    with open(MIX) as fh:
        mix = {**json.load(fh), "margin": [300, 300]}
    data = dataset.build(root, config, mix, seed, 0)
    regions = []
    real = tengine.assemble_candidates

    def seen(window, reads_by_sample, **kw):
        regions.append((window, reads_by_sample, kw))
        return real(window, reads_by_sample, **kw)
    monkeypatch.setattr(tengine, "assemble_candidates", seen)
    _works(data, "mag0_c0", None, monkeypatch)
    monkeypatch.undo()
    return regions


def _jax_reads(reads):
    from lorikeet_tpu.io.bam import BamRecord as JaxRecord
    return [JaxRecord(name=r.name, flag=r.flag, tid=r.tid, pos=r.pos,
                      mapq=r.mapq, cigar=r.cigar, seq=r.seq, qual=r.qual,
                      sample_index=r.sample_index) for r in reads]


@pytest.mark.parametrize("seed", [*range(4), *DENSE_SEEDS])
def test_assemble_region_equals_original(seed, tmp_path, monkeypatch):
    """The split assemble_region (assemble_candidates, the CIGARs in one
    batch, haplotypes_from_candidates) gives the original's haplotypes:
    seeds 0-3 on a window with two alternates of SNPs and indels, the
    DENSE_SEEDS on every region of a dense contig of the benchmark's
    generator, with the engine's keywords."""
    from lorikeet_tpu.assembly.graph import (
        assemble_region as jax_assemble_region)
    from lorikeet_tpu_torch.assembly.graph import (
        assemble_candidates, haplotypes_from_candidates)
    if seed in DENSE_SEEDS:
        regions = _dense_regions(seed, str(tmp_path), monkeypatch)
        assert len(regions) > 5
    else:
        rng = np.random.default_rng(100 + seed)
        ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), 360)
        haps = [ref, _edit(rng, ref, 3), _edit(rng, ref, 4)]
        regions = [(ref, {0: _reads(rng, haps)}, {})]
    for window, reads, kw in regions:
        want = [(h.bases, h.cigar, h.score, h.is_ref, h.kmer_size)
                for h in jax_assemble_region(
                    window, {s: _jax_reads(r) for s, r in reads.items()},
                    **kw)]
        assert len(want) >= (1 if seed in DENSE_SEEDS else 3)
        ref_bytes, cands = assemble_candidates(window, reads, **kw)
        pairs = [(window, np.frombuffer(b, np.uint8)) for _, b, _ in cands]
        for align_batch in (None, _plain):
            cigars, _ = calculate_cigars(pairs, align_batch)
            assert [(h.bases, h.cigar, h.score, h.is_ref, h.kmer_size)
                    for h in haplotypes_from_candidates(
                        ref_bytes, cands, cigars)] == want
