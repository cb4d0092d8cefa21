"""Dangling-end recovery inside the native graph builder
(``native/graph_recover.cpp``), held to the Python path it replaces.

In every case the graph the builder recovers and zips in C++
(``ReadThreadingGraph.build`` with ``allow_zip``) equals what the Python
path makes of the same pruned kmer graph: ``recover_dangling_ends``, then
``has_cycle``, ``remove_paths_not_connected_to_ref`` and
``SeqGraph.from_kmer_graph`` -- the same vertex sequences, the same edges
with multiplicity and ref flag, in the same order -- and the same verdict
where recovery makes the graph cyclic.  Cases:

- the regions of contigs of the benchmark's dense strain mix
  (``portbench/gen``), several seeds, and of its hybrid configuration
  (reads of 5-15 kbp beside the short ones), each region at two kmer
  sizes, pruned and not, under four sets of the recovery's knobs; and
  ``assemble_candidates`` on them with and without the native
  libraries;
- the reference suite's dangling tail and head vectors (as
  ``tests/test_dangling_vectors.py`` holds them on the JAX package);
- random graphs whose heads need the head extension's split, under
  min_matching_bases -1 and >= 0, recover_all on and off;
- graphs that turn cyclic only after recovery;
- the counters, and the kmer-graph path kept for adaptive pruning and
  for more pruning samples than the builder keeps inline.
"""
import json
import os
from collections import Counter

import numpy as np
import pytest

from lorikeet_tpu_torch.assembly import graph as tgraph
from lorikeet_tpu_torch.assembly.graph import (ReadThreadingGraph,
                                               assemble_candidates,
                                               region_pending)
from lorikeet_tpu_torch.assembly.seq_graph import SeqGraph
from lorikeet_tpu_torch.calling import engine as tengine
from lorikeet_tpu_torch.calling.engine import (CallerConfig,
                                               HaplotypeCallerEngine)
from lorikeet_tpu_torch.io.bam import BamRecord, open_bam
from lorikeet_tpu_torch.io.fasta import FastaReader
from lorikeet_tpu_torch.native import graph_native, graph_recover_native
from lorikeet_tpu_torch import processing as tproc
from portbench.gen import dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIX = os.path.join(ROOT, "portbench", "traffic", "strains_1pct.json")
BASES = np.frombuffer(b"ACGT", np.uint8)
#: (min_dangling_branch_length, min_matching_bases, recover_all)
KNOBS = [(1, -1, False), (1, 1, False), (2, 0, True), (1, -1, True)]
#: (configuration, contig kbp, seed) of the captured regions
DATA = [("mag_short_pe150_2s30x", 3, 2 ** 33 + 19),
        ("mag_short_pe150_2s30x", 3, 3141900401),
        ("mag_short_pe150_2s30x", 3, 2 ** 40 + 5),
        ("mag_hybrid_pe150_ont_2s30x", 4, 3141900402)]


def _dump(sg):
    """Vertices in order, each with its sequence and its out-edges in
    order: (target, multiplicity, ref flag)."""
    return [(sg.seqs[u], [(v, e.multiplicity, e.is_ref)
                          for v, e in sg.out_edges[u].items()])
            for u in sg.seqs]


def _python(pending, k, nps, prune, knobs):
    """(verdict, seq graph) of the Python path, the edges recovery added
    and the vertices its head extension made."""
    g = ReadThreadingGraph(k, nps, start_only_at_existing=False)
    g.pending = list(pending)
    g.build(prune_factor=prune, allow_zip=False)
    assert g.native_zip is None
    if g.ref_source is None:
        return ("no reference", None), 0, 0
    if g.cycle_checked:
        return ("cyclic", None), 0, 0
    n = len(g.vertices)
    recovered = g.recover_dangling_ends(*knobs)
    made = len(g.vertices) - n
    if recovered and g.has_cycle():
        return ("cyclic after recovery", None), recovered, made
    g.remove_paths_not_connected_to_ref()
    return ("zipped", _dump(SeqGraph.from_kmer_graph(g))), recovered, made


def _native(pending, k, nps, prune, knobs):
    g = ReadThreadingGraph(k, nps, start_only_at_existing=False)
    g.pending = list(pending)
    min_len, min_matching, recover_all = knobs
    g.build(prune_factor=prune, allow_zip=True, recovery_on=True,
            min_dangling_branch_length=min_len,
            min_matching_bases=min_matching, recover_all=recover_all)
    # nothing left C++ as kmer-graph objects
    assert not g.vertices and not g.out_edges
    if g.ref_source is None:
        return "no reference", None
    if g.cycle_checked:
        return "cyclic", None
    if g.recovered_cyclic:
        return "cyclic after recovery", None
    return "zipped", _dump(SeqGraph.from_native_zip(*g.native_zip))


def _compare(pending, k, prune, knobs, tally, nps=2):
    want, recovered, made = _python(pending, k, nps, prune, knobs)
    assert _native(pending, k, nps, prune, knobs) == want, (k, prune, knobs)
    tally[want[0]] += 1
    tally["recovered"] += recovered > 0
    tally["split"] += made > 0


# ---- the regions of the benchmark's generated contigs ----------------------

_REGIONS = {}


def _regions(data, tmp_path_factory, monkeypatch):
    """The regions one contig's span assembles, as the engine calls
    assemble_candidates: [(window, reads by sample, keywords)]."""
    if data in _REGIONS:
        return _REGIONS[data]
    name, kbp, seed = data
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) \
            as fh:
        config = {**json.load(fh), "contigs": 1, "contig_kbp": kbp}
    with open(MIX) as fh:
        mix = {**json.load(fh), "margin": [300, 300]}
    d = dataset.build(str(tmp_path_factory.mktemp("recover")), config, mix,
                      seed, 0)
    regions = []
    real = tengine.assemble_candidates

    def seen(window, reads_by_sample, **kw):
        regions.append((window, reads_by_sample, kw))
        return real(window, reads_by_sample, **kw)
    monkeypatch.setattr(tengine, "assemble_candidates", seen)
    monkeypatch.setattr(tproc, "_hap_sw_device", lambda cfg: None)
    fasta = FastaReader(d.fasta)
    bams = [open_bam(p) for p in d.bams + d.long_bams]
    cfg = CallerConfig()
    cfg.read_types = ["short"] * len(d.bams) + ["long"] * len(d.long_bams)
    (contig,) = d.contigs
    tproc._call_span(fasta, bams, contig, cfg, HaplotypeCallerEngine(cfg),
                     0, fasta.length(contig), defer=True)
    monkeypatch.undo()
    assert len(regions) > 5
    _REGIONS[data] = regions
    return regions


@pytest.mark.parametrize("data", DATA, ids=lambda d: f"{d[0]}-{d[2]}")
def test_generated_regions_recover_as_python(data, tmp_path_factory,
                                             monkeypatch):
    tally = Counter()
    for window, reads, kw in _regions(data, tmp_path_factory, monkeypatch):
        pending = region_pending(np.asarray(window, np.uint8).tobytes(),
                                 reads, kw.get("min_base_quality", 10))
        for k in (21, 33):
            for prune in (0, 2):
                for knobs in KNOBS:
                    _compare(pending, k, prune, knobs, tally)
    assert tally["zipped"] > 50 and tally["recovered"] > 20, tally


@pytest.mark.parametrize("data", DATA, ids=lambda d: f"{d[0]}-{d[2]}")
def test_assemble_candidates_with_and_without_the_library(
        data, tmp_path_factory, monkeypatch):
    """The candidates of every region, and the counters: every graph that
    reaches the seq-graph step zipped in C++; without the recovering
    library (the kmer graph handed over, recovered in Python), and without
    any native library (threaded in Python too), none, and the same
    candidates."""
    regions = _regions(data, tmp_path_factory, monkeypatch)
    tgraph.take_asm_counts()
    native = [assemble_candidates(w, r, **kw) for w, r, kw in regions]
    counts = tgraph.take_asm_counts()
    assert counts["asm_native_zip"] == counts["asm_graphs"] > len(regions)
    for lib in (graph_recover_native, graph_native):
        monkeypatch.setattr(lib, "_lib", None)
        monkeypatch.setattr(lib, "_failed", True)
        assert [assemble_candidates(w, r, **kw)
                for w, r, kw in regions] == native
        assert tgraph.take_asm_counts() == {
            "asm_graphs": counts["asm_graphs"], "asm_native_zip": 0}


# ---- the reference suite's dangling-end vectors ----------------------------

COMMON_PREFIX = b"AAAAAAAAAACCCCCCCCCCGGGGGGGGGGTTTTTTTTTT"
# (ref_end, alt_end, merges, min_matching_bases) at kmer 15
# (read_threading_graph_unit_tests.rs make_dangling_tails_data)
TAIL_CASES = [
    (b"AAAAAAAAAA", b"CAAA", True, -1),            # incomplete haplotype
    (b"AAAAAAAAAA", b"CAAAAAAAAAA", True, -1),     # insertion
    (b"CCAAAAAAAAAA", b"AAAAAAAAAA", True, -1),    # deletion
    (b"AAAAAAAA", b"CAAAAAAA", True, -1),          # 1 snp
    (b"AAAAAAAA", b"CAAGATAA", True, -1),          # several snps
    (b"AAAAAAAA", b"CAAGATAA", True, 0),
    (b"AAAAAAAA", b"CAAGATAA", True, 1),
    (b"AAAAAAAA", b"CAAGATAA", True, 2),
    (b"AAAAAAAA", b"CAAGATAA", False, 3),          # not enough matches
    (b"AAAAAAAA", b"CAAGATAA", False, 4),
    (b"AAAAA", b"C", False, -1),                   # funky SW alignment
    (b"AAAAAAA", b"CAAAAAC", False, -1),           # ends in mismatch
    (b"AAAAA", b"YYYYY", False, -1),               # all mismatch
]
# (reference, alternate, merges, min_matching_bases) at kmer 5
# (make_dangling_heads_data)
HEAD_CASES = [
    (b"XXXXXXXAACCGGTTACGT", b"AAYCGGTTACGT", True, -1),   # 1 snp
    (b"XXXXXXXAACCGGTTACGT", b"AAYCGGTTACGT", True, 0),
    (b"XXXXXXXAACCGGTTACGT", b"AAYCGGTTACGT", True, 1),
    (b"XXXXXXXAACCGGTTACGT", b"AAYCGGTTACGT", True, 2),
    (b"XXXXXXXAACCGGTTACGT", b"AAYCGGTTACGT", False, 3),
    (b"YYYYYYYAACCGGTTACGT", b"AYYCGGTTACGT", False, -1),  # 2 snps legacy
    (b"YYYYYYYAACCGGTTACGT", b"AYYCGGTTACGT", True, 1),    # 2 snps new
    (b"YYYYYYYAACCGGTTACGT", b"AYCGGTTACGT", True, -1),    # little data
    (b"YYYYYYYAACCGGTTACGT", b"YCCGGTTACGT", True, -1),    # begins mismatch
]


def _vector(reference, alternate, k, min_matching, merges):
    pending = [("ref", reference, 1, True, 0),
               ("alt", alternate, 1, False, 0)]
    knobs = (1, min_matching, False)
    want, recovered, _ = _python(pending, k, 1, 0, knobs)
    assert (recovered > 0) == merges
    assert _native(pending, k, 1, 0, knobs) == want


@pytest.mark.parametrize("ref_end,alt_end,merges,min_matching", TAIL_CASES)
def test_dangling_tail_vectors(ref_end, alt_end, merges, min_matching):
    _vector(COMMON_PREFIX + ref_end, COMMON_PREFIX + alt_end, 15,
            min_matching, merges)


@pytest.mark.parametrize("reference,alternate,merges,min_matching",
                         HEAD_CASES)
def test_dangling_head_vectors(reference, alternate, merges, min_matching):
    _vector(reference, alternate, 5, min_matching, merges)


# ---- random graphs: heads split, tails, both knobs -------------------------

def _mutate(rng, ref, n):
    alt = ref.copy()
    for _ in range(n):
        p = int(rng.integers(10, alt.size - 10))
        r = rng.random()
        if r < 0.6:
            alt[p] = BASES[(np.flatnonzero(BASES == alt[p])[0] + 1) % 4]
        elif r < 0.8:
            alt = np.concatenate([alt[:p], alt[p + int(rng.integers(1, 5)):]])
        else:
            alt = np.concatenate([alt[:p], rng.choice(BASES, 3), alt[p:]])
    return alt


def _random_pending(seed):
    """A reference, a tandem copy of a stretch of it and two mutated
    strains, read at random offsets with 1% errors by two samples."""
    rng = np.random.default_rng(seed)
    ref = rng.choice(BASES, int(rng.integers(150, 300)))
    unit = ref[50:50 + int(rng.integers(8, 20))]
    sources = [ref, np.concatenate([ref[:50], unit, unit, ref[50:]]),
               _mutate(rng, ref, 3), _mutate(rng, ref, 5)]
    pending = [("ref", ref.tobytes(), 1, True, 0)]
    reads = []
    for i in range(int(rng.integers(20, 90))):
        src = sources[int(rng.integers(0, len(sources)))]
        n = int(rng.integers(30, 90))
        lo = int(rng.integers(0, src.size - n))
        read = src[lo:lo + n].copy()
        err = rng.random(n) < 0.01
        read[err] = rng.choice(BASES, int(err.sum()))
        reads.append((f"r{i}", read.tobytes(), 1, False, i % 2))
    return pending + sorted(reads, key=lambda t: t[4])


@pytest.mark.parametrize("knobs", KNOBS + [(3, 2, False), (1, 0, True)],
                         ids=str)
def test_random_graphs_recover_as_python(knobs):
    tally = Counter()
    for seed in range(25):
        pending = _random_pending(1000 + seed)
        for k in (7, 11, 15, 21):
            for prune in (0, 2):
                _compare(pending, k, prune, knobs, tally)
    assert tally["recovered"] > 50 and tally["split"] > 10, tally


def _low_complexity_pending(seed):
    """A reference over 2-4 letters and reads of it and of random
    sequence that starts with a piece of it: small kmers make cycles."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 90))
    alphabet = BASES[:int(rng.integers(2, 5))]
    ref = alphabet[rng.integers(0, alphabet.size, n)]
    pending = [("ref", ref.tobytes(), 1, True, 0)]
    for i in range(int(rng.integers(3, 12))):
        m = int(rng.integers(15, 40))
        if rng.random() < 0.5:
            read = alphabet[rng.integers(0, alphabet.size, m)]
            lo = int(rng.integers(0, n - 10))
            if lo + 8 <= n:
                read[:8] = ref[lo:lo + 8]
        else:
            lo = int(rng.integers(0, n - m))
            read = ref[lo:lo + m].copy()
            err = rng.random(m) < 0.1
            read[err] = alphabet[rng.integers(0, alphabet.size,
                                              int(err.sum()))]
        pending.append((f"r{i}", read.tobytes(), 1, False, 0))
    return pending


@pytest.mark.parametrize("seed,k,knobs", [
    (50026, 7, (1, 1, True)), (50064, 5, (1, -1, True)),
    (50108, 6, (1, 1, True))])
def test_cyclic_only_after_recovery(seed, k, knobs):
    pending = _low_complexity_pending(seed)
    g = ReadThreadingGraph(k, 1, start_only_at_existing=False)
    g.pending = list(pending)
    g.build(prune_factor=0, allow_zip=False)
    assert not g.cycle_checked
    want, recovered, _ = _python(pending, k, 1, 0, knobs)
    assert want == ("cyclic after recovery", None) and recovered
    assert _native(pending, k, 1, 0, knobs) == want
    # and under the other knobs, whatever they make of it
    tally = Counter()
    for other in KNOBS:
        _compare(pending, k, 0, other, tally, nps=1)


# ---- what stays on the kmer-graph path -------------------------------------

def _reads(pending):
    return {0: [BamRecord(name=name, flag=0, tid=0, pos=0, mapq=60,
                          cigar=[("M", len(seq))],
                          seq=np.frombuffer(seq, np.uint8).copy(),
                          qual=np.full(len(seq), 30, np.uint8))
                for name, seq, _, is_ref, _ in pending if not is_ref]}


def test_adaptive_pruning_keeps_the_kmer_graph():
    pending = _random_pending(1003)
    window = np.frombuffer(pending[0][1], np.uint8)
    tgraph.take_asm_counts()
    default = assemble_candidates(window, _reads(pending))
    counts = tgraph.take_asm_counts()
    assert counts["asm_native_zip"] == counts["asm_graphs"] > 0
    assert default[1]
    adaptive = assemble_candidates(window, _reads(pending),
                                   use_adaptive_pruning=True)
    counts = tgraph.take_asm_counts()
    assert counts["asm_native_zip"] == 0 < counts["asm_graphs"]
    assert adaptive[1]


def test_many_pruning_samples_build_in_python():
    """More pruning samples than the builder keeps inline: the graph is
    threaded in Python, as the Python path's oracle."""
    pending = _random_pending(1004)
    g = ReadThreadingGraph(21, 9, start_only_at_existing=False)
    g.pending = list(pending)
    g.build(prune_factor=2, allow_zip=True)
    assert g.native_zip is None and g.vertices and not g.native_pruned
    assert graph_recover_native.build_graph_recover(
        pending, 21, 9, 2, False) is None
