"""Hybrid short + long-read ``call`` of the port on the CPU.

- K2's plain version (CPU devices in the cards' place) on batches of
  150-base rows beside long-read segments, at row widths that put the
  batch on the 16-row register strip (Rpad 384) and on the scratch strips
  (Rpad 640), against the benchmark's plain f64 reference
  (``portbench/reference/pairhmm.py``) within K2's 2e-3 log10;
- a 3 x 10 kbp genome of the hybrid benchmark configuration (two samples,
  each a short-read and a Nanopore-profile long-read BAM) from
  ``portbench/gen`` through ``call -t 2`` on CPU devices: every planted
  allele called and none other, four sample columns, and the counters and
  span attributes of the long-read rows (``pool.WORKER_COUNTS``,
  ``lk.pack``, ``k2.enqueue``), K2 here taking its values from the f64
  host kernel.
"""
import json
import os

import numpy as np
import pytest
import torch

from lorikeet_tpu_torch import cli
from lorikeet_tpu_torch import processing as tproc
from lorikeet_tpu_torch.ops import pairhmm_cuda
from lorikeet_tpu_torch.ops.pairhmm import pairhmm_forward_f64
from lorikeet_tpu_torch.ops.pairhmm_pack import (grouped_strip,
                                                 prepare_grouped_jobs,
                                                 row_width, useful_cells)
from lorikeet_tpu_torch.parallel import pool as tpool
from lorikeet_tpu_torch.parallel import sharding as tshard
from lorikeet_tpu_torch.utils import progress
from portbench.gen import dataset
from portbench.reference import pairhmm as reference
from portbench.reference import truth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "portbench", "configs",
                      "mag_hybrid_pe150_ont_2s30x.json")
MIX = os.path.join(ROOT, "portbench", "traffic", "strains_1pct.json")
#: K2's bar against the exact f64 kernel, log10
K2_BAR = 2e-3
#: log10 values at or below this the program recomputes in f64 itself
ESCALATED_AT = -28.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the plain versions' many small operations on long
    diagonals slow down by orders of magnitude when every test process
    of a parallel run spins up a thread a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed_batch(rng, long_lens):
    """(hap, read, q, iq, dq, gcp) pairs of one region: 3 haplotypes, 40
    short reads of 150 bases and a long read's segment of each length of
    ``long_lens``, each read copied from a haplotype with 1 % of its bases
    changed, at base quality 30 (short) or 20 (long)."""
    hap_len = max(long_lens) + 60
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), hap_len)
    haps = []
    for k in range(3):
        h = base.copy()
        at = rng.choice(hap_len, 4 * k, replace=False)
        h[at] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, at.size)]
        haps.append(h)
    reads = []
    for n, q in [(150, 30)] * 40 + [(n, 20) for n in long_lens]:
        src = haps[rng.integers(0, 3)]
        lo = int(rng.integers(0, hap_len - n + 1))
        read = src[lo:lo + n].copy()
        err = rng.random(n) < 0.01
        read[err] = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, int(err.sum()))]
        quals = np.full(n, q, np.uint8)
        reads.append((read, quals, np.full(n, 45, np.uint8),
                      np.full(n, 45, np.uint8), np.full(n, 10, np.uint8)))
    return [(h, *r) for r in reads for h in haps]


@pytest.mark.parametrize("long_lens, rpad, strip", [
    ((260, 301, 383), 384, 16),
    ((300, 512, 600), 640, 0),
], ids=["strip16", "scratch"])
def test_k2_plain_on_wide_rows(long_lens, rpad, strip):
    pairs = _mixed_batch(np.random.default_rng(rpad), long_lens)
    arrays, _ = prepare_grouped_jobs(pairs, wire=False)
    assert row_width(arrays) == rpad and grouped_strip(rpad) == strip
    assert useful_cells(arrays) == sum(len(p[0]) * len(p[1])
                                       for p in pairs)
    got = pairhmm_cuda.pairhmm_forward_grouped(pairs, torch.device("cpu"))
    want = reference.forward_log10(pairs, torch.float64)
    kept = want > ESCALATED_AT
    long = np.array([len(p[1]) > 150 for p in pairs])
    assert (kept & long).sum() >= len(long_lens)
    gap = np.abs(got - want)[kept]
    assert np.isfinite(got).all() and gap.max() <= K2_BAR, gap.max()


def test_grouped_strip_classes():
    # pairhmm_grouped_launch: K = Rpad / 32 rows a lane
    assert [grouped_strip(r) for r in (128, 256, 384, 512, 640, 1024)] == [
        4, 8, 16, 16, 0, 0]


def _exact_sweep(t: dict) -> torch.Tensor:
    """K2's values of a grouped job from the f64 host kernel, as f32: a
    stand-in for the plain sweep, which takes minutes on the CPU for a
    long-read batch (its numbers are held above)."""
    tiles, hap_of = t["tile_tab"].numpy(), t["hap_tab"].numpy()
    lens, hap_lens = t["read_lens"].numpy(), t["hap_lens"].numpy()
    planes = [t[k].numpy() for k in ("read_u8", "quals", "ins_q", "del_q",
                                     "gcp_q")]
    haps = t["haps"].numpy()
    at, pairs = [], []
    for b, (tile, h) in enumerate(zip(tiles.tolist(), hap_of.tolist())):
        hap = haps[h, :hap_lens[h]]
        for r in range(32):
            n = int(lens[tile * 32 + r])
            if n:
                at.append(b * 32 + r)
                pairs.append((hap, *(p[tile * 32 + r, 1:n + 1]
                                     for p in planes)))
    out = np.zeros(tiles.size * 32)
    out[at] = pairhmm_forward_f64(pairs)
    return torch.from_numpy(out.astype(np.float32))


@pytest.fixture(scope="module")
def hybrid_run(tmp_path_factory):
    """A 3 x 10 kbp genome of the hybrid configuration through ``call -t
    2`` on a CPU device in the card's place (K2's values from the f64 host
    kernel), spans on: (the dataset, the VCF's path, WORKER_COUNTS, the
    spans)."""
    tmp = tmp_path_factory.mktemp("hybrid")
    with open(CONFIG) as fh:
        config = {**json.load(fh), "contigs": 3, "contig_kbp": 10}
    with open(MIX) as fh:
        mix = json.load(fh)
    data = dataset.build(str(tmp / "data"), config, mix, 2 ** 35 + 18, 0)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tproc, "_pool_worthwhile", lambda *a: True)
        mp.setattr(pairhmm_cuda, "pairhmm_sweep_torch", _exact_sweep)
        mp.setattr(tshard, "visible_cards", lambda: [torch.device("cpu")])
        mp.setattr(tshard, "_DEVICES", None)
        mp.setattr(tpool, "WORKER_COUNTS",
                   dict.fromkeys(tpool.WORKER_COUNTS, 0))
        mp.setattr(progress, "GLOBAL_STAGES", {})
        mp.setattr(progress, "SPANS", None)
        out = str(tmp / "out")
        try:
            rc = cli.main(["call", "-t", "2", "--do-not-call-svs",
                           "-r", data.fasta, "-b", *data.bams,
                           "-l", *data.long_bams, "-o", out])
        finally:
            tpool.shutdown_pool()           # the workers' last spans
        counts, spans = dict(tpool.WORKER_COUNTS), progress.SPANS
    finally:
        mp.undo()
    assert rc == 0
    return data, os.path.join(out, "mag0", "mag0.vcf"), counts, spans


def test_hybrid_call_every_planted_allele(hybrid_run):
    data, vcf, _, _ = hybrid_run
    with open(vcf) as fh:
        (header,) = [line for line in fh if line.startswith("#CHROM")]
    assert header.rstrip("\n").split("\t")[9:] == [
        "sample0", "sample1", "long0", "long1"]
    # the long-read samples drawn at the short ones' mix
    got = truth.compare(vcf, data.contigs, data.truth,
                        [*data.fractions, *data.fractions])
    assert got["planted"] > 100
    assert got["missed"] == 0 and got["false"] == 0, got
    assert all(abs(b) < 0.1 for b in got["share_bias"]), got


def test_hybrid_long_read_counters(hybrid_run):
    _, _, counts, spans = hybrid_run
    assert counts["lk_batches"] == 3           # one span a contig
    assert 0 < counts["lk_long_rows"] < counts["lk_rows"]
    assert 0 < counts["lk_bases"] <= counts["lk_slots"]
    packs = [s for s in spans if s[0] == "lk.pack"]
    assert sum(s[5]["long_rows"] for s in packs) == counts["lk_long_rows"]
    assert sum(s[5]["rows"] for s in packs) == counts["lk_rows"]
    # a pack's task, the service's enqueue of that task's batch, and the
    # K2 enqueue inside it (span ids are each process's own)
    task_of = {(s[6][0], s[4]): s[5]["tid"] for s in spans
               if s[0] == "worker.task"}
    service = {s[4]: s[5]["tid"] for s in spans
               if s[0] == "service.enqueue"}
    k2 = {service[s[3]]: s[5] for s in spans if s[0] == "k2.enqueue"
          and s[3] in service}
    assert len(k2) == counts["lk_batches"]
    wide = 0
    for pack in packs:
        attrs = k2[task_of[pack[6][0], pack[3]]]
        assert attrs["strip"] == grouped_strip(pack[5]["rpad"])
        assert attrs["cells"] > 0
        # a short read fills at most 256 lanes: only a long read's
        # segment puts a batch on the wide strips
        if attrs["strip"] in (16, 0):
            assert pack[5]["rpad"] > 256 and pack[5]["long_rows"] > 0
            wide += 1
    # most of this genome's batches hold a segment of 256 bases or more
    assert 2 * wide > len(packs)
