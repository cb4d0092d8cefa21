"""A span's haplotype CIGARs with their SW on the card's Smith-Waterman
kernel (K3), on the card.

Marked ``cuda``: these need an NVIDIA card and skip without one.  On a
machine with a card run
``python -m pytest --noconftest -m cuda tests/test_torch_hap_sw_cuda.py``.
K3 on the N-padded window/haplotype pairs of calculate_cigar, under
NEW_SW_PARAMETERS and SOFTCLIP, through the path the pool's workers take
(``sw_cuda.align_batch_rows``, the kernel's output cut to its CIGARs and
decoded on the host), is bit-identical to the native aligner, warp and
CTA forms; and a pooled ``call -t 8`` whose workers send their spans'
haplotype SW to the device service writes the VCF of the same run with
that SW on the workers' hosts.
"""
import json
import os

import numpy as np
import pytest
import torch

from lorikeet_tpu_torch import cli
from lorikeet_tpu_torch import processing as tproc
from lorikeet_tpu_torch.ops import sw_cuda as sc
from lorikeet_tpu_torch.ops.smith_waterman import (
    NEW_SW_PARAMETERS, OverhangStrategy, align,
)
from lorikeet_tpu_torch.parallel import pool as tpool
from lorikeet_tpu_torch.utils.cigar import (
    calculate_cigar, calculate_cigars, sw_padded,
)
from portbench.gen import dataset

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _haplotypes(rng, n_windows=40):
    """(window, haplotype) pairs as an active region's assembly gives
    them: windows of 150-560 bases, each with SNP, deletion and insertion
    haplotypes, one far longer than its window (the CTA form) and one
    that runs past the window's end (an SW failure)."""
    pairs = []
    for w in range(n_windows):
        ref = BASES[rng.integers(0, 4, int(rng.integers(150, 561)))]
        for edits in (1, 2, 3, 6):
            alt = ref
            for at in sorted(rng.choice(np.arange(10, ref.size - 10), edits,
                                        replace=False))[::-1]:
                n = int(rng.integers(1, 7))
                alt = (np.concatenate([alt[:at], alt[at + n:]])
                       if rng.random() < 0.5 else
                       np.concatenate([alt[:at], BASES[rng.integers(0, 4, n)],
                                       alt[at:]]))
            pairs.append((ref, alt))
        if w % 10 == 0:
            pairs.append((ref, np.concatenate(
                [ref[:100], BASES[rng.integers(0, 4, 500)], ref[100:]])))
            pairs.append((ref, np.concatenate(
                [ref, BASES[rng.integers(0, 4, 300)]])))
    return pairs


def _on_card(device):
    def run(padded, parameters, strategy):
        results, aligned = sc.align_batch_rows(
            padded, parameters, strategy,
            sc.chunk_runner(device, parameters, strategy))
        assert aligned == len(padded)
        return results
    return run


def test_k3_on_padded_haplotype_pairs_equals_native(cuda):
    pairs = _haplotypes(np.random.default_rng(19))
    padded = [(sw_padded(r), sw_padded(a)) for r, a in pairs]
    forms = {str(sc.sw_form(r.size, a.size)) for r, a in padded}
    assert forms == {"warp", "cta"}
    launches = dict(sc.SW_FORM_LAUNCHES)
    got = _on_card(cuda)(padded, NEW_SW_PARAMETERS,
                         OverhangStrategy.SOFTCLIP)
    assert {k: sc.SW_FORM_LAUNCHES[k] - launches[k] for k in launches} \
        == {"warp": 1, "cta": 1}
    assert got == [align(r, a, NEW_SW_PARAMETERS, OverhangStrategy.SOFTCLIP)
                   for r, a in padded]
    cigars, n = calculate_cigars(pairs, _on_card(cuda))
    assert n == len(pairs)
    want = [calculate_cigar(r, a) for r, a in pairs]
    assert cigars == want and None in want


def _call(data, out, threads=8):
    assert cli.main(["call", "-t", str(threads), "-r", data.fasta, "-b",
                     *data.bams, "-o", out]) == 0
    with open(os.path.join(out, "mag0", "mag0.vcf"), "rb") as fh:
        # the header's own lines name the run's paths
        return b"".join(line for line in fh if not line.startswith(b"##"))


def test_pooled_call_vcf_equals_host_path(cuda, tmp_path, monkeypatch):
    with open(os.path.join(ROOT, "portbench", "configs",
                           "mag_short_pe150_2s30x.json")) as fh:
        config = {**json.load(fh), "contigs": 8, "contig_kbp": 10}
    with open(os.path.join(ROOT, "portbench", "traffic",
                           "strains_1pct.json")) as fh:
        mix = json.load(fh)
    data = dataset.build(str(tmp_path / "data"), config, mix, 2 ** 34 + 7, 0)
    monkeypatch.setattr(tproc, "_pool_worthwhile", lambda *a: True)
    monkeypatch.setattr(tpool, "WORKER_COUNTS",
                        dict.fromkeys(tpool.WORKER_COUNTS, 0))
    try:
        card = _call(data, str(tmp_path / "card"))
        counts = dict(tpool.WORKER_COUNTS)
        tpool.shutdown_pool()
        monkeypatch.setattr(tproc, "_hap_sw_device", lambda cfg: None)
        tpool.WORKER_COUNTS.update(dict.fromkeys(tpool.WORKER_COUNTS, 0))
        host = _call(data, str(tmp_path / "host"))
        host_counts = dict(tpool.WORKER_COUNTS)
    finally:
        tpool.shutdown_pool()
    assert card == host and card.count(b"\n") > 100
    assert counts["hsw_batches"] == 8 and host_counts["hsw_batches"] == 0
    assert counts["hap_sw_card"] == counts["hap_sw"] > 0
    assert host_counts["hap_sw_card"] == 0
    assert host_counts["hap_sw"] == counts["hap_sw"]
