"""The checks of the long-read samples (``share_gap_long``,
``lk_gap_long``) and the readers of the long-read counters and span
attributes (``k2.wide_strip_pct``, ``likelihoods.row_fill_pct``): on
synthetic answers and records with the value worked out by hand, inf or
nothing where there is nothing to read, and on a tiny hybrid run on the
CPU, where the program comes out correct and each check's fault (the first
long-read sample's AD swapped; the plain reference in bfloat16 in K2's
place) does not."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import control, control_long
from portbench.lib import cells, correct, harness
from portbench.reference import pairhmm
from portbench.tests import tiny
from portbench.tests.test_metrics import read, record  # noqa: F401
from portbench.tests.test_span_metrics import _span

HYBRID = "hybrid_strains_dense"
#: K2 rows a batch the tiny run samples for the check of its likelihoods
TINY_ROWS = 256


def check(name):
    return correct.reader(name, cells.HERE)


def _job(tmp_path, columns):
    """A job whose VCF calls the 10 planted SNPs of one contig (strain 1,
    at shares 0.3 and 0.7) with AD ``columns`` [(ref, alt)] a sample."""
    rng = np.random.default_rng(3)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 2000)]
    truth, lines = [], []
    for k in range(10):
        pos = 100 + 150 * k
        ref = bytes(seq[pos:pos + 1])
        alt = b"ACGT"[(b"ACGT".index(ref) + 1) % 4:][:1]
        truth.append(("c0", pos, ref, alt, 1))
        lines.append("\t".join(
            ["c0", str(pos + 1), ".", ref.decode(), alt.decode(), "50",
             "PASS", ".", "GT:AD"]
            + [f"0/1:{r},{a}" for r, a in columns]))
    path = tmp_path / "job.vcf"
    names = [f"s{k}" for k in range(len(columns))]
    path.write_text("\n".join(
        ["##fileformat=VCFv4.2",
         "\t".join(["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER",
                    "INFO", "FORMAT", *names]), *lines]) + "\n")
    data = SimpleNamespace(contigs={"c0": seq}, truth=truth,
                           fractions=[[0.3], [0.7]])
    return {"vcf": str(path), "data": data}


def test_share_gap_long(tmp_path):
    # shares 0.3, 0.7 (short) and 0.25, 0.75 (long): gaps 0.05 and 0.05
    job = _job(tmp_path, [(70, 30), (30, 70), (15, 5), (5, 15)])
    got = check("share_gap_long")({"jobs": [job]})
    assert got == pytest.approx(0.05, abs=1e-12)
    # the short samples' gap is share_gap's alone
    assert check("share_gap")({"jobs": [job]}) == pytest.approx(0.0,
                                                                abs=1e-12)


def test_share_gap_long_fault(tmp_path):
    job = _job(tmp_path, [(70, 30), (30, 70), (14, 6), (6, 14)])
    lines = open(job["vcf"]).read().split("\n")
    swapped = control_long.reads_swapped_in(2)(lines)
    # the first long sample's AD turned round, the others as they were
    (row,) = [line for line in swapped if line.startswith("c0\t101\t")]
    assert row.split("\t")[9:] == ["0/1:70,30", "0/1:30,70", "0/1:6,14",
                                   "0/1:6,14"]
    open(job["vcf"], "w").write("\n".join(swapped))
    assert check("share_gap_long")({"jobs": [job]}) == pytest.approx(0.4)


def test_share_gap_long_without_long_samples(tmp_path):
    job = _job(tmp_path, [(70, 30), (30, 70)])
    assert check("share_gap_long")({"jobs": [job]}) == float("inf")
    assert check("share_gap_long")({"jobs": []}) == float("inf")


def _pairs(rng, lens):
    """(hap, read, q, iq, dq, gcp) of reads of ``lens`` bases copied from a
    400-base haplotype."""
    hap = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 400)]
    out = []
    for n in lens:
        lo = int(rng.integers(0, 400 - n))
        out.append((hap, hap[lo:lo + n].copy(), np.full(n, 20, np.uint8),
                    np.full(n, 45, np.uint8), np.full(n, 45, np.uint8),
                    np.full(n, 10, np.uint8)))
    return out


class _Watch:
    """A K2Watch's samples and reader, its values the reference's plus
    ``off``."""

    def __init__(self, batches, off):
        self.samples, self._values = [], {}
        for k, (pairs, delta) in enumerate(zip(batches, off)):
            shares = [k]
            want = pairhmm.forward_log10(pairs, torch.float64)
            self._values[id(shares)] = want + delta
            self.samples.append((pairs, np.arange(len(pairs)), shares))

    def values(self, shares, pick):
        return self._values[id(shares)][pick]


def test_lk_gap_long():
    rng = np.random.default_rng(5)
    batches = [_pairs(rng, [100, 150, 300]), _pairs(rng, [150, 151, 120])]
    watch = _Watch(batches, [np.array([0.5, 0.5, 1e-4]),
                             np.array([0.5, 3e-4, 0.5])])
    answers = {"k2": watch, "device": torch.device("cpu")}
    assert check("lk_gap_long")(answers) == pytest.approx(3e-4, rel=1e-6)
    # every sampled row: the short rows' gaps too
    assert check("lk_gap")({"k2": watch, "device": torch.device("cpu")}) \
        == pytest.approx(0.5, rel=1e-6)
    # the plain reference in bfloat16 in K2's place
    bf16 = control.Control(watch, torch.bfloat16, torch.device("cpu"))
    assert check("lk_gap_long")({"k2": bf16, "device": torch.device(
        "cpu")}) > 2e-3


def test_lk_gap_long_without_long_rows():
    rng = np.random.default_rng(6)
    watch = _Watch([_pairs(rng, [100, 150])], [np.zeros(2)])
    answers = {"k2": watch, "device": torch.device("cpu")}
    assert check("lk_gap_long")(answers) == float("inf")
    assert check("lk_gap_long")({"k2": _Watch([], []),
                                 "device": torch.device("cpu")}) \
        == float("inf")


def test_wide_strip_pct(record):  # noqa: F811
    # a program whose K2 spans carry no strip
    record["spans"] = [_span("k2.enqueue", 0.0, 1.0)]
    assert read("k2.wide_strip_pct", record) is None
    record["spans"] = [_span("k2.enqueue", 0.0, 1.0, strip=8, cells=300),
                       _span("k2.enqueue", 1.0, 2.0, strip=16, cells=500),
                       _span("k2.enqueue", 2.0, 3.0, strip=0, cells=200),
                       _span("k2.readback", 3.0, 4.0)]
    assert read("k2.wide_strip_pct", record) == 70.0
    record["spans"] = [_span("k2.enqueue", 0.0, 1.0, strip=4, cells=300)]
    assert read("k2.wide_strip_pct", record) == 0.0


def test_row_fill_pct(record):  # noqa: F811
    # a program without the counters (the record's "lk" batches alone)
    assert read("likelihoods.row_fill_pct", record) is None
    record["worker_counts"].update(lk_slots=2000, lk_bases=500)
    assert read("likelihoods.row_fill_pct", record) == 25.0
    record["worker_counts"].update(lk_slots=0, lk_bases=0)
    assert read("likelihoods.row_fill_pct", record) is None


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory):
    """(the cell's limits, a tiny run's result, control_long.py's readings
    of it).  At the tiny size a long read's segments are about 3 % of
    K2's rows, against about 16 % at 10 kbp contigs, so the run samples
    TINY_ROWS rows a batch where the cell's own runs sample
    ``harness.ROWS_A_BATCH``."""
    root = tiny.tree(str(tmp_path_factory.mktemp("hybrid")))
    cell = cells.load(HYBRID, root)
    kept = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(harness, "ROWS_A_BATCH", TINY_ROWS)
    try:
        out = tiny.run(root, HYBRID, keep=lambda a: kept.update(
            control_long.long_readings(cell, a)))
    finally:
        mp.undo()
    return cell.limits["checks"], out, kept


def test_tiny_hybrid_run(hybrid):
    limits, out, kept = hybrid
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(limits)
    assert not kept["control"]["correct"]
    assert kept["control"]["checks"]["lk_gap_long"] > limits["lk_gap_long"]
    fault = kept["faults"]["long_reads_swapped"]
    assert not fault["correct"]
    assert fault["checks"]["share_gap_long"] > limits["share_gap_long"]
    # the short samples' numbers are left as they were
    assert fault["checks"]["share_gap"] == out["checks"]["share_gap"][
        "value"]
