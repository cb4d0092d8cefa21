"""The CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: these need an NVIDIA card and skip without one.  On a
machine with a card run
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Pair-HMM: each read length below selects another build of the kernel:
register strips of 4, 8 and 16 rows per lane (Rpad 128, 256, 384/512) and
the global-scratch strips of longer reads.  Smith-Waterman: the kernel, its
plain version and the native aligner agree exactly, under every overhang
strategy, at ref lengths that cross the 1-, 2-, 4- and 8-rows-per-thread
builds up to the cap, and with an alt of 3000 bases.
"""
import numpy as np
import pytest
import torch

from lorikeet_tpu.ops.smith_waterman import (
    ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS, NEW_SW_PARAMETERS,
    ORIGINAL_DEFAULT, STANDARD_NGS, OverhangStrategy, align,
)
from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
from lorikeet_tpu_torch.ops import sw_cuda as sc
from lorikeet_tpu_torch.ops.pairhmm import F32_SUSPECT_LOG10

pytestmark = pytest.mark.cuda

#: kernel vs torch twin, same f32 sweep on the same card: only expf/log10f
#: and FMA contraction differ; the bound chip_smoke.py holds as well
TOL = 1e-4
BASES = np.frombuffer(b"ACGTN", np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _region(rng, read_len, n_reads=40, n_haps=4):
    hap_len = read_len + int(rng.integers(100, 300))
    ref = BASES[rng.integers(0, 4, hap_len)]
    haps = [ref] + [ref.copy() for _ in range(n_haps - 1)]
    for h in haps[1:]:
        h[rng.integers(0, hap_len, 3)] = BASES[rng.integers(0, 5, 3)]
    pairs = []
    for _ in range(n_reads):
        lo = int(rng.integers(0, hap_len - read_len + 1))
        read = ref[lo:lo + read_len].copy()
        read[rng.integers(0, read_len, 2)] = BASES[rng.integers(0, 5, 2)]
        q = rng.integers(6, 41, read_len).astype(np.uint8)
        iq = rng.integers(20, 46, read_len).astype(np.uint8)
        for h in haps:
            pairs.append((h, read, q, iq, iq, np.full(read_len, 10, np.uint8)))
    return pairs


@pytest.mark.parametrize("read_len", [100, 127, 200, 383, 500, 700, 3000])
def test_kernel_matches_plain_version(cuda, read_len):
    rng = np.random.default_rng(read_len)
    n_reads = 40 if read_len <= 700 else 2
    pairs = _region(rng, read_len, n_reads) + _region(rng, 60, 7, 2)
    arrays, out_pos = pc.pack_grouped_inputs(pairs)
    t = pc.to_tensors(arrays, cuda)
    launches = pc.LAUNCHES
    got = pc.pairhmm_grouped_cuda(t)
    torch.cuda.synchronize()
    assert pc.LAUNCHES == launches + 1
    want = pc.pairhmm_sweep_torch(t)
    pos = torch.from_numpy(out_pos).to(cuda)
    got, want = got[pos].cpu().numpy(), want[pos].cpu().numpy()
    assert np.all(np.isfinite(got))
    keep = want > F32_SUSPECT_LOG10
    assert keep.any()
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=TOL)


def test_kernel_rejects_bad_inputs(cuda):
    pairs = _region(np.random.default_rng(1), 80, 3, 2)
    arrays, _ = pc.pack_grouped_inputs(pairs)
    t = pc.to_tensors(arrays, cuda)
    t["quals"] = t["quals"].to(torch.int32)
    with pytest.raises(ValueError, match="quals"):
        pc.pairhmm_grouped_cuda(t)


def _sw_pairs(rng, ref_len, n=6, alt_len=100):
    """Reads of up to ``alt_len`` bases against one random ref, each with
    an N (so never an exact substring), a SNP and a 1-6 bp indel, and one
    read longer than the ref."""
    ref = BASES[rng.integers(0, 4, ref_len)]
    pairs = []
    for _ in range(n):
        ln = min(alt_len, ref_len)
        lo = int(rng.integers(0, ref_len - ln + 1))
        read = bytearray(ref[lo:lo + ln].tobytes())
        read[int(rng.integers(0, ln))] = ord("G")
        k = int(rng.integers(0, len(read) + 1))
        if rng.random() < 0.5:
            read[k:k] = BASES[rng.integers(0, 4, int(rng.integers(1, 7)))
                              ].tobytes()
        else:
            del read[k:k + int(rng.integers(1, 7))]
        read.insert(int(rng.integers(0, len(read) + 1)), ord("N"))
        pairs.append((ref.tobytes(), bytes(read)))
    pairs.append((ref.tobytes(), b"N" + BASES[rng.integers(
        0, 4, ref_len + 20)].tobytes()))
    return pairs


def _sw_check(cuda, pairs, params, strategy):
    t = sc.to_tensors(sc.pack_pairs(pairs), cuda)
    launches = sc.SW_LAUNCHES
    got = sc.sw_align(t, params, strategy)
    torch.cuda.synchronize()
    assert sc.SW_LAUNCHES == launches + 1
    assert got == sc.sw_align_torch(t, params, strategy)
    assert got == [align(r, a, params, strategy) for r, a in pairs]


@pytest.mark.parametrize("ref_len", [1, 127, 128, 129, 600, 1500,
                                     sc.MAX_REF_LEN])
@pytest.mark.parametrize("strategy", [
    OverhangStrategy.SOFTCLIP, OverhangStrategy.INDEL,
    OverhangStrategy.LEADING_INDEL, OverhangStrategy.IGNORE])
def test_sw_kernel_matches_plain_and_native(cuda, strategy, ref_len):
    rng = np.random.default_rng(ref_len + strategy)
    params = (ORIGINAL_DEFAULT, STANDARD_NGS, NEW_SW_PARAMETERS,
              ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS)[strategy]
    n = 2 if ref_len == sc.MAX_REF_LEN else 6
    _sw_check(cuda, _sw_pairs(rng, ref_len, n), params, strategy)


def test_sw_kernel_long_alt(cuda):
    rng = np.random.default_rng(3000)
    pairs = _sw_pairs(rng, 600, n=1) + _sw_pairs(rng, 3200, n=2,
                                                 alt_len=3000)
    _sw_check(cuda, pairs, ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS,
              OverhangStrategy.SOFTCLIP)


def test_sw_kernel_rejects_bad_inputs(cuda):
    p = ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS
    arrays = sc.pack_pairs([(b"ACGTACGT", b"ACTT")])
    t = sc.to_tensors(arrays, cuda)
    t["meta"] = t["meta"].to(torch.int32)
    with pytest.raises(ValueError, match="meta"):
        sc.sw_kernel_launch(t, p, OverhangStrategy.SOFTCLIP)
    t = sc.to_tensors(arrays, cuda)
    t["seqs"] = t["seqs"].cpu()
    with pytest.raises(ValueError, match="want cuda"):
        sc.sw_kernel_launch(t, p, OverhangStrategy.SOFTCLIP)
    t = sc.to_tensors(arrays, cuda)
    t["rows_max"] = sc.MAX_REF_LEN + 2
    with pytest.raises(ValueError, match="ref of"):
        sc.sw_kernel_launch(t, p, OverhangStrategy.SOFTCLIP)
    t = sc.to_tensors(arrays, cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sc.sw_kernel_launch(t, p, 7)                  # no such strategy
