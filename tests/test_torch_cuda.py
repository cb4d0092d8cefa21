"""The CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: these need an NVIDIA card and skip without one.  On a
machine with a card run
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Pair-HMM: each read length below selects another build of the kernel:
register strips of 4, 8 and 16 rows per lane (Rpad 128, 256, 384/512) and
the global-scratch strips of longer reads; the flat kernel (one warp per
pair) runs the same builds, with haplotype slices for 4, 2 and 1 warps per
CTA and in global scratch.  Smith-Waterman: the kernel, its
plain version and the native aligner agree exactly, under every overhang
strategy, at ref lengths that cross the 1-, 2-, 4- and 8-rows-per-thread
builds up to the cap, and with an alt of 3000 bases.
"""
import numpy as np
import pytest
import torch

from lorikeet_tpu_torch.ops.smith_waterman import (
    ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS, NEW_SW_PARAMETERS,
    ORIGINAL_DEFAULT, STANDARD_NGS, OverhangStrategy, align,
)
from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
from lorikeet_tpu_torch.ops import sw_cuda as sc
from lorikeet_tpu_torch.ops.pairhmm import (
    F32_SUSPECT_LOG10, pack_pairhmm_batch,
)

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


def _flat_pair(rng, read_len, hap_len):
    hap = BASES[rng.integers(0, 5 if hap_len > 8 else 4, hap_len)]
    if read_len <= hap_len:
        lo = int(rng.integers(0, hap_len - read_len + 1))
        read = hap[lo:lo + read_len].copy()
    else:
        read = BASES[rng.integers(0, 4, read_len)]
    read[rng.integers(0, read_len, 2)] = BASES[rng.integers(0, 5, 2)]
    # long reads get high qualities, so that their likelihood stays above
    # the escalation bound and the comparison keeps them
    q_lo, iq_lo = (6, 20) if read_len < 400 else (33, 42)
    q = rng.integers(q_lo, 41, read_len).astype(np.uint8)
    iq = rng.integers(iq_lo, 46, read_len).astype(np.uint8)
    return (hap, read, q, iq, iq, np.full(read_len, 10, np.uint8))


def _flat_check(cuda, pairs):
    a = pack_pairhmm_batch(pairs)
    arrays = pc.pack_flat_inputs(
        a["haps"], a["hap_lens"], a["reads"], a["read_lens"], a["quals"],
        a["ins_quals"], a["del_quals"], a["gcps"])
    t = pc.to_tensors(arrays, cuda)
    launches = pc.FLAT_LAUNCHES
    got = pc.pairhmm_flat_cuda(t)
    torch.cuda.synchronize()
    assert pc.FLAT_LAUNCHES == launches + 1
    assert got.shape == (len(pairs),)
    want = pc.pairhmm_flat_torch(t)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.all(np.isfinite(got))
    keep = want > F32_SUSPECT_LOG10
    assert keep.sum() >= len(pairs) // 2
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=TOL)
    return got


@pytest.mark.parametrize("read_len", [1, 31, 32, 127, 128, 511, 512, 3000])
def test_flat_kernel_matches_plain_version(cuda, read_len):
    """Ragged batches whose size is not a multiple of the 4 warps of a CTA;
    haplotypes from 1 base up, shorter and longer than the read."""
    rng = np.random.default_rng(1000 + read_len)
    n = 37 if read_len <= 512 else 5
    pairs = [_flat_pair(rng, read_len, read_len + int(rng.integers(0, 300)))
             for _ in range(n)]
    pairs += [_flat_pair(rng, max(1, read_len // 2), h)
              for h in (1, 2, 33, read_len + 1)]
    assert len(pairs) % 4
    _flat_check(cuda, pairs)


@pytest.mark.parametrize("hap_len", [5000, 20000, 30000, 60000])
def test_flat_kernel_long_haplotypes(cuda, hap_len):
    """Haplotype slices of 4, 2 and 1 warps per CTA (up to ~14,000, ~28,000
    and ~57,000 bases) and the global-scratch slices past that; a 600-base
    read beside short ones puts the read strips in scratch as well at the
    longest."""
    rng = np.random.default_rng(hap_len)
    reads = (40, 100, 130) + ((600,) if hap_len == 60000 else ())
    pairs = [_flat_pair(rng, r, h) for r in reads
             for h in (hap_len, hap_len // 3, 7)]
    pairs = pairs[:-1] if len(pairs) % 4 == 0 else pairs
    _flat_check(cuda, pairs)


def test_flat_kernel_matches_grouped_kernel(cuda):
    pairs = _region(np.random.default_rng(9), 100, 23, 3)
    flat = _flat_check(cuda, pairs)
    grouped = pc.pairhmm_forward_grouped(pairs, cuda)
    np.testing.assert_allclose(flat, grouped, rtol=0, atol=1e-5)


def test_flat_kernel_rejects_bad_inputs(cuda):
    pairs = [_flat_pair(np.random.default_rng(2), 50, 80) for _ in range(3)]
    a = pack_pairhmm_batch(pairs)
    arrays = pc.pack_flat_inputs(
        a["haps"], a["hap_lens"], a["reads"], a["read_lens"], a["quals"],
        a["ins_quals"], a["del_quals"], a["gcps"])
    t = pc.to_tensors(arrays, cuda)
    t["hap_lens"] = t["hap_lens"].cpu()
    with pytest.raises(ValueError, match="hap_lens"):
        pc.pairhmm_flat_cuda(t)
    t = pc.to_tensors(arrays, cuda)
    t["quals"] = t["quals"][:, :33].contiguous()
    with pytest.raises(ValueError, match="plane"):
        pc.pairhmm_flat_cuda(t)


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
