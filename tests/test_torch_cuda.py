"""The CUDA pair-HMM kernel against its plain torch version, on the card.

Marked ``cuda``: these need an NVIDIA card and skip without one.  On a
machine with a card run ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Each read length below selects another build of the kernel: register
strips of 4, 8 and 16 rows per lane (Rpad 128, 256, 384/512) and the
global-scratch strips of longer reads.
"""
import numpy as np
import pytest
import torch

from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
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
