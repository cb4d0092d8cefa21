"""The flagship op as ``(fn, example_args)``: the batched pair-HMM forward.

Counterpart of ``__graft_entry__.entry`` of the JAX package (the same
example batch: 32 pairs, reads of 24 and haplotypes of 48 bases, quals
30/45/45/10, each read the first 24 bases of its haplotype; the JAX
package's ninth argument, the lane index it passes to keep XLA from folding
a constant, is not needed here).  ``fn`` runs
:func:`lorikeet_tpu_torch.ops.pairhmm.pairhmm_forward_batch` on the card, or
on the host when the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np


def entry(device=None):
    """(fn, example_args): ``fn(*example_args)`` is the [B] float32 tensor
    of log10 likelihoods, on ``device`` (None: the card, an error without
    one)."""
    from lorikeet_tpu_torch.device import require_cuda
    from lorikeet_tpu_torch.ops.pairhmm import pairhmm_forward_batch

    target = require_cuda() if device is None else device
    B, R, H = 32, 24, 48
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    haps = bases[rng.integers(0, 4, (B, H))]
    reads = np.stack([h[:R] for h in haps])
    args = (
        haps, np.full(B, H, np.int32), reads, np.full(B, R, np.int32),
        np.full((B, R), 30, np.uint8), np.full((B, R), 45, np.uint8),
        np.full((B, R), 45, np.uint8), np.full((B, R), 10, np.uint8),
    )

    def fn(haps, hap_lens, reads, read_lens, quals, iq, dq, gcp):
        return pairhmm_forward_batch(haps, hap_lens, reads, read_lens, quals,
                                     iq, dq, gcp, device=target)

    return fn, args
