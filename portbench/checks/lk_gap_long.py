"""``lk_gap`` over the long-read segments: the widest |log10 K2 - log10
reference (float64)| over the seeded sample of K2 rows whose read is
longer than a short read (SHORT_READ bases), rows above the escalation
line (``correct.ESCALATED_AT``) only.  inf where none was sampled."""
import numpy as np

from portbench.lib import correct
from portbench.reference import pairhmm

#: the short reads' length: a longer read in a K2 row is a long read's
#: segment
SHORT_READ = 150


def read(answers):
    import torch
    watch, device = answers["k2"], answers["device"]
    pairs, got = [], []
    for sampled, pick, shares in watch.samples:
        long = np.array([len(p[1]) > SHORT_READ for p in sampled], bool)
        if long.any():
            pairs += [p for p, k in zip(sampled, long) if k]
            got.append(watch.values(shares, pick)[long])
    gap = np.zeros(0)
    if pairs:
        want = pairhmm.forward_log10(pairs, torch.float64, device)
        got = np.concatenate(got)
        kept = want > correct.ESCALATED_AT
        gap = np.abs(np.where(np.isfinite(got), got, np.inf) - want)[kept]
    return float(gap.max()) if gap.size else float("inf")
