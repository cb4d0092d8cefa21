"""The device activity chain: per-position ref-vs-any EM, HQ-soft-clip
state expansion and band-pass as torch ops, with the position axis split
over the devices of one process or over the ranks of a
``torch.distributed`` group.

Counterpart of lorikeet_tpu/parallel/pipeline.py.  The reference scales the
genome axis by chunking with small overlaps
(haplotype_caller_engine.rs:417,947; the band-pass needs only a +/-50bp
halo, band_pass_activity_profile.rs:24-26).  Each device or rank smooths
its own stretch of positions from the stretch's raw probabilities and HQ
means widened by a halo (the taps plus the expansion's reach): one process
cuts each stretch with its halo from the host arrays and runs the EM over
both; a group's ranks run the EM on their own stretch and exchange the
halos.  Both then smooth the widened stretch the same way
(``_smooth_padded``).  The chain runs in f32 on the device, as the JAX
chain does; the host chain (models.activity) is f64.  XLA's needs do not
carry over: the position axis is not padded to a power of two, so the
stretches may differ in length, and there is no optimisation barrier.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from lorikeet_tpu_torch.device import device_list
from lorikeet_tpu_torch.models.activity import (
    AVERAGE_HQ_SOFTCLIPS_HQ_BASES_THRESHOLD as HQ_T, gaussian_kernel,
)
from lorikeet_tpu_torch.parallel.hosts import even_shares, group_rank_world


def active_probabilities_torch(gls: torch.Tensor, ploidy: int,
                               snp_heterozygosity=0.001,
                               heterozygosity_stdev=0.01,
                               stand_min_conf=25.0,
                               n_iters: int = 20) -> torch.Tensor:
    """torch version of models.activity.active_probabilities on ``gls``
    [S, L, G]: at most ``n_iters`` EM iterations over every position, with
    converged positions frozen (the fixed-count form of the JAX chain; the
    loop ends early once every position is frozen, which changes no
    value).  f32 [L] on the device of ``gls``."""
    S, L, G = gls.shape
    dt, dev = gls.dtype, gls.device
    counts = torch.tensor(
        [[ploidy - i, i] for i in range(G)], dtype=dt, device=dev)   # [G, 2]
    log10_comb = torch.tensor(
        [(math.lgamma(ploidy + 1) - math.lgamma(i + 1)
          - math.lgamma(ploidy - i + 1)) / math.log(10) for i in range(G)],
        dtype=dt, device=dev)
    ref_pseudo = snp_heterozygosity / heterozygosity_stdev ** 2
    prior_pseudo = torch.tensor(
        [ref_pseudo, snp_heterozygosity * ref_pseudo], dtype=dt, device=dev)

    def posteriors(log10_af):
        af_term = (log10_af[:, None, :] * counts[None, :, :]).sum(2)  # [L, G]
        raw = log10_comb[None, None, :] + gls + af_term[None, :, :]
        m = raw.amax(dim=2, keepdim=True)
        norm = m + torch.log10(
            torch.pow(10.0, raw - m).sum(dim=2, keepdim=True))
        return raw - norm

    log10_af = torch.full((L, 2), -math.log10(2.0), dtype=dt, device=dev)
    allele_counts = torch.zeros((L, 2), dtype=dt, device=dev)
    active = torch.ones(L, dtype=torch.bool, device=dev)
    for _ in range(n_iters):
        lin = torch.pow(10.0, posteriors(log10_af))
        new_counts = (lin.sum(0)[:, :, None] * counts[None, :, :]).sum(1)
        diff = (new_counts - allele_counts).abs().amax(dim=1)
        upd = active[:, None]
        allele_counts = torch.where(upd, new_counts, allele_counts)
        pseudo = prior_pseudo[None, :] + allele_counts
        af_new = torch.log10(pseudo / pseudo.sum(dim=1, keepdim=True))
        log10_af = torch.where(upd, af_new, log10_af)
        active = active & (diff > 0.01)
        if not bool(active.any()):
            break

    log10_p_no_variant = posteriors(log10_af)[:, :, 0].sum(dim=0)
    phred = -10.0 * log10_p_no_variant
    plausible = (log10_p_no_variant + 1e-10) < (stand_min_conf * -0.1)
    emit_ok = phred >= stand_min_conf
    qual_u8 = torch.clamp(torch.trunc(phred), 0, 255)
    prob = 1.0 - torch.pow(10.0, qual_u8 / -10.0)
    return torch.where(plausible & emit_ok, prob, 0.0).to(torch.float32)


def _expand_hq_torch(probs: torch.Tensor, hq_mean: torch.Tensor,
                     prop: int, first: int = 0, last=None) -> torch.Tensor:
    """Device form of models.activity.expand_hq_softclip_states: each
    HQ-soft-clip position scatters its full prob over +/- n as a
    difference-array boxcar (``index_add_`` then ``cumsum``; exact reference
    state expansion, activity_profile.rs:308-339).  The boxcar is cut at
    ``first`` and ``last`` (default: the array's two ends): what reaches
    past the genome is dropped, as on the host."""
    L = probs.shape[0]
    last = L - 1 if last is None else last
    hqm = (hq_mean >= HQ_T) & (probs > 0.0)
    p_sel = torch.where(hqm, probs, 0.0)
    n = torch.clamp(hq_mean, max=float(prop)).to(torch.int64)
    idxs = torch.arange(L, device=probs.device)
    lo = torch.clamp(idxs - n, first, last)
    hi = torch.clamp(idxs + n, first, last)
    delta = torch.zeros(L + 1, dtype=probs.dtype, device=probs.device)
    delta.index_add_(0, lo, p_sel)
    delta.index_add_(0, hi + 1, -p_sel)
    return torch.where(hqm, 0.0, probs) + torch.cumsum(delta[:-1], 0)


def _band_pass_torch(probs: torch.Tensor) -> torch.Tensor:
    """"Same"-mode convolution of [L] with the 101-tap Gaussian, in full
    f32 (cuDNN's TF32 convolutions are switched off for the call)."""
    kernel = torch.from_numpy(
        np.asarray(gaussian_kernel(), np.float32)).to(probs.device)
    half = (kernel.numel() - 1) // 2
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        out = torch.nn.functional.conv1d(
            probs[None, None, :], kernel.flip(0)[None, None, :], padding=half)
    return out[0, 0].to(torch.float32)


def _halo(prop: int) -> int:
    """Positions a stretch needs on each side: the band-pass taps plus the
    reach of the HQ-soft-clip expansion (a neighbour's HQ position within
    ``prop`` bp scatters prob into the stretch)."""
    return (len(gaussian_kernel()) - 1) // 2 + int(prop)


def _smooth_padded(probs: torch.Tensor, hq_mean, prop: int, halo: int,
                   lo: int, L: int) -> torch.Tensor:
    """Expansion and band-pass of the stretch that starts at position
    ``lo`` of an axis of ``L``, given its raw probs and HQ means (None: no
    expansion) with ``halo`` positions on each side, zeros past the genome's
    two ends; the stretch's smoothed values.  The expansion stops at the
    genome's first and last position, as the whole axis's chain does."""
    n = probs.shape[0]
    if hq_mean is not None:
        first = max(0, halo - lo)
        last = min(n - 1, L - 1 - lo + halo)
        probs = _expand_hq_torch(probs, hq_mean, prop, first, last)
    return _band_pass_torch(probs)[halo:n - halo]


def _exchange_halo(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """[left neighbour's last ``halo``, x, right neighbour's first ``halo``]
    along axis 0, zeros at the genome's two ends.  Every rank gathers every
    rank's two edges (``all_gather``) and keeps its neighbours'."""
    zeros = torch.zeros_like(x[:halo])
    rank, world = group_rank_world(group)
    if world == 1:
        return torch.cat([zeros, x, zeros])
    import torch.distributed as dist
    edges = torch.stack([x[:halo], x[-halo:]]).contiguous()
    gathered = [torch.empty_like(edges) for _ in range(world)]
    dist.all_gather(gathered, edges, group=group)
    left = gathered[rank - 1][1] if rank > 0 else zeros
    right = gathered[rank + 1][0] if rank < world - 1 else zeros
    return torch.cat([left, x, right])


def _local_stretch(L: int, halo: int, group) -> tuple:
    """(lo, hi) of this rank's positions; the axis must split evenly into
    stretches no shorter than the halo (a rank's halo comes from its two
    neighbours only)."""
    rank, world = group_rank_world(group)
    if L % world or (world > 1 and L // world < halo):
        raise ValueError(f"{L} positions do not split over {world} ranks "
                         f"into equal stretches of at least {halo}")
    per = L // world
    return rank * per, (rank + 1) * per


def _gather_positions(local: torch.Tensor, group) -> torch.Tensor:
    world = group_rank_world(group)[1]
    if world == 1:
        return local
    import torch.distributed as dist
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts)


def _smooth_stretch(probs: torch.Tensor, hq_mean, prop: int, lo: int,
                    L: int, group) -> torch.Tensor:
    """Band-pass of this rank's stretch, which starts at ``lo``: the raw
    probs and HQ means are exchanged with the neighbours a halo wide, then
    smoothed as one process smooths a stretch."""
    halo = _halo(prop)
    hq = None if hq_mean is None else _exchange_halo(hq_mean, halo, group)
    return _smooth_padded(_exchange_halo(probs, halo, group), hq, prop, halo,
                          lo, L)


def smoothed_activity_device(gls: np.ndarray, hq_mean: np.ndarray,
                             ploidy: int,
                             snp_heterozygosity: float = 0.001,
                             heterozygosity_stdev: float = 0.01,
                             stand_min_conf: float = 25.0,
                             max_prob_propagation: int = 50,
                             n_iters: int = 100,
                             devices="cuda") -> np.ndarray:
    """The device form of models.activity.active_probabilities +
    band_pass_smooth, returning the smoothed [L] profile as numpy.  The
    position axis is split over ``devices`` (a device or a list of them)
    in contiguous stretches (``even_shares``; an empty one runs nothing);
    each is cut from the host arrays with a halo on both sides and runs
    the EM, the HQ-soft-clip expansion and the band-pass on its device,
    and the stretches, their halos cut, are joined in order."""
    devices = device_list(devices)
    prop = int(max_prob_propagation)
    halo = _halo(prop)
    L = gls.shape[1]
    parts = []
    for device, (lo, hi) in zip(devices, even_shares(L, len(devices))):
        if hi == lo:
            continue
        a, b = max(0, lo - halo), min(L, hi + halo)
        pad = (a - (lo - halo), hi + halo - b)
        with (torch.cuda.device(device) if device.type == "cuda"
              else contextlib.nullcontext()):
            g = torch.from_numpy(
                np.ascontiguousarray(gls[:, a:b], np.float32)).to(device)
            h = torch.from_numpy(
                np.ascontiguousarray(hq_mean[a:b], np.float32)).to(device)
            probs = active_probabilities_torch(
                g, ploidy, snp_heterozygosity, heterozygosity_stdev,
                stand_min_conf, n_iters)
            out = _smooth_padded(torch.nn.functional.pad(probs, pad),
                                 torch.nn.functional.pad(h, pad), prop,
                                 halo, lo, L)
            parts.append(out.cpu())
    return torch.cat(parts).numpy()


def sharded_smoothed_activity(gls: np.ndarray, hq_mean: np.ndarray,
                              ploidy: int, group=None,
                              snp_heterozygosity: float = 0.001,
                              heterozygosity_stdev: float = 0.01,
                              stand_min_conf: float = 25.0,
                              max_prob_propagation: int = 50,
                              n_iters: int = 100,
                              device="cuda") -> np.ndarray:
    """smoothed_activity_device with the position axis split over the ranks
    of ``group``, one device each: every rank passes the whole arrays, runs
    the EM on its own stretch of positions, exchanges the halos with its
    neighbours and gets the whole profile back.  A run of several processes
    puts it in smoothed_activity_device's place; ``call`` runs in one
    process and splits over its device list instead."""
    (device,) = device_list(device)
    prop = int(max_prob_propagation)
    L = gls.shape[1]
    lo, hi = _local_stretch(L, _halo(prop), group)
    g = torch.from_numpy(
        np.ascontiguousarray(gls[:, lo:hi], np.float32)).to(device)
    h = torch.from_numpy(
        np.ascontiguousarray(hq_mean[lo:hi], np.float32)).to(device)
    probs = active_probabilities_torch(
        g, ploidy, snp_heterozygosity, heterozygosity_stdev, stand_min_conf,
        n_iters)
    out = _gather_positions(_smooth_stretch(probs, h, prop, lo, L, group),
                            group)
    return out.cpu().numpy()


def sharded_activity_step(group=None, ploidy: int = 2, device="cuda"):
    """Position-sharded activity profiling: local EM, halo exchange,
    band-pass convolution, and all-reduced per-sample depth totals.

    Returns fn(gls [S, L, G] f32, depths [S, L] f32) -> (smoothed probs [L],
    depth_totals [S]) as numpy; every rank passes the whole arrays and gets
    the whole result."""
    device = torch.device(device)

    def step(gls, depths):
        L = gls.shape[1]
        lo, hi = _local_stretch(L, _halo(0), group)
        g = torch.from_numpy(
            np.ascontiguousarray(gls[:, lo:hi], np.float32)).to(device)
        d = torch.from_numpy(
            np.ascontiguousarray(depths[:, lo:hi], np.float32)).to(device)
        probs = active_probabilities_torch(g, ploidy)
        smoothed = _gather_positions(
            _smooth_stretch(probs, None, 0, lo, L, group), group)
        depth_total = d.sum(dim=1)
        if group_rank_world(group)[1] > 1:
            import torch.distributed as dist
            dist.all_reduce(depth_total, op=dist.ReduceOp.SUM, group=group)
        return smoothed.cpu().numpy(), depth_total.cpu().numpy()

    return step
