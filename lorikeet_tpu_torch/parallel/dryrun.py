"""Dry run of the sharded steps and a small ``call``, on one card or over
the ranks of an initialised ``torch.distributed`` group.

Counterpart of the JAX package's ``dryrun_multichip``: (a) the
position-sharded activity step with halo exchange and all-reduced depth
totals, (b) the region-batch step (flat pair-HMM kernel over the pairs,
all-reduced depth matrices), (c) a miniature production ``run_call`` over a
planted SNP (simulate reads, assemble, device likelihoods, genotype, write
the VCF) with the device activity chain on.  ``python -m
lorikeet_tpu_torch.parallel.dryrun`` runs it at world size 1 on the card;
``--device cpu`` runs the kernels' plain versions on the host.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np


def dryrun(world_size: int = 1, device="cuda") -> None:
    import torch

    from lorikeet_tpu_torch.parallel.hosts import group_rank_world
    from lorikeet_tpu_torch.parallel.pipeline import sharded_activity_step
    from lorikeet_tpu_torch.parallel.sharding import (
        demo_inputs, region_batch_step,
    )

    device = torch.device(device)
    rank, world = group_rank_world()
    if world != world_size:
        raise ValueError(f"dryrun({world_size}): the process group has "
                         f"{world} rank(s); initialise torch.distributed "
                         "with that world size first")

    # (a) activity profiling sharded over the genome-position axis
    S, L, ploidy = 2, 256 * world, 2
    rng = np.random.default_rng(0)
    gls = rng.normal(-1.0, 0.5, (S, L, ploidy + 1)).astype(np.float32)
    depths = rng.integers(0, 30, (S, L)).astype(np.float32)
    smoothed, depth_totals = sharded_activity_step(
        None, ploidy, device=device)(gls, depths)
    assert smoothed.shape == (L,) and depth_totals.shape == (S,)
    assert np.isfinite(smoothed).all()
    assert np.allclose(depth_totals, depths.sum(axis=1))

    # (b) region-batch flat pair-HMM split over the pairs
    args = demo_inputs(n_pairs=8 * world)
    lk, depth = region_batch_step(None, device=device)(*args)
    assert lk.shape[0] == 8 * world and np.all(lk <= 0)
    assert depth.shape == (8, 8) and np.isfinite(depth).all()

    # (c) the real pipeline: run_call end to end, pair-HMM and activity
    # chain on the device.  ``call`` is one process on one card, so with
    # several ranks the first runs it and the others wait.
    if rank == 0:
        _small_call(device)
    if world > 1:
        import torch.distributed as dist
        dist.barrier()


def _small_call(device) -> None:
    from lorikeet_tpu_torch.calling.engine import CallerConfig
    from lorikeet_tpu_torch.io.bam_writer import write_bam
    from lorikeet_tpu_torch.parallel import sharding
    from lorikeet_tpu_torch.processing import run_call
    from lorikeet_tpu_torch.testkit.simulate import Variant, simulate_reads

    bases = np.frombuffer(b"ACGT", np.uint8)
    ref = bases[np.random.default_rng(3).integers(0, 4, 900)]
    variants = [Variant(450, bytes(ref[450:451]),
                        b"A" if ref[450] != ord("A") else b"G")]
    recs = simulate_reads(ref, variants, coverage=12, read_length=60,
                          seed=7, tid=0)
    recs.sort(key=lambda r: r.pos)
    # the run's device list is this one device: it stands in for the
    # visible cards while the call configures its devices
    old_cards = sharding.visible_cards
    old_env = os.environ.get("LORIKEET_DEVICE_ACTIVITY")
    old_count = os.environ.get("LORIKEET_PROCESS_COUNT")
    sharding.visible_cards = lambda: [device]
    os.environ["LORIKEET_DEVICE_ACTIVITY"] = "1"
    os.environ["LORIKEET_PROCESS_COUNT"] = "1"     # this rank takes the genome
    try:
        with tempfile.TemporaryDirectory() as td:
            fasta = os.path.join(td, "ref.fna")
            with open(fasta, "w") as fh:
                fh.write(">c0\n" + ref.tobytes().decode() + "\n")
            bam = os.path.join(td, "s.bam")
            write_bam(bam, ["c0"], [900], recs)
            cfg = CallerConfig(use_cuda=True)
            vcf = run_call(fasta, [bam], os.path.join(td, "out"), cfg)
            with open(vcf) as fh:
                body = [ln for ln in fh if not ln.startswith("#")]
            assert any(ln.split("\t")[1] == "451" for ln in body), \
                f"planted SNP missing from the called VCF: {body}"
    finally:
        sharding.visible_cards = old_cards
        for key, old in (("LORIKEET_DEVICE_ACTIVITY", old_env),
                         ("LORIKEET_PROCESS_COUNT", old_count)):
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old


if __name__ == "__main__":
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args()
    dryrun(1, ns.device)
    print(json.dumps({"dryrun": "ok", "world_size": 1, "device": ns.device}))
