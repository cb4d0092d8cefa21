#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lorikeet_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero without the final
``ok`` line:

1. probe   torch/CUDA versions, the card, its capability (9, 0), nvcc.
2. build   compile csrc/pairhmm.cu for sm_90a from the checkout.
3. kernel  region-shaped pairs (64 regions x 6 haplotypes of 300-650 bp x
           40 reads of 100 bp, with N, IUPAC and unknown bytes and duplicate
           tuples) and a long-read batch (500 bp and 3 kb reads): the kernel
           against its plain torch version on the card (|d log10| <= 1e-4 on
           rows above -28), and after the f64 escalation against the native
           f64 kernel (<= 2e-3); median times over >= 5 runs (CUDA events).
4. call    `lorikeet_tpu_torch.cli call -t 1` on a simulated 1 Mbp x 2
           samples x 30x genome, on the card and with --force-cpu (the exact
           f64 host kernel), in turns (card, f64, f64, card) after a short
           warm-up run: same sites, alleles and genotypes, QUAL within 0.1,
           recall >= 0.99, every pair-HMM batch of a card leg on the card.
5. main_path  the largest pair-HMM batch of the first card leg, replayed:
           kernel against the plain version, and both timed.
6. trace   one more card leg under torch.profiler, for the share of the
           run the card sits idle.

The line before the last repeats the card's name and power limit; the last
is the ``ok`` line.  Exits 1 when there is no CUDA device.  Needs one card,
no network.
"""
import contextlib
import io
import json
import os
import sys
import tempfile
import time

KERNEL_TOL = 1e-4        # kernel vs plain torch version, same card, f32
EXACT_TOL = 2e-3         # after f64 escalation vs the native f64 kernel
QUAL_TOL = 0.1           # GPU leg vs f64 leg (docs/benchmarks.md:292-298)
MIN_RECALL = 0.99
GENOME_KBP = 1000
TIMED_RUNS = 7
#: the e2e legs in turns, so that drift on the host hits both alike
LEG_ORDER = ("gpu", "f64", "f64", "gpu")


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


def check(cond, msg: str):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_median_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median of ``runs`` timings of fn() after one warm-up, each between
    two CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def region_pairs(rng, n_regions=64, n_haps=6, n_reads=40, read_len=100):
    """Region-shaped (read x haplotype) cross products with ambiguous bytes
    and duplicate tuples."""
    import numpy as np
    bases = np.frombuffer(b"ACGT", np.uint8)
    odd = np.frombuffer(b"NRYX", np.uint8)
    pairs = []
    for _ in range(n_regions):
        hap_len = int(rng.integers(300, 651))
        ref = bases[rng.integers(0, 4, hap_len)]
        haps = [ref]
        for _ in range(n_haps - 1):
            h = ref.copy()
            h[rng.integers(0, hap_len, 2)] = bases[rng.integers(0, 4, 2)]
            if rng.random() < 0.3:
                h[int(rng.integers(0, hap_len))] = odd[int(rng.integers(0, 4))]
            haps.append(h)
        for _ in range(n_reads):
            lo = int(rng.integers(0, hap_len - read_len + 1))
            read = ref[lo:lo + read_len].copy()
            read[rng.integers(0, read_len, 2)] = bases[rng.integers(0, 4, 2)]
            if rng.random() < 0.2:
                read[int(rng.integers(0, read_len))] = \
                    odd[int(rng.integers(0, 4))]
            q = rng.integers(6, 41, read_len).astype(np.uint8)
            iq = np.full(read_len, 45, np.uint8)
            iq[rng.integers(0, read_len, 5)] = rng.integers(10, 45, 5)
            gcp = np.full(read_len, 10, np.uint8)
            for h in haps:
                pairs.append((h, read, q, iq, iq, gcp))
        pairs.extend(pairs[-3:])                    # duplicate tuples
    return pairs


def long_pairs(rng):
    import numpy as np
    bases = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for read_len in (500, 3000):
        hap_len = read_len + 300
        ref = bases[rng.integers(0, 4, hap_len)]
        haps = [ref, ref.copy()]
        haps[1][rng.integers(0, hap_len, 4)] = bases[rng.integers(0, 4, 4)]
        read = ref[150:150 + read_len].copy()
        read[rng.integers(0, read_len, 3)] = bases[rng.integers(0, 4, 3)]
        q = np.full(read_len, 35, np.uint8)
        o = np.full(read_len, 45, np.uint8)
        g = np.full(read_len, 10, np.uint8)
        pairs.extend((h, read, q, o, o, g) for h in haps)
    return pairs


def kernel_phase(name, pairs, dev, timed: bool) -> dict:
    import numpy as np
    import torch

    from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
    from lorikeet_tpu_torch.ops.pairhmm import (
        F32_SUSPECT_LOG10, pairhmm_forward_checked, pairhmm_forward_f64,
    )

    arrays, out_pos = pc.pack_grouped_inputs(pairs)
    t = pc.to_tensors(arrays, dev)
    pos = torch.from_numpy(out_pos).to(dev)
    launches = pc.LAUNCHES
    got = pc.pairhmm_grouped_cuda(t)[pos]
    torch.cuda.synchronize()
    check(pc.LAUNCHES == launches + 1, f"{name}: kernel launch not counted")
    plain = pc.pairhmm_sweep_torch(t)[pos]
    got = got.cpu().numpy().astype(np.float64)
    plain = plain.cpu().numpy().astype(np.float64)
    check(np.all(np.isfinite(got)), f"{name}: non-finite kernel output")
    keep = plain > F32_SUSPECT_LOG10
    check(keep.any(), f"{name}: no rows above the escalation bound")
    err = float(np.abs(got[keep] - plain[keep]).max())
    check(err <= KERNEL_TOL, f"{name}: kernel vs plain {err} > {KERNEL_TOL}")
    exact = pairhmm_forward_f64(pairs)
    checked = pairhmm_forward_checked(got, pairs)
    err64 = float(np.abs(checked - exact).max())
    check(err64 <= EXACT_TOL, f"{name}: vs f64 {err64} > {EXACT_TOL}")
    uniq = {(id(p[0]), id(p[1])): len(p[0]) * len(p[1]) for p in pairs}
    out = {"pairs": len(pairs), "blocks": int(arrays["tile_tab"].size),
           "rpad": int(arrays["quals"].shape[1]),
           "cells": int(sum(uniq.values())),
           "max_abs_err_vs_plain": err, "max_abs_err_vs_f64": err64,
           "escalated_rows": int((~keep).sum())}
    if timed:
        ms = cuda_median_ms(lambda: pc.pairhmm_grouped_cuda(t))
        plain_ms = cuda_median_ms(lambda: pc.pairhmm_sweep_torch(t),
                                  runs=5)
        t0 = time.perf_counter()
        pc.pairhmm_forward_grouped(pairs, dev)
        forward_ms = (time.perf_counter() - t0) * 1e3
        out.update(ms=ms, plain_ms=plain_ms, forward_ms=forward_ms,
                   gcups=out["cells"] / (ms * 1e-3) / 1e9,
                   plain_gcups=out["cells"] / (plain_ms * 1e-3) / 1e9)
    emit("kernel", batch=name, **out)
    return out


def read_sites(vcf):
    sites = []
    for line in open(vcf):
        if line.startswith("#"):
            continue
        f = line.rstrip("\n").split("\t")
        key = (int(f[1]), f[3], f[4]) + tuple(s.split(":")[0] for s in f[9:])
        sites.append((key, float(f[5])))
    return sites


def call_leg(label, fasta, bams, outdir, extra):
    """One `call` run through the CLI; returns its counters."""
    from lorikeet_tpu.utils import progress
    from lorikeet_tpu_torch import cli
    from lorikeet_tpu_torch.calling import engine
    from lorikeet_tpu_torch.calling import likelihoods as lk
    from lorikeet_tpu_torch.ops import pairhmm as ph
    from lorikeet_tpu_torch.ops import pairhmm_cuda as pc

    work = {"regions": 0, "batches": 0, "pairs": 0, "cells": 0}
    largest = {"cells": -1, "pairs": None}
    compute = engine.compute_works_likelihoods

    def counted(eng, works):
        pairs = [p for w in works for p in w.pairs]
        cells = sum(len(p[0]) * len(p[1]) for p in pairs)
        work["regions"] += len(works)
        work["batches"] += 1
        work["pairs"] += len(pairs)
        work["cells"] += cells
        if cells > largest["cells"]:
            largest.update(cells=cells, pairs=pairs)
        return compute(eng, works)

    engine.compute_works_likelihoods = counted
    progress.GLOBAL_STAGES = {}
    lk.DISPATCH_COUNTS.update(device=0, host=0)
    ph.ESCALATIONS.update(checked=0, escalated=0)
    pc.LAUNCHES = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["call", "-t", "1", "-r", fasta, "-b", *bams,
                           "-o", outdir, *extra])
    finally:
        engine.compute_works_likelihoods = compute
    wall = time.perf_counter() - t0
    launches = pc.LAUNCHES
    stages = dict(progress.GLOBAL_STAGES)
    progress.GLOBAL_STAGES = None
    check(rc == 0, f"{label}: cli exit code {rc}")
    genomes = json.loads(buf.getvalue().strip().splitlines()[-1])[
        "outputs"]["genomes"]
    errors = {g: o["error"] for g, o in genomes.items() if "error" in o}
    check(not errors, f"{label}: genome errors {errors}")
    (vcf,) = [o["vcf"] for o in genomes.values()]
    esc = dict(ph.ESCALATIONS)
    leg = {"leg": label, "wall_s": wall, **work,
           "pairhmm_s": stages.get("pairhmm"),
           "stages_s": stages, "launches": launches,
           "dispatch": dict(lk.DISPATCH_COUNTS),
           "escalated": esc["escalated"], "checked": esc["checked"],
           "escalation_share": (esc["escalated"] / esc["checked"]
                                if esc["checked"] else 0.0),
           "vcf": vcf}
    return leg, largest["pairs"]


def call_phase(root):
    import bench_e2e
    from lorikeet_tpu.io.vcf import read_vcf

    t0 = time.perf_counter()
    fasta, bams, truth = bench_e2e.simulate_dataset(
        root, GENOME_KBP, 2, 30.0, seed=0, cache=True)
    emit("simulate", kbp=GENOME_KBP, samples=2, coverage=30,
         variants=len(truth), seconds=time.perf_counter() - t0)
    # a short f64 run builds the host libraries (g++, at first use), so
    # that no timed leg pays for them
    call_leg("warmup", fasta, bams, os.path.join(root, "warmup"),
             ["--force-cpu", "--limiting-interval", "0-30000"])
    legs = {"gpu": [], "f64": []}
    batch = None
    for run, label in enumerate(LEG_ORDER):
        leg, largest = call_leg(label, fasta, bams,
                                os.path.join(root, f"{label}{run}"),
                                [] if label == "gpu" else ["--force-cpu"])
        calls, _, _ = read_vcf(leg["vcf"])
        leg["calls"] = len(calls)
        leg["recall"] = bench_e2e.recall(calls, truth)
        emit("call", run=run, **leg)
        if label == "gpu":
            check(leg["launches"] > 0, "gpu leg launched no kernel")
            check(leg["dispatch"]["host"] == 0
                  and leg["dispatch"]["device"] > 0,
                  f"gpu leg dispatch {leg['dispatch']}")
            batch = batch or largest
        else:
            check(leg["launches"] == 0 and leg["dispatch"]["device"] == 0,
                  "f64 leg touched the device")
        legs[label].append(leg)
    sites = {k: [read_sites(leg["vcf"]) for leg in v] for k, v in legs.items()}
    for label, runs in sites.items():
        check(all(s == runs[0] for s in runs),
              f"{label} legs disagree with each other")
    sg, sf = sites["gpu"][0], sites["f64"][0]
    check([k for k, _ in sg] == [k for k, _ in sf],
          "gpu and f64 legs call different sites/alleles/genotypes")
    dq = max((abs(a - b) for (_, a), (_, b) in zip(sg, sf)), default=0.0)
    check(dq <= QUAL_TOL, f"QUAL differs by {dq} > {QUAL_TOL}")
    gpu = legs["gpu"][0]
    check(gpu["recall"] >= MIN_RECALL, f"recall {gpu['recall']}")
    emit("compare", sites=len(sg), max_qual_diff=dq, recall=gpu["recall"],
         **{f"{k}_wall_s": [leg["wall_s"] for leg in v]
            for k, v in legs.items()},
         **{f"{k}_pairhmm_s": [leg["pairhmm_s"] for leg in v]
            for k, v in legs.items()})
    return gpu, batch, (fasta, bams, sg)


def trace_phase(root, fasta, bams, sites):
    """One more card leg under the profiler (--profile-dir): how much of the
    run the card is busy.  It runs last, since the profiler's hooks can
    slow later launches; the timed legs run untraced."""
    prof = os.path.join(root, "prof")
    try:
        traced, _ = call_leg("gpu_traced", fasta, bams,
                             os.path.join(root, "traced"),
                             ["--profile-dir", prof])
        busy = device_busy(os.path.join(prof, "trace.json"),
                           traced["wall_s"])
    except Exception as exc:  # noqa: BLE001 — the trace is a measurement
        # only; the checked legs already ran the same path untraced
        emit("trace", error=repr(exc))
        return
    check(read_sites(traced["vcf"]) == sites, "traced leg calls differ")
    emit("trace", **busy)


def device_busy(trace_path: str, wall_s: float) -> dict:
    """Card time by kind from a torch.profiler Chrome trace, against the
    run's wall time (None where the trace holds no card activity)."""
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])

    def seconds(pred):
        return sum(e.get("dur", 0) for e in events if pred(e)) * 1e-6

    kernel_s = seconds(lambda e: e.get("cat") == "kernel")
    copy_s = seconds(lambda e: e.get("cat") in ("gpu_memcpy", "gpu_memset"))
    seen = any(e.get("cat") == "kernel" for e in events)
    return {"wall_s": wall_s, "kernel_s": kernel_s if seen else None,
            "pairhmm_kernel_s": seconds(
                lambda e: e.get("cat") == "kernel"
                and "grouped_kernel" in e.get("name", "")) if seen else None,
            "copy_s": copy_s if seen else None,
            "idle_share": 1.0 - (kernel_s + copy_s) / wall_s
            if seen else None}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import numpy as np

    from lorikeet_tpu_torch import device
    from lorikeet_tpu_torch.ops import _build

    info = device.probe()
    emit("probe", **info)
    check(info["capability"] == [9, 0],
          f"capability {info['capability']}: the kernel is built for sm_90a")
    check(info["nvidia_smi"], "nvidia-smi did not report the card")

    _build.load("pairhmm")
    ptxas = [line.strip() for line in _build.BUILD_LOG.get(
        "pairhmm", "").splitlines() if "registers" in line or "spill" in line]
    emit("build", seconds=_build.BUILD_SECONDS["pairhmm"], ptxas=ptxas)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    checks = [kernel_phase("region", region_pairs(rng), dev, timed=True),
              kernel_phase("long", long_pairs(rng), dev, timed=False)]

    with tempfile.TemporaryDirectory() as root:
        gpu, batch, dataset = call_phase(root)
        # the main path's largest batch, replayed after the counted run:
        # the kernel at the shapes the main path gives it
        main_batch = kernel_phase("main_path", batch, dev, timed=True)
        trace_phase(root, *dataset)
    checks.append(main_batch)

    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": [{
        "name": "pairhmm_grouped", "route": "cuda",
        "source": "lorikeet_tpu_torch/csrc/pairhmm.cu",
        "replaces": "lorikeet_tpu/ops/pairhmm_pallas.py:461",
        "launches": gpu["launches"],
        "max_abs_err": max(c["max_abs_err_vs_plain"] for c in checks),
        "ms": main_batch["ms"], "plain_ms": main_batch["plain_ms"]}]}),
        flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
