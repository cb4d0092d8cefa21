"""Where the CTA form of the Smith-Waterman kernel spends a launch: the
anti-diagonal sweep, the start-point scan, the traceback walk.

    python3 -m lorikeet_tpu_torch.testkit.sw_split      (repo root, one card)

The shipped kernel carries no instrumentation.  This tool copies
``csrc/sw.cu``, adds four ``clock64()`` stamps to the CTA kernel (each
inserted at a line it must find exactly once), makes every pair take that
form, builds the copy beside the other libraries and runs it on two batches:
the largest realignment batch of a ``call --pallas-sw`` run on the simulated
1 Mbp x 2 samples x 30x genome, and the 64 x 40 `region` batch of
``chip_smoke.py``.  Thread 0's cycle counts per pair go out through the
unused tail of the pair's CIGAR slot.  It prints one JSON line per batch:
the shares of sweep, scan and walk in a pair's cycles, the kernel's time
(CUDA events, median of 7), and the card.  Results are checked against the
native aligner, so a stamp that broke the kernel fails.
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from lorikeet_tpu_torch import device
from lorikeet_tpu_torch.ops import _build
from lorikeet_tpu_torch.ops import sw_cuda as sc
from lorikeet_tpu_torch.ops.smith_waterman import (
    ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS, OverhangStrategy, align,
)

#: (line of the CTA kernel, what goes in front of it)
STAMPS = (
    ("  for (int d = 1; d <= R + A; ++d) {\n",
     "  const long long stamp0 = clock64();\n"),
    ("  // --- start point and traceback (sw.cpp calculate_cigar) ---\n"
     "  int64_t p1 = 0, p2 = 0, seg = 0;\n",
     "  const long long stamp1 = clock64();\n"),
    ("  int32_t* out = cigar + m[5];\n  int n = 0;\n",
     "  const long long stamp2 = clock64();\n"),
    ("  res[2 * blockIdx.x] = n;\n",
     "  const long long stamp3 = clock64();\n"
     "  out[R + A + 1] = static_cast<int32_t>(stamp1 - stamp0);\n"
     "  out[R + A + 2] = static_cast<int32_t>(stamp2 - stamp1);\n"
     "  out[R + A + 3] = static_cast<int32_t>(stamp3 - stamp2);\n"),
    # every pair on the CTA form
    ("constexpr int kWarpMaxAlt = 511;", "constexpr int kWarpMaxAlt = 0;  //"),
)


def build_stamped() -> ctypes.CDLL:
    with open(os.path.join(_build.CSRC, "sw.cu")) as fh:
        src = fh.read()
    for anchor, insert in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"sw.cu: {anchor!r} found {src.count(anchor)} "
                               "times, want 1")
        src = src.replace(anchor, insert + anchor)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, "sw_split.cu")
    so = os.path.join(_build.BUILD_DIR, "libsw_split.so")
    with open(cu, "w") as fh:
        fh.write(src)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sw_launch.argtypes = [vp] * 5 + [ci] * 8 + [vp]
    lib.sw_launch.restype = ci
    return lib


def split(lib, name, pairs, params, strategy, dev) -> dict:
    """Run the stamped CTA kernel on ``pairs`` (none an exact substring)."""
    warp_max_alt, sc.WARP_MAX_ALT = sc.WARP_MAX_ALT, 0
    try:
        t = sc.to_tensors(sc.pack_pairs(pairs), dev)
    finally:
        sc.WARP_MAX_ALT = warp_max_alt
    B = len(pairs)
    assert t["n_warp"] == 0
    scratch = torch.empty(t["scratch_len"], dtype=torch.uint8, device=dev)
    out = torch.zeros(2 * B + t["cigar_len"], dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        rc = lib.sw_launch(
            t["seqs"].data_ptr(), t["meta"].data_ptr(), scratch.data_ptr(),
            out[2 * B:].data_ptr(), out.data_ptr(), B, *t["cta_max"],
            params.match_value, params.mismatch_penalty,
            params.gap_open_penalty, params.gap_extend_penalty,
            int(strategy), stream)
        if rc != 0:
            raise RuntimeError(f"stamped sw kernel: CUDA error {rc}")

    launch()
    torch.cuda.synchronize()
    host = out.cpu().numpy()
    got = sc.decode(host, t)
    want = [align(r, a, params, strategy) for r, a in pairs]
    if got != want:
        raise RuntimeError(f"{name}: the stamped kernel disagrees with the "
                           "native aligner")
    m = t["meta_host"]
    at = 2 * B + m[:, 5] + m[:, 1] + m[:, 3] + 1
    cycles = np.stack([host[at], host[at + 1], host[at + 2]], 1).astype(
        np.int64)                                   # [B, sweep/scan/walk]
    times = []
    for _ in range(8):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    total = cycles.sum(1)
    slowest = cycles[int(total.argmax())]
    return {"batch": name, "pairs": B,
            "cells": int((m[:, 1] * m[:, 3]).sum()),
            "kernel_ms": sorted(times[1:])[3],
            "mean_cycles": dict(zip(("sweep", "scan", "walk"),
                                    cycles.mean(0).tolist())),
            "share": dict(zip(("sweep", "scan", "walk"),
                              (cycles.sum(0) / total.sum()).tolist())),
            # the pair that ends last sets a small batch's time
            "slowest_pair_cycles": dict(zip(("sweep", "scan", "walk"),
                                            slowest.tolist()))}


def main() -> int:
    dev = device.require_cuda()
    sys.path.insert(0, os.getcwd())
    import chip_smoke          # the batches are the smoke's own

    lib = build_stamped()
    params, strategy = (ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS,
                        OverhangStrategy.SOFTCLIP)
    batches = {"region": chip_smoke.sw_region_pairs(
        np.random.default_rng(0))}
    with tempfile.TemporaryDirectory() as root:
        from lorikeet_tpu_torch.testkit.dataset import simulate_dataset
        fasta, bams, _ = simulate_dataset(root, chip_smoke.GENOME_KBP, 2,
                                          30.0, seed=0)
        _, _, sw_batch, _ = chip_smoke.call_leg(
            "gpu_sw", fasta, bams, os.path.join(root, "out"),
            chip_smoke.LEG_FLAGS["gpu_sw"])
    batches["sw_main_path"] = [
        (r, a) for r, a in sw_batch
        if len(r) <= sc.MAX_REF_LEN and r.rfind(a) < 0]
    card = device.nvidia_smi_line()
    for name, pairs in batches.items():
        print(json.dumps({**split(lib, name, pairs, params, strategy, dev),
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
