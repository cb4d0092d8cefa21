"""The harness's view of the program (``lorikeet_tpu_torch``): one ``call``
through its CLI, its counters, and what its grouped pair-HMM kernel (K2)
was handed and returned.

The program is imported here and nowhere else in the harness, inside the
functions, so that the reference and the generator never load it.
"""
from __future__ import annotations

import contextlib
import io
import json
import resource

import numpy as np


class K2Watch:
    """Wraps the program's ``enqueue_grouped_jobs``, where every K2 batch
    of the run passes (the parent's own and those the pool's device
    service runs for its workers).  For each batch it keeps the cells and
    bytes that bound the kernel's time, and a sample of ``per_batch``
    rows drawn from ``rng``: the row's bases and qualities, its haplotype
    and a handle on the kernel's output."""

    def __init__(self, rng, per_batch: int):
        from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
        self._pc = pc
        self._rng = rng
        self._per_batch = per_batch
        self.batches = []          # {"cells", "bytes"}
        self.samples = []          # (pairs, out index, shares)
        self._real = pc.enqueue_grouped_jobs
        pc.enqueue_grouped_jobs = self._enqueue

    def close(self):
        self._pc.enqueue_grouped_jobs = self._real

    def _enqueue(self, arrays, out_pos, *args, **kwargs):
        handle = self._real(arrays, out_pos, *args, **kwargs)
        planes = planes_of(arrays)
        lens = planes["read_lens"]
        tiles = lens.reshape(-1, 32).sum(1).astype(np.int64)
        cells = int((tiles[arrays["tile_tab"]]
                     * planes["hap_lens"][arrays["hap_tab"]]).sum())
        nbytes = sum(v.nbytes for v in arrays.values()
                     if isinstance(v, np.ndarray))
        self.batches.append({
            "cells": cells,
            # inputs once, the base table, one f32 out a (block, row)
            "bytes": int(nbytes + 4 * 256 + 4 * 32 * arrays["tile_tab"].size)})
        rows = (arrays["tile_tab"][:, None] * 32 + np.arange(32)).reshape(-1)
        live = np.nonzero(lens[rows] > 0)[0]
        if live.size:
            pick = self._rng.choice(live, min(self._per_batch, live.size),
                                    replace=False)
            self.samples.append((pairs_at(planes, arrays, pick), pick,
                                 handle[0]))
        return handle

    def values(self, shares, pick) -> np.ndarray:
        """The kernel's f32 outputs at flat positions ``pick`` of a batch,
        once it has been read back."""
        import torch
        for _, done in shares:
            if done is not None:
                done.synchronize()
        flat = torch.cat([out.cpu() for out, _ in shares]).numpy()
        return flat[pick].astype(np.float64)


def planes_of(arrays: dict) -> dict:
    """A K2 batch's read planes and haplotypes: a wire-form batch's
    decoded from its codebook and symbol table, a flat batch's as they
    are."""
    if arrays.get("mode") != "wire":
        return arrays
    tup = arrays["cb"].view(np.uint32)[arrays["qidx"]]
    out = dict(arrays)
    for k, name in enumerate(("quals", "ins_q", "del_q", "gcp_q")):
        out[name] = ((tup >> (8 * k)) & 0xFF).astype(np.uint8)

    def unnib(p):
        sym = np.stack([p & 0xF, p >> 4], axis=-1).reshape(p.shape[0], -1)
        return arrays["sym_tab"][sym]

    out["read_u8"] = unnib(arrays["read_nib"])
    hmax = int(arrays["hap_lens"].max())
    out["haps"] = unnib(arrays["hap_nib"])[:, :hmax]
    return out


def pairs_at(planes: dict, arrays: dict, flat: np.ndarray) -> list:
    """(hap, read, q, iq, dq, gcp) of the K2 outputs at flat positions
    ``flat`` (block * 32 + row in the block's tile)."""
    out = []
    for f in flat.tolist():
        block, r = divmod(f, 32)
        row = int(arrays["tile_tab"][block]) * 32 + r
        n = int(planes["read_lens"][row])
        hap = int(arrays["hap_tab"][block])
        out.append((planes["haps"][hap, :planes["hap_lens"][hap]].copy(),
                    *(planes[p][row, 1:n + 1].copy() for p in
                      ("read_u8", "quals", "ins_q", "del_q", "gcp_q"))))
    return out


def use_cards(cards):
    """Put ``cards`` in the place of the visible cards (None: the real
    ones), as the program's tests do to run its plain versions."""
    if cards is None:
        return
    from lorikeet_tpu_torch.parallel import sharding
    sharding.visible_cards = lambda: list(cards)
    sharding._DEVICES = None


def call(args: list) -> dict:
    """One command of the program's CLI (``args[0]``, such as ``call``)
    in this process, its printed output kept from the harness's own: the
    ``outputs`` object of the summary it prints last."""
    from lorikeet_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    if rc != 0:
        raise RuntimeError(f"lorikeet call exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])["outputs"]


def reset_counters(stages: bool):
    """Zero the counters the per-layer metrics read; stage timing on or
    off (the program times its stages only when asked)."""
    from lorikeet_tpu_torch.ops import pairhmm as ph
    from lorikeet_tpu_torch.parallel import pool
    from lorikeet_tpu_torch.utils import progress
    progress.GLOBAL_STAGES = {} if stages else None
    pool.WORKER_COUNTS.update(dict.fromkeys(pool.WORKER_COUNTS, 0))
    ph.ESCALATIONS.update(dict.fromkeys(ph.ESCALATIONS, 0))


def counters() -> dict:
    from lorikeet_tpu_torch.ops import pairhmm as ph
    from lorikeet_tpu_torch.parallel import pool
    from lorikeet_tpu_torch.utils import progress
    return {"stages": dict(progress.GLOBAL_STAGES or {}),
            "worker_counts": dict(pool.WORKER_COUNTS),
            "escalations": dict(ph.ESCALATIONS),
            "spawn_s": [r["spawn_s"] for r in pool.WORKER_REPORTS.values()]}


def worker_pids() -> list:
    from lorikeet_tpu_torch.parallel import pool
    return [w.pid for p in pool._POOLS.values() for w in p.workers
            if w.is_alive()]


def peak_rss_kib() -> dict:
    """The process's own peak resident set (ru_maxrss) and each live pool
    worker's (VmHWM), KiB."""
    workers = []
    for pid in worker_pids():
        with open(f"/proc/{pid}/status") as fh:
            for line in fh:
                if line.startswith("VmHWM:"):
                    workers.append(int(line.split()[1]))
    return {"parent": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
            "workers": workers}


def shutdown():
    """Stop the pool's workers and wait for them."""
    from lorikeet_tpu_torch.parallel import pool
    pool.shutdown_pool()
