"""Observability: logging, per-genome progress lines, per-stage timers,
and an optional profiler trace (``--profile-dir``).

Reference parity: the reference's telemetry is env_logger verbosity
(bin/lorikeet.rs:403-427) plus an indicatif progress-bar tree
(lorikeet_engine.rs:992-1072).  Here: stdlib logging with the same -v/-q
level mapping, a ProgressTree that writes per-genome status lines to
stderr, StageTimer accumulation surfaced in the results dict, and a
``torch.profiler`` trace when a profile directory is given.
"""
from __future__ import annotations

import contextlib
import logging
import os
import sys
import time

log = logging.getLogger("lorikeet_tpu_torch")


def set_log_level(verbosity: int = 0, quiet: bool = False):
    """-v count -> level (bin/lorikeet.rs:403 set_log_level parity)."""
    if quiet:
        level = logging.ERROR
    elif verbosity >= 2:
        level = logging.DEBUG
    elif verbosity == 1:
        level = logging.INFO
    else:
        level = logging.WARNING
    logging.basicConfig(
        level=level, stream=sys.stderr,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    log.setLevel(level)


class StageTimer:
    """Accumulates wall time per named stage; `timings()` returns seconds."""

    def __init__(self):
        self._acc = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] = self._acc.get(name, 0.0) + time.perf_counter() - t0

    def timings(self) -> dict:
        return {k: round(v, 3) for k, v in self._acc.items()}


class ProgressTree:
    """Per-genome status lines on stderr (indicatif-tree stand-in)."""

    def __init__(self, total: int, enabled: bool = True):
        self.total = total
        self.done = 0
        self.enabled = enabled and sys.stderr.isatty()

    def update(self, genome: str, message: str):
        if self.enabled:
            print(f"[{self.done}/{self.total}] {genome}: {message}",
                  file=sys.stderr, flush=True)
        log.info("%s: %s", genome, message)

    def finish_genome(self, genome: str):
        self.done += 1
        self.update(genome, "done")


@contextlib.contextmanager
def maybe_profile(profile_dir: str | None):
    """Trace host and (when a card is present) CUDA activity into
    ``profile_dir/trace.json``, a Chrome trace."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


# ---- optional global hot-path stage accounting ----
#: None = off (zero overhead beyond one attribute check); set to a dict to
#: accumulate {stage: seconds} across _call_span / the pair-HMM dispatch
#: (profile / smooth_extract / region_prep / pairhmm).
GLOBAL_STAGES = None


@contextlib.contextmanager
def global_stage(name: str):
    """Accumulate wall seconds into GLOBAL_STAGES[name] when enabled; the
    per-stage split of the calling hot path (profile / smooth / prep /
    pairhmm / genotype)."""
    acc = GLOBAL_STAGES
    if acc is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
