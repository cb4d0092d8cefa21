"""Optional profiler trace around a run (``--profile-dir``).

Counterpart of ``maybe_profile`` in lorikeet_tpu/utils/progress.py, with
``torch.profiler`` in place of ``jax.profiler``.  Logging, progress lines
and the stage timers (``GLOBAL_STAGES`` included, so that it stays one
object) are imported from ``lorikeet_tpu.utils.progress`` unchanged.
"""
from __future__ import annotations

import contextlib
import os


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
