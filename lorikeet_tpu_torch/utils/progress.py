"""Observability: logging, per-genome progress lines, per-stage timers,
and an optional profiler trace (``--profile-dir``).

Reference parity: the reference's telemetry is env_logger verbosity
(bin/lorikeet.rs:403-427) plus an indicatif progress-bar tree
(lorikeet_engine.rs:992-1072).  Here: stdlib logging with the same -v/-q
level mapping, a ProgressTree that writes per-genome status lines to
stderr, StageTimer accumulation surfaced in the results dict, the
program's span recorder (``global_stage``), and a ``torch.profiler``
trace with the recorded spans beside it when a profile directory is given.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import sys
import threading
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


#: the marker ``maybe_profile`` puts around its run in the profiler's
#: trace, whose start gives the offset of the program's clock
PROFILE_MARK = "lorikeet.profile"


@contextlib.contextmanager
def maybe_profile(profile_dir: str | None):
    """Trace host and (when a card is present) CUDA activity into
    ``profile_dir/trace.json``, a Chrome trace, and the program's spans
    beside it: one row for each thread of this process that recorded
    spans (the main thread, the pool's device service) and one for each
    pool worker, on the trace's clock (``to_trace``).  Spans are on for
    the run; the pools are stopped at its end, so that their workers'
    last spans reach this process."""
    global GLOBAL_STAGES, SPANS
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                record_function)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    was_on = GLOBAL_STAGES is not None
    if not was_on:
        GLOBAL_STAGES = {}
    try:
        with profile(activities=activities) as prof:
            before = time.perf_counter_ns()
            with record_function(PROFILE_MARK):
                yield
                # a persistent pool outlives the run: closing it now is
                # what ships each worker's spans since its last result
                pool = sys.modules.get("lorikeet_tpu_torch.parallel.pool")
                if pool is not None:
                    pool.shutdown_pool()
        spans = SPANS
    finally:
        if not was_on:
            GLOBAL_STAGES = SPANS = None
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans_to_trace(path, before, spans)


def _add_spans_to_trace(path: str, before_ns: int, spans):
    """Append ``spans`` to the Chrome trace at ``path``, on its clock: the
    offset is the start of PROFILE_MARK there less ``before_ns``, the
    program clock read just before the marker was entered."""
    with open(path) as fh:
        trace = json.load(fh)
    events = trace["traceEvents"]
    (mark,) = [e for e in events if e.get("name") == PROFILE_MARK
               and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    window = (float(mark["ts"]), float(mark["ts"]) + float(mark["dur"]))
    rows = {}                                 # (pid, thread) -> row id
    for s in to_trace(spans, window[0] - before_ns / 1e3, window):
        key = (s["pid"], s["thread"])
        if key not in rows:
            rows[key] = 1 + sum(p == s["pid"] for p, _ in rows)
            who = ("main process" if s["wid"] is None
                   else f"pool worker {s['wid']}")
            events.append({"ph": "M", "name": "thread_name",
                           "pid": s["pid"], "tid": rows[key],
                           "args": {"name": f"spans: {who}, {key[1]}"}})
        events.append({"ph": "X", "cat": "lorikeet_span", "name": s["name"],
                       "pid": s["pid"], "tid": rows[key], "ts": s["t0"],
                       "dur": s["t1"] - s["t0"],
                       "args": {**s["attrs"], "span": s["id"],
                                "parent": s["parent"]}})
    with open(path, "w") as fh:
        json.dump(trace, fh, default=str)


# ---- the span recorder ----
#: None = off: each site costs one attribute check and allocates nothing.
#: A dict = on: {name: seconds} summed over the spans of each name (the
#: stage totals), while each span is also kept in SPANS.
GLOBAL_STAGES = None
#: the spans this process closed while on, in the order they closed, as
#: (name, t0_ns, t1_ns, parent_id, span_id, attrs, (pid, worker id,
#: thread name)); None until the first.  Times are ``perf_counter_ns()``,
#: CLOCK_MONOTONIC on Linux, which a process and the workers it spawns
#: share.  Ids are this process's own; a span's parent is the span open
#: in its thread when it opened (0: none).  A pool worker ships its spans
#: with each result (parallel.pool), and the parent keeps them.
SPANS = None
#: this process's worker id in a span pool (None: not a pool worker)
WORKER = None
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_OFF = contextlib.nullcontext()


def _open_spans() -> list:
    """This thread's stack of open spans."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        _local.where = (os.getpid(), WORKER, threading.current_thread().name)
        return _local.stack


def _record(name, t0, t1, parent, sid, attrs, into=None, stage=True):
    acc = GLOBAL_STAGES
    if acc is None:
        return
    global SPANS
    if stage:
        seconds = (t1 - t0) * 1e-9
        acc[name] = acc.get(name, 0.0) + seconds
        if into is not None:
            acc[into] = acc.get(into, 0.0) + seconds
    if SPANS is None:
        with _lock:
            if SPANS is None:
                SPANS = []
    SPANS.append((name, t0, t1, parent, sid, attrs, _local.where))


class _Span:
    __slots__ = ("name", "into", "attrs", "id", "parent", "t0", "subs")

    def __init__(self, name, into, attrs):
        self.name, self.into, self.attrs = name, into, attrs

    def __enter__(self):
        stack = _open_spans()
        self.parent = stack[-1].id if stack else 0
        self.id = next(_ids)
        self.subs = None
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self.attrs

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _local.stack.pop()
        _record(self.name, self.t0, t1, self.parent, self.id, self.attrs,
                self.into)
        if self.subs:
            # one record a sub-stage: its regions' time laid end to end
            # from this span's start, its count and total in attrs
            t = self.t0
            for name, (n, ns) in self.subs.items():
                _record(name, t, t + ns, self.id, next(_ids),
                        {"count": n, "total_s": ns * 1e-9}, stage=False)
                t += ns
        return False


class _SubStage:
    __slots__ = ("name", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        acc = GLOBAL_STAGES
        if acc is not None:
            acc[self.name] = acc.get(self.name, 0.0) + ns * 1e-9
            stack = _open_spans()
            if stack:
                top = stack[-1]
                if top.subs is None:
                    top.subs = {}
                n, total = top.subs.get(self.name, (0, 0))
                top.subs[self.name] = (n + 1, total + ns)
        return False


def global_stage(name: str, into: str = None, **attrs):
    """A span of the program, as a context: off (GLOBAL_STAGES None) it does
    nothing; on, its seconds are added to GLOBAL_STAGES[name] (and to
    GLOBAL_STAGES[into], a stage this span is a part of, from the same
    reading) and it is kept in SPANS with ``attrs``.  Entering gives the
    attrs dict when on, None when off."""
    if GLOBAL_STAGES is None:
        return _OFF
    return _Span(name, into, attrs)


def substage(name: str):
    """A part of the innermost open span that repeats (one a region): its
    seconds go to GLOBAL_STAGES[name] at once, and the span, when it
    closes, records one span for each sub-stage with the count and total
    seconds, not one for each time it ran."""
    if GLOBAL_STAGES is None:
        return _OFF
    return _SubStage(name)


def add_span(name: str, t0_ns: int, **attrs):
    """Record a span that began at ``t0_ns`` (read whether or not spans
    were on then) and ends now, under the open span of this thread."""
    if GLOBAL_STAGES is None:
        return
    stack = _open_spans()
    _record(name, t0_ns, time.perf_counter_ns(),
            stack[-1].id if stack else 0, next(_ids), attrs)


def annotate(**attrs):
    """Add ``attrs`` to the innermost open span of this thread."""
    if GLOBAL_STAGES is None:
        return
    stack = _open_spans()
    if stack:
        stack[-1].attrs.update(attrs)


def take_spans():
    """This process's spans so far (None: none), and SPANS begun anew."""
    global SPANS
    with _lock:
        spans, SPANS = SPANS, None
    return spans


def merge_spans(spans):
    """Another process's shipped spans into this one's, while on."""
    global SPANS
    if GLOBAL_STAGES is None or not spans:
        return
    with _lock:
        if SPANS is None:
            SPANS = []
        SPANS.extend(spans)


def to_trace(spans, offset_us: float, window=None) -> list:
    """``spans`` (SPANS' tuples) on a trace's clock: dicts with ``t0`` and
    ``t1`` in the trace's microseconds (program ns / 1000 + ``offset_us``),
    ``pid``, ``wid``, ``thread``, ``id``, ``parent`` and ``attrs``.  With
    ``window`` (t0, t1) in the trace's microseconds, each span is cut to
    it and one wholly outside is left out."""
    out = []
    for name, a, b, parent, sid, attrs, (pid, wid, thread) in spans or ():
        t0, t1 = a / 1e3 + offset_us, b / 1e3 + offset_us
        if window is not None:
            if t1 < window[0] or t0 > window[1]:
                continue
            t0, t1 = max(t0, window[0]), min(t1, window[1])
        out.append({"name": name, "t0": t0, "t1": t1, "pid": pid,
                    "wid": wid, "thread": thread, "id": sid,
                    "parent": parent, "attrs": attrs})
    return out
