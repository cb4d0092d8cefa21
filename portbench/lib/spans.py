"""The program's own spans on the trace's clock, for the metrics that read
them.

The program (``lorikeet_tpu_torch``) records spans while its stage timing
is on, as it is through a traced run's window: its own, its device
service's and those its pool's workers ship with their results and as the
pool closes, on one clock (``perf_counter_ns``).  A run's record holds
the profiler's trace; the offset between the two clocks is the start of
the harness's ``job 0`` annotation there less the start of the program's
``call`` span of that job, which begins within microseconds of it.
"""
from __future__ import annotations

import re
import sys

#: the harness's annotation of each job of the window in the trace
JOB = re.compile(r"job (\d+) ")
PROGRESS = "lorikeet_tpu_torch.utils.progress"


def of(record: dict) -> list | None:
    """The run's spans, as dicts with ``name``, ``t0``, ``t1`` (the trace's
    us, cut to its window), ``pid``, ``wid`` (None in the program's own
    process), ``thread``, ``id``, ``parent`` and ``attrs``: those the
    record carries, where it does, else the program's own.  None where
    there is no trace or the program records no spans."""
    if "spans" in record:
        return record["spans"]
    trace = record.get("trace")
    return program(trace) if trace else None


def program(trace: dict) -> list | None:
    """The spans of the program loaded in this process on ``trace``'s
    clock, cut to its window; None where it records none."""
    paired = _jobs_and_calls(trace)
    if paired is None:
        return None
    progress, ((job0, _), (call0, _)), _ = paired
    return progress.to_trace(progress.SPANS, job0 - call0, trace["window"])


def clock_skew_ms(trace: dict) -> float | None:
    """How far the two clocks part over the window: the stretch from job
    0's start to the last job's end by the trace's annotations, less the
    same stretch by the program's ``call`` spans, ms."""
    paired = _jobs_and_calls(trace)
    if paired is None:
        return None
    _, ((job0, _), (call0, _)), ((_, job1), (_, call1)) = paired
    return ((job1 - job0) - (call1 - call0)) * 1e-3


def _jobs_and_calls(trace: dict):
    """(the program's progress module, the first job's and the last job's
    (annotation, call span) as (t0, t1) us on their own clocks): the main
    process's last ``call`` spans, one for each job the trace annotates,
    are the window's jobs.  None where the program records no spans."""
    progress = sys.modules.get(PROGRESS)
    raw = getattr(progress, "SPANS", None)
    if getattr(progress, "to_trace", None) is None or not raw:
        return None
    jobs = {}
    for name, a, b in trace["host"]:
        m = JOB.match(name)
        if m:
            jobs[int(m.group(1))] = (a, b)
    calls = sorted((s[1] / 1e3, s[2] / 1e3) for s in raw
                   if s[0] == "call" and s[6][1] is None)
    if 0 not in jobs or len(calls) < len(jobs):
        return None
    calls = calls[-len(jobs):]
    return (progress, (jobs[0], calls[0]),
            (jobs[max(jobs)], calls[-1]))
