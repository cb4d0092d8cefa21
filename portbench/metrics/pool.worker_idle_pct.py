"""Share of the pool's workers' time in the traced window that they spent
waiting for a task (`worker.wait_task`): its sum over the workers that
recorded spans, over their number times the window, %."""

from portbench.lib import spans


def read(record):
    trace = record.get("trace")
    ours = [s for s in spans.of(record) or () if s["wid"] is not None]
    if not trace or not ours:
        return None
    t0, t1 = trace["window"]
    idle = sum(s["t1"] - s["t0"] for s in ours
               if s["name"] == "worker.wait_task")
    return 100.0 * idle / (len({s["pid"] for s in ours}) * (t1 - t0))
