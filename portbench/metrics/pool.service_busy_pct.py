"""Share of the traced window in which the pool's device service thread
(the program's thread named `device-service`) was inside one of its spans
(the union of their intervals), %."""

from portbench.lib import spans
from portbench.lib.trace import union


def read(record):
    trace = record.get("trace")
    busy = [(s["t0"], s["t1"]) for s in spans.of(record) or ()
            if s["thread"] == "device-service"]
    if not trace or not busy:
        return None
    t0, t1 = trace["window"]
    return 100.0 * sum(b - a for a, b in union(busy)) / (t1 - t0)
