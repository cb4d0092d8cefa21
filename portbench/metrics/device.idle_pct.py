"""Share of the traced window in which no kernel, copy or memset ran on
the card (the union of their intervals, not their sum), %."""

from portbench.lib.trace import busy_us


def read(record):
    trace = record.get("trace")
    if not trace:
        return None
    t0, t1 = trace["window"]
    return 100.0 * (1.0 - busy_us(trace) / (t1 - t0))
