"""Time the card spent in K2 (`grouped_kernel`) over the window, from the
profiler's trace, ms a kbp called."""

K2 = "grouped_kernel"


def read(record):
    trace = record.get("trace")
    if not trace or not record["kbp"]:
        return None
    us = sum(b - a for name, a, b in trace["device"] if K2 in name)
    return us * 1e-3 / record["kbp"] if us else None
