"""Share of the lanes of the pair-HMM batches the pool's workers packed
for K2 (the planes' rows, pad rows included, times the row width Rpad)
that hold a read base, %."""


def read(record):
    counts = record["worker_counts"]
    slots = counts.get("lk_slots")
    bases = counts.get("lk_bases")
    return 100.0 * bases / slots if bases is not None and slots else None
