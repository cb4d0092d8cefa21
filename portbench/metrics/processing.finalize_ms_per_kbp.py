"""The `finalize` sub-stage of `region_prep` (each region's reads clipped
and their qualities adjusted), summed over the pool's workers, ms a kbp
called."""


def read(record):
    s = record["stages"].get("finalize")
    return s * 1e3 / record["kbp"] if s is not None and record["kbp"] else None
