"""The program's `region_prep` stage (read finalize, assembly, graph),
summed over the pool's workers, ms a kbp called."""


def read(record):
    s = record["stages"].get("region_prep")
    return s * 1e3 / record["kbp"] if s is not None and record["kbp"] else None
