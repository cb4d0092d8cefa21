"""The `assemble` sub-stage of `region_prep` (each region's graph build, its
k-best paths and the haplotypes' CIGARs), summed over the pool's workers,
ms a kbp called."""


def read(record):
    s = record["stages"].get("assemble")
    return s * 1e3 / record["kbp"] if s is not None and record["kbp"] else None
