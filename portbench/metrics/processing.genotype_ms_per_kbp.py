"""The `genotype` span (`call_regions_batched` on the pair-HMM's values,
realignment included), summed over the pool's workers, ms a kbp
called."""


def read(record):
    s = record["stages"].get("genotype")
    return s * 1e3 / record["kbp"] if s is not None and record["kbp"] else None
