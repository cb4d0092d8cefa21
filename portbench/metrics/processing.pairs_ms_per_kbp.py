"""The `pairs` sub-stage of `region_prep` (`build_pairs`: each region's
read-haplotype pairs and their qualities), summed over the pool's
workers, ms a kbp called."""


def read(record):
    s = record["stages"].get("pairs")
    return s * 1e3 / record["kbp"] if s is not None and record["kbp"] else None
