"""The `lk.pack` part of the pair-HMM stage (`prepare_grouped_jobs`, the
worker's packing of its span's batch), summed over the pool's workers, ms
a kbp called."""


def read(record):
    s = record["stages"].get("lk.pack")
    return s * 1e3 / record["kbp"] if s is not None and record["kbp"] else None
