"""Pair-HMM batches the pool's workers sent to the parent's device
service, a kbp called."""


def read(record):
    n = record["worker_counts"].get("lk_batches")
    return n / record["kbp"] if n and record["kbp"] else None
