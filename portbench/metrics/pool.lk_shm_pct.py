"""Share of the pair-HMM batches the pool's workers sent to the device
service that went through the worker's shared-memory segment, %."""


def read(record):
    counts = record["worker_counts"]
    n = counts.get("lk_batches")
    shm = counts.get("lk_shm_batches")
    return 100.0 * shm / n if shm is not None and n else None
