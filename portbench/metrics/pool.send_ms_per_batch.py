"""The `lk.send` part of the pair-HMM stage (a worker's send of its batch
to the device service, which returns once the service has read it) over
the `"lk"` requests the workers sent, ms a batch."""


def read(record):
    s = record["stages"].get("lk.send")
    n = record["worker_counts"].get("lk_batches")
    return s * 1e3 / n if s is not None and n else None
