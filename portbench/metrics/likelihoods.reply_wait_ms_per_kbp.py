"""The `lk.reply_wait` part of the pair-HMM stage (a worker blocked on the
device service's reply to its batch), summed over the pool's workers, ms
a kbp called."""


def read(record):
    s = record["stages"].get("lk.reply_wait")
    return s * 1e3 / record["kbp"] if s is not None and record["kbp"] else None
