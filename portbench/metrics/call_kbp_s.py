"""Reference kilobases called per second: the genome kbp of every job the
window completed over the window's whole elapsed time (host clock)."""


def read(record):
    return record["kbp"] / record["window_s"] if record["kbp"] else None
