"""Peak resident memory of the process tree: the program's process
(ru_maxrss) plus each live pool worker's VmHWM, read before the pool
closes, MiB."""


def read(record):
    rss = record["rss_kib"]
    return (rss["parent"] + sum(rss["workers"])) / 1024
