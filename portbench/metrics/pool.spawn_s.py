"""The slowest pool worker's start: from its spawn to its first task,
as the worker reports it, s."""


def read(record):
    return max(record["spawn_s"]) if record["spawn_s"] else None
