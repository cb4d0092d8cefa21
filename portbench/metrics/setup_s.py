"""The whole set-up before the window, from the process's start: the
interpreter, torch and the program imported, the data generated, the card
opened and the warm-up call that starts the -t worker pool (host clock)."""


def read(record):
    return record["setup_s"]
