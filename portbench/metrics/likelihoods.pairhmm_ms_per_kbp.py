"""The program's `pairhmm` stage (pack, ship, the card's K2, read back,
escalation), summed over the pool's workers, ms a kbp called."""


def read(record):
    s = record["stages"].get("pairhmm")
    return s * 1e3 / record["kbp"] if s is not None and record["kbp"] else None
