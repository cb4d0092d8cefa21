"""Faults planted where the program writes its answers, for the check of
the comparison itself (the CPU tests and ``portbench/control.py``; the
benchmark's own runs plant none).  Each takes a VCF's lines and returns
them as a broken program would have written them."""
from __future__ import annotations


def _records(lines: list) -> list:
    return [k for k, line in enumerate(lines)
            if line and not line.startswith("#")]


def calls_dropped(lines: list) -> list:
    """Every 50th record left out."""
    drop = set(_records(lines)[::50])
    return [line for k, line in enumerate(lines) if k not in drop]


def allele_altered(lines: list) -> list:
    """The last base of the first ALT allele of every 50th record turned
    into another base."""
    out = list(lines)
    for k in _records(lines)[::50]:
        f = out[k].split("\t")
        alt = f[4].split(",")
        alt[0] = alt[0][:-1] + {"A": "C", "C": "G", "G": "T"}.get(
            alt[0][-1], "A")
        f[4] = ",".join(alt)
        out[k] = "\t".join(f)
    return out


def reads_swapped(lines: list) -> list:
    """Sample 1's read counts (AD) of the reference and the first ALT
    allele swapped in every record: the genotyper's answer for one sample
    turned round."""
    out = list(lines)
    for k in _records(lines):
        f = out[k].split("\t")
        keys = f[8].split(":")
        if "AD" not in keys or len(f) < 10:
            continue
        field = f[9].split(":")
        at = keys.index("AD")
        ad = field[at].split(",")
        if len(ad) > 1:
            ad[0], ad[1] = ad[1], ad[0]
            field[at] = ",".join(ad)
            f[9] = ":".join(field)
            out[k] = "\t".join(f)
    return out


VCF = {"calls_dropped": calls_dropped, "allele_altered": allele_altered,
       "reads_swapped": reads_swapped}


def rewrite(path: str, fault) -> None:
    """The VCF at ``path`` rewritten by ``fault``."""
    with open(path) as fh:
        lines = fh.read().split("\n")
    with open(path, "w") as fh:
        fh.write("\n".join(fault(lines)))
