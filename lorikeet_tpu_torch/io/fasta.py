"""Indexed FASTA access (reference genome I/O).

Mirrors the roles of the reference's ``ReferenceReader`` (faidx fetches,
tid<->contig-name<->genome bookkeeping; reference/src/reference/
reference_reader.rs:21-362) and ``ReferenceReaderUtils`` (genome discovery,
faidx generation; reference_reader_utils.rs:37-344) without htslib: the .fai
format is 5 tab columns (name, length, byte offset, bases per line, bytes per
line) and sequences are fetched by direct byte arithmetic.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class FaiEntry:
    name: str
    length: int
    offset: int
    linebases: int
    linewidth: int


def build_fai(path: str) -> list:
    """Generate faidx entries (and write .fai if absent)."""
    entries = []
    with open(path, "rb") as fh:
        name = None
        length = 0
        offset = 0
        linebases = linewidth = 0
        first_line = True
        pos = 0
        for line in fh:
            if line.startswith(b">"):
                if name is not None:
                    entries.append(FaiEntry(name, length, offset, linebases, linewidth))
                name = line[1:].split()[0].decode()
                pos += len(line)
                offset = pos
                length = 0
                first_line = True
            else:
                stripped = line.rstrip(b"\r\n")
                if first_line and stripped:
                    linebases = len(stripped)
                    linewidth = len(line)
                    first_line = False
                length += len(stripped)
                pos += len(line)
        if name is not None:
            entries.append(FaiEntry(name, length, offset, linebases, linewidth))
    fai_path = path + ".fai"
    if not os.path.exists(fai_path):
        try:
            with open(fai_path, "w") as out:
                for e in entries:
                    out.write(f"{e.name}\t{e.length}\t{e.offset}\t{e.linebases}\t{e.linewidth}\n")
        except OSError:
            pass
    return entries


class FastaReader:
    """faidx-style random access; bases returned as upper-case ASCII uint8."""

    def __init__(self, path: str):
        self.path = path
        fai = path + ".fai"
        if os.path.exists(fai):
            self.entries = []
            with open(fai) as fh:
                for line in fh:
                    name, length, offset, lb, lw = line.split("\t")[:5]
                    self.entries.append(FaiEntry(name, int(length), int(offset),
                                                 int(lb), int(lw)))
        else:
            self.entries = build_fai(path)
        self.by_name = {e.name: e for e in self.entries}
        self._fh = open(path, "rb")
        # Validate the index: some shipped .fai files are CRLF-confused (the
        # offset lands on a newline).  Spot-check each entry's first byte and
        # rebuild in memory if stale.
        for e in self.entries:
            self._fh.seek(e.offset)
            b = self._fh.read(1)
            if b in (b"\n", b"\r", b""):
                self.entries = build_fai(path)
                self.by_name = {x.name: x for x in self.entries}
                break

    @property
    def names(self):
        return [e.name for e in self.entries]

    def length(self, name: str) -> int:
        return self.by_name[name].length

    def fetch(self, name: str, start: int = 0, end: int = None) -> np.ndarray:
        e = self.by_name[name]
        if end is None or end > e.length:
            end = e.length
        start = max(0, start)
        if start >= end:
            return np.zeros(0, np.uint8)
        line_start = start // e.linebases
        byte_start = e.offset + line_start * e.linewidth + (start % e.linebases)
        line_end = (end - 1) // e.linebases
        byte_end = e.offset + line_end * e.linewidth + ((end - 1) % e.linebases) + 1
        self._fh.seek(byte_start)
        raw = self._fh.read(byte_end - byte_start)
        arr = np.frombuffer(raw, np.uint8)
        arr = arr[(arr != 10) & (arr != 13)]  # strip newlines
        # upper-case (a..z -> A..Z)
        lower = (arr >= 97) & (arr <= 122)
        arr = np.where(lower, arr - 32, arr).astype(np.uint8)
        assert arr.size == end - start, (arr.size, end - start)
        return arr

    def close(self):
        self._fh.close()


def read_fasta_all(path: str) -> dict:
    """Whole-file load: {contig_name: uint8 ASCII array}."""
    reader = FastaReader(path)
    out = {n: reader.fetch(n) for n in reader.names}
    reader.close()
    return out
