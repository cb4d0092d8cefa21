"""A stand-in read mapper for driving the raw-read route without one.

``write_sam`` turns a BAM back into the SAM text a mapper would print for
its reads; ``install_stub_mapper`` writes an executable under a mapper's
binary name (``minimap2``, ``ngmlr``, ...) that prints one of those SAM
files, chosen by the read file named on its command line.  With the stub's
directory first on ``PATH``, ``call --single / -1 -2 / --interleaved /
--longreads`` maps through it, so the cached BAM it writes holds exactly
the records of the source BAM.
"""
from __future__ import annotations

import os
import shlex


def _tag_field(key: str, value) -> str:
    if isinstance(value, bool) or not isinstance(value, (int, float, str)):
        raise ValueError(f"tag {key}: no SAM form for {value!r}")
    if isinstance(value, int):
        return f"{key}:i:{value}"
    if isinstance(value, float):
        return f"{key}:f:{value!r}"
    return f"{key}:Z:{value}"


def write_sam(bam_path: str, sam_path: str) -> str:
    """Every record of ``bam_path``, after its header, as SAM text in
    ``sam_path`` (mate fields and tags included); returns ``sam_path``."""
    from lorikeet_tpu_torch.io.bam import BamReader
    reader = BamReader(bam_path)
    names = reader.references
    header = reader.header_text
    with open(sam_path, "w") as out:
        out.write(header if header.endswith("\n") or not header
                  else header + "\n")
        for r in reader.fetch():
            rname = names[r.tid] if r.tid >= 0 else "*"
            if r.mate_tid < 0:
                rnext = "*"
            else:
                rnext = "=" if r.mate_tid == r.tid else names[r.mate_tid]
            cigar = "".join(f"{n}{op}" for op, n in r.cigar) or "*"
            seq = r.seq.tobytes().decode() if len(r.seq) else "*"
            qual = ("*" if not len(r.qual) or r.qual[0] == 255
                    else (r.qual + 33).tobytes().decode())
            fields = [r.name, str(r.flag), rname, str(r.pos + 1),
                      str(r.mapq), cigar, rnext, str(r.mate_pos + 1),
                      str(r.tlen), seq, qual]
            fields += [_tag_field(k, v) for k, v in r.tags.items()]
            out.write("\t".join(fields) + "\n")
    return sam_path


def install_stub_mapper(bindir: str, name: str, routes: dict) -> str:
    """Write ``bindir/name``, an executable that prints the SAM file
    ``routes[key]`` for the first of its arguments whose base name is
    ``key``, and exits 3 (printing its command line on stderr) when no
    argument has a route.  Returns its path."""
    os.makedirs(bindir, exist_ok=True)
    cases = "".join(f"    {shlex.quote(key)}) exec cat {shlex.quote(sam)} ;;\n"
                    for key, sam in routes.items())
    path = os.path.join(bindir, name)
    with open(path, "w") as fh:
        fh.write("#!/bin/sh\n"
                 'for arg in "$@"; do\n'
                 '  case "${arg##*/}" in\n'
                 f"{cases}"
                 "  esac\n"
                 "done\n"
                 f'echo "stub {name}: no route for: $*" >&2\n'
                 "exit 3\n")
    os.chmod(path, 0o755)
    return path
