"""Gene models for dN/dS runs without a gene finder: prodigal-style GFF3
CDS lines that tile a contig, deterministic in their arguments."""
from __future__ import annotations

import numpy as np


def write_gff(path: str, contig: str, length: int, seed: int = 0) -> str:
    """About one CDS a kilobase over ``contig`` (``length`` bases), on
    alternating strands: each starts 100-250 bases after the one before
    ends and is 600-900 bases long (a multiple of 3, phase 0).  The
    seqname is ``contig`` as given (prodigal names a contig without its
    ``genome~`` prefix).  Returns ``path``."""
    rng = np.random.default_rng(seed)
    lines = ["##gff-version 3"]
    start = 1 + int(rng.integers(100, 250))
    while True:
        end = start + 3 * int(rng.integers(200, 301)) - 1
        if end > length:
            break
        k = len(lines)
        strand = "+" if k % 2 else "-"
        lines.append(f"{contig}\tprodigal\tCDS\t{start}\t{end}\t.\t{strand}"
                     f"\t0\tID={contig}_{k}")
        start = end + 1 + int(rng.integers(100, 250))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path
