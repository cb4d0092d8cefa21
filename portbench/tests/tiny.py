"""A benchmark tree in a temporary directory whose cells are cut to a size
that a CPU test holds, and a run of it on the CPU in place of the card."""
from __future__ import annotations

import json
import os
import shutil

from portbench.lib import cells

#: what a tiny cell keeps of its configuration
TINY = {"contigs": 2, "contig_kbp": 4, "call_args": ["call", "-t", "2"]}


def tree(dest: str, **config_changes) -> str:
    """A copy of the benchmark's data files and readers under
    ``dest``, every configuration cut to TINY; returns ``dest``."""
    spec = json.load(open(os.path.join(cells.ROOT, "BENCHMARK.json")))
    bench = os.path.join(dest, spec["paths"][0])
    for sub in ("checks", "metrics", "traffic", "limits"):
        shutil.copytree(os.path.join(cells.HERE, sub),
                        os.path.join(bench, sub))
    for conf in spec["configs"]:
        with open(os.path.join(cells.ROOT, conf["file"])) as fh:
            config = json.load(fh)
        config.update(TINY, **config_changes)
        path = os.path.join(dest, conf["file"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(config, fh)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return dest


def run(root: str, cell: str, seed: int = 12345, seconds: float = 0.0,
        traced: bool = False, keep=None) -> dict:
    """One run of ``cell`` of the tree at ``root`` on the CPU (the
    program's plain versions in the card's place)."""
    import torch

    from portbench.lib import harness
    return harness.run(cells.load(cell, root), seed, seconds, traced,
                       cards=[torch.device("cpu")], keep=keep)
