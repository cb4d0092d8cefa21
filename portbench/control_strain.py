#!/usr/bin/env python3
"""Readings that the limits of the strain checks (``strain_impure``,
``strain_em_gap``, ``strain_count_gap``, ``strain_share_gap``) are set
from (not run by the benchmark's own runs).

    python3 portbench/control_strain.py --workload genotype_strains12 \\
        --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process, a run of the cell with a window of
``seconds``, judged by the cell's own checks and limits as the benchmark
judges it (``program``, the lower readings) and with each of FAULTS
planted in a copy of every job's annotated VCF and strain table (the
upper readings), each of which has to come out not correct:

- ``groups_permuted``: the ``VG`` labels of the split records permuted
  across the records, so that the groups no longer follow the strains;
- ``abundances_permuted``: each sample's abundances in the strain table
  moved one strain on (strain k given strain k + 1's, the last the
  first's);
- ``strains_merged``: every variant group linked into one strain, as a
  program writes that links them all: each split record's ``ST`` made
  0 and the strain table one strain of abundance 1 in every sample.

One JSON line a seed.
"""
import argparse
import json
import os
import re
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

VG = re.compile(r"(^|;)VG=(-?\d+)")
ST = re.compile(r"(^|;)ST=([\d,]+)")


def groups_permuted(lines: list, seed: int = 0) -> list:
    """A VCF's lines with the ``VG`` values of its records permuted
    across them (a seeded shuffle)."""
    import numpy as np
    at = [k for k, line in enumerate(lines)
          if line and not line.startswith("#")
          and VG.search(line.split("\t")[7])]
    labels = [VG.search(lines[k].split("\t")[7]).group(2) for k in at]
    order = np.random.default_rng(seed).permutation(len(labels))
    out = list(lines)
    for k, label in zip(at, [labels[i] for i in order]):
        f = out[k].split("\t")
        f[7] = VG.sub(lambda m: f"{m.group(1)}VG={label}", f[7])
        out[k] = "\t".join(f)
    return out


def abundances_permuted(lines: list) -> list:
    """A strain table's lines with each row's abundances those of the row
    after it (the last row's the first's)."""
    rows = [line.split("\t") for line in lines[1:] if line]
    moved = [[r[0], *rows[(k + 1) % len(rows)][1:]]
             for k, r in enumerate(rows)]
    return [lines[0], *("\t".join(r) for r in moved), ""]


def strains_merged(lines: list) -> list:
    """A VCF's lines with every ``ST`` made 0."""
    out = []
    for line in lines:
        if line and not line.startswith("#"):
            f = line.split("\t")
            f[7] = ST.sub(lambda m: f"{m.group(1)}ST=0", f[7])
            line = "\t".join(f)
        out.append(line)
    return out


def one_strain(lines: list) -> list:
    """A strain table's lines made one strain of abundance 1 in every
    sample."""
    samples = lines[0].split("\t")[1:]
    return [lines[0], "\t".join(["strain_0", *("1.000000" for _ in samples)]),
            ""]


def _rewrite(src: str, dest: str, fault):
    with open(src) as fh:
        lines = fh.read().split("\n")
    with open(dest, "w") as fh:
        fh.write("\n".join(fault(lines)))


def faulted(job: dict, name: str) -> dict:
    """A job with ``name``'s fault planted in copies of its VCF and strain
    table, written side by side into a directory of their own."""
    from portbench.reference import strain
    vcf, table = job["vcf"], strain.coverages_of(job["vcf"])
    root = f"{os.path.dirname(vcf)}.{name}"
    os.makedirs(root, exist_ok=True)
    out_vcf = os.path.join(root, os.path.basename(vcf))
    out_table = os.path.join(root, os.path.basename(table))
    if name == "groups_permuted":
        _rewrite(vcf, out_vcf, groups_permuted)
        shutil.copyfile(table, out_table)
    elif name == "strains_merged":
        _rewrite(vcf, out_vcf, strains_merged)
        _rewrite(table, out_table, one_strain)
    else:
        shutil.copyfile(vcf, out_vcf)
        _rewrite(table, out_table, abundances_permuted)
    return {**job, "vcf": out_vcf}


FAULTS = ("groups_permuted", "abundances_permuted", "strains_merged")


def readings(cell, answers) -> dict:
    """Each fault's numbers and verdict."""
    from portbench.lib import correct
    bench = os.path.join(cell.root, cell.bench)
    out = {}
    for name in FAULTS:
        jobs = [faulted(job, name) for job in answers["jobs"]]
        ok, shown = correct.judge(correct.numbers(
            {**answers, "jobs": jobs}, cell.limits, bench), cell.limits)
        out[name] = {"correct": ok,
                     "checks": {k: v["value"] for k, v in shown.items()}}
    return {"faults": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    from portbench.lib import cells, harness
    cell = cells.load(args.workload)
    for seed in args.seeds:
        kept = {}
        result = harness.run(
            cell, seed, args.seconds, False,
            keep=lambda answers: kept.update(readings(cell, answers)))
        print(json.dumps({
            "workload": cell.name, "seed": seed,
            "program": {"correct": result["correct"],
                        "checks": {k: v["value"] for k, v in
                                   result["checks"].items()}},
            **kept, "sampled": result["sampled"],
            "metrics": result["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
