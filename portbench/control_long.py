#!/usr/bin/env python3
"""Readings that the limits of the long-read checks (``share_gap_long``,
``lk_gap_long``) are set from (not run by the benchmark's own runs).

    python3 portbench/control_long.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

For each seed, in one process, a run of the cell, judged as
``control.py`` judges it (the program, the bfloat16 control in K2's place
and each fault of ``lib/faults.py``), and with one fault more:
``long_reads_swapped``, the first long-read sample's read counts (AD) of
the reference and the first ALT allele swapped in every record.  One JSON
line a seed.
"""
import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def reads_swapped_in(column: int):
    """A fault: sample ``column``'s (0 the VCF's first sample) AD of the
    reference and the first ALT allele swapped in every record."""
    def fault(lines: list) -> list:
        out = []
        for line in lines:
            f = line.split("\t")
            if not line or line.startswith("#") or len(f) <= 9 + column:
                out.append(line)
                continue
            keys = f[8].split(":")
            field = f[9 + column].split(":")
            if "AD" in keys and len(field) > keys.index("AD"):
                ad = field[keys.index("AD")].split(",")
                if len(ad) > 1:
                    ad[0], ad[1] = ad[1], ad[0]
                    field[keys.index("AD")] = ",".join(ad)
                    f[9 + column] = ":".join(field)
            out.append("\t".join(f))
        return out
    return fault


def long_readings(cell, answers) -> dict:
    """``control.readings`` and the ``long_reads_swapped`` fault."""
    from portbench import control
    from portbench.lib import correct, faults
    bench = os.path.join(cell.root, cell.bench)
    out = control.readings(cell, answers)
    short = len(answers["jobs"][0]["data"].fractions) if answers["jobs"] \
        else 2
    fault = reads_swapped_in(short)
    jobs = []
    for k, job in enumerate(answers["jobs"]):
        path = f"{job['vcf']}.long_reads_swapped.{k}"
        shutil.copyfile(job["vcf"], path)
        faults.rewrite(path, fault)
        jobs.append({**job, "vcf": path})
    a = {**{k: answers[k] for k in ("failed", "device", "k2", "lk")
            if k in answers}, "jobs": jobs}
    ok, shown = correct.judge(correct.numbers(a, cell.limits, bench),
                              cell.limits)
    out["faults"]["long_reads_swapped"] = {
        "correct": ok, "checks": {k: v["value"] for k, v in shown.items()}}
    return out


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
            keep=lambda answers: kept.update(long_readings(cell, answers)))
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
