#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

For each seed, in one process, a run of the cell with a window of
``seconds``, judged four ways by the cell's own checks and limits:

- ``program``: as the benchmark judges it (the lower readings);
- ``control``: the plain reference computed in bfloat16, the type below
  the float32 that the card's pair-HMM states, put in K2's place on the
  rows the run sampled;
- ``faults``: each of ``lib/faults.py``'s faults planted in every job's
  VCF as the program wrote it.

Each of the last two has to come out not correct.  One JSON line a seed,
each way with its numbers and ``correct``.
"""
import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class Control:
    """The plain reference in ``dtype`` in the place of K2, on the rows a
    K2Watch sampled: the watch's ``samples``, and ``values`` that reads
    the reference instead of the kernel."""

    def __init__(self, watch, dtype, device):
        self.samples = watch.samples
        self._dtype, self._device = dtype, device
        self._at, self._out = {}, None

    def values(self, shares, pick):
        from portbench.reference import pairhmm
        if self._out is None:
            pairs, lo = [], 0
            for sample in self.samples:
                self._at[id(sample[2])] = lo
                pairs += sample[0]
                lo += len(sample[0])
            self._out = pairhmm.forward_log10(pairs, self._dtype,
                                              self._device)
        lo = self._at[id(shares)]
        return self._out[lo:lo + len(pick)]


def readings(cell, answers) -> dict:
    """The control's and each fault's numbers and verdicts."""
    import torch

    from portbench.lib import correct, faults
    bench = os.path.join(cell.root, cell.bench)

    def judged(a):
        ok, shown = correct.judge(correct.numbers(a, cell.limits, bench),
                                  cell.limits)
        return {"correct": ok,
                "checks": {k: v["value"] for k, v in shown.items()}}

    base = {k: answers[k] for k in ("jobs", "failed", "device")}
    # the program's own K2 readings, where a fault leaves them as they were
    same_k2 = {k: answers[k] for k in ("k2", "lk") if k in answers}
    out = {"control": judged({**base, "k2": Control(
        answers["k2"], torch.bfloat16, answers["device"])}), "faults": {}}
    for name, fault in faults.VCF.items():
        jobs = []
        for k, job in enumerate(answers["jobs"]):
            path = f"{job['vcf']}.{name}.{k}"
            shutil.copyfile(job["vcf"], path)
            faults.rewrite(path, fault)
            jobs.append({**job, "vcf": path})
        out["faults"][name] = judged({**base, **same_k2, "jobs": jobs})
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
