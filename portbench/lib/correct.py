"""Whether a run's answers are right.

The numbers a cell compares, and the limit of each, are its
``limits/<cell>.json`` (``{"checks": {name: limit}, "k2_every_job":
bool}``); each number is read from the run's answers by
``checks/<name>.py``, found by that name, so a cell that needs another
check brings its reader as a new file.  The readers share what is here:
each job's VCF against the planted variants, and a seeded sample of K2's
likelihoods against the plain reference in float64.
"""
from __future__ import annotations

import importlib.util
import os

import numpy as np

from portbench.reference import pairhmm, truth

#: rows at or below this log10 likelihood the program recomputes in
#: float64 itself, whatever K2 returned (its escalation rule)
ESCALATED_AT = -28.0


def likelihood_gap(answers: dict) -> dict:
    """The widest |log10 K2 - log10 reference| over the sampled rows whose
    reference value lies above ESCALATED_AT (a value K2 left non-finite
    counts as infinitely wide).  ``answers["k2"]`` is the run's K2Watch:
    its ``samples`` [(pairs, pick, shares)] and its reader ``values(shares,
    pick)`` of the kernel's outputs.  Kept on ``answers``."""
    import torch
    if "lk" in answers:
        return answers["lk"]
    watch, device = answers["k2"], answers["device"]
    pairs = [p for s in watch.samples for p in s[0]]
    if not pairs:
        answers["lk"] = {"rows": 0, "value": float("inf")}
        return answers["lk"]
    want = pairhmm.forward_log10(pairs, torch.float64, device)
    got = np.concatenate([watch.values(shares, pick)
                          for _, pick, shares in watch.samples])
    kept = want > ESCALATED_AT
    gap = np.abs(np.where(np.isfinite(got), got, np.inf) - want)[kept]
    answers["lk"] = {"rows": int(kept.sum()),
                     "value": float(gap.max()) if gap.size else float("inf")}
    return answers["lk"]


def vcf_tally(answers: dict) -> dict:
    """Over the jobs [{"vcf", "data"}] of ``answers``: planted variants,
    alleles called, planted ones missed, called ones not planted, summed;
    and ``share_bias``, each job's mean share bias of each sample (see
    ``truth.compare``).  Kept on ``answers``."""
    if "vcf" not in answers:
        total = {"planted": 0, "called": 0, "missed": 0, "false": 0,
                 "share_bias": []}
        for job in answers["jobs"]:
            data = job["data"]
            got = truth.compare(job["vcf"], data.contigs, data.truth,
                                data.fractions)
            for k in ("planted", "called", "missed", "false"):
                total[k] += got[k]
            total["share_bias"].append(got["share_bias"])
        answers["vcf"] = total
    return answers["vcf"]


def reader(name: str, bench: str):
    """``read(answers) -> float`` of ``checks/<name>.py`` under the
    benchmark's folder ``bench``."""
    path = os.path.join(bench, "checks", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_check_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def numbers(answers: dict, limits: dict, bench: str) -> dict:
    """{name: value} of every check the cell's ``limits`` name."""
    return {name: reader(name, bench)(answers)
            for name in limits["checks"]}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit."""
    shown = {k: {"value": numbers[k], "limit": v}
             for k, v in limits["checks"].items()}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in shown.values())
    return ok, shown
