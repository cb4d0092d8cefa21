"""The comparison that decides ``correct`` fails when it should, at a size
a CPU test holds: the control (the plain reference in bfloat16, the type
below the float32 that K2 states, in K2's place) and every planted fault
come out not correct through the cell's own checks and limits, where the
program's answers come out correct.  At each cell's own size the same
readings are taken on the card by ``portbench/control.py``."""
import importlib
import json
import os

import numpy as np
import pytest

from portbench import control
from portbench.lib import cells, faults
from portbench.tests import tiny

CELLS = [w["name"] for w in json.load(open(os.path.join(
    cells.ROOT, "BENCHMARK.json")))["workloads"]]


def _failing(checks: dict) -> set:
    return {k for k, v in checks.items()
            if not np.isfinite(v["value"]) or v["value"] > v["limit"]}


@pytest.fixture(scope="module", params=CELLS)
def readings(request, tmp_path_factory):
    """(cell, the run's result, control.py's readings of it)."""
    root = tiny.tree(str(tmp_path_factory.mktemp("control")))
    cell = cells.load(request.param, root)
    kept = {}
    out = tiny.run(root, request.param,
                   keep=lambda a: kept.update(control.readings(cell, a)))
    return cell, out, kept


def test_program_is_correct(readings):
    _, out, _ = readings
    assert out["correct"], out["checks"]
    assert out["sampled"]["lk_rows"] > 0 and out["sampled"]["planted"] > 0


def test_control_is_not_correct(readings):
    cell, _, kept = readings
    got = kept["control"]
    assert not got["correct"]
    assert got["checks"]["lk_gap"] > cell.limits["checks"]["lk_gap"]


#: each fault planted in the VCFs and the checks it has to fail
VCF_CATCHES = {"calls_dropped": {"vcf_missed"},
               "allele_altered": {"vcf_missed", "vcf_false"},
               "reads_swapped": {"share_gap"}}


@pytest.mark.parametrize("fault", list(faults.VCF))
def test_vcf_fault_is_not_correct(readings, fault):
    cell, _, kept = readings
    got = kept["faults"][fault]
    limits = cell.limits["checks"]
    assert not got["correct"]
    failing = {k for k, v in got["checks"].items()
               if not np.isfinite(v) or v > limits[k]}
    assert VCF_CATCHES[fault] <= failing


def _half_left_out(real):
    """K2 that computes the first half of a batch's blocks and gives the
    rest the mean of those values."""
    def k2(t, card=0):
        out = real(t, card).clone()
        half = out.numel() // 64 * 32
        out[half:] = out[:half].mean()
        return out
    return k2


def _answers_altered(real):
    """K2 with one answer in eight (row 0 of every eight of a tile)
    altered by 0.5 where it is produced."""
    def k2(t, card=0):
        out = real(t, card).clone()
        out[::8] += 0.5
        return out
    return k2


def _vcf_written(fault):
    """The program's VCF writer with ``fault`` planted in what it
    writes."""
    def wrap(real):
        def write(path, *args, **kwargs):
            result = real(path, *args, **kwargs)
            faults.rewrite(path, fault)
            return result
        return write
    return wrap


FAULTS = {"half_left_out": ("ops.pairhmm_cuda", "pairhmm_grouped_cuda",
                            _half_left_out, {"lk_gap"}),
          "answers_altered": ("ops.pairhmm_cuda", "pairhmm_grouped_cuda",
                              _answers_altered, {"lk_gap"}),
          **{name: ("processing", "write_vcf", _vcf_written(fault),
                    VCF_CATCHES[name])
             for name, fault in faults.VCF.items()}}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_broken_path_is_not_correct(tmp_path, monkeypatch, fault):
    """The rest of a run (no card asked for) with the timed path broken
    underneath: ``correct`` comes out false, on the number that should
    catch it."""
    where, name, broken, catches = FAULTS[fault]
    module = importlib.import_module("lorikeet_tpu_torch." + where)
    monkeypatch.setattr(module, name, broken(getattr(module, name)))
    root = tiny.tree(str(tmp_path))
    out = tiny.run(root, "short_strains_dense")
    assert not out["correct"]
    assert catches <= _failing(out["checks"])
