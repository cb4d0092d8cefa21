"""The `k2.readback` spans (`readback_grouped`: the wait on a batch's K2
and copies, and its values gathered) in the traced window, ms a batch."""

from portbench.lib import spans


def read(record):
    ms = [s["t1"] - s["t0"] for s in spans.of(record) or ()
          if s["name"] == "k2.readback"]
    return sum(ms) * 1e-3 / len(ms) if ms else None
