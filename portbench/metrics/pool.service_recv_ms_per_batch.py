"""The device service's `service.recv` spans of `"lk"` requests (its read
of a worker's pickled batch from the pipe) in the traced window, ms a
batch."""

from portbench.lib import spans


def read(record):
    ms = [s["t1"] - s["t0"] for s in spans.of(record) or ()
          if s["name"] == "service.recv" and s["attrs"].get("kind") == "lk"]
    return sum(ms) * 1e-3 / len(ms) if ms else None
