"""The `k2.enqueue` spans (`enqueue_grouped_jobs`: the batch pinned, its
copies in, the launches and the copy back enqueued) in the traced window,
ms a batch."""

from portbench.lib import spans


def read(record):
    ms = [s["t1"] - s["t0"] for s in spans.of(record) or ()
          if s["name"] == "k2.enqueue"]
    return sum(ms) * 1e-3 / len(ms) if ms else None
