"""The device's timeline from ``torch.profiler``'s Chrome trace: what ran on
the card inside the measured window, its union (busy time), and the
largest operations and idle gaps for the result's breakdown."""
from __future__ import annotations

import json

#: trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


def read(path: str) -> dict:
    """{"window": (t0, t1) us, "device": [(name, t0, t1)], "host":
    [(name, t0, t1)]}: the window's marker, the device's operations and
    the host's annotations and operations, from a Chrome trace."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    window, device, host = None, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        span = (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e.get("cat") in DEVICE_CATS:
            device.append(span)
        elif e["name"] == WINDOW and e.get("cat") == "user_annotation":
            window = span[1:]
        elif e.get("cat") in ("user_annotation", "cpu_op"):
            host.append(span)
    if window is None:
        raise ValueError(f"{path}: no {WINDOW} span")
    t0, t1 = window
    device = [(n, max(a, t0), min(b, t1)) for n, a, b in device
              if b > t0 and a < t1]
    return {"window": window, "device": device, "host": host}


def union(spans) -> list:
    """The union of (t0, t1) intervals as sorted, disjoint intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_us(trace: dict) -> float:
    return sum(b - a for a, b in union((a, b) for _, a, b in trace["device"]))


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the shortest host span that covers its middle."""
    by_name = {}
    for name, a, b in trace["device"]:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    t0, t1 = trace["window"]
    busy = union((a, b) for _, a, b in trace["device"])
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = sorted(((edges[k + 1] - edges[k], edges[k])
                   for k in range(0, len(edges) - 1, 2)), reverse=True)[:top]
    named = []
    for length, start in gaps:
        mid = start + length / 2
        covering = [(b - a, n) for n, a, b in trace["host"] if a <= mid <= b]
        named.append([min(covering)[1] if covering else "host, no span",
                      length * 1e-6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
