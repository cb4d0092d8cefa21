"""One run of a cell: set-up, the measured window, the check of its answers
and the metrics.

Set-up makes the cell's genomes from the seed (in spawned processes, so
that the program's process never holds the generator's arrays), imports
the program, opens the card and runs one warm-up ``call`` that starts the
program's ``-t`` worker pool.  The window is a closed loop of whole-genome
``call`` jobs, each on input paths no earlier job used and into a new
output directory, and ends when the first job that finishes after
``seconds`` finishes.
"""
from __future__ import annotations

import contextlib
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from portbench.lib import cells, correct, trace
from portbench.lib.cells import Cell

#: top-level module names that may not be loaded when a run ends: JAX and
#: the JAX package the program was ported from
FOREIGN = ("jax", "jaxlib", "flax", "lorikeet_tpu")
#: K2 rows sampled from each K2 batch for the check of its likelihoods
ROWS_A_BATCH = 32


class NoCard(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def foreign_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def _build(args):
    from portbench.gen import dataset
    root, config, mix, seed, index, warmup = args
    return dataset.build(root, config, mix, seed, index, warmup)


def make_data(work: str, cell: Cell, seed: int) -> tuple:
    """(datasets, warm-up dataset), each genome in a spawned process."""
    n = cell.mix["genomes"]
    jobs = [(os.path.join(work, "data"), cell.config, cell.mix, seed, g,
             os.path.join(work, "warmup") if g == 0 else None)
            for g in range(n)]
    with ProcessPoolExecutor(n, mp_context=multiprocessing.get_context(
            "spawn")) as ex:
        built = list(ex.map(_build, jobs))
    return [built[0][0], *built[1:]], built[0][1]


def _link(src: str, dest: str):
    """``src`` at the new path ``dest``: a hard link, so that no bytes are
    written, or a copy where the file system has none."""
    try:
        os.link(src, dest)
    except OSError:
        shutil.copyfile(src, dest)


def job_inputs(work: str, data, j: int) -> tuple:
    """Genome ``data``'s files at paths of job ``j``'s own: (fasta, bams,
    long bams)."""
    root = os.path.join(work, "jobs", str(j))
    os.makedirs(root)
    stem = f"{data.name}_j{j}"
    fasta = os.path.join(root, f"{stem}.fna")
    for ext in ("", ".fai"):
        _link(data.fasta + ext, fasta + ext)
    out = []
    for group in (data.bams, data.long_bams):
        paths = []
        for path in group:
            dest = os.path.join(root, f"{stem}_{os.path.basename(path)}")
            for ext in ("", ".bai"):
                _link(path + ext, dest + ext)
            paths.append(dest)
        out.append(paths)
    return fasta, *out


def _span(profiler, name: str):
    """A named span on the host's timeline of a traced run."""
    if profiler is None:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def call_args(cell: Cell, fasta: str, bams: list, long_bams: list,
              out: str) -> list:
    args = [*cell.config["call_args"], "-r", fasta, "-b", *bams]
    if long_bams:
        args += ["-l", *long_bams]
    return [*args, "-o", out]


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        cards=None, started=None, keep=None) -> dict:
    """One run; returns the result line's object.  ``cards`` (None: the
    machine's CUDA cards, which must number the cell's chips) stand in the
    place of the visible cards: the tests pass CPU devices, on which the
    program runs its plain versions.  ``started`` is
    ``time.perf_counter()`` when the process started, so that set-up
    counts from there (None: from now).  ``keep(answers)``, where given,
    is handed the run's answers (each job's VCF and genome, the K2 watch)
    once the result is made and before the run's files go: the readings
    that set the limits of ``correct`` are taken there."""
    import torch
    t_setup = time.perf_counter() if started is None else started
    if cards is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            raise NoCard(f"{cell.name} needs {cell.chips} CUDA card(s); "
                         f"this machine has {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    else:
        device = torch.device(cards[0])
    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        return _run(cell, seed, seconds, traced, cards, device, work,
                    t_setup, keep)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(cell, seed, seconds, traced, cards, device, work, t_setup,
         keep) -> dict:
    import torch

    datasets, warm = make_data(work, cell, seed)
    from portbench.lib import port
    port.use_cards(cards)
    if device.type == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    port.call(call_args(cell, warm.fasta, warm.bams, warm.long_bams,
                        os.path.join(work, "warmup_out")))
    setup_s = time.perf_counter() - t_setup
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    watch = port.K2Watch(np.random.default_rng(
        [int(seed) & (2 ** 64 - 1), 17]), ROWS_A_BATCH)
    port.reset_counters(stages=traced)
    profiler = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function
        profiler = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
        profiler.start()
        mark = record_function(trace.WINDOW)
        mark.__enter__()
    need_k2 = cell.limits.get("k2_every_job", True)
    jobs, done, failed = [], [], []
    t0 = time.perf_counter()
    try:
        while True:
            j = len(jobs)
            data = datasets[j % len(datasets)]
            fasta, bams, long_bams = job_inputs(work, data, j)
            before = len(watch.batches)
            t_job = time.perf_counter()
            jobs.append(data.name)
            try:
                with _span(profiler, f"job {j} {data.name}"):
                    outputs = port.call(call_args(
                        cell, fasta, bams, long_bams,
                        os.path.join(work, "out", str(j))))
                launched = len(watch.batches) - before
                genomes = outputs.get("genomes", {})
                bad = {g: o for g, o in genomes.items()
                       if "error" in o or o.get("cached")}
                if bad or not genomes or (need_k2 and not launched):
                    raise RuntimeError(
                        f"job {j}: genomes {sorted(genomes)}, failed or "
                        f"cached {bad}, K2 launches {launched}")
                for out in genomes.values():
                    done.append({"vcf": out["vcf"], "data": data,
                                 "s": time.perf_counter() - t_job})
            except Exception as exc:  # noqa: BLE001 — counted, not raised
                failed.append(f"{type(exc).__name__}: {exc}")
                print(f"job {j} failed: {exc}", file=sys.stderr)
            if time.perf_counter() - t0 >= seconds:
                break
    finally:
        window_s = time.perf_counter() - t0
        if profiler is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            mark.__exit__(None, None, None)
            profiler.stop()
        watch.close()
    rss = port.peak_rss_kib()
    memory_peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    counts = port.counters()
    port.shutdown()

    record = {
        "kbp": sum(d["data"].kbp for d in done), "window_s": window_s,
        "job_s": [d["s"] for d in done],
        "setup_s": setup_s, "rss_kib": rss,
        "k2_batches": watch.batches, **counts}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if profiler is not None:
        path = os.path.join(work, "trace.json")
        profiler.export_chrome_trace(path)
        timeline = trace.read(path)
        record["trace"] = timeline
        device_info["busy_s"] = trace.busy_us(timeline) * 1e-6
        device_info["window_s"] = (timeline["window"][1]
                                   - timeline["window"][0]) * 1e-6
        breakdown = trace.breakdown(timeline)

    answers = {"jobs": done, "failed": failed, "k2": watch,
               "device": device}
    bench = os.path.join(cell.root, cell.bench)
    ok, shown = correct.judge(
        correct.numbers(answers, cell.limits, bench), cell.limits)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = cells.reader(m["name"], cell.root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": ok, "attempted": len(jobs), "failed": len(failed),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    tally = correct.vcf_tally(answers)
    result["sampled"] = {
        "lk_rows": correct.likelihood_gap(answers)["rows"],
        **{k: tally[k] for k in ("planted", "called", "missed", "false")},
        "share_bias": tally["share_bias"], "job_s": record["job_s"]}
    if keep is not None:
        keep(answers)
    result["checks"] = shown
    return result
