"""Persistent span-worker pool and the parent's CUDA device service.

Counterpart of lorikeet_tpu/parallel/pool.py.  The reference scales one
genome over cores with rayon (src/assembly/assembly_region_walker.rs:139-141
region fan-out under the global pool of src/bin/lorikeet.rs:29-32).  Here:

- N long-lived worker PROCESSES (``spawn``, never ``fork``: the parent holds
  a CUDA context), reused across chunks, contigs and genomes, run the host
  stages of each chunk span: BAM decode, activity profile, assembly,
  genotyping.  A worker holds no card: it starts with an empty
  CUDA_VISIBLE_DEVICES, and nothing it runs initialises CUDA.
- The PARENT owns the cards.  With a device service, a thread of the
  parent with a CUDA stream of its own on each device of the run's list
  (parallel.sharding.get_devices) runs every worker's pair-HMM batch on the
  grouped kernel, its table blocks split over the list (``"lk"``); when the
  run takes the device activity chain (``cfg.device_activity``), every
  span's chain, split by position over the same list (``"act"``; the CPU
  under ``--force-cpu``); on a run on cards, each span's haplotype
  CIGARs' SW (``"hsw"``: processing._span_hap_cigars) on the SW kernel,
  on the first card; and, under ``--pallas-sw``, every realignment SW
  batch there too (``"sw"``).  A worker packs its batch on its own CPU
  (``prepare_grouped_jobs``), sends it, prepares its next span while the
  card computes, then genotypes on the reply: one outstanding request per
  worker, replies in the order each worker sent its requests.  A pair
  batch's arrays travel in a shared-memory segment the worker owns, only
  their header on the pipe (``parallel.shm``); the service maps the batch
  while it enqueues it.  A ``"hsw"`` batch travels so too, and its reply
  is the kernel's CIGAR codes, which the worker decodes.  ``"act"`` and
  ``"sw"`` requests are pickled.
- A worker packs in the wire form (4-bit bases and a u8 codebook index a
  lane, decoded on the card) when the parent's gate says so
  (``pairhmm_cuda._wire_enabled``: ``LORIKEET_WIRE_COMPRESS``, or under
  ``auto`` the parent's measured host-to-card rate below 2 GB/s), read
  once when the pool starts and handed to each worker.  The JAX package's
  workers always pack so; here the link decides for them as for the
  parent.
- Every pair batch of a run on cards goes to the service; the workers'
  f64 host kernel runs only under ``--force-cpu`` (``likelihoods``: one
  rule for where a pair batch runs).
- No fallback hides the card: a failed launch or readback is an error
  reply, the worker raises ("device service failed"), and ``gather``
  raises in the parent.  Without a service (``--force-cpu`` and no
  ``--pallas-sw``) the workers compute the f64 pair-HMM themselves and the
  pool is a persistent chunk-process map.

A span's genotyping starts from the upstream deletions that the serial loop
would carry into it (``carry_deletions``): each result reports the sites its
genotyping checked against them and the deletions it leaves, and
``gather_contig`` reruns, with the carried deletions, the rare span where
one of them covers a site.  So a contig's calls at any ``-t`` are those of
``-t 1``.

Workers' counters cross back with each result (pair batches run on a
worker's host, ESCALATIONS, GLOBAL_STAGES seconds, the spans recorded
since the last result, requests sent) and the parent adds them to its
own; LAUNCHES, CARD_LAUNCHES, WIRE_LAUNCHES, WIRE_COUNTS, SW_LAUNCHES,
SW_COUNTS and DISPATCH_COUNTS["remote"] move in the parent, where the
service runs the kernels.

Not ported from the JAX module: its cold-bucket bounce (nvcc builds each
kernel once, at first use), its ``device_dead`` bounce, which would send a
failing card's batches to the workers' hosts and hide the failure, and its
in-flight depth probe (``LORIKEET_SERVICE_INFLIGHT``): a CUDA stream orders
two enqueued jobs by itself, so the probe would check nothing, and on the
H100 the depths 1 and 2 gave the same walls; the depth is SERVICE_DEPTH.
"""
from __future__ import annotations

import atexit
import os
import threading
import time
import traceback

_POOLS = {}           # key -> SpanWorkerPool (small LRU; see get_pool)
_MAX_POOLS = 2        # idle workers cost no CPU, but each holds BAM caches
#: "lk" jobs the service keeps enqueued on its streams: it waits on the
#: oldest once this many are in flight, so that the copies and the kernels
#: of one job overlap the readback of the one before
SERVICE_DEPTH = 2
#: the variable a pool reads when it starts (the wire gate): a pool is
#: kept for one setting of it (see get_pool)
WIRE_ENV = "LORIKEET_WIRE_COMPRESS"
#: requests the workers sent to the device service, added up by
#: ``gather``: pair batches, those of them that went through the worker's
#: shared-memory segment, SW batches, spans' activity chains, spans'
#: haplotype SW batches; what the pair batches held: read rows, those of
#: long-read samples, lanes (the planes' rows, pad rows included, times
#: Rpad) and the read bases in them; the spans' haplotype CIGARs, the
#: SW alignments they took and those the card ran (processing.HAP_COUNTS);
#: and the assembly graphs that reached the seq-graph step and those the
#: native builder zipped (assembly.graph.ASM_COUNTS).  The strain layer
#: of ``genotype`` counts here too, in the parent: the split contexts it
#: clustered, those given a variant group, the groups and the strains
#: (processing adds them from strain.genotype_mode.run_genotype's outputs)
WORKER_COUNTS = {"lk_batches": 0, "lk_shm_batches": 0, "sw_batches": 0,
                 "act_spans": 0, "hsw_batches": 0, "lk_rows": 0,
                 "lk_long_rows": 0, "lk_slots": 0, "lk_bases": 0,
                 "hap_cigars": 0, "hap_sw": 0, "hap_sw_card": 0,
                 "asm_graphs": 0, "asm_native_zip": 0,
                 "strain_contexts": 0, "strain_clustered": 0,
                 "strain_groups": 0, "strain_strains": 0}
#: spans ``gather_contig`` ran again because a deletion carried from the
#: spans before covered a site there
SPAN_RERUNS = {"spans": 0}
#: pid -> what that worker last reported: its id, the seconds from its
#: spawn to the end of its imports, whether it imported torch and whether
#: torch's CUDA is initialised in it, and any module of jax or of the JAX
#: package it holds
WORKER_REPORTS = {}
#: held while the environment is changed for a spawn
_SPAWN_LOCK = threading.Lock()
_FOREIGN = ("jax", "jaxlib", "lorikeet_tpu", "bench_e2e")


def _worker_main(wid, cfg, task_q, result_q, rpc_conn, t_spawn, wire,
                 hap_sw):
    """Worker process entry: persistent readers, span loop.  With
    ``rpc_conn`` the pair-HMM batches of a ``use_cuda`` run (in the wire
    form when ``wire``), the haplotype SW batches of its spans when
    ``hap_sw`` (the parent's ``processing._hap_sw_device``), the activity
    chains of a ``device_activity`` run and the SW batches of a
    ``use_cuda_sw`` run go to the parent's device service.
    Readers are cached per (fasta, bams) input set so one pool serves many
    genomes without re-decoding.  ``t_spawn`` is the parent's clock at the
    spawn, for the worker's start-up seconds.  It holds no card: the
    parent spawned it with CUDA_VISIBLE_DEVICES empty."""
    import queue as _q
    import sys

    import numpy as np

    from lorikeet_tpu_torch import processing
    from lorikeet_tpu_torch.assembly import graph as asm_graph
    from lorikeet_tpu_torch.calling import likelihoods as L
    from lorikeet_tpu_torch.calling import realign
    from lorikeet_tpu_torch.calling.engine import (
        HaplotypeCallerEngine, call_regions_batched,
    )
    from lorikeet_tpu_torch.io.bam import open_bam
    from lorikeet_tpu_torch.io.fasta import FastaReader
    from lorikeet_tpu_torch.ops import pairhmm as PH
    from lorikeet_tpu_torch.processing import _call_span
    from lorikeet_tpu_torch.utils import progress

    progress.WORKER = wid
    stage = progress.global_stage
    on_card = rpc_conn is not None and cfg.use_cuda is not False
    if on_card:
        from lorikeet_tpu_torch.ops.pairhmm_pack import (
            prepare_grouped_jobs, row_width,
        )
        from lorikeet_tpu_torch.parallel.shm import WorkerSegment
        segment = WorkerSegment()          # its memfd made at the first batch
        # the samples of long-read BAMs (after the short ones)
        long_samples = [s for s, kind in enumerate(cfg.read_types or ())
                        if kind == "long"]
    # from the spawn to here: an interpreter and this package's host
    # modules; no torch (the packer is numpy only, the card the parent's)
    spawn_s = time.time() - t_spawn
    sent = dict.fromkeys(WORKER_COUNTS, 0)
    readers = {}                           # (fasta, bams) -> state, max 2

    def _readers_for(fasta_path, bam_paths):
        key = (fasta_path, tuple(bam_paths))
        state = readers.get(key)
        if state is None:
            if len(readers) >= 2:          # bound decoded-BAM memory
                readers.pop(next(iter(readers)))
            # the open_bam size heuristic is per FILE; a worker holds every
            # sample at once, so stream when the AGGREGATE would blow the
            # eager budget
            high_mem = getattr(cfg, "high_memory", False)
            streaming = None
            if not high_mem:
                try:
                    total = sum(os.path.getsize(p) for p in bam_paths)
                except OSError:
                    total = 0
                threshold = int(os.environ.get(
                    "LORIKEET_EAGER_BAM_MAX", str(256 * 1024 * 1024)))
                if total > threshold:
                    streaming = True
            # the FASTA's index and each BAM inflated, its header read (its
            # records are parsed at their first use, in the span's profile)
            with stage("bam_open", bams=len(bam_paths)):
                state = (FastaReader(fasta_path),
                         [open_bam(p, high_memory=high_mem,
                                   streaming=streaming)
                          for p in bam_paths])
            readers[key] = state
        return state

    def _service(kind, payload):
        """One request to the parent's device service and its reply."""
        rpc_conn.send((kind, payload, None))
        return _reply()

    def _reply():
        status, payload = rpc_conn.recv()
        if status != "ok":
            raise RuntimeError(f"device service failed: {payload}")
        return payload

    def _device_sw(pairs, parameters, strategy):
        # realignment runs inside genotyping, which runs only once this
        # worker's "lk" reply is in: no request of its own is outstanding
        sent["sw_batches"] += 1
        return _service("sw", (pairs, parameters, strategy))

    def _take_pending():
        # a span's activity chain and its haplotype SW run before its pair
        # batch is sent, while the span before may still wait on its "lk"
        # reply: that reply comes first on the pipe, so it is taken (and
        # that span genotyped) before such a request goes out
        nonlocal pending
        if pending is not None:
            _finish(pending)
            pending = None

    def _device_activity(*args):
        _take_pending()
        sent["act_spans"] += 1
        return _service("act", args)

    def _device_hap_sw(pairs, parameters, strategy):
        def run(chunks):
            # each chunk's packed table and sequences through the segment,
            # its host sizes in the header; the reply is each chunk's
            # CIGARs in sw_cuda.compact's form
            arrays = {"sizes": [{k: c[k] for k in HOST_SIZES}
                                for c in chunks],
                      "parameters": parameters, "strategy": strategy}
            for i, c in enumerate(chunks):
                arrays[f"seqs.{i}"], arrays[f"meta.{i}"] = c["seqs"], \
                    c["meta"]
            _take_pending()
            segment.put(rpc_conn, "hsw", arrays, None)
            sent["hsw_batches"] += 1
            return _reply()
        return align_batch_rows(pairs, parameters, strategy, run)

    if rpc_conn is not None:
        realign.DEVICE_SW_BATCH = _device_sw
        processing.DEVICE_ACTIVITY = _device_activity
    if on_card and hap_sw:
        from lorikeet_tpu_torch.ops.sw_cuda import HOST_SIZES, align_batch_rows
        processing.DEVICE_HAP_SW = _device_hap_sw

    def _put(tid, res, engine):
        geno = engine.genotyping
        res = (res, geno.deletion_checks, geno._upstream_dels)
        for key, n in processing.HAP_COUNTS.items():
            sent[key] += n
            processing.HAP_COUNTS[key] = 0
        for key, n in asm_graph.take_asm_counts().items():
            sent[key] += n
        stages = progress.GLOBAL_STAGES
        counters = {"host": L.DISPATCH_COUNTS["host"],
                    "escalations": dict(PH.ESCALATIONS),
                    "stages": stages, "spans": progress.take_spans(),
                    **sent}
        L.DISPATCH_COUNTS["host"] = 0
        PH.ESCALATIONS.update(dict.fromkeys(PH.ESCALATIONS, 0))
        sent.update(dict.fromkeys(sent, 0))
        progress.GLOBAL_STAGES = {} if stages is not None else None
        torch = sys.modules.get("torch")
        counters["report"] = {
            "pid": os.getpid(), "wid": wid, "spawn_s": spawn_s,
            "torch_imported": torch is not None,
            "cuda_initialized": bool(torch is not None
                                     and torch.cuda.is_initialized()),
            "foreign_modules": sorted(
                m for m in sys.modules if m.split(".")[0] in _FOREIGN)}
        result_q.put((tid, "ok", (res, counters)))

    def _genotype(res, engine, works, lks):
        if works:
            with stage("genotype"):
                for calls in call_regions_batched(engine, works, lks):
                    res.calls.extend(calls)

    # ---- async span pipeline (pair-HMM on the parent's card) -------------
    # pack span N's pair batch here, ship it to the parent's card, prepare
    # span N+1 while it computes, then check + genotype N on the reply.
    # With spans on, span N's end (the reply, the check, the genotyping)
    # is the span ``worker.finish`` of its tid, inside whatever this worker
    # runs then.
    pending = None                 # (tid, res, engine, works)

    def _finish(p):
        tid2, res2, engine2, works2 = p
        try:
            with stage("worker.finish", tid=tid2):
                with stage("lk.reply_wait", into="pairhmm"):
                    payload = _reply()
                with stage("lk.checked", into="pairhmm"):
                    pairs = [pp for w in works2 for pp in w.pairs]
                    lks = PH.pairhmm_forward_checked(payload, pairs)
                _genotype(res2, engine2, works2, lks)
            _put(tid2, res2, engine2)
        except Exception:  # noqa: BLE001 — surface to the parent
            result_q.put((tid2, "error", traceback.format_exc()))

    while True:
        t_wait = time.perf_counter_ns()
        if pending is not None:
            try:
                task = task_q.get_nowait()
            except _q.Empty:
                _finish(pending)
                pending = None
                continue
        else:
            task = task_q.get()
        if task[0] == "stop":
            if pending is not None:
                _finish(pending)
                pending = None
            if task[1]:
                # the spans since this worker's last result: the parent
                # keeps them while it closes the pool
                if progress.GLOBAL_STAGES is None:
                    progress.GLOBAL_STAGES = {}
                progress.add_span("worker.wait_task", t_wait)
                result_q.put((None, "spans", progress.take_spans()))
            break
        tid, fasta_path, bam_paths, contig, sp, stages_on, carried = task
        if not stages_on:
            progress.GLOBAL_STAGES = None
        elif progress.GLOBAL_STAGES is None:
            progress.GLOBAL_STAGES = {}
        progress.add_span("worker.wait_task", t_wait)
        try:
            done = None
            with stage("worker.task", tid=tid, contig=contig, lo=sp[0],
                       hi=sp[1]):
                # announce pickup so the parent can requeue this task if we
                # die mid-span (crash tolerance; reference analogue: the
                # per-genome try/continue of lorikeet_engine.rs:100)
                result_q.put((tid, "start", wid))
                # a fresh engine per span, its genotyping state (upstream
                # deletions) the one the parent carried in: the calls then
                # never depend on which spans this worker ran before
                engine = HaplotypeCallerEngine(cfg)
                engine.genotyping._upstream_dels = list(carried)
                engine.genotyping.deletion_checks = []
                fasta, bams = _readers_for(fasta_path, bam_paths)
                if not on_card:
                    done = _call_span(fasta, bams, contig, cfg, engine, *sp)
                else:
                    res, works = _call_span(fasta, bams, contig, cfg,
                                            engine, *sp, defer=True)
                    pairs = [p for w in works for p in w.pairs]
                    if pairs:
                        with stage("lk.pack", into="pairhmm") as attrs:
                            job = prepare_grouped_jobs(pairs, wire=wire)
                        # a work's pairs are each of its reads against
                        # each haplotype, one packed row a read
                        arrays = job[0]
                        lens = arrays["read_lens"]
                        rpad = row_width(arrays)
                        rows = int(np.count_nonzero(lens))
                        long_rows = sum(len(w.reads_by_sample.get(s, ()))
                                        for w in works for s in long_samples)
                        sent["lk_rows"] += rows
                        sent["lk_long_rows"] += long_rows
                        sent["lk_slots"] += lens.size * rpad
                        sent["lk_bases"] += int(lens.sum(dtype=np.int64))
                        if attrs is not None:
                            attrs.update(rpad=rpad, rows=rows,
                                         long_rows=long_rows)
                        # drain the previous reply BEFORE sending the next
                        # request: a duplex pipe with a blocked send on
                        # BOTH ends (parent pushing reply N, worker pushing
                        # request N+1, each larger than the socket buffer)
                        # is a hard deadlock.  It also guards the segment:
                        # the service replies to batch N only after it has
                        # copied it out and unmapped it, so batch N+1 never
                        # overwrites a batch the service still reads.
                        # Overlap is unharmed: span N+1's host prep already
                        # ran while the card computed batch N; only the
                        # send moves.
                        if pending is not None:
                            _finish(pending)
                            pending = None
                        with stage("lk.send", into="pairhmm"):
                            segment.send(rpc_conn, job, tid)
                        sent["lk_batches"] += 1
                        sent["lk_shm_batches"] += 1
                        pending = (tid, res, engine, works)
                    else:
                        if pending is not None:
                            _finish(pending)
                            pending = None
                        _genotype(res, engine, works, None)
                        done = res
            # after the task's span has closed, so that it travels with
            # its own result
            if done is not None:
                _put(tid, done, engine)
        except Exception:  # noqa: BLE001 — surface to the parent
            result_q.put((tid, "error", traceback.format_exc()))
            if pending is not None:
                # drain the outstanding reply (and emit the pending span's
                # result): a reply left in the pipe would be read as the
                # answer to this worker's NEXT request, silently giving
                # every later batch the likelihoods of the one before
                _finish(pending)
                pending = None
    if on_card:
        segment.close()
    if rpc_conn is not None:
        rpc_conn.send(("bye", None, None))


class SpanWorkerPool:
    """Persistent worker pool over chunk spans; see module docstring."""

    def __init__(self, cfg, n_workers: int, device_service: bool):
        import multiprocessing as mp

        from lorikeet_tpu_torch.parallel.shm import ServiceSegments
        ctx = mp.get_context("spawn")
        self.key = None                      # set by get_pool
        self.n_workers = n_workers
        self._ctx = ctx
        self._cfg = cfg
        self._device_service = device_service
        self.task_q = ctx.Queue()
        self.result_q = ctx.Queue()
        self._next_id = 0
        self._next_wid = 0
        self._results = {}
        self._tasks = {}                     # tid -> task tuple (requeue)
        self._inflight = {}                  # tid -> wid ("start" seen)
        self._retries = {}                   # tid -> requeue count
        self._dead_handled = set()           # wids already recovered
        self._lock = threading.Lock()
        self._service_stop = threading.Event()
        self._service_thread = None
        self._conns = []
        #: the descriptor of each worker's segment, held for the service
        self._segments = ServiceSegments()
        self._wid_proc = {}
        #: whether the workers pack their pair batches in the wire form:
        #: the parent's gate, asked only when its card serves them
        self.wire = False
        if device_service and cfg.use_cuda is not False:
            from lorikeet_tpu_torch.ops.pairhmm_cuda import _wire_enabled
            self.wire = _wire_enabled()
        #: whether the workers send their spans' haplotype SW to the
        #: service, which runs it on ``processing._hap_sw_device``
        self.hap_sw = device_service and _hap_sw_on_service(cfg)
        self.workers = [self._spawn_worker() for _ in range(n_workers)]
        if device_service and self._conns:
            self._service_thread = threading.Thread(
                target=self._serve_device, name="device-service",
                daemon=True)
            self._service_thread.start()

    def _spawn_worker(self):
        """Start one worker process (initial fill or crash replacement)."""
        wid = self._next_wid
        self._next_wid += 1
        child_c = None
        if self._device_service:
            parent_c, child_c = self._ctx.Pipe()
            self._conns.append(parent_c)
        p = self._ctx.Process(
            target=_worker_main,
            args=(wid, self._cfg, self.task_q, self.result_q, child_c,
                  time.time(), self.wire, self.hap_sw),
            daemon=True)
        # the child inherits the environment at start(): an empty
        # CUDA_VISIBLE_DEVICES there before any of its imports run.  The
        # parent read the variable when it initialised CUDA, so the brief
        # change does not reach its own card.
        with _SPAWN_LOCK:
            saved = os.environ.get("CUDA_VISIBLE_DEVICES")
            os.environ["CUDA_VISIBLE_DEVICES"] = ""
            try:
                p.start()
            finally:
                if saved is None:
                    os.environ.pop("CUDA_VISIBLE_DEVICES", None)
                else:
                    os.environ["CUDA_VISIBLE_DEVICES"] = saved
        # pipe fds are inherited by the spawned child via pickling; the
        # parent closes its copy of the child end
        if child_c is not None:
            child_c.close()
        self._wid_proc[wid] = p
        return p

    # ---- crash tolerance --------------------------------------------------
    def _requeue(self, tid):
        n = self._retries.get(tid, 0)
        if n >= 2:
            raise RuntimeError(
                f"span task {tid} was lost to {n} worker crash(es) and "
                "re-ran out of retries (likely a reproducible native "
                "fault in this span)")
        self._retries[tid] = n + 1
        self.task_q.put(self._tasks[tid])

    def recover_dead_workers(self) -> bool:
        """Requeue tasks that died with their worker onto the survivors and
        respawn replacements, keeping pool capacity.  The reference keeps a
        genome alive past a failed scope task
        (src/processing/lorikeet_engine.rs:100); the pool matches that with
        task-level requeue instead of aborting the run."""
        changed = False
        for wid, p in list(self._wid_proc.items()):
            if wid in self._dead_handled or p.is_alive():
                continue
            self._dead_handled.add(wid)
            changed = True
            for t in [t for t, w in self._inflight.items() if w == wid]:
                del self._inflight[t]
                self._requeue(t)
            new_p = self._spawn_worker()
            try:
                self.workers[self.workers.index(p)] = new_p
            except ValueError:
                self.workers.append(new_p)
        return changed

    # ---- parent-side device service ---------------------------------------
    def _serve_device(self):
        """Serve the workers' "lk", "act", "hsw" and "sw" requests on the
        parent's cards: "lk" split over the run's device list, on a CUDA
        stream of this thread's own for each position in the list (a card
        listed twice gets two); "act" over the same list; "hsw" (a span's
        haplotype SW, its chunks in the worker's segment) and "sw" on the
        first card.  The list is read at each request: a pool outlives the
        run that started it.  Keeps SERVICE_DEPTH "lk" jobs enqueued
        before it waits on the oldest.  Every failure is an error reply:
        the worker raises, nothing is computed on its host."""
        import contextlib
        from multiprocessing.connection import wait as conn_wait

        import torch

        from lorikeet_tpu_torch import processing
        from lorikeet_tpu_torch.calling import likelihoods as L
        from lorikeet_tpu_torch.ops import _build
        from lorikeet_tpu_torch.ops import pairhmm_cuda as PC
        from lorikeet_tpu_torch.ops import sw_cuda as SC
        from lorikeet_tpu_torch.parallel import pipeline
        from lorikeet_tpu_torch.parallel.sharding import get_devices
        from lorikeet_tpu_torch.processing import _activity_devices
        from lorikeet_tpu_torch.utils.progress import annotate, global_stage

        streams = {}                       # (position, device) -> stream
        inflight = []                      # [(conn, handle)] in send order
        built = []                         # K2 and K3 built (hap_device)

        def stream_of(position, device):
            """This thread's stream for ``device`` at ``position`` (None
            for a CPU device)."""
            if device.type != "cuda":
                return None
            key = (position, device)
            if key not in streams:
                streams[key] = torch.cuda.Stream(device)
            return streams[key]

        def on_stream(device):
            """Context that makes this thread's stream on ``device`` the
            current one (nothing for a CPU device)."""
            stream = stream_of("sw", device)
            return (contextlib.nullcontext(None) if stream is None
                    else torch.cuda.stream(stream))

        def reply(conn, msg):
            try:
                with global_stage("service.reply"):
                    conn.send(msg)
            except OSError:
                pass   # the worker died; gather requeues its span

        def hap_sw(batch):
            """A span's haplotype SW chunks on the SW kernel's device, on
            this thread's stream there: each chunk's CIGARs in
            sw_cuda.compact's form, for the worker to decode."""
            a = batch.arrays
            parameters, strategy = a["parameters"], a["strategy"]
            device = hap_device()
            with on_stream(device):
                # each chunk copied out of the segment (the table kept on
                # the host for the cut), which is then the worker's again
                tensors = [SC.to_tensors(
                    {**sizes, "seqs": a[f"seqs.{i}"],
                     "meta": a[f"meta.{i}"].copy()}, device)
                    for i, sizes in enumerate(a["sizes"])]
                del a
                batch.close()
                return [SC.sw_align_rows(t, parameters, strategy)
                        for t in tensors]

        def hap_device():
            device = processing._hap_sw_device(self._cfg)
            if device is None:
                raise RuntimeError("a haplotype SW batch, but the run "
                                   "takes its SW on the host")
            if device.type == "cuda" and not built:
                # K3 with K2, one nvcc each, started together, in the
                # first request: the warm-up call's, never the window's
                _build.load_all(("pairhmm", "sw"))
                built.append(True)
            return device

        def finish(item):
            conn, handle = item
            try:
                vals = PC.readback_grouped(handle)
            except Exception:  # noqa: BLE001 — the worker raises it
                reply(conn, ("error", traceback.format_exc()))
                return
            reply(conn, ("ok", vals))

        closed = set()
        while not self._service_stop.is_set():
            # live is recomputed each pass so crash-replacement workers
            # (recover_dead_workers appends their conns) get served too
            live = [c for c in self._conns if c not in closed]
            if not live:
                if self._service_stop.wait(0.2):
                    break
                continue
            # with work in flight, only take requests that are already
            # waiting before reading results back: a lone worker must not
            # wait a poll interval for each span
            ready = conn_wait(live, timeout=0.0 if inflight else 0.2)
            if not ready:
                while inflight:
                    finish(inflight.pop(0))
                continue
            for conn in ready:
                batch = None
                try:
                    # each request is (kind, payload, tid): the tid of
                    # the worker's task for "lk", None for the others;
                    # an "lk" payload is the header of a batch in the
                    # worker's segment, mapped here
                    with global_stage("service.recv"):
                        kind, payload, tid = conn.recv()
                        annotate(kind=kind, tid=tid)
                        if kind in ("lk", "hsw"):
                            batch = self._segments.receive(conn, payload)
                except (EOFError, OSError):
                    closed.add(conn)
                    self._segments.drop(conn)
                    continue
                except Exception:  # noqa: BLE001 — the worker raises it
                    reply(conn, ("error", traceback.format_exc()))
                    continue
                if kind == "bye":
                    closed.add(conn)
                    self._segments.drop(conn)
                    continue
                try:
                    # inside the try: a malformed payload is an error reply
                    # and never kills this thread (the workers would wait
                    # on their replies forever)
                    if kind == "lk":
                        devices = get_devices()
                        # the call whatever wraps it (its own span is
                        # k2.enqueue)
                        with global_stage("service.enqueue", tid=tid):
                            handle = PC.enqueue_grouped_jobs(
                                batch.arrays, batch.out_pos, devices,
                                [stream_of(i, d)
                                 for i, d in enumerate(devices)])
                        # the enqueue pinned a copy of every array (a
                        # CPU device computed at once): the segment is
                        # the worker's again once it is unmapped
                        batch.close()
                        inflight.append((conn, handle))
                        L.DISPATCH_COUNTS["remote"] += 1
                    elif kind == "act":
                        *args, prop = payload
                        smoothed = pipeline.smoothed_activity_device(
                            *args, max_prob_propagation=prop,
                            devices=_activity_devices(self._cfg))
                        reply(conn, ("ok", smoothed))
                    elif kind == "hsw":
                        reply(conn, ("ok", hap_sw(batch)))
                    elif kind == "sw":
                        pairs, parameters, strategy = payload
                        with on_stream(torch.device(SC.SW_DEVICE)):
                            aligned = SC.align_batch_cuda(pairs, parameters,
                                                          strategy)
                        reply(conn, ("ok", aligned))
                    else:
                        raise ValueError(f"unknown request {kind!r}")
                except Exception:  # noqa: BLE001 — the worker raises it
                    reply(conn, ("error", traceback.format_exc()))
                if batch is not None:
                    # a batch whose request failed: its traceback is gone
                    # here, and with it any view of the segment
                    batch.close(strict=False)
                while len(inflight) >= SERVICE_DEPTH:
                    finish(inflight.pop(0))
        while inflight:
            finish(inflight.pop(0))

    # ---- task API ---------------------------------------------------------
    def submit(self, contig: str, span, fasta_path: str = None,
               bam_paths: list = None, carried=()) -> int:
        """Queue one span; ``carried`` is the upstream deletions its
        genotyping starts from (empty: see ``gather_contig``)."""
        from lorikeet_tpu_torch.utils import progress
        with self._lock:
            tid = self._next_id
            self._next_id += 1
        task = (tid, fasta_path or self.default_fasta,
                bam_paths or self.default_bams, contig, span,
                progress.GLOBAL_STAGES is not None, list(carried))
        self._tasks[tid] = task
        self.task_q.put(task)
        return tid

    def gather(self, task_ids: list) -> list:
        """Results for ``task_ids`` in that order (blocks): per span its
        ContigResult, the (tid, start) of the sites its genotyping checked
        against upstream deletions, and the deletions it left.  Each
        result's counters are added to the parent's.  Worker deaths are
        survived: their in-flight tasks are requeued onto the survivors
        and replacements are respawned (retry-capped so a span that
        reproducibly kills workers still surfaces as an error)."""
        want = set(task_ids)
        idle_polls = 0
        while want - self._results.keys():
            try:
                tid, status, payload = self.result_q.get(timeout=5.0)
            except Exception:  # noqa: BLE001 — queue.Empty: recovery check
                if self.recover_dead_workers():
                    idle_polls = 0
                    continue
                # ghost recovery: a worker that died between task pickup
                # and its "start" message leaves a task with no result, no
                # in-flight owner, and nothing queued.  Only possible after
                # a death, so gate on one having happened.
                missing = [t for t in want if t not in self._results
                           and t not in self._inflight]
                if missing and self._dead_handled and self.task_q.empty():
                    idle_polls += 1
                    if idle_polls >= 2:
                        for t in missing:
                            self._requeue(t)
                        idle_polls = 0
                continue
            if status == "start":
                self._inflight[tid] = payload
                continue
            if status == "error":
                raise RuntimeError(f"span worker failed:\n{payload}")
            self._inflight.pop(tid, None)
            res, counters = payload
            _add_counters(counters)
            self._results[tid] = res
        for t in task_ids:
            self._tasks.pop(t, None)
        return [self._results.pop(t) for t in task_ids]

    def gather_contig(self, task_ids: list) -> list:
        """ContigResults of one contig's spans, ``task_ids`` in contig
        order, as the serial span loop gives them.  That loop genotypes
        with one engine, so a deletion emitted near the end of span N
        suppresses a site it covers in span N+1
        (GenotypingEngine._covered_by_upstream_deletion).  The workers ran
        each span from no deletions; where the carried ones cover a site
        that span is run again starting from them."""
        from lorikeet_tpu_torch.utils.progress import global_stage
        tasks = [self._tasks[t] for t in task_ids]
        parts = []
        carried = []
        with global_stage("pool.gather", contig=tasks[0][3] if tasks
                          else None, tids=list(task_ids)):
            for task, (res, checks, left) in zip(tasks,
                                                 self.gather(task_ids)):
                kept, covered = carry_deletions(carried, checks)
                if covered:
                    SPAN_RERUNS["spans"] += 1
                    _, fasta_path, bam_paths, contig, span = task[:5]
                    rerun = self.submit(contig, span, fasta_path, bam_paths,
                                        carried)
                    ((res, _, carried),) = self.gather([rerun])
                else:
                    carried = kept + left
                parts.append(res)
        return parts

    def close(self):
        """Stop the workers and the service.  With spans on, each worker
        ships the spans it recorded since its last result as it stops, and
        they join this process's (utils.progress)."""
        from lorikeet_tpu_torch.utils import progress
        stop = ("stop", progress.GLOBAL_STAGES is not None)
        for _ in self.workers:
            try:
                self.task_q.put(stop)
            except Exception:  # noqa: BLE001
                pass

        def drain():
            # results nobody gathered (after an error) are dropped; the
            # workers' last spans are kept
            try:
                while True:
                    _, status, payload = self.result_q.get_nowait()
                    if status == "spans":
                        progress.merge_spans(payload)
            except Exception:  # noqa: BLE001 — queue.Empty
                pass

        # drained while the workers exit: a worker cannot exit while its
        # queue feeder still holds data for a full pipe
        deadline = time.monotonic() + 10
        for w in self.workers:
            while w.is_alive() and time.monotonic() < deadline:
                drain()
                w.join(timeout=0.1)
            if w.is_alive():
                w.terminate()
                w.join(timeout=5)
        drain()
        # the service stops after the workers: one of them may still be
        # waiting on its last reply
        self._service_stop.set()
        if self._service_thread is not None:
            self._service_thread.join(timeout=5)
        for conn in self._conns:
            conn.close()
        self._segments.close()


def carry_deletions(carried: list, checks: list) -> tuple:
    """Replay a span's deletion checks against the upstream deletions
    carried into it, as GenotypingEngine._covered_by_upstream_deletion
    prunes and tests them: (the carried deletions that survive the span,
    whether one of them covered a checked site)."""
    covered = False
    for tid, start in checks:
        if not carried:
            break
        carried = [(t, s, e) for t, s, e in carried
                   if t == tid and e >= start]
        covered |= any(s < start <= e for _, s, e in carried)
    return carried, covered


def _hap_sw_on_service(cfg) -> bool:
    """Whether a span's haplotype SW runs on the service's card (the
    parent's ``processing._hap_sw_device``) rather than on the worker's
    host."""
    from lorikeet_tpu_torch import processing
    return processing._hap_sw_device(cfg) is not None


def _add_counters(counters: dict):
    """A worker result's counters into the parent's own."""
    from lorikeet_tpu_torch.calling import likelihoods as L
    from lorikeet_tpu_torch.ops import pairhmm as PH
    from lorikeet_tpu_torch.utils import progress
    L.DISPATCH_COUNTS["host"] += counters["host"]
    for key, n in counters["escalations"].items():
        PH.ESCALATIONS[key] += n
    acc = progress.GLOBAL_STAGES
    if acc is not None:
        for stage, seconds in (counters["stages"] or {}).items():
            acc[stage] = acc.get(stage, 0.0) + seconds
    progress.merge_spans(counters["spans"])
    for key in WORKER_COUNTS:
        WORKER_COUNTS[key] += counters[key]
    report = counters["report"]
    WORKER_REPORTS[report["pid"]] = report


def get_pool(fasta_path: str, bam_paths: list, cfg, n_workers: int,
             device_service: bool):
    """Keyed accessor: reuse a live pool when (cfg, device chain, size,
    service) match —
    a pool serves any (fasta, bams) input set, so it survives across
    contigs AND genomes.  Each worker's start costs an interpreter, the
    host modules and its own decode of the BAMs; keeping them alive
    amortises that.  A small registry (not a singleton) lets two
    configurations alternate without paying a respawn per switch."""
    from lorikeet_tpu_torch.processing import _cfg_fingerprint
    # the workers read the device chain's switch from the cfg they were
    # spawned with, and it is not a field of the fingerprint; the pool
    # reads WIRE_ENV and where the haplotype SW runs when it starts
    key = (_cfg_fingerprint(cfg), getattr(cfg, "device_activity", False),
           n_workers, device_service, os.environ.get(WIRE_ENV),
           device_service and _hap_sw_on_service(cfg))
    pool = _POOLS.get(key)
    if pool is not None:
        try:
            pool.recover_dead_workers()    # respawn any crash casualties
            ok = all(w.is_alive() for w in pool.workers)
        except Exception:  # noqa: BLE001 — unrecoverable: rebuild below
            ok = False
        if ok:
            _POOLS[key] = _POOLS.pop(key)  # LRU touch
            pool.default_fasta = fasta_path
            pool.default_bams = list(bam_paths)
            return pool
        _POOLS.pop(key, None)
        pool.close()
    while len(_POOLS) >= _MAX_POOLS:
        _POOLS.pop(next(iter(_POOLS))).close()
    pool = SpanWorkerPool(cfg, n_workers, device_service)
    pool.key = key
    pool.default_fasta = fasta_path
    pool.default_bams = list(bam_paths)
    _POOLS[key] = pool
    return pool


def pool_alive() -> bool:
    """True when a live pool exists (its spawn cost is already paid)."""
    return any(all(w.is_alive() for w in p.workers)
               for p in _POOLS.values())


def shutdown_pool():
    while _POOLS:
        _POOLS.pop(next(iter(_POOLS))).close()


atexit.register(shutdown_pool)
