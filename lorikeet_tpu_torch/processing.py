"""Pipeline orchestration: genome -> contigs -> chunks -> regions -> calls.

Mirrors the reference's orchestration spine
(src/processing/lorikeet_engine.rs:77-520 apply_per_reference,
haplotype_caller_engine.rs:304-620 collect_activity_profile,
assembly_region_walker.rs:33-213): stream each BAM over contig chunks,
build per-sample ref-vs-any profiles, smooth, carve regions, call active
regions, then write the per-genome VCF.

The chunking matches the reference sizing: outer chunks of
~250kb/total_samples (haplotype_caller_engine.rs:417) and the same region
padding/size defaults.

Counterpart of lorikeet_tpu/processing.py.  The orchestration is the same;
what changed is where the device comes in: the pair-HMM runs on the CUDA
kernel unless ``cfg.use_cuda`` is False (resolved once, at
_configure_devices; no card is then an error), over the process's device
list (``--devices``: parallel/sharding.py) in place of the JAX mesh, and
there is no compile prewarm.  Activity profiling takes the device chain
(parallel/pipeline.py, split by position over the list) by the JAX
package's rule, decided once in the parent and carried on ``cfg``.  ``-t``
above 1 fans the chunk spans out over the span-worker pool
(parallel/pool.py): CPU workers, with the parent's cards serving their
pair-HMM batches, activity chains and SW batches.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from lorikeet_tpu_torch.calling.engine import CallerConfig, HaplotypeCallerEngine
from lorikeet_tpu_torch.io.bam import BamReader, open_bam
from lorikeet_tpu_torch.io.fasta import FastaReader
from lorikeet_tpu_torch.io.vcf import write_vcf
from lorikeet_tpu_torch.models.activity import (
    RefVsAnyProfile, accumulate_reads, active_probabilities, band_pass_smooth,
    extract_regions,
)

# Region-extraction defaults live on CallerConfig (cli.rs knob parity);
# these aliases remain for external callers/tests.
ASSEMBLY_REGION_PADDING = 100
MIN_ASSEMBLY_REGION_SIZE = 50
MAX_ASSEMBLY_REGION_SIZE = 300
MAX_INPUT_DEPTH = 200_000
DEPTH_PER_SAMPLE_FILTER = 5


def _read_passes_filters(rec, mapq_threshold=20, read_type="short",
                         min_long_read_size=1500,
                         min_long_read_average_base_qual=20,
                         flag_filter=None):
    """read_utils.rs:25-90 filter set; long reads additionally require a
    minimum length and average base quality (:70-77).  ``flag_filter``
    gates improper-pair / secondary / supplementary handling
    (read_utils.rs:44-48 consults FlagFilter; secondary reads never pass)."""
    from lorikeet_tpu_torch.utils.cigar import read_length, reference_length
    if len(rec.seq) == 0 or len(rec.qual) == 0 or not rec.cigar:
        return False
    if rec.is_secondary or rec.is_unmapped:
        return False
    if rec.is_supplementary and not (flag_filter is not None
                                     and flag_filter.include_supplementary):
        return False
    if rec.is_paired and not rec.is_proper_pair \
            and not (flag_filter is not None
                     and flag_filter.include_improper_pairs):
        return False
    if rec.is_duplicate or rec.is_qc_fail:
        return False
    if rec.mapq < mapq_threshold or rec.mapq == 255:
        return False
    if len(rec.seq) < 30:
        return False
    if read_type == "long":
        if len(rec.seq) < min_long_read_size:
            return False
        if float(np.mean(rec.qual)) < min_long_read_average_base_qual:
            return False
    # cigar-shape checks: the native decoder summarizes them as intrinsic
    # bits (bam_decode.cpp: 1=refskip, 2=consecutive indels, 4=edge
    # deletion, 8=query-length mismatch, 16=zero reference length)
    if rec.intrinsic >= 0:
        return rec.intrinsic == 0
    if reference_length(rec.cigar) == 0:
        return False
    if read_length(rec.cigar) != len(rec.seq):
        return False
    if any(op == "N" for op, _ in rec.cigar):
        return False
    # no consecutive indels, no leading/trailing deletion
    core = [op for op, _ in rec.cigar if op not in "SH"]
    if core and (core[0] == "D" or core[-1] == "D"):
        return False
    for a, b in zip(core, core[1:]):
        if a in "ID" and b in "ID":
            return False
    return True


@dataclass
class ContigResult:
    tid: int
    calls: list = field(default_factory=list)
    n_regions: int = 0
    n_active: int = 0
    # per-sample passing-depth RLE (positive run = DP >= filter), the ANI
    # comparable-base encoding of haplotype_caller_engine.rs:1015-1051
    depth_pass_rle: list = field(default_factory=list)


def _rle_encode(mask: np.ndarray) -> list:
    """Boolean mask -> signed run lengths (True runs positive)."""
    if mask.size == 0:
        return []
    changes = np.flatnonzero(np.diff(mask.view(np.int8))) + 1
    bounds = np.concatenate([[0], changes, [mask.size]])
    runs = np.diff(bounds)
    signs = np.where(mask[bounds[:-1]], 1, -1)
    return (runs * signs).tolist()


def _chunk_size(n_samples: int, cfg) -> int:
    """Outer-chunk sizing: ~250kb/total_samples, floored so a chunk always
    holds several regions (haplotype_caller_engine.rs:417 sizing)."""
    return max(250_000 // max(n_samples, 1),
               5 * cfg.max_assembly_region_size)


def _contig_spans(lo: int, hi: int, chunk_size: int, cfg) -> list:
    """(fetch_lo, fetch_hi, core_lo, core_hi) spans covering [lo, hi).

    Halo: regions can reach MAX size + padding past a boundary, and the
    band-pass filter needs +/-50bp of context (SURVEY §5 haloing)."""
    halo = cfg.max_assembly_region_size + cfg.assembly_region_padding + 50
    spans = []
    for core_lo in range(lo, hi, chunk_size):
        core_hi = min(core_lo + chunk_size, hi)
        spans.append((max(lo, core_lo - halo), min(hi, core_hi + halo),
                      core_lo, core_hi))
    return spans


def call_contig(
    fasta: FastaReader,
    bams: list,                 # one BamReader per sample
    contig_name: str,
    cfg: CallerConfig = None,
    engine: HaplotypeCallerEngine = None,
    limit=None,                 # optional (start, end) restriction
    chunk_threads: int = 1,
    pool=None,                  # parallel.pool.SpanWorkerPool
) -> ContigResult:
    """Chunked contig loop: large contigs are processed in outer chunks
    of ~250kb/samples with a halo (haplotype_caller_engine.rs:417,443-470
    sizing); per-chunk results (calls, depth RLE) concatenate exactly.
    ``chunk_threads`` parallelizes the chunk loop (the reference's inner
    rayon chunk parallelism) when the contig loop itself is serial;
    ``pool`` does the same with the span-worker PROCESSES of
    parallel/pool.py, where the GIL serializes threaded chunk work."""
    cfg = cfg or CallerConfig()
    engine = engine or HaplotypeCallerEngine(cfg)
    length = fasta.length(contig_name)
    n_samples = len(bams)
    lo, hi = (0, length) if limit is None else (max(0, limit[0]),
                                                min(length, limit[1]))
    if hi <= lo:
        # limiting interval starts past this contig's end: nothing to call
        # (same empty shape as the min-contig-size skip)
        return ContigResult(tid=0)
    chunk_size = _chunk_size(n_samples, cfg)
    if hi - lo <= chunk_size and pool is None:
        return _call_span(fasta, bams, contig_name, cfg, engine, lo, hi)
    spans = ([(lo, hi, lo, hi)] if hi - lo <= chunk_size
             else _contig_spans(lo, hi, chunk_size, cfg))
    if pool is not None:
        # persistent span-worker pool (parallel.pool): spans fan out over
        # long-lived CPU workers; with a device service the parent's card
        # serves every worker's pair-HMM (and --pallas-sw SW) batches
        ids = [pool.submit(contig_name, sp, fasta.path,
                           [b.path for b in bams]) for sp in spans]
        parts = pool.gather_contig(ids)
    elif chunk_threads > 1 and len(spans) > 1 \
            and not any(getattr(b, "is_streaming", False) for b in bams):
        for b in bams:
            b._ensure_decoded()
        contig_seq = fasta.fetch(contig_name)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(min(chunk_threads, len(spans))) as ex:
            parts = list(ex.map(
                lambda sp: _call_span(fasta, bams, contig_name, cfg, engine,
                                      sp[0], sp[1], sp[2], sp[3],
                                      ref_seq=contig_seq), spans))
    else:
        # two-stage span pipeline: while the device / native kernel chews
        # span N's pair-HMM batch (GIL released), the main thread prepares
        # span N+1 (SURVEY §7.1 host-device pipeline balance)
        from concurrent.futures import ThreadPoolExecutor

        from lorikeet_tpu_torch.calling.engine import (
            call_regions_batched, compute_works_likelihoods,
        )
        from lorikeet_tpu_torch.utils import progress
        parts = []
        pending = None

        def _finish(p):
            result, works, fut = p
            lks = fut.result() if fut else None
            with progress.global_stage("genotype"):
                for calls in call_regions_batched(engine, works, lks):
                    result.calls.extend(calls)
            parts.append(result)

        with ThreadPoolExecutor(1) as pool:
            for sp in spans:
                result, works = _call_span(fasta, bams, contig_name, cfg,
                                           engine, *sp, defer=True)
                fut = pool.submit(compute_works_likelihoods, engine,
                                  works) if works else None
                if pending is not None:
                    _finish(pending)
                pending = (result, works, fut)
            if pending is not None:
                _finish(pending)
    return _merge_parts(parts, n_samples)


def _merge_parts(parts: list, n_samples: int) -> ContigResult:
    """Concatenate per-span ContigResults in traversal order."""
    result = None
    for part in parts:
        if result is None:
            result = part
        else:
            result.calls.extend(part.calls)
            result.n_regions += part.n_regions
            result.n_active += part.n_active
            for s in range(n_samples):
                _rle_concat(result.depth_pass_rle[s],
                            part.depth_pass_rle[s])
    return result


def _device_activity(cfg, devices) -> bool:
    """Whether activity profiling takes the device chain (parallel/pipeline:
    EM, HQ-soft-clip expansion and band-pass as torch ops, split by
    position over ``devices``): the JAX package's rule.
    LORIKEET_DEVICE_ACTIVITY=1 or 0 decides when set; otherwise the chain
    is on when the run is on cards, uses more than one, and runs at -t 1
    (the JAX package's -t workers run on a CPU backend, where its rule
    says off)."""
    env = os.environ.get("LORIKEET_DEVICE_ACTIVITY")
    if env in ("0", "1"):
        return env == "1"
    return (getattr(cfg, "use_cuda", None) is not False
            and len(devices) > 1
            and all(d.type == "cuda" for d in devices)
            and (getattr(cfg, "threads", 1) or 1) <= 1)


def _activity_devices(cfg) -> list:
    """Devices of the activity chain: the run's device list, or the CPU
    when the caller asked for the host (``use_cuda`` False)."""
    import torch
    if getattr(cfg, "use_cuda", None) is False:
        return [torch.device("cpu")]
    from lorikeet_tpu_torch.parallel.sharding import get_devices
    return get_devices()


#: in a -t pool worker: sends a span's activity chain to the parent's
#: device service (parallel/pool.py), called as
#: ``DEVICE_ACTIVITY(gls, hq_mean, ploidy, snp_heterozygosity,
#: heterozygosity_stdev, stand_min_conf, max_prob_propagation)``
DEVICE_ACTIVITY = None
#: in a -t pool worker of a run whose haplotype SW is on the card
#: (parallel/pool.py): sends a span's haplotype SW batch to the parent's
#: device service, called as ``DEVICE_HAP_SW(pairs, parameters,
#: strategy)`` -> ([(cigar, offset)], pairs the kernel aligned)
DEVICE_HAP_SW = None
#: the haplotype CIGARs this process's spans computed, the SW alignments
#: they took (the pairs past calculate_cigar's trivial cases; equal pairs
#: of a span share one) and those of them the SW kernel ran; a pool
#: worker ships them with each result (parallel/pool.py WORKER_COUNTS)
HAP_COUNTS = {"hap_cigars": 0, "hap_sw": 0, "hap_sw_card": 0}


def _hap_sw_device(cfg):
    """The device of a span's haplotype SW batch: the SW kernel's
    (``sw_cuda.SW_DEVICE``) on a run on cards; None, the native aligner a
    pair at a time, on the host (``use_cuda`` False) and where CPU devices
    stand in for the cards.  Asked in the parent only; tests that want the
    kernel's plain version on this path make it return the CPU."""
    if getattr(cfg, "use_cuda", None) is False:
        return None
    import torch

    from lorikeet_tpu_torch.ops import sw_cuda
    from lorikeet_tpu_torch.parallel.sharding import get_devices
    device = torch.device(sw_cuda.SW_DEVICE)
    if device.type == "cuda" and any(d.type == "cuda"
                                     for d in get_devices()):
        return device
    return None


def _span_hap_cigars(cfg, drafts) -> list:
    """The CIGARs of each draft's candidates (engine.RegionDraft), their
    SW in one batch for the whole span: on the parent's card through
    DEVICE_HAP_SW in a pool worker, on ``_hap_sw_device`` in the parent,
    else on the native host aligner.  Timed under the ``assemble``
    sub-stage; the batch's pack, send, wait and decode also as the span
    ``asm.hap_sw``."""
    from lorikeet_tpu_torch.utils import progress as _prog
    from lorikeet_tpu_torch.utils.cigar import calculate_cigars
    pairs = [p for d in drafts for p in d.cigar_pairs()]
    if DEVICE_HAP_SW is not None:
        send = DEVICE_HAP_SW
    elif _prog.WORKER is None and (device := _hap_sw_device(cfg)) is not None:
        from lorikeet_tpu_torch.ops import sw_cuda

        def send(padded, parameters, strategy):
            return sw_cuda.align_batch_rows(
                padded, parameters, strategy,
                sw_cuda.chunk_runner(device, parameters, strategy))
    else:
        send = None
    card = 0

    def batch(padded, parameters, strategy):
        nonlocal card
        with _prog.global_stage(
                "asm.hap_sw", pairs=len(padded),
                bytes=sum(r.size + a.size for r, a in padded)):
            aligned, card = send(padded, parameters, strategy)
        return aligned
    with _prog.substage("assemble"):
        cigars, n_sw = calculate_cigars(pairs, batch if send else None)
    HAP_COUNTS["hap_cigars"] += len(pairs)
    HAP_COUNTS["hap_sw"] += n_sw
    HAP_COUNTS["hap_sw_card"] += card
    out, at = [], 0
    for d in drafts:
        out.append(cigars[at:at + len(d.candidates)])
        at += len(d.candidates)
    return out


def _configure_devices(cfg):
    """Resolve ``cfg.use_cuda`` once for the run: None means the card, as
    True does, and the card is then required; only False (``--force-cpu``)
    selects the f64 host kernel and makes the device list the CPU.
    ``cfg.devices`` (``--devices``: 'auto', N) sets the list
    (parallel.sharding.configure_devices: an error above the visible
    count).  ``cfg.use_cuda_sw`` (independent of use_cuda) requires a card
    too.  Whether spans take the device activity chain is decided here,
    once, and put on ``cfg.device_activity``.  The tests put CPU devices
    in the cards' place (``sharding.visible_cards``) and move SW_DEVICE to
    the CPU to run the plain versions through the same path."""
    import torch

    from lorikeet_tpu_torch.calling.likelihoods import resolve_use_cuda
    from lorikeet_tpu_torch.parallel.sharding import configure_devices
    from lorikeet_tpu_torch.utils.progress import log
    cfg.use_cuda = resolve_use_cuda(cfg.use_cuda)
    devices = configure_devices(getattr(cfg, "devices", None) or "auto",
                                on_card=cfg.use_cuda)
    cfg.device_activity = _device_activity(cfg, devices)
    log.info("pair-HMM on %s; activity on the %s chain",
             f"the CUDA kernel over {[str(d) for d in devices]}"
             if cfg.use_cuda else "the f64 host kernel",
             "device" if cfg.device_activity else "host")
    if cfg.use_cuda_sw:
        from lorikeet_tpu_torch.ops import sw_cuda
        if torch.device(sw_cuda.SW_DEVICE).type == "cuda":
            from lorikeet_tpu_torch.device import require_cuda
            require_cuda()


def _cpu_only_backend(cfg) -> bool:
    """True when the caller asked for the host on every path (worker
    processes then cannot contend for a card): ``use_cuda`` False and no
    device SW.  ``use_cuda`` None means the card."""
    if getattr(cfg, "use_cuda_sw", False):
        return False
    return getattr(cfg, "use_cuda", None) is False


def _rle_concat(dst: list, src: list):
    """Append signed-run RLE, merging the boundary run when signs match."""
    if dst and src and (dst[-1] > 0) == (src[0] > 0):
        dst[-1] += src[0]
        dst.extend(src[1:])
    else:
        dst.extend(src)


def _call_span(fasta, bams, contig_name, cfg, engine, lo, hi,
               core_lo=None, core_hi=None, ref_seq=None, defer=False):
    """Profile + call [lo, hi); emit only regions starting inside the core
    span and depth RLE for exactly [core_lo, core_hi).  ``ref_seq`` (the
    whole contig) may be prefetched by the caller — required under chunk
    threading, where the FastaReader handle's seeks would race.

    With ``defer`` True, returns (result, works) BEFORE the pair-HMM and
    genotyping run — the span pipeline overlaps that compute with the next
    span's host preparation."""
    core_lo = lo if core_lo is None else core_lo
    core_hi = hi if core_hi is None else core_hi

    # the span recorder (utils.progress; off: one None check a site)
    from lorikeet_tpu_torch.utils import progress as _prog

    with _prog.global_stage("profile"):
        length = fasta.length(contig_name)
        if ref_seq is None:
            ref_seq = fasta.fetch(contig_name)
        n_samples = len(bams)
        tid_per_bam = [b.tid(contig_name) if contig_name in b.references else -1
                       for b in bams]
        result = ContigResult(tid=tid_per_bam[0] if tid_per_bam else 0)

        # ---- activity profiling over [lo, hi) ----
        read_types = getattr(cfg, "read_types", None) or ["short"] * n_samples
        thresholds = getattr(cfg, "alignment_thresholds", None)
        from lorikeet_tpu_torch.io.filter import FlagFilter
        flag_filter = getattr(cfg, "flag_filter", None) or FlagFilter()
        profiles = [RefVsAnyProfile.zeros(hi - lo, cfg.ploidy) for _ in range(n_samples)]
        # per-sample read source: ("eager", [records]) or ("lazy", bam, tid,
        # sorted-order indices) — the lazy form never builds BamRecord objects
        # for reads that stay outside active regions
        sample_reads = [("eager", []) for _ in range(n_samples)]
        for s, bam in enumerate(bams):
            if tid_per_bam[s] < 0:
                continue
            # streaming readers decode exactly this span's BGZF window here
            # (haplotype_caller_engine.rs:675-725 per-chunk indexed fetch);
            # all index-based access below is window-relative and self-consistent
            bam.prepare_span(tid_per_bam[s], lo, hi)
            rt = read_types[s] if s < len(read_types) else "short"
            mask = bam.filter_mask(
                tid_per_bam[s], cfg.mapq_threshold, read_type=rt,
                min_long_read_size=cfg.min_long_read_size,
                min_long_read_average_base_qual=cfg.min_long_read_average_base_qual,
                include_improper_pairs=flag_filter.include_improper_pairs,
                include_supplementary=flag_filter.include_supplementary)
            cols = None
            if mask is not None and (thresholds is None
                                     or not thresholds.active):
                cols = getattr(bam, "columnar", lambda t: None)(tid_per_bam[s])
            if cols is not None:
                from lorikeet_tpu_torch.models.activity import accumulate_reads_columnar
                idx = bam.fetch_indices(tid_per_bam[s], lo, hi, mask=mask)
                if accumulate_reads_columnar(
                        profiles[s], cols, idx, ref_seq[lo:hi], lo, hi,
                        bq=cfg.min_base_quality, ploidy=cfg.ploidy):
                    sample_reads[s] = ("lazy", bam, tid_per_bam[s], idx)
                    continue
            candidates = []
            for rec in bam.fetch(tid_per_bam[s], lo, hi, mask=mask):
                if mask is None and not _read_passes_filters(
                        rec, cfg.mapq_threshold, read_type=rt,
                        min_long_read_size=cfg.min_long_read_size,
                        min_long_read_average_base_qual=cfg.min_long_read_average_base_qual,
                        flag_filter=flag_filter):
                    continue
                rec.sample_index = s
                candidates.append(rec)
            if thresholds is not None and thresholds.active:
                from lorikeet_tpu_torch.io.filter import apply_alignment_thresholds
                candidates = apply_alignment_thresholds(candidates, thresholds)
            sample_reads[s] = ("eager", candidates)
            accumulate_reads(profiles[s], candidates, ref_seq[lo:hi], lo, hi,
                             bq=cfg.min_base_quality, ploidy=cfg.ploidy)

    with _prog.global_stage("smooth_extract"):
        result.depth_pass_rle = [
            _rle_encode((p.dp() >= getattr(cfg, "depth_per_sample_filter",
                                           DEPTH_PER_SAMPLE_FILTER))
                        [core_lo - lo:core_hi - lo]) for p in profiles]
        gls = np.stack([p.finalize_gls(cfg.ploidy) for p in profiles])
        hq_n = sum(p.hq_sc_n for p in profiles)
        hq_sum = sum(p.hq_sc_sum for p in profiles)
        hq_mean = np.where(hq_n > 0, hq_sum / np.maximum(hq_n, 1), 0.0)
        prop = getattr(cfg, "max_prob_propagation_distance", 50)
        if getattr(cfg, "device_activity", False):
            # EM + band-pass as one chain of torch ops on the devices; in a
            # pool worker, on the parent's
            args = (gls, hq_mean, cfg.ploidy, cfg.snp_heterozygosity,
                    cfg.heterozygosity_stdev, cfg.stand_min_conf, prop)
            if DEVICE_ACTIVITY is not None:
                smoothed = DEVICE_ACTIVITY(*args)
            else:
                from lorikeet_tpu_torch.parallel.pipeline import (
                    smoothed_activity_device)
                smoothed = smoothed_activity_device(
                    *args[:-1], max_prob_propagation=prop,
                    devices=_activity_devices(cfg))
        else:
            raw_probs = active_probabilities(gls, cfg.ploidy,
                                             cfg.snp_heterozygosity,
                                             cfg.heterozygosity_stdev,
                                             cfg.stand_min_conf)
            smoothed = band_pass_smooth(raw_probs, hq_mean,
                                        max_prob_propagation=prop)
        # forced-calling feature VCF: regions carrying given alleles are called
        # even when inactive (haplotype_caller_engine.rs:1166-1177) — realised
        # here by forcing the activity probability at given starts
        given_span = []
        if getattr(cfg, "features_vcf", None):
            from lorikeet_tpu_torch.calling.given_alleles import load_feature_vcf
            by_contig = load_feature_vcf(cfg.features_vcf)
            given_span = [vc for vc in by_contig.get(contig_name, [])
                          if lo <= vc.start < hi]
            if given_span:
                smoothed = np.asarray(smoothed).copy()
                for vc in given_span:
                    smoothed[vc.start - lo] = 1.0
        regions = extract_regions(smoothed,
                                  active_prob_threshold=cfg.active_prob_threshold,
                                  min_region_size=cfg.min_assembly_region_size,
                                  max_region_size=cfg.max_assembly_region_size)
        result.n_regions = sum(1 for r in regions
                               if core_lo <= lo + r.start < core_hi)

    with _prog.global_stage("region_prep"):
        # ---- prepare each active region (host), then run ONE batched pair-HMM
        # dispatch for the whole span (regions are owned by the chunk their
        # active span STARTS in, so halo overlaps never double-call) ----
        from lorikeet_tpu_torch.calling.clipping import (
            finalize_region_reads, finalize_region_reads_columnar,
        )
        from lorikeet_tpu_torch.calling.engine import call_regions_batched
        # vectorized read-span index per sample: one (pos, reference_end) array
        # pair instead of O(reads x regions) per-record property calls
        span_arrays = []
        for s in range(n_samples):
            kind = sample_reads[s]
            if kind[0] == "lazy":
                _, b, t, idx = kind
                c = b.columnar(t)
                span_arrays.append((c["pos"][idx], c["ends"][idx]))
            else:
                rs = kind[1]
                span_arrays.append((
                    np.fromiter((r.pos for r in rs), np.int64, len(rs)),
                    np.fromiter((r.reference_end for r in rs), np.int64,
                                len(rs))))
        works, drafts = [], []
        for region in regions:
            if not region.is_active:
                continue
            active_start = lo + region.start
            active_end = lo + region.end
            if not (core_lo <= active_start < core_hi):
                continue
            result.n_active += 1
            pad_start = max(0, active_start - cfg.assembly_region_padding)
            pad_end = min(length - 1, active_end + cfg.assembly_region_padding)
            window = ref_seq[pad_start:pad_end + 1]
            reads_by_sample = {}
            with _prog.substage("finalize"):
                for s in range(n_samples):
                    pos_a, end_a = span_arrays[s]
                    sel = np.flatnonzero((pos_a <= pad_end) & (end_a > pad_start))
                    sel = sel[:cfg.max_input_depth]
                    kind = sample_reads[s]
                    if kind[0] == "lazy":
                        # native columnar finalize: records_at + the whole clipping
                        # chain fused into one C++ call — each kept read
                        # materializes once, already clipped/qual-adjusted
                        _, b, t, idx = kind
                        fin = finalize_region_reads_columnar(
                            b, t, idx[sel], s, pad_start, pad_end,
                            min_base_quality=cfg.min_base_quality,
                            dont_use_soft_clipped_bases=
                            cfg.dont_use_soft_clipped_bases,
                            soft_clip_low_quality_ends=
                            cfg.soft_clip_low_quality_ends)
                        if fin is None:           # no native toolchain
                            fin = finalize_region_reads(
                                {s: b.records_at(t, idx[sel], sample_index=s)},
                                pad_start, pad_end,
                                min_base_quality=cfg.min_base_quality,
                                dont_use_soft_clipped_bases=
                                cfg.dont_use_soft_clipped_bases,
                                soft_clip_low_quality_ends=
                                cfg.soft_clip_low_quality_ends)[s]
                        reads_by_sample[s] = fin
                    else:
                        rs = kind[1]
                        reads_by_sample[s] = finalize_region_reads(
                            {s: [rs[i] for i in sel.tolist()]}, pad_start, pad_end,
                            min_base_quality=cfg.min_base_quality,
                            dont_use_soft_clipped_bases=
                            cfg.dont_use_soft_clipped_bases,
                            soft_clip_low_quality_ends=
                            cfg.soft_clip_low_quality_ends)[s]
            given_here = [vc for vc in given_span
                          if vc.start <= pad_end and vc.end >= pad_start]
            # fraction of active-span positions meaningfully active, keys the
            # automatic extra kmer sizes (activity_profile.rs:506-518 density
            # over smoothed probs > 0.05)
            span_probs = smoothed[region.start:region.end + 1]
            density = float(np.mean(span_probs > 0.05)) if len(span_probs) else 0.0
            draft = engine.draft_region(window, pad_start, active_start,
                                        active_end, reads_by_sample,
                                        tid=result.tid,
                                        given_alleles=given_here,
                                        activity_density=density,
                                        finalized=True)
            if draft is not None:
                drafts.append(draft)
        # every region's haplotype CIGARs at once, their SW one batch of
        # the span (on the card where the run has one), then each region
        # on to its events, trim and pairs
        for draft, cigars in zip(drafts, _span_hap_cigars(cfg, drafts)):
            work = engine.complete_region(draft, cigars)
            if work is not None:
                works.append(work)
    if defer:
        return result, works
    if works:
        from lorikeet_tpu_torch.calling.engine import (
            compute_works_likelihoods)
        lks = compute_works_likelihoods(engine, works)
        with _prog.global_stage("genotype"):
            for calls in call_regions_batched(engine, works, lks):
                result.calls.extend(calls)
    return result


@dataclass
class GenomeSpec:
    """One genome inside one FASTA: named subset of contigs.

    The reference concatenates genomes into one FASTA with contigs named
    `genome~contig` (reference_reader_utils.rs:250-311 SEPARATOR '~'); a
    FASTA without '~' names is a single genome named by file stem."""
    name: str
    fasta: str
    contigs: list


def discover_genomes(references: list, genome_dir: str = None,
                     extension: str = "fna") -> list:
    """Genome discovery from CLI inputs (reference_reader_utils.rs:160-311
    parse_references): explicit FASTA paths and/or a directory scan."""
    import glob as _glob
    paths = list(references or [])
    if genome_dir:
        paths.extend(sorted(_glob.glob(os.path.join(genome_dir,
                                                    f"*.{extension}"))))
    specs = []
    for path in paths:
        fr = FastaReader(path)
        names = fr.names
        if names and all("~" in n for n in names):
            by_genome = {}
            for n in names:
                by_genome.setdefault(n.split("~", 1)[0], []).append(n)
            for gname, contigs in by_genome.items():
                specs.append(GenomeSpec(gname, path, contigs))
        else:
            stem = os.path.splitext(os.path.basename(path))[0]
            specs.append(GenomeSpec(stem, path, list(names)))
    return specs


# config fields that only steer execution, not results — excluded from the
# checkpoint fingerprint so resuming with e.g. a different -t reuses work
_EXECUTION_ONLY_CFG = frozenset({"threads", "checkpoint", "graph_output"})


def _cfg_fingerprint(cfg) -> str:
    """Stable digest of the calling-relevant config (object-typed knobs
    contribute their class name + public attrs)."""
    import dataclasses
    import hashlib
    parts = []
    for f in dataclasses.fields(cfg):
        if f.name in _EXECUTION_ONLY_CFG:
            continue
        v = getattr(cfg, f.name)
        if isinstance(v, (int, float, str, bool, tuple, list, type(None))):
            parts.append(f"{f.name}={v!r}")
        else:
            attrs = sorted(getattr(v, "__dict__", {}).items())
            parts.append(f"{f.name}={type(v).__name__}:{attrs!r}")
    return hashlib.sha256(";".join(parts).encode()).hexdigest()[:16]


def _chunk_key(contig: str, bams: list, cfg_fp: str,
               fasta_path: str = "") -> str:
    """Checkpoint key: contig + the reference FASTA's and every BAM's
    (path, size, mtime) + config."""
    import hashlib
    h = hashlib.sha256()
    h.update(contig.encode())
    h.update(cfg_fp.encode())
    try:
        st = os.stat(fasta_path)
        h.update(f"{fasta_path}:{st.st_size}:{st.st_mtime_ns}".encode())
    except OSError:
        h.update(fasta_path.encode())
    for b in bams:
        p = getattr(b, "path", "")
        try:
            st = os.stat(p)
            h.update(f"{p}:{st.st_size}:{st.st_mtime_ns}".encode())
        except OSError:
            h.update(p.encode())
    return h.hexdigest()[:24]


def _call_contigs(spec, fasta, bams, cfg, engine, limit,
                  checkpoint_dir: str = None) -> list:
    """Per-contig results, threaded over contigs when cfg.threads allows
    (the reference's rayon contig parallelism,
    haplotype_caller_engine.rs:443-465).  Contigs touch disjoint BAM record
    sets, so after an eager decode the readers are shared read-only; each
    worker opens its own FastaReader (the handle seeks)."""
    min_size = getattr(cfg, "min_contig_size", 0) or 0
    n_workers = min(getattr(cfg, "threads", 1) or 1, len(spec.contigs))

    cfg_fp = _cfg_fingerprint(cfg) if checkpoint_dir else None

    def _one(local_fasta, contig, chunk_threads=1, local_bams=None):
        local_bams = bams if local_bams is None else local_bams
        # contigs below --min-contig-size are skipped outright
        # (haplotype_caller_engine.rs:340,418 min_contig_length gate)
        if min_size and local_fasta.length(contig) < min_size:
            return ContigResult(tid=0)
        # per-contig checkpoint: long multi-contig jobs resume where they
        # stopped (beyond the reference's genome-level artifact cache,
        # lorikeet_engine.rs:135-157; SURVEY §5 checkpointed region queues)
        ck_path = None
        if checkpoint_dir is not None and limit is None:
            import pickle
            ck_path = os.path.join(
                checkpoint_dir,
                _chunk_key(contig, bams, cfg_fp, spec.fasta) + ".pkl")
            if os.path.exists(ck_path):
                try:
                    with open(ck_path, "rb") as fh:
                        return pickle.load(fh)
                except Exception:  # noqa: BLE001 — corrupt: recompute
                    pass
        result = call_contig(local_fasta, local_bams, contig, cfg, engine,
                             limit=limit, chunk_threads=chunk_threads)
        if ck_path is not None:
            import pickle
            os.makedirs(checkpoint_dir, exist_ok=True)
            tmp = ck_path + ".tmp"
            with open(tmp, "wb") as fh:
                pickle.dump(result, fh)
            os.replace(tmp, ck_path)
        return result

    from multiprocessing import current_process
    streaming = any(getattr(b, "is_streaming", False) for b in bams)
    requested = getattr(cfg, "threads", 1) or 1
    inner = int(os.environ.get("LORIKEET_CHUNK_THREADS", "1"))
    # a process of a pool (the per-genome processes, a span worker) never
    # starts a pool of its own
    if requested > 1 and inner <= 1 \
            and current_process().name == "MainProcess" \
            and os.environ.get("LORIKEET_SPAN_POOL", "1") != "0" \
            and _pool_worthwhile(spec, fasta, bams, cfg, limit):
        # persistent span-worker pool: -t workers survive across contigs
        # AND genomes (a spawn and a BAM decode each), all contigs' chunk
        # spans fan out together, and when the parent holds the card its
        # device service runs the workers' pair-HMM batches (the rayon
        # region fan-out of assembly_region_walker.rs:139-141, with the
        # card as a shared service instead of a contended resource)
        from lorikeet_tpu_torch.parallel.pool import get_pool
        # workers are full processes (not rayon threads): oversubscribing
        # cores just multiplies startup + decode; clamp to the box
        n_pool = min(requested, os.cpu_count() or requested)
        pool = get_pool(spec.fasta, [b.path for b in bams], cfg, n_pool,
                        device_service=not _cpu_only_backend(cfg)
                        or getattr(cfg, "device_activity", False))
        return _call_contigs_pooled(spec, fasta, bams, cfg, limit,
                                    checkpoint_dir, cfg_fp, min_size, pool)
    if n_workers <= 1 or len(spec.contigs) <= 1:
        # chunk-level threading exists (call_contig chunk_threads) but the
        # chunk hot path is GIL-bound Python — measured SLOWER threaded
        # (29s vs 16s on a 400kb contig), so threads stay off by default
        # (opt in via LORIKEET_CHUNK_THREADS for native-dominated loads).
        return [_one(fasta, c, chunk_threads=inner)
                for c in spec.contigs]
    if not streaming:
        for b in bams:
            b._ensure_decoded()

    def work(contig):
        local_fasta = FastaReader(spec.fasta)
        # a streaming reader holds ONE decoded window, so concurrent contigs
        # must not share it — each worker opens its own indexed handle
        local_bams = ([open_bam(b.path, streaming=True) for b in bams]
                      if streaming else bams)
        try:
            return _one(local_fasta, contig, local_bams=local_bams)
        finally:
            local_fasta.close()

    # the shared engine carries per-traversal genotyping state
    # (GenotypingEngine._upstream_dels for spanning-deletion suppression),
    # so concurrent contigs must each get their own engine
    engine = None

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(n_workers) as ex:
        return list(ex.map(work, spec.contigs))


def _pool_worthwhile(spec, fasta, bams, cfg, limit) -> bool:
    """Worker processes cost a spawn and a BAM decode each: only build a
    pool when the genome has enough chunk work to amortize it, unless one
    is already alive (spawn already paid; tiny follow-on genomes ride it
    for free)."""
    from lorikeet_tpu_torch.parallel.pool import pool_alive
    if pool_alive():
        return True
    units = _genome_units(spec, fasta, cfg, len(bams), limit)
    total = sum(sp[1] - sp[0] for _, sp in units)
    return len(units) >= 2 and total >= 500_000


def _call_contigs_pooled(spec, fasta, bams, cfg, limit, checkpoint_dir,
                         cfg_fp, min_size, pool) -> list:
    """All contigs' chunk spans submitted to the persistent pool up front,
    gathered + checkpointed per contig afterwards (keeps every worker busy
    across contig boundaries)."""
    import pickle
    n_samples = len(bams)
    chunk_size = _chunk_size(n_samples, cfg)
    results = [None] * len(spec.contigs)
    pending = []                      # (contig_idx, ck_path, task_ids)
    for i, contig in enumerate(spec.contigs):
        if min_size and fasta.length(contig) < min_size:
            results[i] = ContigResult(tid=0)
            continue
        ck_path = None
        if checkpoint_dir is not None and limit is None:
            ck_path = os.path.join(
                checkpoint_dir,
                _chunk_key(contig, bams, cfg_fp, spec.fasta) + ".pkl")
            if os.path.exists(ck_path):
                try:
                    with open(ck_path, "rb") as fh:
                        results[i] = pickle.load(fh)
                    continue
                except Exception:  # noqa: BLE001 — corrupt: recompute
                    pass
        length = fasta.length(contig)
        lo, hi = (0, length) if limit is None else (max(0, limit[0]),
                                                    min(length, limit[1]))
        if hi <= lo:
            results[i] = ContigResult(tid=0)
            continue
        spans = ([(lo, hi, lo, hi)] if hi - lo <= chunk_size
                 else _contig_spans(lo, hi, chunk_size, cfg))
        pending.append((i, ck_path,
                        [pool.submit(contig, sp, spec.fasta,
                                     [b.path for b in bams])
                         for sp in spans]))
    for i, ck_path, ids in pending:
        result = _merge_parts(pool.gather_contig(ids), n_samples)
        if ck_path is not None:
            os.makedirs(checkpoint_dir, exist_ok=True)
            tmp = ck_path + ".tmp"
            with open(tmp, "wb") as fh:
                pickle.dump(result, fh)
            os.replace(tmp, ck_path)
        results[i] = result
    return results


def run_genome(spec: GenomeSpec, bams: list, genome_dir: str,
               cfg: CallerConfig, sample_names: list, limit=None) -> dict:
    """Call one genome's contigs; write `{genome}.vcf` + ANI tables.

    Mirrors the per-genome task of lorikeet_engine.rs:77-520 (VCF at
    haplotype_caller_engine.rs:1948-1957, ANI at ani_calculator.rs:55).

    Under a multi-process run (torch.distributed or
    LORIKEET_PROCESS_COUNT>1) with chunk-level sharding requested, work is
    split at chunk granularity across processes (see run_genome_sharded)."""
    os.makedirs(genome_dir, exist_ok=True)
    fasta = FastaReader(spec.fasta)
    engine = HaplotypeCallerEngine(cfg)
    n_samples = len(bams)
    checkpoint_dir = (os.path.join(genome_dir, ".chunks")
                      if getattr(cfg, "checkpoint", False) else None)
    results = _call_contigs(spec, fasta, bams, cfg, engine, limit,
                            checkpoint_dir=checkpoint_dir)
    return _assemble_genome_outputs(spec, fasta, results, genome_dir, cfg,
                                    sample_names, n_samples)


def _assemble_genome_outputs(spec, fasta, results, genome_dir, cfg,
                             sample_names, n_samples) -> dict:
    """Gather per-contig results into the genome VCF + ANI tables (the
    single-writer tail of the per-genome task)."""
    from lorikeet_tpu_torch.strain.ani import run_ani
    from lorikeet_tpu_torch.utils.progress import global_stage

    with global_stage("genome.outputs", genome=spec.name):
        all_calls = []
        passing_rle = [[] for _ in range(n_samples)]
        genome_size = 0
        for local_tid, contig in enumerate(spec.contigs):
            res = results[local_tid]
            for vc in res.calls:
                vc.tid = local_tid
            all_calls.extend(res.calls)
            for s in range(n_samples):
                rle = (res.depth_pass_rle[s] if s < len(res.depth_pass_rle)
                       else [-fasta.length(contig)])
                passing_rle[s].extend(rle or [-fasta.length(contig)])
            genome_size += fasta.length(contig)

        contig_lengths = [fasta.length(n) for n in spec.contigs]
        vcf_path = os.path.join(genome_dir, f"{spec.name}.vcf")
        write_vcf(vcf_path, all_calls, spec.contigs, contig_lengths, sample_names)
        ani_paths = run_ani(all_calls, os.path.join(genome_dir, spec.name),
                            sample_names, spec.name, genome_size,
                            passing_sites=passing_rle,
                            qual_by_depth_filter=getattr(
                                cfg, "qual_by_depth_filter", 25.0),
                            depth_per_sample_filter=getattr(
                                cfg, "depth_per_sample_filter", 5))
        return {"vcf": vcf_path, "ani": ani_paths, "n_calls": len(all_calls)}


def _genome_units(spec, fasta, cfg, n_samples, limit=None) -> list:
    """The genome's global chunk work-list: (contig_index, span) in
    deterministic traversal order.  Every process of a multi-host run
    computes the identical list, so round-robin index sharding needs no
    coordination (SURVEY §2.4 rows 1-2: region-level work distribution)."""
    min_size = getattr(cfg, "min_contig_size", 0) or 0
    chunk_size = _chunk_size(n_samples, cfg)
    units = []
    for ci, contig in enumerate(spec.contigs):
        length = fasta.length(contig)
        if min_size and length < min_size:
            continue
        lo, hi = (0, length) if limit is None else (max(0, limit[0]),
                                                    min(length, limit[1]))
        if hi <= lo:
            continue
        if hi - lo <= chunk_size:
            units.append((ci, (lo, hi, lo, hi)))
        else:
            units.extend((ci, sp) for sp in _contig_spans(lo, hi,
                                                          chunk_size, cfg))
    return units


def run_genome_sharded(spec: GenomeSpec, bams: list, genome_dir: str,
                       cfg: CallerConfig, sample_names: list, limit=None,
                       process_index: int = None,
                       process_count: int = None) -> dict:
    """Chunk-level multi-process run of one genome (SURVEY §2.4 rows 1-2,
    the region-queue half the genome-round-robin of parallel/hosts.py does
    not cover): every process computes the identical global chunk list,
    takes units round-robin by index, writes one shard file per unit into
    ``genome_dir/.shards``, and process 0 gathers all shards in traversal
    order to assemble the final VCF + ANI tables (the reference's
    single-writer VCF tail, haplotype_caller_engine.rs:1948-1957).

    Shards ride the job's shared filesystem — the same channel the
    reference's per-genome output cache uses (lorikeet_engine.rs:135-157) —
    so no collective is needed for what is a host-side gather of Python
    records.  Worker processes return {"vcf": None, "role": "worker"}."""
    import pickle
    import time as _time

    from lorikeet_tpu_torch.parallel.hosts import distributed_context

    if process_index is None or process_count is None:
        process_index, process_count = distributed_context()
    if process_count <= 1:
        return run_genome(spec, bams, genome_dir, cfg, sample_names,
                          limit=limit)
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} out of range for "
                         f"process_count {process_count}")
    os.makedirs(genome_dir, exist_ok=True)
    # the shard dir name carries a fingerprint of everything that shifts
    # unit boundaries or changes results (cfg + input file stats + limit +
    # sample count): a resumed run with changed inputs lands in a fresh dir
    # instead of silently reusing shards computed for different spans
    import hashlib
    shard_fp = hashlib.sha256(
        (_chunk_key("*shards*", bams, _cfg_fingerprint(cfg), spec.fasta)
         + f":{limit}:{len(bams)}").encode()).hexdigest()[:16]
    shard_dir = os.path.join(genome_dir, f".shards-{shard_fp}")
    os.makedirs(shard_dir, exist_ok=True)
    fasta = FastaReader(spec.fasta)
    n_samples = len(bams)
    units = _genome_units(spec, fasta, cfg, n_samples, limit=limit)

    engine = HaplotypeCallerEngine(cfg)
    for ui in range(process_index, len(units), process_count):
        ci, sp = units[ui]
        path = os.path.join(shard_dir, f"u{ui:06d}.pkl")
        if os.path.exists(path):
            continue  # resumed run: shard already computed
        if not os.path.isdir(shard_dir):
            break  # gatherer already collected + removed the dir: done
        part = _call_span(fasta, bams, spec.contigs[ci], cfg, engine, *sp)
        tmp = f"{path}.p{process_index}.tmp"
        try:
            with open(tmp, "wb") as fh:
                pickle.dump((ci, part), fh)
            os.replace(tmp, path)  # atomic: gatherers never see partials
        except FileNotFoundError:
            # gatherer rmtree'd the dir between the isdir check and the
            # write (resume race): gather is complete, stop quietly
            break

    if process_index != 0:
        return {"vcf": None, "role": "worker", "units": len(units)}

    # ---- gather (process 0): wait for every unit shard, merge in order.
    # Fault tolerance: if no new shard lands for LORIKEET_SHARD_GRACE
    # seconds (a worker died or stalled), the gatherer steals the missing
    # units and computes them itself — a dead worker costs one grace period
    # plus its units' compute, never a 24 h poll (the reference's per-genome
    # try/continue, SURVEY §5, at shard granularity).
    deadline = _time.time() + float(
        os.environ.get("LORIKEET_SHARD_TIMEOUT", "86400"))
    grace = float(os.environ.get("LORIKEET_SHARD_GRACE", "60"))
    paths = [os.path.join(shard_dir, f"u{ui:06d}.pkl")
             for ui in range(len(units))]
    missing = {ui for ui, p in enumerate(paths) if not os.path.exists(p)}
    last_progress = _time.time()
    while missing:
        if _time.time() > deadline:
            raise TimeoutError(
                f"{len(missing)} of {len(units)} chunk shards missing after "
                f"LORIKEET_SHARD_TIMEOUT (first: u{min(missing):06d})")
        if _time.time() - last_progress > grace:
            # steal: compute missing units here, lowest index first; late
            # workers racing us is fine (atomic os.replace, same content)
            for ui in sorted(missing):
                if os.path.exists(paths[ui]):
                    continue
                ci, sp = units[ui]
                part = _call_span(fasta, bams, spec.contigs[ci], cfg,
                                  engine, *sp)
                tmp = f"{paths[ui]}.steal{process_index}.tmp"
                with open(tmp, "wb") as fh:
                    pickle.dump((ci, part), fh)
                os.replace(tmp, paths[ui])
            missing = {ui for ui in missing if not os.path.exists(paths[ui])}
            break
        _time.sleep(0.05)
        now_missing = {ui for ui in missing
                       if not os.path.exists(paths[ui])}
        if now_missing != missing:
            last_progress = _time.time()
            missing = now_missing
    if missing:
        raise RuntimeError(
            f"{len(missing)} chunk shards still missing after work-stealing")

    per_contig = {}
    for ui, path in enumerate(paths):
        with open(path, "rb") as fh:
            ci, part = pickle.load(fh)
        merged = per_contig.get(ci)
        if merged is None:
            per_contig[ci] = part
        else:
            merged.calls.extend(part.calls)
            merged.n_regions += part.n_regions
            merged.n_active += part.n_active
            for s in range(n_samples):
                _rle_concat(merged.depth_pass_rle[s],
                            part.depth_pass_rle[s])
    results = [per_contig.get(ci, ContigResult(tid=0))
               for ci in range(len(spec.contigs))]
    out = _assemble_genome_outputs(spec, fasta, results, genome_dir, cfg,
                                   sample_names, n_samples)
    import glob as _glob
    import shutil
    # drop this run's shards and any stale-fingerprint dirs from prior runs
    for d in _glob.glob(os.path.join(genome_dir, ".shards-*")):
        shutil.rmtree(d, ignore_errors=True)
    return out


def split_bams_to_genomes(bam_paths: list, bams: list, specs: list,
                          cache_dir: str, writer_only: bool = False) -> dict:
    """One BAM per (input BAM, genome) holding only that genome's contigs
    (split_bams_to_references, index_bams.rs:84-160).  Returns
    {(bam_path, genome_name): split_path}; split files keep the full
    sequence dictionary and header (tids stay stable) and are reused when
    already present.

    Tmp names are pid-unique so concurrent processes over a shared
    cache_dir never interleave writes into the same tmp file.  With
    ``writer_only=False`` on a multi-process run, callers should let only
    one process write (see start_engine) and have the rest wait on the
    ``.split_done`` marker via wait_for_split_bams."""
    from lorikeet_tpu_torch.io.bam_writer import write_bam
    os.makedirs(cache_dir, exist_ok=True)
    out = {}
    for p, rdr in zip(bam_paths, bams):
        stem = os.path.splitext(os.path.basename(p))[0]
        for spec in specs:
            dest = os.path.join(cache_dir, f"{stem}_{spec.name}.bam")
            out[(p, spec.name)] = dest
            if os.path.exists(dest):
                continue
            tids = sorted(rdr.tid(c) for c in spec.contigs
                          if c in rdr.references)
            recs = [r for t in tids for r in rdr.fetch(t)]
            # write atomically: an interrupted run must not leave a
            # truncated BAM that later runs silently reuse
            tmp = f"{dest}.p{os.getpid()}.tmp"
            write_bam(tmp, rdr.references, rdr.lengths, recs,
                      header_text=(rdr.header_text + "\n"
                                   if rdr.header_text
                                   and not rdr.header_text.endswith("\n")
                                   else rdr.header_text) or None)
            if os.path.exists(tmp + ".bai"):
                os.replace(tmp + ".bai", dest + ".bai")
            os.replace(tmp, dest)
    if writer_only:
        # completion marker for multi-process waiters (all dests + indices
        # are in place once this lands)
        marker = os.path.join(cache_dir, ".split_done")
        with open(marker + f".p{os.getpid()}.tmp", "w") as fh:
            fh.write("ok")
        os.replace(marker + f".p{os.getpid()}.tmp", marker)
    return out


def wait_for_split_bams(bam_paths: list, specs: list, cache_dir: str,
                        timeout: float = None) -> dict:
    """Non-writing processes of a multi-process run: wait for the writer's
    ``.split_done`` marker, then return the same {(bam, genome): path} map
    split_bams_to_genomes would."""
    import time as _time
    marker = os.path.join(cache_dir, ".split_done")
    deadline = _time.time() + (timeout if timeout is not None else float(
        os.environ.get("LORIKEET_SHARD_TIMEOUT", "86400")))
    while not os.path.exists(marker):
        if _time.time() > deadline:
            raise TimeoutError(f"split-BAM writer never finished: {marker}")
        _time.sleep(0.05)
    return {(p, spec.name): os.path.join(
                cache_dir,
                f"{os.path.splitext(os.path.basename(p))[0]}_{spec.name}.bam")
            for p in bam_paths for spec in specs}


def start_engine(mode: str, references: list, bam_paths: list,
                 output_dir: str, cfg: CallerConfig = None,
                 genome_dir: str = None, extension: str = "fna",
                 sample_names=None, limit=None, force: bool = False,
                 long_bam_paths: list = None,
                 parallel_genomes: int = 1,
                 split_bams: bool = False,
                 bam_cache_dir: str = None) -> dict:
    """Multi-genome orchestrator (start_lorikeet_engine,
    lorikeet_engine.rs:1075 + apply_per_reference :77): one output directory
    per genome, artifact-presence caching unless `force`
    (lorikeet_engine.rs:135-157)."""
    cfg = cfg or CallerConfig()
    os.makedirs(output_dir, exist_ok=True)
    _configure_devices(cfg)
    specs = discover_genomes(references, genome_dir, extension)
    # multi-host pod slice (SURVEY §2.4 rows 1-2): with at least one genome
    # per process, each process takes its genome subset (outputs are
    # per-genome disjoint directories); with fewer genomes than processes,
    # every process keeps every genome and work shards at CHUNK granularity
    # inside run_genome_sharded instead (the reference's region-level rayon
    # parallelism, assembly_region_walker.rs:139-141, spread across hosts)
    from lorikeet_tpu_torch.parallel.hosts import host_shard
    from lorikeet_tpu_torch.parallel.hosts import distributed_context
    pidx, pcnt = distributed_context()
    cfg.chunk_shard = pcnt > 1 and len(specs) < pcnt
    # pin the context on cfg: spawned children (process pools) see
    # distributed_context() == (0, 1) and would otherwise duplicate the
    # whole genome on every host
    cfg.process_index, cfg.process_count = pidx, pcnt
    if not cfg.chunk_shard:
        specs = host_shard(specs, pidx, pcnt)
    # long-read samples follow the short-read samples, as in the reference
    # (haplotype_caller_engine.rs:515-524)
    long_bam_paths = long_bam_paths or []
    all_paths = list(bam_paths) + list(long_bam_paths)
    cfg.read_types = (["short"] * len(bam_paths)
                      + ["long"] * len(long_bam_paths))
    bams = [open_bam(p, high_memory=getattr(cfg, "high_memory", False))
            for p in all_paths]
    bam_paths = all_paths
    if sample_names is None:
        sample_names = []
        for k, b in enumerate(bams):
            names = b.sample_names()
            sample_names.append(names[0] if names else f"sample{k}")

    from lorikeet_tpu_torch.utils.progress import ProgressTree, StageTimer, log

    split_map = None
    if split_bams and len(specs) > 1:
        # per-genome BAM split: each genome task decodes only its own
        # (much smaller) BAM — the reference does this to avoid file-lock
        # contention across genome threads (index_bams.rs:84).  In
        # chunk-shard mode every process holds every spec, so exactly one
        # process writes the shared cache and the rest wait on its marker
        # (concurrent writers over one cache_dir would duplicate work).
        split_cache = bam_cache_dir or os.path.join(output_dir, "split_bams")
        if getattr(cfg, "chunk_shard", False) and pidx != 0:
            split_map = wait_for_split_bams(bam_paths, specs, split_cache)
        else:
            split_map = split_bams_to_genomes(
                bam_paths, bams, specs, split_cache,
                writer_only=getattr(cfg, "chunk_shard", False))

    progress = ProgressTree(len(specs))
    results = {}

    def run_one(spec):
        """Per-genome task (lorikeet_engine.rs:82,100 scoped threadpool
        role; host-bound stages overlap, device dispatches serialize)."""
        if split_map is not None:
            genome_bams = [open_bam(split_map[(p, spec.name)],
                                    high_memory=getattr(cfg, "high_memory",
                                                        False))
                           for p in bam_paths]
        else:
            genome_bams = bams
        _process_genome(spec, mode, genome_bams, bam_paths, long_bam_paths,
                        output_dir, cfg, sample_names, limit, force,
                        progress, results, log, StageTimer)

    if parallel_genomes > 1 and len(specs) > 1:
        if _cpu_only_backend(cfg):
            # real multi-core scaling: one PROCESS per genome (the
            # reference's scoped threadpool has no GIL; Python threads
            # serialize the host-bound hot path).  Children run CPU-only —
            # used when no card is in play anyway.
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor
            payloads = []
            for spec in specs:
                genome_paths = ([split_map[(p, spec.name)]
                                 for p in bam_paths]
                                if split_map is not None else bam_paths)
                payloads.append((spec, mode, genome_paths, bam_paths,
                                 long_bam_paths, output_dir, cfg,
                                 sample_names, limit, force))
            ctx = mp.get_context("spawn")
            with ProcessPoolExecutor(max_workers=parallel_genomes,
                                     mp_context=ctx) as pool:
                for name, out in pool.map(_genome_task, payloads):
                    results[name] = out
                    progress.finish_genome(name)
        else:
            # card in play: threads overlap host stages with device
            # dispatch without contending for the chip across processes
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=parallel_genomes) as pool:
                list(pool.map(run_one, specs))
    else:
        for spec in specs:
            run_one(spec)
    return results


def _genome_task(payload):
    """Process-pool worker: runs one genome CPU-only in a fresh
    interpreter and returns (genome_name, result dict)."""
    (spec, mode, genome_bam_paths, bam_paths, long_bam_paths, output_dir,
     cfg, sample_names, limit, force) = payload
    # FORCE no card (not setdefault): spawned workers inherit the parent's
    # environment and would otherwise all contend for the single card.
    # Workers are CPU-only by design; the parent process owns the device.
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from lorikeet_tpu_torch.utils.progress import ProgressTree, StageTimer, log
    bams = [open_bam(p, high_memory=getattr(cfg, "high_memory", False))
            for p in genome_bam_paths]
    progress = ProgressTree(1, enabled=False)
    results = {}
    _process_genome(spec, mode, bams, bam_paths, long_bam_paths,
                    output_dir, cfg, sample_names, limit, force,
                    progress, results, log, StageTimer)
    return spec.name, results.get(spec.name)


def _process_genome(spec, mode, bams, bam_paths, long_bam_paths, output_dir,
                    cfg, sample_names, limit, force, progress, results, log,
                    StageTimer):
    timer = StageTimer()
    gdir = os.path.join(output_dir, spec.name)
    vcf_path = os.path.join(gdir, f"{spec.name}.vcf")
    if os.path.exists(vcf_path) and not force:
        progress.update(spec.name, "cached — skipping (use --force)")
        results[spec.name] = {"vcf": vcf_path, "cached": True}
        progress.done += 1
        return
    if force and getattr(cfg, "checkpoint", False):
        # --force also invalidates per-contig checkpoints
        import shutil
        shutil.rmtree(os.path.join(gdir, ".chunks"), ignore_errors=True)
    # per-genome isolation: one genome failing does not kill the run
    # (lorikeet_engine.rs per-genome scope tasks, SURVEY §5)
    if True:
        try:
            from lorikeet_tpu_torch.parallel.hosts import distributed_context
            pin = getattr(cfg, "process_index", None)
            is_gatherer = (not getattr(cfg, "chunk_shard", False)
                           or (pin if pin is not None
                               else distributed_context()[0]) == 0)
            if long_bam_paths and mode != "summarise" and is_gatherer \
                    and not getattr(cfg, "do_not_call_svs", False):
                # SV calling on long-read samples (lorikeet_engine.rs:370-383)
                progress.update(spec.name, "calling structural variants")
                from lorikeet_tpu_torch.strain.sv import call_structural_variants
                with timer.stage("sv"):
                    sv = call_structural_variants(
                        long_bam_paths, gdir, spec.fasta,
                        min_mapq=cfg.mapq_threshold,
                        min_sv_qual=getattr(cfg, "min_sv_qual", 3))
                sv_out = {"structural_variants": sv} if sv else {}
            else:
                sv_out = {}
            progress.update(spec.name, "calling variants")
            with timer.stage("call"):
                if getattr(cfg, "chunk_shard", False):
                    # pinned context survives into spawned children where
                    # distributed_context() would report (0, 1)
                    out = run_genome_sharded(
                        spec, bams, gdir, cfg, sample_names, limit=limit,
                        process_index=getattr(cfg, "process_index", None),
                        process_count=getattr(cfg, "process_count", None))
                else:
                    out = run_genome(spec, bams, gdir, cfg, sample_names,
                                     limit=limit)
            if out.get("vcf") is None:
                # chunk-shard worker process: shards written, the gathering
                # process owns the VCF and every post-calling stage
                results[spec.name] = out
                progress.finish_genome(spec.name)
                return
            out.update(sv_out)

            if mode == "consensus":
                progress.update(spec.name, "writing consensus genomes")
                from lorikeet_tpu_torch.strain.consensus import generate_consensus
                with timer.stage("consensus"):
                    out["consensus"] = generate_consensus(
                        spec.fasta, out["vcf"], gdir, contigs=spec.contigs,
                        genome_name=spec.name)
            elif mode == "genotype":
                progress.update(spec.name, "resolving strains")
                from lorikeet_tpu_torch.parallel.pool import WORKER_COUNTS
                from lorikeet_tpu_torch.strain.genotype_mode import run_genotype
                from lorikeet_tpu_torch.utils.progress import (annotate,
                                                               global_stage)
                # the strain layer, serial here after the pool has gathered
                # every span: the span `strain`, its parts run_genotype's
                with timer.stage("genotype"), global_stage(
                        "strain", genome=spec.name):
                    strain = run_genotype(
                        spec.fasta, out["vcf"], gdir, bam_paths=bam_paths,
                        contigs=spec.contigs, genome_name=spec.name,
                        qual_by_depth_filter=getattr(
                            cfg, "qual_by_depth_filter", 25.0),
                        min_variant_depth=getattr(
                            cfg, "min_variant_depth_for_genotyping", 10),
                        abundance_mode=getattr(
                            cfg, "abundance_mode", "leftover"))
                    annotate(samples=len(bam_paths or ()),
                             contexts=strain["n_contexts"])
                out.update(strain)
                for key, n in (("strain_contexts", "n_contexts"),
                               ("strain_clustered", "n_clustered"),
                               ("strain_groups", "n_variant_groups"),
                               ("strain_strains", "n_strains")):
                    WORKER_COUNTS[key] += strain[n]
            out["timings"] = timer.timings()
            results[spec.name] = out
        except Exception as exc:  # noqa: BLE001
            log.exception("genome %s failed", spec.name)
            results[spec.name] = {"error": f"{type(exc).__name__}: {exc}"}
        progress.finish_genome(spec.name)


def run_call(reference: str, bam_paths: list, output_dir: str,
             cfg: CallerConfig = None, sample_names=None, limit=None) -> str:
    """`call` mode over one FASTA's full contig set: returns the VCF path.
    (Single-genome convenience wrapper; start_engine is the full entry point.)"""
    cfg = cfg or CallerConfig()
    os.makedirs(output_dir, exist_ok=True)
    _configure_devices(cfg)
    fasta = FastaReader(reference)
    bams = [open_bam(p, high_memory=getattr(cfg, "high_memory", False))
            for p in bam_paths]
    if sample_names is None:
        sample_names = []
        for k, b in enumerate(bams):
            names = b.sample_names()
            sample_names.append(names[0] if names else f"sample{k}")
    engine = HaplotypeCallerEngine(cfg)
    all_calls = []
    for contig in fasta.names:
        res = call_contig(fasta, bams, contig, cfg, engine, limit=limit)
        for vc in res.calls:
            vc.tid = fasta.names.index(contig)
        all_calls.extend(res.calls)
    genome_name = os.path.splitext(os.path.basename(reference))[0]
    vcf_path = os.path.join(output_dir, f"{genome_name}.vcf")
    write_vcf(vcf_path, all_calls, fasta.names,
              [fasta.length(n) for n in fasta.names], sample_names)
    return vcf_path
