"""Realign reads to their best haplotype.

Counterpart of lorikeet_tpu/calling/realign.py
(assembly_based_caller_utils.rs:208-246 realign_reads_to_their_best_haplotype):
each read is Smith-Waterman-aligned to the haplotype with its best
likelihood and the alignment is composed through the haplotype-vs-reference
CIGAR; the best-haplotype search comes from the port's likelihoods.  The
SW runs on the native host aligner, or batched on the CUDA kernel
(ops/sw_cuda.py) with ``use_cuda_sw``, bit-identical either way; in a
``-t`` pool worker that batch goes to the parent's card (DEVICE_SW_BATCH).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from lorikeet_tpu_torch.ops.smith_waterman import (
    ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS, OverhangStrategy, align,
)
from lorikeet_tpu_torch.calling.likelihoods import search_best_alleles
from lorikeet_tpu_torch.utils.cigar import CigarBuilder

#: runs a ``use_cuda_sw`` batch: None means ops.sw_cuda.align_batch_cuda in
#: this process; a pool worker, which holds no card, sets a function that
#: sends the batch to the parent's device service (parallel/pool.py)
DEVICE_SW_BATCH = None


def _padded_hap_cigar(hap_cigar: list) -> list:
    """Hap-vs-ref cigar right-padded with 1000M (deletions dropped), the
    read-invariant prefix of create_read_aligned_to_ref
    (alignment_utils.rs:56-60) — shared by compose_to_reference's fallback
    and the per-haplotype cache in realign_reads_to_best_haplotype."""
    pb = CigarBuilder(remove_deletions=True)
    for op, n in hap_cigar:
        pb.add(op, n)
    pb.add("M", 1000)
    return pb.make()


def compose_to_reference(read_vs_hap_cigar: list, read_offset_in_hap: int,
                         hap_cigar: list, hap_ref_start: int,
                         ref_bases: np.ndarray = None,
                         read_bases: np.ndarray = None,
                         padded_hap_cigar: list = None):
    """(new_ref_pos, read-vs-ref cigar) from a read-vs-haplotype alignment.

    Faithful to create_read_aligned_to_ref (alignment_utils.rs:40-165):
    the hap-vs-ref cigar is right-padded with match so reads running off
    the haplotype stay aligned, trimmed to start at the read's offset,
    composed via apply_cigar_to_cigar (read-vs-hap soft clips become
    insertions), and — when ``ref_bases``/``read_bases`` are given —
    left-aligned with the read position adjusted for any leading deletion
    the alignment sheds."""
    from lorikeet_tpu_torch.utils.cigar import (
        CigarBuilder, CigarBuilderError, apply_cigar_to_cigar,
        left_align_indels, read_length, read_start_on_reference_haplotype,
        trim_cigar_by_bases,
    )
    from lorikeet_tpu_torch.utils.cigar import read_start_on_reference_haplotype

    # fast path: a pure-match read-vs-hap alignment whose haplotype span
    # sits inside ONE match run of the hap-vs-ref cigar composes to a
    # single M — no CIGAR construction, no trim/apply, and left-alignment is a no-op
    # (no indels to shift).  The general path below is the spec; the fuzz
    # test pins equality.
    if (padded_hap_cigar is not None and len(read_vs_hap_cigar) == 1
            and read_vs_hap_cigar[0][0] == "M"):
        n = read_vs_hap_cigar[0][1]
        q = 0
        for hop, hn in padded_hap_cigar:
            if hop in "MIS=X":                 # consumes haplotype bases
                if q <= read_offset_in_hap and \
                        read_offset_in_hap + n <= q + hn:
                    if hop != "M":
                        break                   # inside an insertion: general
                    return (hap_ref_start + read_start_on_reference_haplotype(
                        padded_hap_cigar, read_offset_in_hap),
                        [("M", n)])
                q += hn
                if q > read_offset_in_hap:
                    break                       # span crosses run boundary
    try:
        sw_builder = CigarBuilder(remove_deletions=True)
        for op, n in read_vs_hap_cigar:
            sw_builder.add(op, n)
        sw_cigar = sw_builder.make()
        padded = (padded_hap_cigar if padded_hap_cigar is not None
                  else _padded_hap_cigar(hap_cigar))
        start_on_ref_hap = read_start_on_reference_haplotype(
            padded, read_offset_in_hap)
        new_pos = hap_ref_start + start_on_ref_hap
        hap_to_ref, _, _ = trim_cigar_by_bases(
            padded, read_offset_in_hap, read_length(padded) - 1)
        composed = apply_cigar_to_cigar(sw_cigar, hap_to_ref)
        # left-alignment only ever moves indels; an indel-free cigar is a
        # guaranteed no-op (and it is the common case)
        if ref_bases is not None and read_bases is not None \
                and any(op in "ID" for op, _ in composed):
            composed, lead_removed, _ = left_align_indels(
                composed, ref_bases, read_bases, start_on_ref_hap)
            new_pos += lead_removed
        return new_pos, composed
    except (CigarBuilderError, ValueError):
        return None, []


def realign_reads_to_best_haplotype(likelihoods, haplotypes,
                                    window_start: int,
                                    use_cuda_sw: bool = False) -> int:
    """Replace each evidence read with a copy realigned via its best
    haplotype; returns the number of realigned reads.  ``haplotypes`` are
    AssembledHaplotypes whose cigars are vs the padded window at
    ``window_start``.  With ``use_cuda_sw`` the per-read SW alignments of
    the region run as one batch on the device (ops.sw_cuda, SW_DEVICE);
    the native host aligner stays the default."""
    n = 0
    ref_hap = next((h for h in haplotypes if h.is_ref), None)
    ref_bases = (np.frombuffer(ref_hap.bases, np.uint8)
                 if ref_hap is not None else None)
    # pass 1: gather (hap, core read) SW jobs across all samples
    jobs = []      # (sample, read_idx, hap, lead_s, tail_s, core_seq)
    priority = np.array([(1 if h.is_ref else 0) - (len(h.cigar) - 1)
                         for h in haplotypes], np.int64)
    for s in likelihoods.samples:
        mat = likelihoods.values[s]            # [haps, reads]
        reads = likelihoods.reads_by_sample[s]
        if mat.shape[1] == 0:
            continue
        # near-ties (within 0.2 log10) prefer the reference haplotype then
        # fewer cigar elements (haplotype_alignment_tiebreaking_priority,
        # assembly_based_caller_utils.rs:187-195)
        best, _, _ = search_best_alleles(mat, priority)
        for i, rec in enumerate(reads):
            hap = haplotypes[int(best[i])]
            if hap.is_ref:
                continue                        # already ref-aligned
            # soft clips are excluded from the SW and re-appended after
            lead_s = rec.cigar[0][1] if rec.cigar and rec.cigar[0][0] == "S" \
                else 0
            tail_s = rec.cigar[-1][1] if len(rec.cigar) > 1 \
                and rec.cigar[-1][0] == "S" else 0
            core_seq = rec.seq[lead_s:len(rec.seq) - tail_s]
            jobs.append((s, i, hap, lead_s, tail_s, core_seq))
    if not jobs:
        return 0

    if use_cuda_sw:
        run = DEVICE_SW_BATCH
        if run is None:
            from lorikeet_tpu_torch.ops.sw_cuda import align_batch_cuda as run
        aligned = run(
            [(hap.bases, core.tobytes()) for _, _, hap, _, _, core in jobs],
            ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS,
            OverhangStrategy.SOFTCLIP)
    else:
        aligned = [align(hap.bases, core.tobytes(),
                         ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS,
                         OverhangStrategy.SOFTCLIP)
                   for _, _, hap, _, _, core in jobs]

    pad_cache = {}   # hap id -> pre-padded hap-vs-ref cigar
    for (s, i, hap, lead_s, tail_s, core_seq), res in zip(jobs, aligned):
        if res is None:
            continue
        cigar, offset = res
        padded = pad_cache.get(id(hap))
        if padded is None:
            padded = pad_cache[id(hap)] = _padded_hap_cigar(hap.cigar)
        new_pos, new_cigar = compose_to_reference(
            cigar, offset, hap.cigar, window_start,
            ref_bases=ref_bases, read_bases=core_seq,
            padded_hap_cigar=padded)
        if new_pos is None or not new_cigar:
            continue
        if lead_s:
            new_cigar = [("S", lead_s)] + new_cigar
        if tail_s:
            new_cigar = new_cigar + [("S", tail_s)]
        reads = likelihoods.reads_by_sample[s]
        reads[i] = dataclasses.replace(
            reads[i], pos=new_pos, cigar=new_cigar)
        n += 1
    return n
