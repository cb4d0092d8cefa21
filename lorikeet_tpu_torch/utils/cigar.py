"""CIGAR algebra helpers.

Compact equivalents of the reference's cigar machinery
(reference/src/reads/cigar_utils.rs, cigar_builder.rs,
alignment_utils.rs): consumption accounting, trimming to a base window,
indel left-alignment, and the haplotype-vs-reference CIGAR recipe.
CIGARs are lists of (op_char, length).
"""
from __future__ import annotations

import numpy as np

CONSUMES_READ = set("MIS=X")
CONSUMES_REF = set("MDN=X")


def read_length(cigar) -> int:
    return sum(n for op, n in cigar if op in CONSUMES_READ)


def reference_length(cigar) -> int:
    return sum(n for op, n in cigar if op in CONSUMES_REF)


def read_offset_at(pos: int, read_pos: int, cigar) -> int | None:
    """Read-base index aligned at genomic `pos`, or None if the position
    falls in a deletion/skip or outside the alignment
    (read_utils.rs get_read_base_quality_at_reference_coordinate role)."""
    ref = read_pos
    off = 0
    for op, n in cigar:
        if op in ("M", "=", "X"):
            if ref <= pos < ref + n:
                return off + (pos - ref)
            ref += n
            off += n
        elif op in ("I", "S"):
            off += n
        elif op in ("D", "N"):
            if ref <= pos < ref + n:
                return None
            ref += n
        # H/P consume nothing
    return None


def merge_adjacent(cigar):
    out = []
    for op, n in cigar:
        if n == 0:
            continue
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + n)
        else:
            out.append((op, n))
    return out


class CigarBuilderError(ValueError):
    pass


class CigarBuilder:
    """Validating, normalizing CIGAR accumulator
    (reference/src/reads/cigar_builder.rs).

    ``make()`` merges adjacent same-type elements, normalizes mixed
    insertion/deletion runs to deletion-then-insertion, optionally strips
    deletions with no aligned bases before/after them (counting the removed
    bases), and validates clip placement (leading H then S, trailing S then
    H, no clips mid-read, at least one read-consuming non-clip element).
    ``make()`` may be called repeatedly as elements accumulate; counters
    are recomputed over the full element list each time."""

    def __init__(self, remove_deletions: bool = True):
        self.remove_deletions = remove_deletions
        self.elements = []      # raw (op, len) in added order
        self.leading_deletion_bases_removed = 0
        self.trailing_deletion_bases_removed = 0

    def add(self, op: str, n: int) -> "CigarBuilder":
        if n < 0:
            raise CigarBuilderError(f"negative length {n}{op}")
        if op not in "MIDNSHP=X":
            raise CigarBuilderError(f"unknown op {op!r}")
        if n:
            self.elements.append((op, n))
        return self

    def _validate(self, elements):
        # clips only at the ends, H outside S
        n = len(elements)
        i = 0
        while i < n and elements[i][0] == "H":
            i += 1
        while i < n and elements[i][0] == "S":
            i += 1
        j = n
        while j > i and elements[j - 1][0] == "H":
            j -= 1
        while j > i and elements[j - 1][0] == "S":
            j -= 1
        core = elements[i:j]
        if any(op in "SH" for op, _ in core):
            raise CigarBuilderError(f"clips inside the read: {elements}")
        if not any(op in "MI=X" for op, _ in core):
            raise CigarBuilderError(f"fully clipped cigar: {elements}")

    def make(self):
        """Normalized [(op, len)]; raises CigarBuilderError when invalid."""
        elements = merge_adjacent(self.elements)
        # normalize maximal I/D runs to one D then one I
        # (cigar_builder.rs indel-sandwich handling)
        out = []
        i = 0
        while i < len(elements):
            op, n = elements[i]
            if op in "ID":
                d_tot = ins_tot = 0
                while i < len(elements) and elements[i][0] in "ID":
                    if elements[i][0] == "D":
                        d_tot += elements[i][1]
                    else:
                        ins_tot += elements[i][1]
                    i += 1
                if d_tot:
                    out.append(("D", d_tot))
                if ins_tot:
                    out.append(("I", ins_tot))
            else:
                out.append((op, n))
                i += 1
        leading_removed = trailing_removed = 0
        if self.remove_deletions:
            # a deletion with no aligned (M/=/X) bases before (after) it is
            # a leading (trailing) deletion and is dropped; insertions do
            # not anchor a deletion
            kept = []
            aligned_seen = 0
            aligned_total = sum(1 for op, _ in out if op in "M=X")
            for op, n in out:
                if op in "M=X":
                    aligned_seen += 1
                    kept.append((op, n))
                elif op == "D":
                    if aligned_seen == 0:
                        leading_removed += n
                    elif aligned_seen == aligned_total:
                        trailing_removed += n
                    else:
                        kept.append((op, n))
                else:
                    kept.append((op, n))
            out = merge_adjacent(kept)
        self.leading_deletion_bases_removed = leading_removed
        self.trailing_deletion_bases_removed = trailing_removed
        self._validate(out)
        return out


def clip_cigar(cigar, start: int, stop: int, clip_op: str = "S"):
    """Replace query positions [start, stop) with clip elements
    (cigar_utils.rs:149-230 clip_cigar).  Positions count soft-clipped and
    aligned read bases; hard clips pass through.  Deletions at the clip
    boundary or inside the clipped span are dropped (via CigarBuilder's
    leading/trailing deletion removal)."""
    builder = CigarBuilder(remove_deletions=True)
    pos = 0
    for op, n in cigar:
        if op == "H":
            builder.add("H", n)
            continue
        consumes = op in CONSUMES_READ
        end = pos + (n if consumes else 0)
        if end <= start or pos >= stop:
            # outside the clip; deletions exactly at the boundary are
            # meaningless and skipped (cigar_utils.rs:180-186)
            if consumes or (pos != start and pos != stop):
                builder.add(op, n)
        else:
            if not consumes:
                pos = end
                continue   # D/N inside the clipped span vanish
            lo = max(pos, start)
            hi = min(end, stop)
            if pos < lo:
                builder.add(op, lo - pos)
            kept_clip = "S" if (op == "S" and clip_op == "S") else clip_op
            builder.add(kept_clip, hi - lo)
            if end > hi:
                builder.add(op, end - hi)
        pos = end
    return builder.make()


def alignment_start_shift(cigar, num_clipped: int) -> int:
    """Reference bases skipped when hard-clipping the first ``num_clipped``
    query bases (cigar_utils.rs:281-330)."""
    ref_clipped = 0
    pos = 0
    for op, n in cigar:
        if op == "H":
            continue
        end = pos + (n if op in CONSUMES_READ else 0)
        if end <= num_clipped:
            if op in CONSUMES_REF:
                ref_clipped += n
        elif pos < num_clipped:
            if op in CONSUMES_REF:
                ref_clipped += num_clipped - pos
            break
        else:
            break
        pos = end
    return ref_clipped


def _trim_cigar(cigar, start: int, end: int, by_reference: bool):
    """Workhorse for trim_cigar_by_bases / trim_cigar_by_reference
    (alignment_utils.rs:334-386): keep the cigar portion covering
    [start, end] inclusive in read or reference coordinates, with
    zero-length elements included at both boundaries; leading/trailing
    deletions are removed by CigarBuilder and reported."""
    assert end >= start, (start, end)
    builder = CigarBuilder(remove_deletions=True)
    element_end = 0
    for op, n in cigar:
        element_start = element_end
        consumed = (op in CONSUMES_REF) if by_reference \
            else (op in CONSUMES_READ)
        element_end = element_start + (n if consumed else 0)
        if element_end < start or (element_end == start
                                   and element_start < start):
            continue
        if element_start > end and element_end > end + 1:
            break
        if element_end == element_start:
            overlap = n
        else:
            overlap = min(end + 1, element_end) - max(start, element_start)
        builder.add(op, overlap)
    out = builder.make()
    return (out, builder.leading_deletion_bases_removed,
            builder.trailing_deletion_bases_removed)


def trim_cigar_by_bases(cigar, start: int, end: int):
    """Keep the cigar portion covering READ bases [start, end] inclusive;
    returns (cigar, leading_deletion_bases_removed,
    trailing_deletion_bases_removed)."""
    return _trim_cigar(cigar, start, end, by_reference=False)


def trim_cigar_by_reference(cigar, start: int, end: int):
    """Keep the cigar portion covering REFERENCE positions [start, end]
    inclusive; same return shape as trim_cigar_by_bases."""
    return _trim_cigar(cigar, start, end, by_reference=True)


# (op13, advance_12, advance_23) per (op12, op23) pair; read-vs-hap soft
# clips behave as insertions (alignment_utils.rs:967-1049 CigarPairTransform)
_PAIR_TRANSFORM = {}
for _m12 in "M=X":
    for _m23 in "M=X":
        _PAIR_TRANSFORM[(_m12, _m23)] = ("M", 1, 1)
    for _i23 in "IS":
        _PAIR_TRANSFORM[(_m12, _i23)] = ("I", 1, 1)
    _PAIR_TRANSFORM[(_m12, "D")] = ("D", 0, 1)
for _i12 in "IS":
    for _o23 in "M=XISD":
        _PAIR_TRANSFORM[(_i12, _o23)] = ("I", 1, 0)
for _o23 in "M=X":
    _PAIR_TRANSFORM[("D", _o23)] = ("D", 1, 1)
for _i23 in "IS":
    _PAIR_TRANSFORM[("D", _i23)] = (None, 1, 1)
_PAIR_TRANSFORM[("D", "D")] = ("D", 0, 1)


def apply_cigar_to_cigar(first_to_second, second_to_third):
    """Compose two alignments: read-vs-hap through hap-vs-ref
    (alignment_utils.rs:240-281 apply_cigar_to_cigar).  Walks both cigars
    base by base applying the pair-transform table; output goes through
    CigarBuilder (leading/trailing deletions removed)."""
    first_to_second = merge_adjacent(first_to_second)
    second_to_third = merge_adjacent(second_to_third)
    builder = CigarBuilder(remove_deletions=True)
    i12 = i23 = 0          # element indices
    e12 = e23 = 0          # consumed length within current element
    while i12 < len(first_to_second) and i23 < len(second_to_third):
        op12, n12 = first_to_second[i12]
        op23, n23 = second_to_third[i23]
        op13, adv12, adv23 = _PAIR_TRANSFORM[(op12, op23)]
        # the transform is constant for an op pair: take the whole
        # remaining run at once instead of stepping base by base
        take = min(n12 - e12 if adv12 else 1 << 60,
                   n23 - e23 if adv23 else 1 << 60)
        e12 += adv12 * take
        e23 += adv23 * take
        if op13 is not None:
            builder.add(op13, take)
        if e12 == n12:
            i12 += 1
            e12 = 0
        if e23 == n23:
            i23 += 1
            e23 = 0
    return builder.make()


def read_start_on_reference_haplotype(hap_vs_ref_cigar,
                                      read_start_on_haplotype: int) -> int:
    """Reference bases before the read start, walking the hap-vs-ref cigar
    until enough haplotype bases are consumed
    (alignment_utils.rs:283-310)."""
    if read_start_on_haplotype == 0:
        return 0
    ref_consumed = 0
    hap_consumed = 0
    for op, n in hap_vs_ref_cigar:
        if op in CONSUMES_REF:
            ref_consumed += n
        if op in CONSUMES_READ:
            hap_consumed += n
        if hap_consumed >= read_start_on_haplotype:
            excess = (hap_consumed - read_start_on_haplotype
                      if op in CONSUMES_REF else 0)
            return max(ref_consumed - excess, 0)
    raise ValueError("cigar doesn't reach the read start")


def normalize_alleles(sequences, bounds, max_shift: int, trim: bool):
    """GATK normalize_alleles (alignment_utils.rs:585-639): trim redundant
    shared bases off both ends of the per-sequence index ranges, then shift
    the ranges left while the flanking bases allow.  ``bounds`` is a list of
    [start, end) lists mutated in place; returns (start_shift, end_shift)."""

    def last_base_on_right_is_same():
        idxs = [b[1] - 1 for b in bounds]
        if any(i < 0 for i in idxs):
            return False
        first = sequences[0][idxs[0]]
        return all(sequences[n][idxs[n]] == first
                   for n in range(len(sequences)))

    def first_base_on_left_is_same():
        first = sequences[0][bounds[0][0]]
        return all(sequences[n][bounds[n][0]] == first
                   for n in range(len(sequences)))

    def next_base_on_left_is_same():
        idxs = [b[0] - 1 for b in bounds]
        if any(i < 0 for i in idxs):
            return False
        first = sequences[0][idxs[0]]
        return all(sequences[n][idxs[n]] == first
                   for n in range(len(sequences)))

    start_shift = end_shift = 0
    min_size = min(b[1] - b[0] for b in bounds)
    while trim and min_size > 0 and last_base_on_right_is_same():
        for b in bounds:
            b[1] -= 1
        min_size -= 1
        end_shift += 1
    while trim and min_size > 0 and first_base_on_left_is_same():
        for b in bounds:
            b[0] += 1
        min_size -= 1
        start_shift -= 1
    while start_shift < max_shift and next_base_on_left_is_same() \
            and last_base_on_right_is_same():
        for b in bounds:
            b[0] -= 1
            b[1] -= 1
        start_shift += 1
        end_shift += 1
    return start_shift, end_shift


def left_align_indels(cigar, ref: np.ndarray, read: np.ndarray, ref_offset: int = 0):
    """Left-align (VCF-normalize) the indels of a read-vs-reference cigar.

    Faithful port of alignment_utils.rs:425-560 left_align_indels: traverse
    the cigar right to left accumulating indel ref/read ranges, and at each
    alignment block trim+shift the accumulated alleles via normalize_alleles
    — merging indels that meet inside one tandem repeat and cancelling
    insertion/deletion pairs that net out.  Returns (cigar,
    leading_deletion_bases_removed, trailing_deletion_bases_removed)."""
    cigar = merge_adjacent(cigar)
    if not any(op in "ID" for op, _ in cigar):
        return cigar, 0, 0
    ref = np.asarray(ref, np.uint8)
    read = np.asarray(read, np.uint8)
    r_end = ref_offset + reference_length(cigar)
    q_end = read_length(cigar)
    ref_range = [r_end, r_end]     # [start, end) on ref (global coords)
    read_range = [q_end, q_end]    # [start, end) on read
    result_rtl = []
    for k in range(len(cigar) - 1, -1, -1):
        op, n = cigar[k]
        on_ref = n if op in CONSUMES_REF else 0
        on_read = n if op in CONSUMES_READ else 0
        if op in "ID":
            # accumulate; shifting happens at the next alignment block
            ref_range[0] -= on_ref
            read_range[0] -= on_read
        elif ref_range[1] == ref_range[0] and read_range[1] == read_range[0]:
            ref_range = [ref_range[0] - on_ref, ref_range[1] - on_ref]
            read_range = [read_range[0] - on_read, read_range[1] - on_read]
            result_rtl.append((op, n))
        else:
            max_shift = n if op in "M=X" else 0
            max_shift = min(max_shift, ref_range[0], read_range[0])
            start_shift, end_shift = normalize_alleles(
                [ref, read], [ref_range, read_range], max_shift, True)
            # new match alignment on the right due to left-alignment
            result_rtl.append(("M", end_shift))
            emit_indel = (k == 0 or start_shift < max_shift
                          or op not in "M=X")
            new_match_left = -start_shift if start_shift < 0 else 0
            remaining_left = n if start_shift < 0 else n - start_shift
            if emit_indel:
                result_rtl.append(("D", ref_range[1] - ref_range[0]))
                result_rtl.append(("I", read_range[1] - read_range[0]))
                ref_range[1] = ref_range[0]
                read_range[1] = read_range[0]
                dr = new_match_left + (remaining_left
                                       if op in CONSUMES_REF else 0)
                ref_range = [ref_range[0] - dr, ref_range[1] - dr]
                dq = new_match_left + (remaining_left
                                       if op in CONSUMES_READ else 0)
                read_range = [read_range[0] - dq, read_range[1] - dq]
            result_rtl.append(("M", new_match_left))
            result_rtl.append((op, remaining_left))
    result_rtl.append(("D", ref_range[1] - ref_range[0]))
    result_rtl.append(("I", read_range[1] - read_range[0]))
    builder = CigarBuilder(remove_deletions=True)
    for op, n in reversed(result_rtl):
        builder.add(op, n)
    out = builder.make()
    return (out, builder.leading_deletion_bases_removed,
            builder.trailing_deletion_bases_removed)


#: N bases on each side of a haplotype CIGAR's SW pair (cigar_utils.rs:393)
SW_PAD = 10


def trivial_cigar(ref_seq: np.ndarray, alt_seq: np.ndarray):
    """calculate_cigar's cases that take no alignment: an empty alternate,
    or one of the reference's length with at most two mismatches.  None
    for every other pair."""
    if alt_seq.size == 0:
        return [("D", int(ref_seq.size))]
    if alt_seq.size == ref_seq.size:
        mismatches = int(np.count_nonzero(alt_seq != ref_seq))
        if mismatches <= 2:
            return [("M", int(ref_seq.size))]
    return None


def sw_padded(seq: np.ndarray) -> np.ndarray:
    """``seq`` between SW_PAD Ns on each side, as calculate_cigar aligns it."""
    pad = np.full(SW_PAD, ord("N"), np.uint8)
    return np.concatenate([pad, seq, pad])


def cigar_from_alignment(ref_seq: np.ndarray, alt_seq: np.ndarray,
                         cigar, offset):
    """calculate_cigar's end from the (CIGAR, offset) of the padded pair's
    SW: None on an SW failure, else the pads trimmed and the indels
    left-aligned."""
    if offset != 0 or any(op == "S" for op, _ in cigar):
        return None  # SW failure (is_s_w_failure)
    trimmed, lead_del, trail_del = trim_cigar_by_bases(
        cigar, SW_PAD, alt_seq.size + SW_PAD - 1)
    # restore trailing deletions for left-alignment; it may remove them
    # again and report them (cigar_utils.rs:421-456)
    if trail_del > 0:
        trimmed = trimmed + [("D", trail_del)]
    aligned, la_lead, la_trail = left_align_indels(
        trimmed, ref_seq, alt_seq, lead_del)
    total_lead = lead_del + la_lead
    out = []
    if total_lead > 0:
        out.append(("D", total_lead))
    out.extend(aligned)
    if la_trail > 0:
        out.append(("D", la_trail))
    return merge_adjacent(out)


def calculate_cigar(ref_seq: np.ndarray, alt_seq: np.ndarray,
                    strategy=None, params=None):
    """Haplotype-vs-reference CIGAR (cigar_utils.rs:358-457): trivial cases,
    then N-padded SW + pad trimming + indel left-alignment."""
    from lorikeet_tpu_torch.ops.smith_waterman import (
        align, NEW_SW_PARAMETERS, OverhangStrategy)
    if params is None:
        params = NEW_SW_PARAMETERS
    if strategy is None:
        strategy = OverhangStrategy.SOFTCLIP
    ref_seq = np.asarray(ref_seq, np.uint8)
    alt_seq = np.asarray(alt_seq, np.uint8)
    cigar = trivial_cigar(ref_seq, alt_seq)
    if cigar is not None:
        return cigar
    return cigar_from_alignment(
        ref_seq, alt_seq,
        *align(sw_padded(ref_seq), sw_padded(alt_seq), params, strategy))


def calculate_cigars(pairs, align_batch=None) -> tuple:
    """calculate_cigar (NEW_SW_PARAMETERS, SOFTCLIP) of each (ref, alt)
    pair, the SW of every pair past the trivial cases in one call of
    ``align_batch(padded_pairs, params, strategy)``, which returns a
    (CIGAR, offset) each; equal pairs share one alignment.  Without
    ``align_batch``, the native aligner a pair at a time.  Returns (the
    CIGARs, the number of alignments made)."""
    from lorikeet_tpu_torch.ops.smith_waterman import (
        align, NEW_SW_PARAMETERS, OverhangStrategy)
    params, strategy = NEW_SW_PARAMETERS, OverhangStrategy.SOFTCLIP
    pairs = [(np.asarray(r, np.uint8), np.asarray(a, np.uint8))
             for r, a in pairs]
    cigars = [trivial_cigar(r, a) for r, a in pairs]
    slot = {}                           # (ref, alt) bytes -> padded index
    padded, todo = [], []
    for k, (ref, alt) in enumerate(pairs):
        if cigars[k] is not None:
            continue
        key = (ref.tobytes(), alt.tobytes())
        if key not in slot:
            slot[key] = len(padded)
            padded.append((sw_padded(ref), sw_padded(alt)))
        todo.append((k, slot[key]))
    if align_batch is None:
        aligned = [align(r, a, params, strategy) for r, a in padded]
    else:
        aligned = align_batch(padded, params, strategy) if padded else []
    for k, j in todo:
        cigars[k] = cigar_from_alignment(*pairs[k], *aligned[j])
    return cigars, len(padded)
