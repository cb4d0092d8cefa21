"""Tandem-repeat unit detection for indel alleles.

Contract: reference/src/model/variant_context_utils.rs:32-266
(get_num_tandem_repeat_units / find_repeated_substring /
find_number_of_repetitions) and
reference/src/annotator/tandem_repeat.rs:16-27 (the assembly-region
wrapper that strips the leading shared base and passes the reference
context starting right after the variant position).

Used by the assembly-region trimmer to widen indel padding to
``str_padding + longest_repeat_run`` (assembly_region_trimmer.rs:96-117).
"""
from __future__ import annotations


def find_repeated_substring(bases: bytes) -> int:
    """Length of the shortest unit whose tandem repetition spells ``bases``;
    the full length when only the trivial decomposition exists.

    Follows GATK's findRepeatedSubstring (which
    variant_context_utils.rs:205-226 ports — the port's inner loop steps by
    1 instead of the unit length, collapsing it to homopolymers only; we
    keep the original stride semantics)."""
    n = len(bases)
    for rep_len in range(1, n // 2 + 1):
        if n % rep_len:
            continue
        unit = bases[:rep_len]
        if all(bases[start:start + rep_len] == unit
               for start in range(rep_len, n, rep_len)):
            return rep_len
    return n


def find_number_of_repetitions(unit: bytes, s: bytes,
                               leading: bool = True) -> int:
    """Number of whole leading (or trailing) repetitions of ``unit`` in
    ``s`` (variant_context_utils.rs:228-266)."""
    if not s or not unit:
        return 0
    count = 0
    if leading:
        i = 0
        while s[i:i + len(unit)] == unit:
            count += 1
            i += len(unit)
    else:
        i = len(s)
        while i - len(unit) >= 0 and s[i - len(unit):i] == unit:
            count += 1
            i -= len(unit)
    return count


def get_num_tandem_repeat_units(ref_bases: bytes, alt_bases: bytes,
                                remaining_ref_context: bytes):
    """(repetition counts [ref, alt], unit) for one ref/alt indel pair with
    the shared leading base ALREADY stripped; None when the alleles are not
    tandem-decomposable (variant_context_utils.rs:151-194)."""
    long_b = alt_bases if len(alt_bases) > len(ref_bases) else ref_bases
    if not long_b:
        return None
    unit = long_b[:find_repeated_substring(long_b)]
    reps_in_ref = find_number_of_repetitions(unit, ref_bases, True)
    ref_count = find_number_of_repetitions(
        unit, ref_bases + remaining_ref_context, True) - reps_in_ref
    alt_count = find_number_of_repetitions(
        unit, alt_bases + remaining_ref_context, True) - reps_in_ref
    return ([max(ref_count, 0), max(alt_count, 0)], unit)


def vc_tandem_repeat_units(vc, ref_window: bytes, window_start: int):
    """Trimmer entry point: counts+unit for an indel VariantContext against
    the padded reference window (tandem_repeat.rs:16-27: context starts at
    vc.start + 1 to skip the shared padding base).  Returns None for
    non-indels or non-repeat indels; counts cover ref then each alt."""
    ref_allele = vc.alleles[0].bases
    if len(ref_allele) < 1:
        return None
    alts = [a for a in vc.alleles[1:]
            if not a.is_symbolic and not a.is_span_del]
    if not alts or all(len(a.bases) == len(ref_allele) for a in alts):
        return None
    ctx_start = vc.start + 1 - window_start
    if ctx_start < 0 or ctx_start > len(ref_window):
        return None
    context = bytes(ref_window[ctx_start:])
    ref_stripped = bytes(ref_allele[1:])
    lengths = []
    unit = b""
    for alt in alts:
        if len(alt.bases) <= 1:
            return None
        result = get_num_tandem_repeat_units(
            ref_stripped, bytes(alt.bases[1:]), context)
        if result is None or result[0][0] == 0 or result[0][1] == 0:
            return None
        if not lengths:
            lengths.append(result[0][0])
        lengths.append(result[0][1])
        unit = result[1]
    return lengths, unit
