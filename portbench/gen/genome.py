"""Genomes and their strains: random sequence, planted variants, and the
alignment of each strain to the reference.

A frozen rewrite of the variant planting and haplotype building of the
port's ``testkit/dataset.py`` and ``testkit/simulate.py`` (``apply_variants``),
kept here so that the benchmark's data never changes with the program; the
planting draws a fixed set of variants a contig length in an order of the
seed's, so that seeds differ in where the work lies and not in how much.
Deterministic in the generator it is handed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
#: index of each ASCII base in BASES (A C G T), 0 elsewhere
BASE_INDEX = np.zeros(256, np.int64)
BASE_INDEX[BASES] = np.arange(4)


@dataclass(frozen=True)
class Strain:
    """A haplotype aligned to the reference: ``seq`` u8 [n], ``ref_pos``
    int64 [n] (the reference position of each base, -1 on an inserted one)
    and ``del_after`` int64 [n] (reference bases deleted between base k
    and base k + 1)."""
    seq: np.ndarray
    ref_pos: np.ndarray
    del_after: np.ndarray


def random_genome(rng, length: int) -> np.ndarray:
    return BASES[rng.integers(0, 4, length)]


def reference_strain(ref: np.ndarray) -> Strain:
    n = len(ref)
    return Strain(ref, np.arange(n, dtype=np.int64), np.zeros(n, np.int64))


def shares_of(n: int, weights) -> np.ndarray:
    """``n`` split into whole counts in the ratio of ``weights``, the
    remainders going to the largest fractions (the same counts for every
    seed)."""
    w = np.asarray(weights, np.float64)
    exact = n * w / w.sum()
    counts = np.floor(exact).astype(np.int64)
    rest = n - int(counts.sum())
    counts[np.argsort(counts - exact, kind="stable")[:rest]] += 1
    return counts


def plant_variants(rng, ref: np.ndarray, spec: dict, margin) -> list:
    """[(pos, ref bytes, alt bytes)], VCF style with an anchor base on
    indels, 0-based, from ``margin[0]`` to ``len(ref) - margin[1]``.  A
    contig of a given length gets the same work from every seed: as many
    variants as the mean of ``spec["spacing"]`` fits, apart by gaps spread
    evenly over that range, of each kind (SNP, deletion, insertion) in the
    shares ``spec`` gives and with indel lengths spread evenly over
    ``spec["indel_length"]``; the seed draws their order, the SNPs' alt
    bases and the inserted bases."""
    lo, hi = spec["spacing"]
    if lo < 2 * spec["indel_length"][1] + 2:
        raise ValueError("variant spacing too small for its indels")
    room = len(ref) - margin[0] - margin[1]
    n = max(int(room // ((lo + hi) / 2)), 1)
    gaps = np.rint(lo + (hi - lo) * (np.arange(n - 1) + 0.5)
                   / max(n - 1, 1)).astype(np.int64)
    pos = margin[0] + np.concatenate([[0], np.cumsum(rng.permutation(
        gaps))])
    pos = pos[pos < len(ref) - margin[1]]
    n = pos.size
    kind = rng.permutation(np.repeat(np.arange(3), shares_of(
        n, [spec["snp"], spec["deletion"], spec["insertion"]])))
    l0, l1 = spec["indel_length"]
    n_indel = np.zeros(n, np.int64)
    for k in (1, 2):
        at = np.nonzero(kind == k)[0]
        n_indel[at] = rng.permutation(l0 + np.arange(at.size)
                                      % (l1 - l0 + 1))
    shift = rng.integers(1, 4, n)
    inserted = BASES[rng.integers(0, 4, int(n_indel.sum()))]
    ins_at = np.cumsum(n_indel) - n_indel
    out = []
    for p, k, m, s, at in zip(pos.tolist(), kind.tolist(), n_indel.tolist(),
                              shift.tolist(), ins_at.tolist()):
        anchor = bytes(ref[p:p + 1])
        if k == 0:
            alt = BASES[(BASE_INDEX[ref[p]] + s) % 4]
            out.append((p, anchor, bytes([alt])))
        elif k == 1:
            out.append((p, bytes(ref[p:p + m + 1]), anchor))
        else:
            out.append((p, anchor, anchor + bytes(inserted[at:at + m])))
    return out


def apply_variants(ref: np.ndarray, variants: list) -> Strain:
    """The strain that carries every one of ``variants`` (sorted, apart)."""
    seq, ref_pos, del_after = [], [], []
    done = 0                                # reference bases consumed
    for p, r, a in variants:
        seq.append(ref[done:p + 1])
        ref_pos.append(np.arange(done, p + 1))
        dels = np.zeros(p + 1 - done, np.int64)
        if len(r) == len(a):                # SNP: the anchor is the base
            seq[-1] = np.concatenate([ref[done:p],
                                      np.frombuffer(a, np.uint8)])
        elif len(r) > len(a):               # deletion after the anchor
            dels[-1] = len(r) - 1
        else:                               # insertion after the anchor
            ins = np.frombuffer(a[1:], np.uint8)
            seq.append(ins)
            ref_pos.append(np.full(len(ins), -1))
            del_after.append(dels)
            dels = np.zeros(len(ins), np.int64)
        del_after.append(dels)
        done = p + len(r)
    seq.append(ref[done:])
    ref_pos.append(np.arange(done, len(ref)))
    del_after.append(np.zeros(len(ref) - done, np.int64))
    return Strain(np.concatenate(seq).astype(np.uint8),
                  np.concatenate(ref_pos).astype(np.int64),
                  np.concatenate(del_after).astype(np.int64))
