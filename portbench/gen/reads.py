"""Reads drawn from a sample's strains: paired short reads and unpaired long
reads, aligned to the reference, with their CIGARs.

A frozen, vectorised rewrite of the port's ``testkit/simulate.py``
(``simulate_reads``, ``_cigar_for_read``) and ``testkit/longreads.py``:
every read of a sample is drawn, erred and aligned with array operations
over all reads at once.  Deterministic in the generator it is handed.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from portbench.gen.genome import BASE_INDEX, BASES, Strain, shares_of

#: BAM flag bits (SAM spec 1.4)
PAIRED, PROPER, REVERSE, MATE_REVERSE, READ1, READ2 = \
    0x1, 0x2, 0x10, 0x20, 0x40, 0x80
#: read names of one contig are numbered below this, after tid times it
NAMES_A_CONTIG = 10_000_000
#: the fewest of a sample's fragments that cover a site on which one of
#: its reads carries an error
MIN_ERROR_DEPTH = 5
#: BAM CIGAR operation codes
OP_M, OP_I, OP_D, OP_S = 0, 1, 2, 4


def ragged_index(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat indices of the ragged rows [starts[k], starts[k] + lens[k]),
    row after row."""
    lens = np.asarray(lens, np.int64)
    starts = np.asarray(starts, np.int64)
    if lens.size and (lens == lens[0]).all():      # one width: a 2-D index
        return (starts[:, None] + np.arange(lens[0])).reshape(-1)
    first = np.cumsum(lens) - lens
    return np.repeat(starts - first, lens) + np.arange(int(lens.sum()))


def offsets(lens: np.ndarray) -> np.ndarray:
    lens = np.asarray(lens, np.int64)
    return np.cumsum(lens) - lens


@dataclass(frozen=True)
class Reads:
    """Aligned reads of one sample, one entry a record: ``tid`` (the
    contig), ``pos`` (0-based leftmost reference base), ``ref_len``
    (reference bases the CIGAR spans), ``flag``, ``mate_pos`` (-1
    unpaired), ``tlen``, ``name`` (a number: both mates of a fragment
    share it), ``seq`` (u8 bases, all records end to end, ``seq_len``
    each) and ``cigar`` (u32 BAM CIGAR words end to end, ``n_cigar``
    each); one base quality and MAPQ for all."""
    tid: np.ndarray
    pos: np.ndarray
    ref_len: np.ndarray
    flag: np.ndarray
    mate_pos: np.ndarray
    tlen: np.ndarray
    name: np.ndarray
    seq: np.ndarray
    seq_len: np.ndarray
    cigar: np.ndarray
    n_cigar: np.ndarray
    qual: int
    mapq: int

    def __len__(self):
        return self.pos.size

    def take(self, idx: np.ndarray) -> "Reads":
        """The records ``idx`` (indices or a mask), in that order."""
        idx = np.arange(len(self))[idx]
        return replace(
            self, tid=self.tid[idx], pos=self.pos[idx],
            ref_len=self.ref_len[idx], flag=self.flag[idx],
            mate_pos=self.mate_pos[idx], tlen=self.tlen[idx],
            name=self.name[idx],
            seq=self.seq[ragged_index(offsets(self.seq_len)[idx],
                                      self.seq_len[idx])],
            seq_len=self.seq_len[idx],
            cigar=self.cigar[ragged_index(offsets(self.n_cigar)[idx],
                                          self.n_cigar[idx])],
            n_cigar=self.n_cigar[idx])

    def sorted(self) -> "Reads":
        """Coordinate order, as a BAM's index needs."""
        return self.take(np.lexsort((self.pos, self.tid)))


def concat(parts: list) -> Reads:
    first = parts[0]
    return replace(first, **{
        f: np.concatenate([getattr(p, f) for p in parts])
        for f in ("tid", "pos", "ref_len", "flag", "mate_pos", "tlen", "name",
                  "seq", "seq_len", "cigar", "n_cigar")})


def align(strain: Strain, starts: np.ndarray, lens: np.ndarray) -> tuple:
    """CIGARs of the reads at strain bases [starts, starts + lens): an
    inserted base is I (S at a read's end), a deletion between two read
    bases is D, every other base M.  Returns (pos, ref_len, cigar words
    end to end, n_cigar)."""
    # a read that meets no inserted base and no deletion is one M run
    events = np.concatenate([[0], np.cumsum(
        (strain.ref_pos < 0) | (strain.del_after > 0))])
    ends = starts + lens
    # a deletion after the read's last base is not in the read
    last_del = strain.del_after[ends - 1] > 0
    plain = events[ends] - events[starts] - last_del == 0
    if plain.all():
        return (strain.ref_pos[starts], lens.astype(np.int64),
                (lens.astype(np.uint32) << 4) | OP_M, np.ones(lens.size,
                                                              np.int64))
    k = np.nonzero(~plain)[0]
    pos, ref_len, cigar, n_cigar = _align_rows(strain, starts[k], lens[k])
    out_pos = strain.ref_pos[starts]
    out_pos[k] = pos
    out_len = lens.astype(np.int64)
    out_len[k] = ref_len
    count = np.ones(lens.size, np.int64)
    count[k] = n_cigar
    words = np.empty(int(count.sum()), np.uint32)
    first = offsets(count)
    words[first] = (lens.astype(np.uint32) << 4) | OP_M
    words[ragged_index(first[k], n_cigar)] = cigar
    return out_pos, out_len, words, count


def _align_rows(strain: Strain, starts: np.ndarray, lens: np.ndarray):
    """:func:`align` for reads that meet an insertion or a deletion."""
    m, width = starts.size, int(lens.max())
    col = np.arange(width)
    valid = col[None, :] < lens[:, None]
    at = np.minimum(starts[:, None] + col, strain.seq.size - 1)
    ins = (strain.ref_pos[at] < 0) & valid
    dels = np.where(valid[:, 1:], strain.del_after[at[:, :-1]], 0)
    start = valid.copy()
    start[:, 1:] &= (ins[:, 1:] != ins[:, :-1]) | (dels > 0)
    row, c0 = np.nonzero(start)
    last = np.append(row[1:] != row[:-1], True)
    first = np.insert(row[1:] != row[:-1], 0, True)
    end = np.append(c0[1:], 0)
    end[last] = lens[row[last]]
    run_ins = ins[row, c0]
    op = np.where(run_ins, OP_I, OP_M)
    op[run_ins & (first | last)] = OP_S
    has_d = (c0 > 0) & (dels[row, np.maximum(c0 - 1, 0)] > 0)
    items_row = np.concatenate([row, row[has_d]])
    key = np.concatenate([2 * c0 + 1, 2 * c0[has_d]])
    order = np.lexsort((key, items_row))
    words = np.concatenate([(end - c0) << 4 | op,
                            dels[row[has_d], c0[has_d] - 1] << 4 | OP_D])
    first_m = np.full(m, width, np.int64)
    np.minimum.at(first_m, row[op == OP_M], c0[op == OP_M])
    pos = strain.ref_pos[starts + first_m]
    ref_len = lens - ins.sum(1) + dels.sum(1)
    return (pos, ref_len, words[order].astype(np.uint32),
            np.bincount(items_row, minlength=m))


def _substitute(rng, seq: np.ndarray, rate: float, site: np.ndarray,
                fragment: np.ndarray) -> np.ndarray:
    """``seq`` with about ``rate`` of its bases, at uniform positions,
    each replaced by another base.  ``site`` names the strain base each
    base of ``seq`` was read from, ``fragment`` the fragment it belongs
    to.  No two errors of a sample fall on one site, and none on a site
    that fewer than MIN_ERROR_DEPTH of the sample's fragments cover: so
    every allele its reads carry on two reads or more is a planted one,
    and an error is never the larger part of what the sample's reads say
    at a site (at a contig's thin ends two agreeing errors, or one error
    on the only read there, make a call the truth does not hold)."""
    hit = rng.integers(0, seq.size, rng.binomial(seq.size, rate))
    _, first = np.unique(site[hit], return_index=True)
    hit = hit[np.sort(first)]
    depth = np.bincount(site)
    # a fragment reads a site at most twice, once a mate: count the
    # fragments where the reads are too few to make the least depth alone
    thin = depth < 2 * MIN_ERROR_DEPTH
    few = thin[site]
    covered = np.unique(site[few].astype(np.int64) << 32
                        | fragment[few]) >> 32
    depth[thin] = np.bincount(covered, minlength=depth.size)[thin]
    hit = hit[depth[site[hit]] >= MIN_ERROR_DEPTH]
    out = seq.copy()
    out[hit] = BASES[(BASE_INDEX[seq[hit]] + rng.integers(1, 4, hit.size))
                     % 4]
    return out


def _site(strain: Strain, s: int, idx: np.ndarray) -> np.ndarray:
    """Site of strain ``s``'s bases ``idx``: the reference position, or
    for an inserted base one of the strain's own above every position."""
    ref_pos = strain.ref_pos[idx]
    return np.where(ref_pos >= 0, ref_pos,
                    (s + 1) * 4 * strain.ref_pos.size + idx)


def _strain_of(rng, n: int, fractions) -> np.ndarray:
    """Strain index of each of ``n`` fragments: 0 the reference strain,
    k the k-th planted strain, ``fractions[k - 1]`` of them to the
    nearest fragment, in an order the seed draws."""
    p = np.array([1.0 - sum(fractions), *fractions])
    return rng.permutation(np.repeat(np.arange(p.size), shares_of(
        n, np.maximum(p, 0.0))))


def short_pairs(rng, strains: list, fractions, spec: dict,
                length: int, tid: int) -> Reads:
    """Paired reads over a genome of ``length`` bases at ``spec``'s
    coverage, read length, insert size and substitution rate, each
    fragment from a strain chosen at ``fractions``."""
    rl = spec["length"]
    n_frag = int(spec["coverage"] * length / (2 * rl))
    strain_of = _strain_of(rng, n_frag, fractions)
    flen = np.rint(rng.normal(spec["insert_mean"], spec["insert_sd"],
                              n_frag)).astype(np.int64)
    u = rng.random(n_frag)
    parts, sites = [], []
    for s, strain in enumerate(strains):
        k = np.nonzero(strain_of == s)[0]
        if not k.size:
            continue
        f = np.clip(flen[k], rl, strain.seq.size)
        f0 = (u[k] * (strain.seq.size - f + 1)).astype(np.int64)
        starts = np.concatenate([f0, f0 + f - rl])
        lens = np.full(starts.size, rl, np.int64)
        pos, ref_len, cigar, n_cigar = align(strain, starts, lens)
        idx = ragged_index(starts, lens)
        seq = strain.seq[idx]
        sites.append(_site(strain, s, idx))
        n = k.size
        mate = np.concatenate([pos[n:], pos[:n]])
        span = pos[n:] + ref_len[n:] - pos[:n]
        parts.append(Reads(
            tid=np.full(2 * n, tid), pos=pos, ref_len=ref_len,
            flag=np.concatenate([
                np.full(n, PAIRED | PROPER | READ1 | MATE_REVERSE),
                np.full(n, PAIRED | PROPER | READ2 | REVERSE)]).astype(
                    np.uint16),
            mate_pos=mate, tlen=np.concatenate([span, -span]),
            name=np.concatenate([k, k]) + tid * NAMES_A_CONTIG, seq=seq,
            seq_len=lens,
            cigar=cigar, n_cigar=n_cigar, qual=spec["base_qual"],
            mapq=spec["mapq"]))
    reads = concat(parts)
    return replace(reads, seq=_substitute(rng, reads.seq,
                                          spec["substitution_rate"],
                                          np.concatenate(sites),
                                          np.repeat(reads.name,
                                                    reads.seq_len)))


def long_reads(rng, strains: list, fractions, spec: dict,
               length: int, tid: int) -> Reads:
    """Unpaired reads of ``spec["length"]`` bases (uniform between its two
    ends) at ``spec``'s coverage and substitution rate, on either strand,
    each from a strain chosen at ``fractions``."""
    lo, hi = spec["length"]
    n = int(spec["coverage"] * length / ((lo + hi) / 2))
    strain_of = _strain_of(rng, n, fractions)
    lens_all = rng.integers(lo, hi + 1, n)
    u = rng.random(n)
    reverse = rng.random(n) < 0.5
    parts, sites = [], []
    for s, strain in enumerate(strains):
        k = np.nonzero(strain_of == s)[0]
        if not k.size:
            continue
        lens = np.minimum(lens_all[k], strain.seq.size)
        starts = (u[k] * (strain.seq.size - lens + 1)).astype(np.int64)
        pos, ref_len, cigar, n_cigar = align(strain, starts, lens)
        idx = ragged_index(starts, lens)
        sites.append(_site(strain, s, idx))
        parts.append(Reads(
            tid=np.full(k.size, tid), pos=pos, ref_len=ref_len,
            flag=np.where(reverse[k], REVERSE, 0).astype(np.uint16),
            mate_pos=np.full(k.size, -1), tlen=np.zeros(k.size, np.int64),
            name=k + tid * NAMES_A_CONTIG,
            seq=strain.seq[idx],
            seq_len=lens, cigar=cigar, n_cigar=n_cigar,
            qual=spec["base_qual"], mapq=spec["mapq"]))
    reads = concat(parts)
    return replace(reads, seq=_substitute(rng, reads.seq,
                                          spec["substitution_rate"],
                                          np.concatenate(sites),
                                          np.repeat(reads.name,
                                                    reads.seq_len)))
