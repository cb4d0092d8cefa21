"""A ``genotype`` job's strain layer against a plain reference.

Plain torch in float64 and numpy over the annotated VCF's text and the
generator's truth; imports nothing of the program and no JAX.

(a) ``abundances``: each sample's strain abundances from the VCF's split
records (those carrying ``VG``): their AD shares and the strains their
``ST`` names.  The EM is the centrifuge-style one of Lorikeet's
``strain_abundances_calculator.rs:38-155`` with the semantics the port's
``run_genotype`` states for its default (``leftover``) mode, whose
departures from the Rust are these:

- no reference-allele mass enters the EM: a strain's weights are the alt
  shares of the records it carries (the Rust pushes each record's ref
  share to every strain not carrying it,
  ``abundance_calculator_engine.rs:190-215``);
- a strain is updated only while its θ is above ``EPS`` and it carries a
  record (the Rust skips a strain only when its weight equals eps);
- convergence at ``EPS`` = 1e-4 of summed |Δθ| (the Rust's 1e-2), at most
  1000 rounds;
- the reference strain (the heuristic of
  ``abundance_calculator_engine.rs:485-500``: some sample shows reference
  reads at 97 % or more of the split records) is not an EM strain: the
  sum over strains of the median alt share of the records that strain
  alone carries (else of those it carries), capped at 1, scales the θ,
  and 1 less that sum is the reference strain's abundance;
- a reference strain under 0.1 in every sample is culled and each
  sample's θ normalised to 1 (the Rust's removal loop culls by eps).

(b) ``purity``: how far the variant groups (``VG``) hold to the planted
strains, in plain Python.

(c) ``count_gap`` and ``share_gap``: the strains of a job's table against
the planted strains, their number and each sample's abundance against
the mix's share, in plain Python and numpy.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from portbench.reference.truth import normalize

#: the EM's convergence bound and the θ below which a strain rests
EPS = 1e-4
MAX_ROUNDS = 1000
#: the share of split records at which a sample with reference reads
#: makes the reference strain present
REFERENCE_SHARE = 0.97
#: the reference strain's least abundance, in some sample, to be kept
REFERENCE_MIN = 0.1


def _info(field: str) -> dict:
    out = {}
    for item in field.split(";"):
        key, _, value = item.partition("=")
        out[key] = value
    return out


def split_records(vcf_path: str) -> list:
    """The VCF's records that carry ``VG``, each as (contig, 0-based pos,
    ref, [alts], VG, [ST strains], [AD of each sample, or None])."""
    out = []
    with open(vcf_path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            info = _info(f[7])
            if "VG" not in info:
                continue
            st = [int(x) for x in info["ST"].split(",")] \
                if info.get("ST") else []
            keys = f[8].split(":") if len(f) > 8 else []
            ads = []
            for sample in f[9:]:
                ad = dict(zip(keys, sample.split(":"))).get("AD", ".")
                ads.append(None if "." in ad.split(",")
                           else [int(x) for x in ad.split(",")])
            out.append((f[0], int(f[1]) - 1, f[3], f[4].split(","),
                        int(info["VG"]), st, ads))
    return out


def em(alt: torch.Tensor, carries: torch.Tensor) -> torch.Tensor:
    """One sample's θ [strains]: ``alt`` [records] the sample's alt
    shares, ``carries`` [strains, records] bool."""
    zero = torch.zeros((), dtype=torch.float64)
    weights = torch.where(carries, alt[None, :], zero)
    has = carries.any(dim=1)
    theta = torch.ones(carries.shape[0], dtype=torch.float64)
    tiny = torch.finfo(torch.float64).eps
    shift, rounds = 1.0, 0
    while shift > EPS and rounds < MAX_ROUNDS:
        rounds += 1
        total = float(weights.sum())
        live = (theta.abs() > EPS) & has
        pooled = (theta[:, None] * carries).sum(dim=0).clamp(min=tiny)
        moved = torch.where(live[:, None] & carries,
                            weights * theta[:, None] / pooled[None, :],
                            weights)
        share = moved.sum(dim=1) / total if total > 0 \
            else torch.zeros_like(theta)
        share = torch.where(torch.isfinite(share) & (share >= EPS), share,
                            zero)
        new = torch.where(live, share, zero)
        weights = torch.where(live[:, None], moved, weights)
        shift = float((new - theta).abs().sum())
        theta = new
    return theta


def abundances(vcf_path: str) -> dict:
    """{row of ``*_strain_coverages.tsv``: [abundance of each sample]}:
    ``strain_<k>`` for every strain ``ST`` names, ``strain_reference``
    where the reference strain is present."""
    records = split_records(vcf_path)
    if not records:
        return {}
    n_samples = len(records[0][6])
    alt = np.zeros((len(records), n_samples))
    ref = np.zeros_like(alt)
    for v, rec in enumerate(records):
        for s, ad in enumerate(rec[6]):
            total = sum(ad) if ad else 0
            if total > 0:
                alt[v, s] = ad[1] / total if len(ad) > 1 else 0.0
                ref[v, s] = ad[0] / total
    members = [rec[5] for rec in records]
    n_strains = max((k for m in members for k in m), default=-1) + 1
    carries = torch.zeros((n_strains, len(records)), dtype=torch.bool)
    for v, m in enumerate(members):
        for k in m:
            carries[k, v] = True
    thetas = [em(torch.from_numpy(alt[:, s]), carries).numpy()
              for s in range(n_samples)]
    present = bool(((ref > 0).sum(axis=0)
                    >= int(len(records) * REFERENCE_SHARE)).any())
    reference = np.zeros(n_samples)
    if present:
        for s in range(n_samples):
            total = 0.0
            for k in range(n_strains):
                alone = [alt[v, s] for v, m in enumerate(members)
                         if m == [k]]
                shares = alone or [alt[v, s] for v, m in enumerate(members)
                                   if k in m]
                if shares:
                    total += float(np.median(shares))
            total = min(1.0, total)
            reference[s] = max(0.0, 1.0 - total)
            thetas[s] = thetas[s] * total
        if reference.max() < REFERENCE_MIN:
            present = False
            thetas = [t / t.sum() if t.sum() > 0 else t for t in thetas]
    out = {f"strain_{k}": [float(t[k]) for t in thetas]
           for k in range(n_strains)}
    if present:
        out["strain_reference"] = reference.tolist()
    return out


def coverages_of(vcf_path: str) -> str:
    """The ``*_strain_coverages.tsv`` beside a job's VCF ``<genome>.vcf``."""
    stem = os.path.basename(vcf_path)[:-len(".vcf")]
    return os.path.join(os.path.dirname(vcf_path),
                        f"{stem}_strain_coverages.tsv")


def read_coverages(path: str) -> dict:
    """{row: [abundance of each sample]} of a ``*_strain_coverages.tsv``."""
    with open(path) as fh:
        lines = [line.rstrip("\n").split("\t") for line in fh if line.strip()]
    return {f[0]: [float(x) for x in f[1:]] for f in lines[1:]}


def abundance_gap(vcf_path: str) -> float:
    """The widest |the TSV's abundance − the reference's| over a job's
    strains and samples: inf where the TSV is missing or its rows are not
    the reference's, 0 where neither has a row."""
    path = coverages_of(vcf_path)
    if not os.path.exists(path):
        return math.inf
    got, want = read_coverages(path), abundances(vcf_path)
    if got.keys() != want.keys():
        return math.inf
    if any(len(got[k]) != len(want[k]) for k in want):
        return math.inf
    return max((abs(a - b) for k in want for a, b in zip(got[k], want[k])),
               default=0.0)


def _planted(contigs: dict, truth: list) -> dict:
    """{(contig, normalised pos, ref, alt): {planted strains}}."""
    planted = {}
    for c, p, r, a, k in truth:
        planted.setdefault((c, *normalize(contigs[c], p, r, a)),
                           set()).add(k)
    return planted


def _carried(record, contigs: dict, planted: dict) -> list:
    """The planted strains of each planted allele a split record carries."""
    c, pos, r, alts = record[:4]
    out = []
    for alt in alts:
        if alt in (".", "*") or alt.startswith("<"):
            continue
        key = (c, *normalize(contigs[c], pos, r.encode(), alt.encode()))
        if key in planted:
            out.append(planted[key])
    return out


def purity(vcf_path: str, contigs: dict, truth: list) -> tuple:
    """(impure, clustered): of the planted alleles [(contig, pos, ref, alt,
    strain)] that a split record with a ``VG`` other than -1 carries,
    those whose group's majority planted strain is none of theirs, and
    all of them.  An allele planted in several strains counts as each of
    them in its group's majority (ties go to the lower strain)."""
    planted = _planted(contigs, truth)
    entries = []                                  # (group, strains)
    for record in split_records(vcf_path):
        if record[4] != -1:
            entries += [(record[4], strains)
                        for strains in _carried(record, contigs, planted)]
    votes = {}
    for group, strains in entries:
        tally = votes.setdefault(group, {})
        for k in strains:
            tally[k] = tally.get(k, 0) + 1
    majority = {g: min(t, key=lambda k: (-t[k], k)) for g, t in votes.items()}
    impure = sum(majority[g] not in strains for g, strains in entries)
    return impure, len(entries)


def stands_for(vcf_path: str, contigs: dict, truth: list) -> dict:
    """{strain ``ST`` names: the planted strain (numbered as the truth
    numbers them) to which most of the planted alleles its records carry
    belong, None where they carry none}.  Ties go to the lower strain."""
    planted = _planted(contigs, truth)
    votes = {}
    for record in split_records(vcf_path):
        carried = _carried(record, contigs, planted)
        for k in record[5]:
            tally = votes.setdefault(k, {})
            for strains in carried:
                for p in strains:
                    tally[p] = tally.get(p, 0) + 1
    return {k: min(t, key=lambda p: (-t[p], p)) if t else None
            for k, t in votes.items()}


def _strain_rows(vcf_path: str):
    """The ``strain_<k>`` rows of the job's table {k: abundances}, and its
    ``strain_reference`` row (None where it has none); None where the
    table is missing."""
    path = coverages_of(vcf_path)
    if not os.path.exists(path):
        return None
    rows = read_coverages(path)
    found = {int(name[len("strain_"):]): values
             for name, values in rows.items()
             if name.startswith("strain_") and name[7:].isdigit()}
    return found, rows.get("strain_reference")


def count_gap(vcf_path: str, fractions: list) -> float:
    """|the strains in the job's table − the strains the mix plants|
    (the reference strain not counted); inf where there is no table."""
    rows = _strain_rows(vcf_path)
    if rows is None:
        return math.inf
    return float(abs(len(rows[0]) - len(fractions[0])))


def share_gap(vcf_path: str, contigs: dict, truth: list,
              fractions: list) -> float:
    """The widest, over the samples and the planted strains, |the summed
    abundance of the table's strains that stand for the planted strain
    (``stands_for``) − its share in the mix|, with each strain that
    stands for none, and the reference strain, held against 0 (the mix
    plants no strain without variants).  inf where there is no table or a
    row's samples are not the mix's."""
    rows = _strain_rows(vcf_path)
    if rows is None:
        return math.inf
    found, reference = rows
    want = np.asarray(fractions, np.float64).T     # [planted, samples]
    got = np.zeros_like(want)
    stray = [reference] if reference is not None else []
    stands = stands_for(vcf_path, contigs, truth)
    for k, values in found.items():
        if len(values) != want.shape[1]:
            return math.inf
        planted = stands.get(k)
        if planted is None:
            stray.append(values)
        else:
            got[planted - 1] += values
    if any(len(values) != want.shape[1] for values in stray):
        return math.inf
    gap = float(np.abs(got - want).max())
    return max([gap, *(float(np.max(values)) for values in stray)])
