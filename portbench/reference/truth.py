"""A job's VCF against the variants the generator planted.

Plain Python over the VCF text and the generator's truth: both sides are
put in one normal form (left-aligned, parsimonious: Tan, Abecasis and Kang
2015, "Unified representation of genetic variants") against the reference
sequence, and compared allele by allele; at each planted allele called,
each sample's share of the reads (its AD) against the share of the
sample's fragments that the strains carrying it hold.  Imports nothing of
the program.
"""
from __future__ import annotations

import numpy as np


def normalize(ref_seq: np.ndarray, pos: int, ref: bytes,
              alt: bytes) -> tuple:
    """(pos, ref, alt), 0-based, left-aligned and trimmed to the fewest
    bases: the same change written any way gives one tuple."""
    ref, alt = bytearray(ref), bytearray(alt)
    while True:
        if ref and alt and ref[-1] == alt[-1] and (len(ref) > 1
                                                    or len(alt) > 1):
            ref.pop()
            alt.pop()
            if (not ref or not alt) and pos > 0:
                pos -= 1
                base = int(ref_seq[pos])
                ref.insert(0, base)
                alt.insert(0, base)
            continue
        break
    while len(ref) > 1 and len(alt) > 1 and ref[0] == alt[0]:
        ref.pop(0)
        alt.pop(0)
        pos += 1
    return pos, bytes(ref), bytes(alt)


def called_alleles(vcf_path: str, contigs: dict) -> dict:
    """Every ALT allele of every record of a VCF over ``contigs`` {name:
    u8 sequence}, normalised, as (contig, pos, ref, alt): the share of
    each sample's reads that carry it, by the sample's AD (NaN where the
    sample has no AD or no depth).  Symbolic alleles and ``*`` are left
    out."""
    out = {}
    with open(vcf_path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            pos, ref = int(f[1]) - 1, f[3].encode()
            keys = f[8].split(":") if len(f) > 8 else []
            ads = []
            for sample in f[9:]:
                field = dict(zip(keys, sample.split(":")))
                ad = field.get("AD", ".")
                ads.append(None if "." in ad.split(",")
                           else [int(x) for x in ad.split(",")])
            for k, alt in enumerate(f[4].split(",")):
                if alt in (".", "*") or alt.startswith("<"):
                    continue
                shares = [ad[k + 1] / sum(ad) if ad and len(ad) > k + 1
                          and sum(ad) else float("nan") for ad in ads]
                out[(f[0], *normalize(contigs[f[0]], pos, ref,
                                      alt.encode()))] = shares
    return out


def compare(vcf_path: str, contigs: dict, truth: list,
            fractions: list) -> dict:
    """{"planted", "called", "missed", "false", "share_bias"}: the planted
    variants [(contig, pos, ref, alt, strain)] not called, the called
    alleles that were not planted, and for each sample the mean, over the
    planted alleles called, of the share of its reads that carry the
    allele less the share of its fragments drawn from the allele's strain
    (``fractions[sample][strain - 1]``)."""
    want = {(c, *normalize(contigs[c], p, r, a)): k
            for c, p, r, a, k in truth}
    got = called_alleles(vcf_path, contigs)
    bias = []
    for s, shares in enumerate(fractions):
        d = np.array([got[v][s] - shares[k - 1] for v, k in want.items()
                      if v in got and s < len(got[v])], np.float64)
        d = d[np.isfinite(d)]
        bias.append(float(d.mean()) if d.size else float("nan"))
    return {"planted": len(want), "called": len(got),
            "missed": len(want.keys() - got.keys()),
            "false": len(got.keys() - want.keys()), "share_bias": bias}
