"""VCF 4.2 writing/reading.

Output format mirrors the reference's htslib-based writer
(reference/src/model/variant_context.rs:1189-1320 write_as_vcf_record,
haplotype_caller_engine.rs:1966-2012 header): INFO keys AC/AF/AN/DP/MLEAC/
MLEAF/MQ/QD, FORMAT GT:AD:DP:GQ:PL.
"""
from __future__ import annotations

import numpy as np

from lorikeet_tpu_torch.models.variants import Allele, Genotype, VariantContext

INFO_HEADER = [
    ('AC', 'A', 'Integer', 'Allele count in genotypes, for each ALT allele, in the same order as listed'),
    ('AF', 'A', 'Float', 'Allele Frequency, for each ALT allele, in the same order as listed'),
    ('AN', '1', 'Integer', 'Total number of alleles in called genotypes'),
    ('DP', '1', 'Integer', 'Approximate read depth; some reads may have been filtered'),
    ('MLEAC', 'A', 'Integer', 'Maximum likelihood expectation (MLE) for the allele counts'),
    ('MLEAF', 'A', 'Float', 'Maximum likelihood expectation (MLE) for the allele frequency'),
    ('MQ', 'R', 'Float', 'RMS Mapping Quality'),
    ('NDA', '1', 'Integer', 'Number of alternate alleles discovered (but not necessarily genotyped) at this site'),
    ('BQ', 'R', 'Integer', 'Median PHRED-scaled Base Quality of the variant'),
    ('QD', '1', 'Float', 'Variant Confidence/Quality by Depth'),
    ('QF', '1', 'String', 'Whether the variant passed quality checks to be included in ANI analyses'),
    ('VG', '1', 'Integer', 'Variant group or cluster the variant belongs to'),
    ('ST', '.', 'Integer', 'Strain IDs the variant group occurs in'),
]
FORMAT_HEADER = [
    ('GT', '1', 'String', 'Genotype'),
    ('AD', 'R', 'Integer', 'Allelic depths for the ref and alt alleles in the order listed'),
    ('DP', '1', 'Integer', 'Approximate read depth'),
    ('GQ', '1', 'Integer', 'Genotype Quality'),
    ('PL', 'G', 'Integer', 'Normalized, Phred-scaled likelihoods for genotypes as defined in the VCF specification'),
    ('PGT', '1', 'String', 'Physical phasing haplotype information, describing how the alternate alleles are phased in relation to one another'),
    ('PID', '1', 'String', 'Physical phasing ID information, where each unique ID within a given sample (but not across samples) connects records within a phasing group'),
    ('PS', '1', 'Integer', 'Phasing set (typically the position of the first variant in the set)'),
]


def _fmt_info_value(v):
    if isinstance(v, (list, tuple, np.ndarray)):
        return ",".join(_fmt_info_value(x) for x in v)
    if isinstance(v, float):
        return f"{v:.2f}" if abs(v - round(v, 2)) < 1e-9 else f"{v:.4f}"
    return str(v)


def write_vcf(path: str, contexts: list, contig_names: list, contig_lengths: list,
              sample_names: list, source: str = "lorikeet_tpu"):
    with open(path, "w") as out:
        out.write("##fileformat=VCFv4.2\n")
        out.write(f"##source={source}\n")
        for key, num, typ, desc in INFO_HEADER:
            out.write(f'##INFO=<ID={key},Number={num},Type={typ},Description="{desc}">\n')
        for key, num, typ, desc in FORMAT_HEADER:
            out.write(f'##FORMAT=<ID={key},Number={num},Type={typ},Description="{desc}">\n')
        for name, length in zip(contig_names, contig_lengths):
            out.write(f"##contig=<ID={name},length={length}>\n")
        out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                  + "\t".join(sample_names) + "\n")
        for vc in sorted(contexts, key=lambda v: (v.tid, v.start)):
            out.write(format_record(vc, contig_names))


def format_record(vc: VariantContext, contig_names: list) -> str:
    chrom = contig_names[vc.tid]
    pos = vc.start + 1
    ref = str(vc.reference)
    alts = ",".join(str(a) for a in vc.alternate_alleles) or "."
    qual = f"{vc.phred_scaled_qual:.2f}"
    filt = ";".join(vc.filters) if vc.filters else "."
    info_parts = []
    for key, *_ in INFO_HEADER:
        if key in vc.attributes:
            info_parts.append(f"{key}={_fmt_info_value(vc.attributes[key])}")
    info = ";".join(info_parts) if info_parts else "."
    # physical-phasing FORMAT keys appear only when any genotype has them
    phased = any(g.attributes.get("PGT") for g in vc.genotypes)
    fmt = "GT:AD:DP:GQ:PGT:PID:PL:PS" if phased else "GT:AD:DP:GQ:PL"
    gts = []
    for g in vc.genotypes:
        gt = _format_gt(g, vc)
        ad = ",".join(str(int(x)) for x in g.ad) if g.ad is not None else "."
        dp = str(g.dp) if g.dp >= 0 else "."
        gq = str(g.gq) if g.gq >= 0 else "."
        pl_arr = g.pl()
        pl = ",".join(str(int(x)) for x in pl_arr) if pl_arr is not None else "."
        if phased:
            pgt = g.attributes.get("PGT", ".")
            pid = g.attributes.get("PID", ".")
            ps = str(g.attributes.get("PS", "."))
            gts.append(f"{gt}:{ad}:{dp}:{gq}:{pgt}:{pid}:{pl}:{ps}")
        else:
            gts.append(f"{gt}:{ad}:{dp}:{gq}:{pl}")
    return (f"{chrom}\t{pos}\t.\t{ref}\t{alts}\t{qual}\t{filt}\t{info}\t{fmt}\t"
            + "\t".join(gts) + "\n")


def _format_gt(g: Genotype, vc: VariantContext) -> str:
    if not g.alleles:
        return "/".join(["."] * g.ploidy)
    idx = []
    for a in g.alleles:
        try:
            idx.append(str(vc.alleles.index(a)))
        except ValueError:
            idx.append(".")
    return "/".join(idx)


def read_vcf(path: str):
    """Parse a VCF into (contexts, contig_names, sample_names) — used by
    summarise mode and tests (variant_context.rs:681-1120 round-trip role)."""
    contexts = []
    contigs = []
    samples = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith("##contig="):
                name = line.split("ID=")[1].split(",")[0].split(">")[0]
                contigs.append(name)
                continue
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                samples = line.split("\t")[9:]
                continue
            f = line.split("\t")
            chrom, pos, _, ref, alts, qual, filt, info = f[:8]
            if chrom not in contigs:
                # legal VCFs may omit ##contig headers; register the
                # chromosome instead of collapsing it onto tid 0
                contigs.append(chrom)
            tid = contigs.index(chrom)
            alleles = [Allele(ref.encode(), True)] + [
                Allele(a.encode(), False) for a in alts.split(",") if a != "."]
            start = int(pos) - 1
            vc = VariantContext(tid, start, start + len(ref) - 1, alleles)
            if qual != ".":
                vc.log10_p_error = float(qual) / -10.0
            if filt not in (".", "PASS", ""):
                vc.filters = filt.split(";")
            for kv in info.split(";"):
                if "=" in kv:
                    k, v = kv.split("=", 1)
                    vals = v.split(",")
                    try:
                        parsed = [int(x) for x in vals]
                    except ValueError:
                        try:
                            parsed = [float(x) for x in vals]
                        except ValueError:
                            parsed = vals
                    vc.attributes[k] = parsed if len(parsed) > 1 or k in (
                        "AC", "AF", "MLEAC", "MLEAF") else parsed[0]
            if len(f) > 9:
                fmt_keys = f[8].split(":")
                for s_idx, cell in enumerate(f[9:]):
                    parts = dict(zip(fmt_keys, cell.split(":")))
                    g = Genotype(s_idx, 2)
                    gt = parts.get("GT", ".")
                    if gt and gt != ".":
                        sep = "/" if "/" in gt else "|"
                        allele_idx = [x for x in gt.split(sep)]
                        g.alleles = [alleles[int(x)] for x in allele_idx
                                     if x != "."]
                        g.ploidy = len(allele_idx)
                    if parts.get("DP", ".") not in (".", ""):
                        g.dp = int(parts["DP"])
                    if parts.get("GQ", ".") not in (".", ""):
                        g.gq = int(parts["GQ"])
                    if parts.get("AD", ".") not in (".", ""):
                        g.ad = np.array([int(x) for x in parts["AD"].split(",")])
                    if parts.get("PL", ".") not in (".", ""):
                        pls = np.array([float(x) for x in parts["PL"].split(",")])
                        g.log10_likelihoods = pls / -10.0
                    vc.genotypes.append(g)
            contexts.append(vc)
    return contexts, contigs, samples
