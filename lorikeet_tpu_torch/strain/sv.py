"""Structural-variant calling via svim on long-read BAMs.

Contract: reference/src/processing/lorikeet_engine.rs:893-990
call_structural_variants — per long-read sample, `svim alignment
--skip_genotyping --min_mapq N --sequence_alleles` into
`{prefix}/svim_{idx}/`, then per-sample
`bcftools sort | bcftools view -i 'QUAL >= q'` and a multi-sample
`bcftools merge | bcftools sort` into
`{prefix}/structural_variants.vcf.gz`.  The reference shells out to
bcftools/bgzip; here the filter/sort/merge run in-process with bcftools'
semantics (merge_sv_vcfs below), one external tool instead of three.
"""
from __future__ import annotations

import gzip
import os
import subprocess

from lorikeet_tpu_torch.io.mapping import check_for_external_command
from lorikeet_tpu_torch.utils.progress import log

DEFAULT_MIN_SV_QUAL = 3


def _read_vcf_lines(path: str):
    header, body = [], []
    with open(path) as fh:
        for line in fh:
            (header if line.startswith("#") else body).append(line)
    return header, body


def _qual_passes(qual_field: str, min_sv_qual: float) -> bool:
    """bcftools `view -i 'QUAL >= q'`: a missing QUAL ('.') never satisfies
    the expression — even at q == 0."""
    if qual_field == "." or qual_field == "":
        return False
    try:
        return float(qual_field) >= min_sv_qual
    except ValueError:
        return False


def merge_sv_vcfs(per_sample_paths: list, out_path: str,
                  min_sv_qual: float = DEFAULT_MIN_SV_QUAL) -> str:
    """In-process equivalent of the reference's per-sample
    `bcftools sort | view -i 'QUAL >= q'` + multi-sample
    `bcftools merge | bcftools sort` pipeline (lorikeet_engine.rs:919,952).

    bcftools-merge semantics implemented:
    - records merge at (CHROM, POS, REF) after reference-allele extension
      (the longest REF wins; shorter-REF records' ALTs gain the extra
      suffix), ALTs union in first-seen order -> one multiallelic record
      (`-m both` default);
    - per-sample GT columns with allele indices remapped to the merged ALT
      order; samples absent at a site get './.';
    - duplicate sample names are uniquified '2:NAME' style (--force-samples);
    - QUAL is the maximum across merged records; ID keeps the first
      non-missing; INFO/FORMAT come from the first record; FILTER is PASS
      only when every merged record passed;
    - output sorted by (header contig order over ALL inputs, POS)
      (`bcftools sort`).
    """
    meta = None
    contig_order: dict = {}
    sample_names: list = []
    merged: dict = {}
    n = len(per_sample_paths)
    for s_idx, path in enumerate(per_sample_paths):
        header, body = _read_vcf_lines(path)
        # contig order is the union over every input header, first-seen
        # (bcftools merge unifies headers before sorting)
        for ln in header:
            if ln.startswith("##contig="):
                cname = ln.split("ID=")[1].split(",")[0].split(">")[0]
                contig_order.setdefault(cname, len(contig_order))
        names = [ln.rstrip("\n").split("\t")[9:]
                 for ln in header if ln.startswith("#CHROM")]
        cols = names[0] if names and names[0] else []
        name = cols[0] if cols else f"sample_{s_idx}"
        if name in sample_names:          # --force-samples uniquification
            name = f"{s_idx + 1}:{name}"
        sample_names.append(name)
        if meta is None:
            meta = [ln for ln in header if not ln.startswith("#CHROM")
                    and not ln.startswith("##contig=")]
        for line in body:
            f = line.rstrip("\n").split("\t")
            if len(f) < 8:
                continue
            if not _qual_passes(f[5], min_sv_qual):
                continue
            chrom, pos, ref = f[0], int(f[1]), f[3]
            # group by site; REF extension resolves differing lengths below
            site_key = (chrom, pos)
            site = merged.setdefault(site_key, {
                "ref": ref, "alts": [], "id": f[2], "qual": None,
                "filters": [], "info": f[7],
                "format": f[8] if len(f) > 8 else "GT",
                "gts": {},            # sample idx -> (gt_field, alt_map)
            })
            # reference-allele extension (bcftools merge pads shorter REFs)
            if len(ref) > len(site["ref"]):
                extra = ref[len(site["ref"]):]
                site["alts"] = [a + extra if a not in (".", "*")
                                and not a.startswith("<") else a
                                for a in site["alts"]]
                site["ref"] = ref
            pad = site["ref"][len(ref):]
            alts_in = [] if f[4] in (".", "") else f[4].split(",")
            alt_map = {}              # input allele index -> merged index
            alt_map[0] = 0
            for ai, alt in enumerate(alts_in, start=1):
                padded = alt if alt == "*" or alt.startswith("<") \
                    else alt + pad
                if padded not in site["alts"]:
                    site["alts"].append(padded)
                alt_map[ai] = site["alts"].index(padded) + 1
            try:
                q = float(f[5])
                site["qual"] = q if site["qual"] is None \
                    else max(site["qual"], q)
            except ValueError:
                pass
            if site["id"] in (".", "") and f[2] not in (".", ""):
                site["id"] = f[2]
            site["filters"].append(f[6])
            gt = f[9] if len(f) > 9 else "./."
            if s_idx not in site["gts"]:
                site["gts"][s_idx] = (gt, dict(alt_map))

    def _remap_gt(gt_field: str, alt_map: dict) -> str:
        # remap the GT subfield's allele indices to the merged ALT order;
        # other FORMAT subfields pass through
        parts = gt_field.split(":")
        gt = parts[0]
        sep = "|" if "|" in gt else "/"
        out = []
        for tok in gt.split(sep):
            if tok == "." or tok == "":
                out.append(tok or ".")
            else:
                try:
                    out.append(str(alt_map.get(int(tok), int(tok))))
                except ValueError:
                    out.append(tok)
        parts[0] = sep.join(out)
        return ":".join(parts)

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    opener = gzip.open if out_path.endswith(".gz") else open
    with opener(out_path, "wt") as out:
        for line in meta or ["##fileformat=VCFv4.2\n"]:
            out.write(line)
        for cname in contig_order:
            out.write(f"##contig=<ID={cname}>\n")
        out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                  + "\t".join(sample_names) + "\n")
        keys = sorted(merged, key=lambda k: (
            contig_order.get(k[0], len(contig_order)), k[0], k[1]))
        for key in keys:
            site = merged[key]
            if not site["alts"]:
                continue
            filters = set(site["filters"])
            filt = "PASS" if filters == {"PASS"} else \
                ";".join(sorted(filters - {"PASS"})) or "."
            qual = "." if site["qual"] is None else f"{site['qual']:g}"
            gts = []
            for i in range(n):
                if i in site["gts"]:
                    gt, amap = site["gts"][i]
                    gts.append(_remap_gt(gt, amap))
                else:
                    gts.append("./.")
            out.write("\t".join([
                key[0], str(key[1]), site["id"] or ".", site["ref"],
                ",".join(site["alts"]), qual, filt, site["info"],
                site["format"]]) + "\t" + "\t".join(gts) + "\n")
    return out_path


def call_structural_variants(long_bam_paths: list, output_prefix: str,
                             reference: str, min_mapq: int = 20,
                             min_sv_qual: int = DEFAULT_MIN_SV_QUAL) -> str | None:
    """Returns the merged structural_variants.vcf.gz path, or None when
    svim is unavailable (logged, non-fatal — matching the reference's
    optional SV stage)."""
    if not long_bam_paths:
        return None
    if not check_for_external_command("svim"):
        log.warning("svim not found on PATH; skipping structural variant "
                    "calling (external_command_checker.rs:check_for_svim)")
        return None
    os.makedirs(output_prefix, exist_ok=True)
    per_sample = []
    for idx, bam in enumerate(long_bam_paths):
        svim_dir = os.path.join(output_prefix, f"svim_{idx}")
        os.makedirs(svim_dir, exist_ok=True)
        cmd = ["svim", "alignment", "--skip_genotyping",
               "--min_mapq", str(min_mapq), "--sequence_alleles",
               svim_dir, bam, reference]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            log.warning("svim failed for %s: %s", bam, proc.stderr[-500:])
            continue
        variants = os.path.join(svim_dir, "variants.vcf")
        if os.path.exists(variants):
            per_sample.append(variants)
    if not per_sample:
        return None
    out_path = os.path.join(output_prefix, "structural_variants.vcf.gz")
    return merge_sv_vcfs(per_sample, out_path, min_sv_qual)
