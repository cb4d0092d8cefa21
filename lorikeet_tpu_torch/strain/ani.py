"""Pairwise sample ANI: conANI / popANI / subpopANI.

Contract: reference/src/ani_calculator/ani_calculator.rs:55-405.
- site filter: QD >= qual_by_depth_filter (25.0) (variant_context_utils.rs:99;
  the reference's qual_threshold comparison on log10_p_error is trivially
  true and reproduced as such);
- consensus allele per sample = first argmax AD, None when max depth is 0
  (variant_context.rs:485-512); allele presence = AD >= depth_per_sample_filter
  (variant_context.rs:516-523);
- per qualifying site, off-diagonal (ani_calculator.rs:239-292): conANI counts
  consensus differences (length-difference for indel alleles, else 1), popANI
  counts sites with NO shared allele, subpopANI counts any allele-set
  difference — both weighted by the mean length of the differing alleles;
- DIAGONAL terms compare each sample against the reference genome itself
  (ani_calculator.rs:293-327): consensus != ref adds to conANI[i,i]; ref
  allele absent adds the mean present-allele length to popANI/subpopANI[i,i];
- denominators come from the compared-bases matrix (dual-cursor walk over
  run-length encoded passing-depth arrays, :104-170), or genome_size when
  absent; matrices are normalised in place as 1 - count/denominator (:330-352)
  with f32 semantics (no clamping — a zero denominator yields inf/nan exactly
  as the reference's f32 division does);
- outputs three TSV matrices `{prefix}_{consensus,population,subpopulation}_ani.tsv`
  in the reference's format (:354-405): ##source / ##sample header lines,
  1-based numeric sample ids, 8-decimal cells.
"""
from __future__ import annotations

import os

import numpy as np

QUAL_BY_DEPTH_FILTER = 25.0
DEPTH_PER_SAMPLE_FILTER = 5


def calculate_compared_bases(passing_sites: list | None, genome_size: int,
                             n_samples: int) -> np.ndarray:
    """Comparable-base matrix from per-sample run-length encoded depth-pass
    arrays (positive run = passing, negative run = failing).

    Faithful to the reference's dual-cursor walk (ani_calculator.rs:104-170),
    including its advance rule when both runs exhaust simultaneously (i1 += 1
    but i2 += 2, skipping one run of the second sample — :141-143).  The
    skipped-run behavior is load-bearing for output parity, so it is
    reproduced, not fixed."""
    out = np.full((n_samples, n_samples), np.float32(genome_size), np.float32)
    if passing_sites is None:
        return out
    for s1_ind, s1 in enumerate(passing_sites):
        for s2_ind in range(s1_ind + 1, n_samples):
            s2 = passing_sites[s2_ind]
            i1 = i2 = 0
            used1 = used2 = 0
            differing = 0
            while i1 < len(s1) and i2 < len(s2):
                val1 = int(s1[i1])
                val2 = int(s2[i2])
                abs1 = abs(val1) - used1
                abs2 = abs(val2) - used2
                if val1 < 0 or val2 < 0:
                    differing += min(abs1, abs2)
                used1 += min(abs1, abs2)
                used2 += min(abs1, abs2)
                if used1 >= abs(val1) and used2 >= abs(val2):
                    i1 += 1
                    i2 += 2  # reference quirk: skips one s2 run
                    used1 -= abs(val1)
                    used2 -= abs(val2)
                elif used1 >= abs(val1):
                    i1 += 1
                    used1 -= abs(val1)
                else:
                    i2 += 1
                    used2 -= abs(val2)
            comparable = np.float32(genome_size - differing)
            out[s1_ind, s2_ind] = out[s2_ind, s1_ind] = comparable
        # self row: genome minus this sample's failing bases (:158-162)
        failing = sum(int(r) for r in s1 if int(r) < 0)
        out[s1_ind, s1_ind] = np.float32(genome_size + failing)
    return out


# back-compat alias (earlier sessions imported the clean-room name)
compared_bases_from_rle = calculate_compared_bases


def site_passes(vc, qual_by_depth_filter=QUAL_BY_DEPTH_FILTER) -> bool:
    """variant_context_utils.rs:81-97 passes_thresholds: honour a cached
    QF annotation, else fall back to the QD threshold."""
    qf = vc.attributes.get("QF")
    if qf in ("true", "false"):
        return qf == "true"
    qd = vc.attributes.get("QD")
    if isinstance(qd, list):
        qd = qd[0]
    if qd is not None:
        return float(qd) >= qual_by_depth_filter
    return True


def _sample_ad(vc, sample_idx) -> np.ndarray:
    g = vc.genotypes[sample_idx]
    ad = g.ad if g.ad is not None else np.zeros(vc.n_alleles, np.int64)
    ad = np.asarray(ad)
    if len(ad) < vc.n_alleles:
        ad = np.pad(ad, (0, vc.n_alleles - len(ad)))
    return ad


def consensus_allele_index(vc, sample_idx) -> int | None:
    """First argmax of AD; None when the max depth is 0
    (variant_context.rs:485-512)."""
    ad = _sample_ad(vc, sample_idx)
    if ad.max() == 0:
        return None
    return int(np.argmax(ad))


def alleles_present_in_sample(vc, sample_idx, threshold) -> np.ndarray:
    """AD >= threshold per allele (variant_context.rs:516-523)."""
    return _sample_ad(vc, sample_idx) >= threshold


class ANICalculator:
    def __init__(self, n_samples: int):
        self.conANI = np.zeros((n_samples, n_samples), np.float32)
        self.popANI = np.zeros((n_samples, n_samples), np.float32)
        self.subpopANI = np.zeros((n_samples, n_samples), np.float32)
        self.n = n_samples

    def consume(self, contexts, depth_filter=DEPTH_PER_SAMPLE_FILTER,
                qual_by_depth_filter=QUAL_BY_DEPTH_FILTER):
        """ani_calculator.rs:176-327 calculate_from_contexts (counting pass)."""
        for vc in contexts:
            if not site_passes(vc, qual_by_depth_filter):
                continue
            cons = [consensus_allele_index(vc, s) or 0 for s in range(self.n)]
            present = [alleles_present_in_sample(vc, s, depth_filter)
                       for s in range(self.n)]
            lens = [len(a) for a in vc.alleles]
            for i in range(self.n):
                if not present[i].any():
                    continue
                # diagonal: this sample vs the reference genome (:293-327)
                if cons[i] != 0:
                    if lens[cons[i]] > 1 or lens[0] > 1:
                        self.conANI[i, i] += abs(lens[cons[i]] - lens[0])
                    else:
                        self.conANI[i, i] += 1.0
                if not present[i][0]:
                    n_present = int(np.count_nonzero(present[i]))
                    bd = (sum(lens[a] for a in np.flatnonzero(present[i]))
                          / (n_present if n_present > 0 else 1.0))
                    self.popANI[i, i] += bd
                    self.subpopANI[i, i] += bd
                for j in range(i + 1, self.n):
                    if not present[j].any():
                        continue
                    if cons[i] != cons[j]:
                        li, lj = lens[cons[i]], lens[cons[j]]
                        diff = abs(li - lj) if (li > 1 or lj > 1) else 1.0
                        self.conANI[i, j] += diff
                        self.conANI[j, i] += diff
                    bases_diff = 0.0
                    divisor = 0.0
                    for a in range(vc.n_alleles):
                        if present[i][a] != present[j][a]:
                            bases_diff += lens[a]
                            divisor += 1.0
                    bases_diff /= divisor if divisor > 0 else 1.0
                    if not (present[i] & present[j]).any():
                        self.popANI[i, j] += bases_diff
                        self.popANI[j, i] += bases_diff
                    if (present[i] != present[j]).any():
                        self.subpopANI[i, j] += bases_diff
                        self.subpopANI[j, i] += bases_diff

    def finalize(self, compared_bases: np.ndarray):
        """In-place 1 - count/denominator in f32 (ani_calculator.rs:330-352);
        a zero denominator flows through as inf/nan like the reference."""
        cb = np.asarray(compared_bases, np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            for name in ("conANI", "popANI", "subpopANI"):
                mat = getattr(self, name)
                setattr(self, name,
                        (np.float32(1.0) - mat / cb).astype(np.float32))

    def write_tables(self, output_prefix: str, sample_names, reference_name: str,
                     compared_bases: np.ndarray):
        """Reference TSV format (ani_calculator.rs:354-405): ##source +
        ##sample=<ID=i, name=...> header lines, `SampleID` padded to 10,
        1-based numeric column ids padded to 8, rows labelled 1..n, cells
        printed with 8 decimals."""
        from lorikeet_tpu_torch import __version__
        self.finalize(compared_bases)
        paths = {}
        for mat, tag in ((self.conANI, "consensus_ani"),
                         (self.popANI, "population_ani"),
                         (self.subpopANI, "subpopulation_ani")):
            path = f"{output_prefix}_{tag}.tsv"
            with open(path, "w") as out:
                out.write(f"##source=lorikeet-v{__version__}\n")
                for idx, name in enumerate(sample_names):
                    out.write(f"##sample=<ID={idx + 1}, name={name}>\n")
                out.write(f"{'SampleID': <10}")
                for s in range(len(sample_names)):
                    out.write(f"\t{s + 1: <8}")
                out.write("\n")
                for i in range(self.n):
                    out.write(str(i + 1))
                    for j in range(self.n):
                        out.write(f"\t{mat[i, j]:.8f}")
                    out.write("\n")
            paths[tag] = path
        return paths


def read_ani_table(path: str):
    """Parse a written ANI table back into (sample_names, matrix)."""
    names = []
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith("##sample=<"):
                names.append(line.split("name=", 1)[1].rstrip(">"))
            elif line.startswith("##") or line.startswith("SampleID"):
                continue
            elif line:
                rows.append([float(x) for x in line.split("\t")[1:]])
    return names, np.asarray(rows, np.float32)


def run_ani(contexts, output_prefix, sample_names, reference_name,
            genome_size, passing_sites=None,
            qual_by_depth_filter=QUAL_BY_DEPTH_FILTER,
            depth_per_sample_filter=DEPTH_PER_SAMPLE_FILTER):
    calc = ANICalculator(len(sample_names))
    calc.consume(contexts, depth_filter=depth_per_sample_filter,
                 qual_by_depth_filter=qual_by_depth_filter)
    cb = calculate_compared_bases(passing_sites, genome_size,
                                  len(sample_names))
    return calc.write_tables(output_prefix, sample_names, reference_name, cb)


def run_summarise(vcf_paths: list, output_dir: str,
                  calculate_fst: bool = False,
                  qual_by_depth_filter: float = QUAL_BY_DEPTH_FILTER,
                  depth_per_sample_filter: int = DEPTH_PER_SAMPLE_FILTER,
                  threads: int = 1) -> dict:
    """`summarise` mode: ANI tables (and optionally Hudson Fst) from
    existing VCFs (lorikeet_engine.rs:1224-1305).  ``threads`` parallelizes
    across VCFs (each VCF's work is independent: parse + numpy ANI/Fst)."""
    from lorikeet_tpu_torch.io.vcf import read_vcf
    os.makedirs(output_dir, exist_ok=True)

    def one(path):
        contexts, contigs, samples = read_vcf(path)
        if not samples:
            samples = ["sample0"]
        # genome size from contig headers
        genome_size = 0
        with open(path) as fh:
            for line in fh:
                if line.startswith("##contig=") and "length=" in line:
                    # length is optional per VCF 4.2
                    genome_size += int(line.split("length=")[1]
                                       .split(">")[0].split(",")[0])
                elif not line.startswith("#"):
                    break
        name = os.path.splitext(os.path.basename(path))[0]
        prefix = os.path.join(output_dir, name)
        out = run_ani(contexts, prefix, samples, name,
                      max(genome_size, 1),
                      qual_by_depth_filter=qual_by_depth_filter,
                      depth_per_sample_filter=depth_per_sample_filter)
        if calculate_fst:
            from lorikeet_tpu_torch.strain.fst import write_fst
            out["fst"] = write_fst(
                contexts, len(samples), samples, output_dir, name,
                depth_filter=depth_per_sample_filter)
        return name, out

    if threads > 1 and len(vcf_paths) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(min(threads, len(vcf_paths))) as ex:
            return dict(ex.map(one, vcf_paths))
    return dict(one(p) for p in vcf_paths)
