"""Planted variants (left-aligned, trimmed) absent from the alleles of
their job's VCF, summed over the jobs."""
from portbench.lib import correct


def read(answers):
    return correct.vcf_tally(answers)["missed"]
