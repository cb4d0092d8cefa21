"""Alleles of the jobs' VCFs that were not planted, summed over the
jobs."""
from portbench.lib import correct


def read(answers):
    return correct.vcf_tally(answers)["false"]
