"""The genotyper's read counts against the mix: the widest, over jobs and
samples, |mean over the planted alleles called of (the share of the
sample's reads carrying the allele, by its AD) - (the share of the
sample's fragments drawn from the allele's strain)|."""
import math

from portbench.lib import correct


def read(answers):
    bias = [abs(b) for job in correct.vcf_tally(answers)["share_bias"]
            for b in job]
    if not bias or any(math.isnan(b) for b in bias):
        return float("inf")
    return max(bias)
