"""``share_gap`` over the long-read samples: the widest, over jobs and
long-read samples, |mean over the planted alleles called of (the share of
the sample's reads carrying the allele, by its AD) - (the share of the
sample's fragments drawn from the allele's strain)|.  The long-read
samples are the VCF's columns after the short-read ones, one for each
short-read sample and drawn at the same mix.  inf where a job's VCF has
no such column."""
import math

from portbench.reference import truth


def read(answers):
    bias = []
    for job in answers["jobs"]:
        data = job["data"]
        n = len(data.fractions)
        got = truth.compare(job["vcf"], data.contigs, data.truth,
                            [*data.fractions, *data.fractions])
        bias += [abs(b) for b in got["share_bias"][n:]]
    if not bias or any(math.isnan(b) for b in bias):
        return float("inf")
    return max(bias)
