"""Each strain's abundance against its planted share: the widest, over
jobs, samples and planted strains, |the summed abundance of the job's
strains that stand for the planted strain (most of the planted alleles
their ``ST`` records carry are its) − its share in the mix|, a strain that
stands for none and the reference strain held against 0.  inf where a job
has no strain table."""
import math

from portbench.reference import strain


def read(answers):
    if not answers["jobs"]:
        return math.inf
    return max(strain.share_gap(job["vcf"], job["data"].contigs,
                                job["data"].truth, job["data"].fractions)
               for job in answers["jobs"])
