"""The variant groups against the planted strains: the widest, over jobs,
share (%) of the clustered planted alleles (those a split record with a
``VG`` other than -1 carries) whose group's majority planted strain is
not their own.  inf where a job clustered no planted allele."""
import math

from portbench.reference import strain


def read(answers):
    worst = 0.0
    for job in answers["jobs"]:
        data = job["data"]
        impure, clustered = strain.purity(job["vcf"], data.contigs,
                                          data.truth)
        if not clustered:
            return math.inf
        worst = max(worst, 100.0 * impure / clustered)
    return worst if answers["jobs"] else math.inf
