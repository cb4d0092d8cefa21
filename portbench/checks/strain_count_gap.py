"""The strains against the planted strains: the widest, over jobs,
|the strains in the job's ``<genome>_strain_coverages.tsv`` − the
strains the mix plants|, the reference strain not counted.  inf where a
job has no such table."""
import math

from portbench.reference import strain


def read(answers):
    if not answers["jobs"]:
        return math.inf
    return max(strain.count_gap(job["vcf"], job["data"].fractions)
               for job in answers["jobs"])
