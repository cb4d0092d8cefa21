"""The strains' abundances against the plain reference's EM: the widest,
over jobs, samples and strains, |abundance in the job's
``<genome>_strain_coverages.tsv`` (beside its VCF) − the reference's on
the same VCF's AD shares and ``ST`` strains|.  inf where a job has no
such table or its rows are not the reference's."""
import math

from portbench.reference import strain


def read(answers):
    if not answers["jobs"]:
        return math.inf
    return max(strain.abundance_gap(job["vcf"]) for job in answers["jobs"])
