"""The `strain` span (a `genotype` job's strain layer in the parent, after
the pool has gathered every span: split contexts, clustering, linkage,
EM, strain FASTAs and the annotated VCF), ms a kbp called.  0 where the
program counts the strain layer and ran none (a `call` job); None where
it does not count it."""


def read(record):
    if "strain_contexts" not in record["worker_counts"] or not record["kbp"]:
        return None
    return record["stages"].get("strain", 0.0) * 1e3 / record["kbp"]
