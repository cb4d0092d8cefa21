"""The `strain.linkage` span (every sample's BAM reopened in the parent
and the variant groups linked into strains by read co-occurrence), ms a
kbp called.  0 where the program counts the strain layer and linked
nothing (a `call` job); None where it does not count it."""


def read(record):
    if "strain_contexts" not in record["worker_counts"] or not record["kbp"]:
        return None
    return record["stages"].get("strain.linkage", 0.0) * 1e3 / record["kbp"]
