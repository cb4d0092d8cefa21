"""The `strain.umap` span (the depth profiles' UMAP embedding, taken
above 8 samples), ms a kbp called.  0 where the program counts the strain
layer and embedded nothing (a `call` job); None where it does not count
it."""


def read(record):
    if "strain_contexts" not in record["worker_counts"] or not record["kbp"]:
        return None
    return record["stages"].get("strain.umap", 0.0) * 1e3 / record["kbp"]
