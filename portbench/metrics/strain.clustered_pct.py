"""Share of the split contexts the strain layer clustered that it gave a
variant group (HDBSCAN's label other than -1), %.  None where the
program does not count them or clustered none."""


def read(record):
    counts = record["worker_counts"]
    n = counts.get("strain_contexts")
    return 100.0 * counts["strain_clustered"] / n if n else None
