"""Share of the assembly graphs that reached the seq-graph step whose seq
graph the native graph builder zipped (no kmer graph rebuilt as Python
objects), summed over the pool's workers, %.  None where the program does
not count them or built none."""


def read(record):
    counts = record["worker_counts"]
    n = counts.get("asm_graphs")
    zipped = counts.get("asm_native_zip")
    return 100.0 * zipped / n if zipped is not None and n else None
