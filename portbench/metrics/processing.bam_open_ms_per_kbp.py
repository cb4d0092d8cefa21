"""The workers' `bam_open` span: a new reader set for a job's inputs (the
FASTA's index, each BAM inflated and its header read), summed over the
pool's workers, ms a kbp called."""


def read(record):
    s = record["stages"].get("bam_open")
    return s * 1e3 / record["kbp"] if s is not None and record["kbp"] else None
