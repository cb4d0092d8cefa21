"""The `asm.hap_sw` span of the `assemble` sub-stage (a span's haplotype SW
batch: its pack, its send to the card, the wait and the decode), summed
over the pool's workers, ms a kbp called.  None where the program records
no such span."""


def read(record):
    s = record["stages"].get("asm.hap_sw")
    return s * 1e3 / record["kbp"] if s is not None and record["kbp"] else None
