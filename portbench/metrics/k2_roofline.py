"""K2's share of its roofline: the least time an H100 could take for the
window's K2 batches over the time K2 took (profiler trace), %.

A batch's least time is the larger of its operations over the f32 peak
and its bytes over the memory peak.  Operations: 12 f32 operations a DP
cell (the recurrence term by term: M 4, I 3, D 3, the I + D that the next
M reads 1, the rescaling once in 8 diagonals 1), one cell a read base and
haplotype base of each distinct (read, haplotype) pair, whatever
implements K2.  Bytes: the batch's input arrays read once, the base table
and one f32 result a (block, row) written once.  Peaks: NVIDIA's H100 SXM
data sheet, dense, 700 W."""

K2 = "grouped_kernel"
OPS_PER_CELL = 12
PEAK_F32_OPS_S = 67e12
PEAK_BYTES_S = 3.35e12


def bound_s(batch: dict) -> float:
    return max(OPS_PER_CELL * batch["cells"] / PEAK_F32_OPS_S,
               batch["bytes"] / PEAK_BYTES_S)


def read(record):
    trace = record.get("trace")
    if not trace:
        return None
    us = sum(b - a for name, a, b in trace["device"] if K2 in name)
    if not us:
        return None
    return 100.0 * sum(map(bound_s, record["k2_batches"])) / (us * 1e-6)
