"""Share of the SW alignments of the spans' haplotype CIGARs (the pairs
past calculate_cigar's trivial cases) that the card's Smith-Waterman
kernel (K3) ran, summed over the pool's workers, %.  None where the
program does not count them or aligned none."""


def read(record):
    counts = record["worker_counts"]
    n = counts.get("hap_sw")
    card = counts.get("hap_sw_card")
    return 100.0 * card / n if card is not None and n else None
