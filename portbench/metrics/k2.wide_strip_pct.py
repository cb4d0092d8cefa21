"""Share of K2's DP cells (read bases times haplotype bases of its pairs)
launched on the 16-row register strip or on the scratch strips, the two
widest, by the `k2.enqueue` spans' `strip` and `cells`, %.  None where
the program records neither."""

from portbench.lib import spans

WIDE = (16, 0)


def read(record):
    k2 = [s["attrs"] for s in spans.of(record) or ()
          if s["name"] == "k2.enqueue" and "strip" in s["attrs"]]
    total = sum(a["cells"] for a in k2)
    if not total:
        return None
    return 100.0 * sum(a["cells"] for a in k2 if a["strip"] in WIDE) / total
