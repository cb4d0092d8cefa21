"""The widest |log10 K2 - log10 reference (float64)| over a seeded sample
of rows of every K2 batch of the window."""
from portbench.lib import correct


def read(answers):
    return correct.likelihood_gap(answers)["value"]
