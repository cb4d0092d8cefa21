"""Log-probability math utilities.

Numerics contract follows the reference implementation's math layer
(reference/src/utils/math_utils.rs, quality_utils.rs): phred↔probability
conversions, the Jacobian-table approximate log10-sum (MAX_TOLERANCE=8.0,
TABLE_STEP=1e-4), and log-space helpers.  These fix the exact float semantics
that downstream genotype likelihoods / QUAL values depend on, so we reproduce
them bit-for-bit on the host (numpy f64) and to f32 tolerance on device.
"""
from __future__ import annotations

import numpy as np

LOG10_E = np.log10(np.e)
LN_10 = np.log(10.0)
INV_LN_10 = 1.0 / LN_10
LOG10_ONE_HALF = np.log10(0.5)
LOG10_ONE_THIRD = -np.log10(3.0)
LOG10_P_OF_ZERO = -1000000.0

MAX_QUAL = 254
MIN_USABLE_Q_SCORE = 6
MAX_REASONABLE_Q_SCORE = 60

# --- Jacobian log table (math_utils.rs:480-500) ---------------------------------
_JACOBIAN_MAX_TOLERANCE = 8.0
_JACOBIAN_TABLE_STEP = 0.0001
_JACOBIAN_INV_STEP = 1.0 / _JACOBIAN_TABLE_STEP
_JACOBIAN_CACHE = np.log10(
    1.0 + 10.0 ** (-np.arange(int(_JACOBIAN_MAX_TOLERANCE / _JACOBIAN_TABLE_STEP) + 1)
                   * _JACOBIAN_TABLE_STEP)
)


def approximate_log10_sum_log10(a, b):
    """Jacobian-table log10(10^a + 10^b), scalar semantics of math_utils.rs:314."""
    if a > b:
        a, b = b, a
    if a == -np.inf:
        return b
    diff = b - a
    if diff < _JACOBIAN_MAX_TOLERANCE:
        return b + _JACOBIAN_CACHE[int(round(diff * _JACOBIAN_INV_STEP))]
    return b


def approximate_log10_sum_log10_arr(vals: np.ndarray) -> float:
    """Array form (math_utils.rs:344): anchor at max element, add Jacobian terms."""
    vals = np.asarray(vals, dtype=np.float64)
    if vals.size == 0:
        return -np.inf
    max_idx = int(np.argmax(vals))
    approx_sum = vals[max_idx]
    for i, v in enumerate(vals):
        if i == max_idx or v == -np.inf:
            continue
        diff = approx_sum - v
        if diff < _JACOBIAN_MAX_TOLERANCE:
            approx_sum += _JACOBIAN_CACHE[int(round(diff * _JACOBIAN_INV_STEP))]
    return float(approx_sum)


def log10_sum_log10(vals: np.ndarray) -> float:
    """Exact log10-sum-exp10 (max-anchored)."""
    vals = np.asarray(vals, dtype=np.float64)
    m = np.max(vals)
    if np.isneginf(m):
        return float(m)
    return float(m + np.log10(np.sum(10.0 ** (vals - m))))


def log10_sum_log10_two(a: float, b: float) -> float:
    if a > b:
        a, b = b, a
    if np.isneginf(a):
        return b
    return b + np.log1p(10.0 ** (a - b)) * INV_LN_10


def normalize_log10(vals: np.ndarray, take_log10_of_output: bool = True) -> np.ndarray:
    """Normalize a log10 prob vector so probs sum to 1."""
    vals = np.asarray(vals, dtype=np.float64)
    s = log10_sum_log10(vals)
    out = vals - s
    if not take_log10_of_output:
        out = 10.0 ** out
    return out


def log10_one_minus_pow10(a: float) -> float:
    """log10(1 - 10^a) without precision loss (math_utils.rs:303)."""
    if a > 0.0:
        return np.nan
    if a == 0.0:
        return -np.inf
    return log1mexp(a * LN_10) * INV_LN_10


def log1mexp(a: float) -> float:
    """ln(1 - e^a) for a <= 0 (natural_log_utils.rs)."""
    if a > 0.0:
        return np.nan
    if a == 0.0:
        return -np.inf
    if a < np.log(0.5):
        return np.log1p(-np.exp(a))
    return np.log(-np.expm1(a))


# --- Phred conversions (quality_utils.rs) ---------------------------------------

def qual_to_error_prob(qual) -> np.ndarray | float:
    """10^(-q/10); accepts scalars or arrays."""
    return 10.0 ** (np.asarray(qual, dtype=np.float64) / -10.0)


def qual_to_prob(qual):
    return 1.0 - qual_to_error_prob(qual)


def qual_to_error_prob_log10(qual):
    return np.asarray(qual, dtype=np.float64) * -0.1


def qual_to_prob_log10(qual):
    return np.log10(1.0 - 10.0 ** (np.asarray(qual, dtype=np.float64) / -10.0))


def fast_bernoulli_entropy(p: float) -> float:
    """Pade approximation of Bernoulli entropy (math_utils.rs:fast_bernoulli_entropy)."""
    product = p * (1.0 - p)
    return product * ((11.0 + 33.0 * product) / (2.0 + 20.0 * product))


def log10_factorial(n: float) -> float:
    """log10(n!) via lgamma (math_utils.rs log10_factorial)."""
    import math as _m
    return _m.lgamma(n + 1.0) / _m.log(10.0)


def digamma(x: float) -> float:
    """Psi function via upward recurrence + asymptotic series (x > 0)."""
    result = 0.0
    while x < 6.0:
        result -= 1.0 / x
        x += 1.0
    inv = 1.0 / x
    inv2 = inv * inv
    return (result + np.log(x) - 0.5 * inv
            - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0)))


def log_likelihood_ratio(n_ref: int, alt_quals, repeat_factor: int = 1) -> float:
    """ln-likelihood ratio of variation vs sequencing error for a pileup
    (haplotype_caller_engine.rs:1761-1806 log_likelihood_ratio, flat prior
    branch): exact single-iteration variational approximation."""
    import math as _m
    alt_quals = np.asarray(alt_quals, np.float64)
    n_alt = repeat_factor * len(alt_quals)
    n = n_ref + n_alt

    f_tilde_ratio = np.exp(digamma(n_ref + 1.0) - digamma(n_alt + 1.0))
    eps = qual_to_error_prob(alt_quals)
    z_bar_alt = (1.0 - eps) / (1.0 - eps + eps * f_tilde_ratio)
    log_eps = np.log(eps)
    log_one_minus_eps = np.log1p(-eps)
    read_sum = float(np.sum(
        z_bar_alt * (log_one_minus_eps - log_eps)
        + fast_bernoulli_entropy_arr(z_bar_alt)))

    beta_entropy = (_m.lgamma(n_alt + 1) + _m.lgamma(n_ref + 1)
                    - _m.lgamma(n + 2))
    return beta_entropy + read_sum * repeat_factor


def fast_bernoulli_entropy_arr(p):
    product = p * (1.0 - p)
    return product * ((11.0 + 33.0 * product) / (2.0 + 20.0 * product))


def error_prob_to_qual(p: float) -> int:
    return int(round(min(-10.0 * np.log10(max(p, 1e-254)), 254.0)))


def log_likelihood_ratio_constant_error(ref_count: int, alt_count: int,
                                        error_probability: float) -> float:
    """haplotype_caller_engine.rs:1808 — all alt observations share one
    error probability."""
    qual = error_prob_to_qual(error_probability)
    return log_likelihood_ratio(ref_count, [qual], alt_count)


class RunningAverage:
    """Welford running mean/variance (math_utils.rs RunningAverage)."""

    def __init__(self):
        self.mean = 0.0
        self._s = 0.0
        self.obs_count = 0

    def add(self, obs: float):
        self.obs_count += 1
        old_mean = self.mean
        self.mean += (obs - self.mean) / self.obs_count
        self._s += (obs - old_mean) * (obs - self.mean)

    def add_all(self, col):
        for obs in col:
            self.add(obs)

    def stddev(self) -> float:
        return float(np.sqrt(self._s / (self.obs_count - 1)))

    def var(self) -> float:
        return self._s / (self.obs_count - 1)
