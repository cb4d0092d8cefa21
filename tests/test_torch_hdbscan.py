"""The port's HDBSCAN (numpy) against scikit-learn's, label for label.

`lorikeet_tpu_torch.strain.hdbscan.HDBSCAN` stands in for
`sklearn.cluster.HDBSCAN` in the strain layer; the VCF, the strain FASTAs
and the coverage tables depend on its labels, numbering included, so every
case here asks for `np.array_equal`.  The data are the shapes the strain
layer clusters (depth fractions of 1 to 8 samples, rounded, with many exact
duplicates and rows of only 0 and 1; the 2-D UMAP layout above 8 samples)
and the corner cases (all points identical, one true cluster, pure noise),
at `cluster_variants`' min_cluster_size rule, with and without
allow_single_cluster.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from sklearn.cluster import HDBSCAN as SkHDBSCAN

from lorikeet_tpu_torch.strain import hdbscan
from lorikeet_tpu_torch.strain.hdbscan import HDBSCAN
from lorikeet_tpu_torch.strain.umap import umap_embed


def mcs_rule(n):
    """cluster_variants' min_cluster_size for n split contexts."""
    return min(max(5, n // 25), max(2, n // 2))


def blobs(rng, n, f):
    centres = rng.random((3, f))
    return centres[rng.integers(0, 3, n)] + rng.normal(0, 0.04, (n, f))


def depth_fractions(rng, n, f):
    """Strain mixtures' alt fractions rounded to 0.05, a third of the rows
    pure 0/1 profiles."""
    # two strains' fractions in each sample, and variants both carry
    mix = np.hstack([rng.dirichlet(np.ones(2), f), np.ones((f, 1))])
    frac = mix[:, rng.integers(0, 3, n)].T + rng.normal(0, 0.03, (n, f))
    x = np.clip(np.round(frac / 0.05) * 0.05, 0.0, 1.0)
    pure = rng.random(n) < 1 / 3
    x[pure] = rng.integers(0, 2, (int(pure.sum()), f))
    return x


def identical(rng, n, f):
    return np.full((n, f), rng.random())


def one_cluster(rng, n, f):
    return rng.random(f) + rng.normal(0, 0.02, (n, f))


def noise(rng, n, f):
    return rng.random((n, f))


KINDS = {"blobs": blobs, "depth": depth_fractions, "identical": identical,
         "one_cluster": one_cluster, "noise": noise}
#: (points, features): 1 to 8 samples, the raw path's range
SHAPES = [(4, 1), (9, 2), (25, 3), (60, 4), (150, 5), (400, 6), (900, 7),
          (3000, 8)]


def _labels(cls, X, **kw):
    """Labels, or the exception's type when the call raises."""
    try:
        return cls(**kw).fit_predict(X)
    except (ValueError, KeyError) as exc:
        return type(exc)


def _assert_same(X, **kw):
    want = _labels(SkHDBSCAN, X, copy=True, **kw)
    got = _labels(HDBSCAN, X, copy=True, **kw)
    if isinstance(want, type) or isinstance(got, type):
        assert got is want or issubclass(want, got), (got, want)
        return
    assert got.dtype == np.int64
    assert np.array_equal(got, want), (
        f"{int((got != want).sum())} of {len(X)} labels differ; "
        f"scikit-learn {np.unique(want)}, port {np.unique(got)}")


@pytest.mark.parametrize("single", [True, False], ids=["single", "multi"])
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("n,f", SHAPES, ids=[f"{n}x{f}" for n, f in SHAPES])
def test_labels_equal_scikit_learn(n, f, kind, single):
    rng = np.random.default_rng(1000 * n + 10 * f + sorted(KINDS).index(kind))
    X = KINDS[kind](rng, n, f)
    _assert_same(X, min_cluster_size=mcs_rule(n), allow_single_cluster=single)


@pytest.mark.parametrize("single", [True, False], ids=["single", "multi"])
@pytest.mark.parametrize("n", [40, 300, 3000])
def test_labels_equal_scikit_learn_on_2d_layouts(n, single):
    """Above 8 samples cluster_variants clusters a 2-D UMAP layout:
    continuous, near-tied coordinates."""
    rng = np.random.default_rng(n)
    X = blobs(rng, n, 2) if n == 3000 else umap_embed(
        depth_fractions(rng, n, 12), n_components=2, seed=42)
    _assert_same(X, min_cluster_size=mcs_rule(n), allow_single_cluster=single)


def test_errors_follow_scikit_learn():
    X = np.zeros((5, 2))
    for cls in (SkHDBSCAN, HDBSCAN):
        with pytest.raises(ValueError, match="min_samples"):
            cls(min_cluster_size=6, copy=True).fit_predict(X)
        with pytest.raises(ValueError, match="n_samples=1"):
            cls(min_cluster_size=2, min_samples=1,
                copy=True).fit_predict(X[:1])


def test_distances_sum_features_in_order():
    """The squared distance adds the features one after another, as
    scikit-learn's euclidean_rdist does; numpy's pairwise summation of 9 or
    more terms adds in another order and rounds differently."""
    rng = np.random.default_rng(3)
    X = rng.random((50, 9))
    got = hdbscan.squared_distances(X[:1], X)[0]
    want = np.zeros(50)
    for i in range(50):
        acc = 0.0
        for k in range(9):
            d = X[0, k] - X[i, k]
            acc += d * d
        want[i] = acc
    assert np.array_equal(got, want)


def test_never_imports_scikit_learn():
    with open(hdbscan.__file__) as fh:
        imports = [line.split() for line in fh
                   if line.startswith(("import ", "from "))]
    assert {words[1].split(".")[0] for words in imports} \
        == {"__future__", "numpy"}


#: duplicate-heavy small matrices: entries from a few fractions
FRACTIONS = st.sampled_from([0.0, 0.05, 0.25, 0.5, 0.65, 0.75, 1.0])


@settings(max_examples=300, deadline=None)
@given(st.integers(2, 40).flatmap(lambda n: st.tuples(
    st.lists(st.lists(FRACTIONS, min_size=3, max_size=3), min_size=n,
             max_size=n),
    st.integers(1, 3), st.integers(2, max(2, n)),
    st.one_of(st.none(), st.integers(1, n)), st.booleans())))
def test_small_duplicate_heavy_matrices(case):
    rows, f, mcs, min_samples, single = case
    X = np.array(rows)[:, :f]
    _assert_same(X, min_cluster_size=mcs, min_samples=min_samples,
                 allow_single_cluster=single)
