"""HDBSCAN as scikit-learn computes it, in host numpy.

The port's counterpart of ``sklearn.cluster.HDBSCAN`` for the one way the
strain layer calls it (``genotype_mode.cluster_variants``): dense finite
data, euclidean metric, alpha 1.0, excess-of-mass selection,
``cluster_selection_epsilon`` 0 and no ``max_cluster_size``.  Its input is
a [split contexts, samples] depth-fraction matrix (or its 2-D UMAP
embedding) of a few thousand rows at most, so it is plain numpy: no torch,
no card.

It follows scikit-learn 1.9's ``sklearn/cluster/_hdbscan/hdbscan.py``
(``HDBSCAN.fit``, ``_hdbscan_prims`` with ``algo="kd_tree"``, the path
``algorithm="auto"`` takes on such data, and ``_process_mst``),
``_linkage.pyx`` (``mst_from_data_matrix``, ``make_single_linkage``) and
``_tree.pyx`` (``_condense_tree``, ``_compute_stability``,
``_get_clusters``, ``_do_labelling``); those files are Copyright the
scikit-learn developers, under the BSD 3-clause licence.  Depth fractions
repeat a lot, so ties are the rule; the labels, numbering included, equal
scikit-learn's because every order that settles a tie is kept:

- a distance is sqrt(sum of (x_i - y_i)^2), summed feature by feature in
  f64 (numpy's pairwise summation adds in another order from 8 features);
- a core distance is the ``min_samples``-th smallest distance, the point
  itself counted first (``kneighbors(X, min_samples)[:, -1]``);
- Prim's tree starts at node 0; each step takes the first out-of-tree node
  of least reachability (the scan's strict ``<``), with the tree node that
  reached it first at that value;
- the edges are ordered by numpy's default ``argsort`` of the same f64
  array scikit-learn sorts; clusters are numbered in the order of their
  sorted ids.
"""
from __future__ import annotations

import numpy as np

#: a Prim edge, as ``_linkage.pyx`` lays it out (its sort reads "distance")
MST_EDGE = np.dtype([("current_node", np.int64), ("next_node", np.int64),
                     ("distance", np.float64)])
DBL_MAX = float(np.finfo(np.float64).max)
#: rows of the distance matrix held at once by ``core_distances``
ROW_CHUNK = 512


def squared_distances(rows: np.ndarray, X: np.ndarray) -> np.ndarray:
    """[len(rows), len(X)] squared euclidean distances, summed over the
    features in their order (``euclidean_rdist``)."""
    acc = np.zeros((rows.shape[0], X.shape[0]))
    for f in range(X.shape[1]):
        d = rows[:, f, None] - X[None, :, f]
        acc += d * d
    return acc


def core_distances(X: np.ndarray, min_samples: int) -> np.ndarray:
    """Distance of each point to its ``min_samples``-th nearest neighbour,
    itself the first."""
    k = min_samples - 1
    out = np.empty(len(X))
    for lo in range(0, len(X), ROW_CHUNK):
        sq = squared_distances(X[lo:lo + ROW_CHUNK], X)
        out[lo:lo + ROW_CHUNK] = np.partition(sq, k, axis=1)[:, k]
    return np.sqrt(out)


def prim_tree(X: np.ndarray, core: np.ndarray) -> np.ndarray:
    """The mutual-reachability minimum spanning tree, edge by edge in the
    order ``mst_from_data_matrix`` adds them."""
    n = len(X)
    mst = np.empty(n - 1, MST_EDGE)
    in_tree = np.zeros(n, bool)
    min_reach = np.full(n, np.inf)
    # scikit-learn starts the sources at 1; only an unreached node keeps it
    sources = np.ones(n, np.int64)
    current = 0
    for i in range(n - 1):
        in_tree[current] = True
        dist = np.sqrt(squared_distances(X[current:current + 1], X)[0])
        reach = np.maximum(np.maximum(core[current], core), dist)
        better = (reach < min_reach) & ~in_tree
        min_reach[better] = reach[better]
        sources[better] = current
        candidates = np.where(in_tree, np.inf, min_reach)
        new = int(np.argmin(candidates))
        if candidates[new] < DBL_MAX:
            mst[i] = (sources[new], new, candidates[new])
        else:
            # no candidate below DBL_MAX: the scan's initial edge
            mst[i] = (0, 0, DBL_MAX)
            new = 0
        current = new
    return mst


def single_linkage(mst: np.ndarray):
    """(left, right, distance, size) lists of the single-linkage tree of
    the sorted edges; the cluster a row makes is n + its index."""
    mst = mst[np.argsort(mst["distance"])]
    n = len(mst) + 1
    parent = [-1] * (2 * n - 1)
    size = [1] * n + [0] * (n - 1)
    left, right, dist, sizes = [], [], mst["distance"].tolist(), []

    def find(x):
        root = x
        while parent[root] != -1:
            root = parent[root]
        while parent[x] != -1 and parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for i, (a, b) in enumerate(zip(mst["current_node"].tolist(),
                                   mst["next_node"].tolist())):
        ra, rb = find(a), find(b)
        left.append(ra)
        right.append(rb)
        sizes.append(size[ra] + size[rb])
        parent[ra] = parent[rb] = n + i
        size[n + i] = size[ra] + size[rb]
    return left, right, dist, sizes


def _bfs_hierarchy(left, right, n, root):
    """``bfs_from_hierarchy``: the nodes under ``root``, level by level."""
    queue, out = [root], []
    while queue:
        out.extend(queue)
        queue = [x - n for x in queue if x >= n]
        if queue:
            queue = [c for node in queue for c in (left[node], right[node])]
    return out


def condense_tree(left, right, dist, sizes, min_cluster_size: int):
    """(parent, child, lambda, size) arrays of ``_condense_tree``: clusters
    below ``min_cluster_size`` fall out of their parent point by point."""
    n = len(left) + 1
    root = 2 * (n - 1)
    relabel = [0] * (root + 1)
    relabel[root] = n
    next_label = n + 1
    ignore = [False] * (root + 1)
    rows = []

    def fall_out(parent, sub_root, lam):
        for sub in _bfs_hierarchy(left, right, n, sub_root):
            if sub < n:
                rows.append((parent, sub, lam, 1))
            ignore[sub] = True

    for node in _bfs_hierarchy(left, right, n, root):
        if ignore[node] or node < n:
            continue
        h = node - n
        lo, hi, d = left[h], right[h], dist[h]
        lam = 1.0 / d if d > 0.0 else np.inf
        lo_count = sizes[lo - n] if lo >= n else 1
        hi_count = sizes[hi - n] if hi >= n else 1
        big_lo, big_hi = lo_count >= min_cluster_size, \
            hi_count >= min_cluster_size
        if big_lo and big_hi:
            for child, count in ((lo, lo_count), (hi, hi_count)):
                relabel[child] = next_label
                next_label += 1
                rows.append((relabel[node], relabel[child], lam, count))
        elif not big_lo and not big_hi:
            fall_out(relabel[node], lo, lam)
            fall_out(relabel[node], hi, lam)
        elif not big_lo:
            relabel[hi] = relabel[node]
            fall_out(relabel[node], lo, lam)
        else:
            relabel[lo] = relabel[node]
            fall_out(relabel[node], hi, lam)
    parent, child, lam, size = zip(*rows)
    return (np.array(parent, np.int64), np.array(child, np.int64),
            np.array(lam, np.float64), np.array(size, np.int64))


def stability(parent, child, lam, size) -> dict:
    """``_compute_stability``: {cluster id: sum over its rows of (lambda -
    its birth) * size}, summed row by row in the tree's order."""
    smallest = int(parent.min())
    n_clusters = int(parent.max()) - smallest + 1
    births = np.full(max(int(child.max()), smallest) + 1, np.nan)
    births[child] = lam
    births[smallest] = 0.0
    # bincount adds the weights in row order, as the Cython loop does
    sums = np.bincount(parent - smallest, weights=(lam - births[parent]) * size,
                       minlength=n_clusters)
    return {smallest + i: s for i, s in enumerate(sums.tolist())}


def select_clusters(parent, child, size, stab: dict,
                    allow_single_cluster: bool) -> set:
    """``_get_clusters``' excess of mass: a cluster is kept unless its
    children's stabilities sum to more than its own."""
    nodes = sorted(stab, reverse=True)
    if not allow_single_cluster:
        nodes = nodes[:-1]
    is_tree = size > 1
    kids = {}
    for p, c in zip(parent[is_tree].tolist(), child[is_tree].tolist()):
        kids.setdefault(p, []).append(c)
    is_cluster = dict.fromkeys(nodes, True)
    for node in nodes:
        subtree = np.sum([stab[c] for c in kids.get(node, [])])
        if subtree > stab[node]:
            is_cluster[node] = False
            stab[node] = subtree
        else:
            stack = list(kids.get(node, []))
            while stack:
                sub = stack.pop()
                is_cluster[sub] = False
                stack.extend(kids.get(sub, []))
    return {c for c, keep in is_cluster.items() if keep}


def label_points(parent, child, lam, clusters: set,
                 allow_single_cluster: bool) -> np.ndarray:
    """``_do_labelling``: a point takes the label of the nearest selected
    cluster above it (clusters numbered by sorted id), else noise (-1);
    with ``allow_single_cluster`` and one cluster, a point under the root
    takes the root's label when it left at the root's largest lambda."""
    root = int(parent.min())
    cluster_map = {c: i for i, c in enumerate(sorted(clusters))}
    parent_of = dict(zip(child.tolist(), parent.tolist()))
    # the union-find's representative: a parent's id is below its
    # children's, so one ascending pass settles every cluster
    top = {root: root}
    for c in sorted(c for c in parent_of if c > root):
        top[c] = c if c in clusters else top[parent_of[c]]
    single = len(clusters) == 1 and allow_single_cluster
    threshold = lam[parent == root].max() if single else None
    point_lambda = np.empty(root)
    points = child < root
    point_lambda[child[points]] = lam[points]
    labels = np.full(root, -1, np.int64)
    for p in range(root):
        cluster = top[parent_of[p]]
        if cluster != root:
            labels[p] = cluster_map[cluster]
        elif single and point_lambda[p] >= threshold:
            labels[p] = cluster_map[cluster]
    return labels


class HDBSCAN:
    """``sklearn.cluster.HDBSCAN`` at the settings listed in the module
    docstring; ``fit_predict(X)`` returns int64 labels, -1 for noise."""

    def __init__(self, min_cluster_size: int = 5, min_samples=None,
                 allow_single_cluster: bool = False, copy: bool = False):
        # ``copy`` only matters to scikit-learn's precomputed input; it is
        # taken so that callers pass the same arguments
        self.min_cluster_size = min_cluster_size
        self.min_samples = min_samples
        self.allow_single_cluster = allow_single_cluster
        self.copy = copy

    def fit_predict(self, X) -> np.ndarray:
        X = np.ascontiguousarray(X, dtype=np.float64)
        if X.ndim != 2 or len(X) == 0:
            raise ValueError(f"expected a non-empty 2-D array, got shape "
                             f"{X.shape}")
        if not np.isfinite(X).all():
            raise ValueError("HDBSCAN here takes finite data only")
        if int(self.min_cluster_size) < 2:
            raise ValueError(f"min_cluster_size ({self.min_cluster_size}) "
                             "must be at least 2")
        if len(X) == 1:
            raise ValueError("n_samples=1 while HDBSCAN requires more than "
                             "one sample")
        min_samples = (self.min_cluster_size if self.min_samples is None
                       else self.min_samples)
        if min_samples < 1:
            raise ValueError(f"min_samples ({min_samples}) must be at "
                             "least 1")
        if min_samples > len(X):
            raise ValueError(f"min_samples ({min_samples}) must be at most "
                             f"the number of samples in X ({len(X)})")
        mst = prim_tree(X, core_distances(X, min_samples))
        parent, child, lam, size = condense_tree(*single_linkage(mst),
                                                 self.min_cluster_size)
        clusters = select_clusters(parent, child, size,
                                   stability(parent, child, lam, size),
                                   self.allow_single_cluster)
        self.labels_ = label_points(parent, child, lam, clusters,
                                    self.allow_single_cluster)
        return self.labels_
