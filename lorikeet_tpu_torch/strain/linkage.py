"""Read-linkage grouping of variant groups into strains.

Contract: reference/src/linkage/linkage_engine.rs
- get_reads_for_groups (:889-1038): per sample, per variant-group, per
  variant, fetch reads overlapping the site; a read supports the group when
  the first alternate allele's bases match the read sequence at the variant
  offset (substring containment at read edges).  Read ids are
  "{sample}_{qname}"; group mean depth = sum over variants of
  max(matched reads, alt AD) / n_variants.
- build_graph (:1040-1147): nodes = variant groups (label >= 0); for each
  unordered pair with shared reads or cluster separation < 2.5, edge weight
  w = 1 - |A∩B|/|A∪B|; if w < 0.98 ("connected by reads") the weight gets a
  depth correction w += w * (1 - ln(min_depth)/ln(max_depth)), else the
  separation value (similarly corrected) is used.  Edges are directed from
  the higher-depth group to the lower-depth group.
- compute_strain_denominations (:122-421): the "rising water table"
  traversal.  Sources (no incoming edges) are visited in descending mean
  depth; each is joined to its closest sink by minimum mean-edge-weight
  path (ties prefer longer paths).  If the source still sits above the
  water table — 1 - cumulative/own_depth >= 0.35 (MIN_DETECTABLE_DEPTH_
  EPSILON :45) — and no node on the path is at capacity, the path becomes a
  strain and every node's cumulative depth rises by the source's remaining
  depth; paths through at-capacity nodes are merged into the existing
  strain sharing the capacity node and the most path nodes
  (merge_paths :472-716); below-water sources flood their path and are
  removed.  Finally the highest-depth sink becomes its own strain if it is
  still above water or unseen (:389-411).

The reference's `previous_groups`/`exclusive_groups` inputs are always
empty in v0.8.2 (haplotype_clustering_engine.rs:54-56, never written) but
are honored here for parity.
"""
from __future__ import annotations

import heapq
import itertools
import math

import numpy as np

MIN_DETECTABLE_DEPTH_EPSILON = 0.35
SEPARATION_THRESHOLD = 2.5
READ_LINK_WEIGHT_CUTOFF = 0.98


def get_reads_for_groups(grouped_contexts: dict, bams: list,
                         contig_names: list = None):
    """Collect supporting read ids + mean read depth per variant group.

    grouped_contexts: {group_id: [VariantContext, ...]} (split contexts:
    exactly one alt allele each).  bams: one BamReader per sample.
    ``contig_names`` maps vc.tid to a contig name so each BAM resolves its
    OWN tid — headers from different mapping runs may order contigs
    differently.  Returns ({group: set("sample_readname")},
    {group: mean_depth})."""
    from lorikeet_tpu_torch.io.bam import FLAG_UNMAPPED

    group_reads = {g: set() for g in grouped_contexts}
    group_counts = {g: 0.0 for g in grouped_contexts}
    for sample_idx, bam in enumerate(bams):
        tid_cache = {}
        col_cache = {}

        def columnar_of(btid):
            h = col_cache.get(btid)
            if h is None:
                c = bam.columnar(btid) if hasattr(bam, "columnar") else None
                ext = bam.columnar_ext(btid) if c is not None else None
                h = col_cache[btid] = (c, ext) if ext is not None else (None,
                                                                        None)
            return h

        for group, variants in grouped_contexts.items():
            for vc in variants:
                btid = vc.tid
                if contig_names is not None and vc.tid < len(contig_names):
                    name = contig_names[vc.tid]
                    if name not in tid_cache:
                        tid_cache[name] = (bam.tid(name)
                                           if name in bam.references else -1)
                    btid = tid_cache[name]
                    if btid < 0:
                        continue
                alt = vc.alternate_alleles[0].bases
                ad = None
                if sample_idx < len(vc.genotypes):
                    g = vc.genotypes[sample_idx]
                    if g.ad is not None and len(g.ad) > 1:
                        ai = vc.attributes.get("_ALT_INDEX", 1)
                        ad = float(g.ad[min(ai, len(g.ad) - 1)])
                allele_depth = ad if ad is not None else 0.0
                c, ext = columnar_of(btid)
                if c is not None:
                    # columnar fast path: identical match semantics to the
                    # record loop below, without materializing a BamRecord
                    # per overlapping read (the 10 Mbp soak measured this
                    # loop as the whole strain layer's dominant cost)
                    idx = bam.fetch_indices(btid, vc.start, vc.end + 1)
                    if idx.size:
                        rl = c["read_len"][idx].astype(np.int64)
                        keep = (((ext["flag"][idx] & FLAG_UNMAPPED) == 0)
                                & (rl > 0))
                        idx, rl = idx[keep], rl[keep]
                    read_count = 0.0
                    if idx.size:
                        seq_buf = c["seq"]
                        alt_arr = np.frombuffer(alt, np.uint8)
                        la = len(alt_arr)
                        ri = vc.start - c["pos"][idx]
                        p_lo = ri < 0
                        p_hi = ri >= rl
                        ri_c = np.where(p_lo, 0, np.where(p_hi, rl - 1, ri))
                        full = ~(p_lo | p_hi) & (ri_c + la <= rl)
                        starts = c["read_off"][idx] + ri_c
                        matched = np.zeros(idx.size, bool)
                        if full.any():
                            sub = seq_buf[starts[full][:, None]
                                          + np.arange(la)]
                            matched[full] = (sub == alt_arr[None, :]) \
                                .all(axis=1)
                        for t in np.flatnonzero(~full).tolist():
                            lo2 = int(starts[t])
                            hi2 = int(c["read_off"][idx[t]] + rl[t])
                            sub = seq_buf[lo2:min(hi2, lo2 + la)].tobytes()
                            if sub and sub in alt:
                                matched[t] = True
                        mi = idx[matched]
                        if mi.size:
                            names = ext["names"]
                            no = ext["name_off"]
                            nl = ext["name_len"]
                            add = group_reads[group].add
                            for j in mi.tolist():
                                add((sample_idx,
                                     names[no[j]:no[j] + nl[j]]))
                            read_count = float(mi.size)
                    group_counts[group] += max(read_count, allele_depth)
                    continue
                read_count = 0.0
                for rec in bam.fetch(btid, vc.start, vc.end + 1):
                    if rec.is_unmapped or len(rec.seq) == 0:
                        continue
                    seq = rec.seq.tobytes()
                    read_index = vc.start - rec.pos
                    partial = False
                    if read_index < 0:
                        partial = True
                        read_index = 0
                    elif read_index >= len(seq):
                        read_index = len(seq) - 1
                        partial = True
                    if not partial and read_index + len(alt) <= len(seq):
                        matched = seq[read_index:read_index + len(alt)] == alt
                    else:
                        sub = seq[read_index:min(len(seq), read_index + len(alt))]
                        matched = bool(sub) and sub in alt
                    if matched:
                        group_reads[group].add(f"{sample_idx}_{rec.name}")
                        read_count += 1.0
                group_counts[group] += max(read_count, allele_depth)
    mean_depth = {g: group_counts[g] / max(len(vcs), 1)
                  for g, vcs in grouped_contexts.items()}
    return group_reads, mean_depth


def build_graph(group_reads: dict, mean_depth: dict,
                separations: np.ndarray = None,
                previous_groups: dict = None,
                exclusive_groups: dict = None):
    """Directed variant-group graph: edges run high-depth -> low-depth.

    Returns (nodes: [group], edges: {(u, v): weight}).
    """
    previous_groups = previous_groups or {}
    exclusive_groups = exclusive_groups or {}
    nodes = [g for g in group_reads if g >= 0]
    edges = {}

    def excluded(g1, g2):
        return (g2 in exclusive_groups.get(g1, ()) or
                g1 in exclusive_groups.get(g2, ()))

    for g1, g2 in itertools.combinations(nodes, 2):
        if excluded(g1, g2):
            continue
        ind1 = previous_groups.get(g1, g1)
        ind2 = previous_groups.get(g2, g2)
        if ind1 == ind2:
            continue
        r1, r2 = group_reads[g1], group_reads[g2]
        inter = len(r1 & r2)
        sep = (float(separations[ind1, ind2])
               if separations is not None and separations.size else np.inf)
        under_sep = sep < SEPARATION_THRESHOLD
        if inter == 0 and not under_sep:
            continue
        union = len(r1 | r2)
        weight = 1.0 - (inter / union if union else 0.0)
        d1, d2 = mean_depth.get(g1, 0.0), mean_depth.get(g2, 0.0)
        lo, hi = min(d1, d2), max(d1, d2)
        depth_factor = (1.0 - math.log(lo) / math.log(hi)
                        if lo > 0 and hi > 0 and math.log(hi) != 0 else 1.0)
        if weight < READ_LINK_WEIGHT_CUTOFF:
            weight = weight + weight * depth_factor
        elif under_sep:
            weight = sep + sep * depth_factor
        else:
            continue
        if d1 > d2:
            edges[(g1, g2)] = weight
        else:
            edges[(g2, g1)] = weight
    return nodes, edges


def _dijkstra(live, out_adj, start, goal):
    """Min-total-weight directed path start->goal over live nodes, or None."""
    if start == goal:
        return 0.0, [start]
    dist = {start: 0.0}
    prev = {}
    heap = [(0.0, start)]
    while heap:
        d, u = heapq.heappop(heap)
        if u == goal:
            path = [u]
            while path[-1] != start:
                path.append(prev[path[-1]])
            return d, path[::-1]
        if d > dist.get(u, np.inf):
            continue
        for v, w in out_adj.get(u, ()):
            if v not in live:
                continue
            nd = d + w
            if nd < dist.get(v, np.inf):
                dist[v] = nd
                prev[v] = u
                heapq.heappush(heap, (nd, v))
    return None


class LinkageEngine:
    def __init__(self, grouped_contexts: dict, cluster_separations=None,
                 previous_groups=None, exclusive_groups=None):
        self.grouped_contexts = grouped_contexts
        self.cluster_separations = cluster_separations
        self.previous_groups = previous_groups or {}
        self.exclusive_groups = exclusive_groups or {}
        self.mean_depth = {}

    def run_linkage(self, bams: list, contig_names: list = None) -> list:
        """Returns strains as ordered lists of variant-group ids."""
        group_reads, self.mean_depth = get_reads_for_groups(
            self.grouped_contexts, bams, contig_names)
        nodes, edges = build_graph(group_reads, self.mean_depth,
                                   self.cluster_separations,
                                   self.previous_groups,
                                   self.exclusive_groups)
        if not edges:
            return [[g] for g in nodes]
        return self.compute_strain_denominations(nodes, edges)

    # ---- water-table traversal -------------------------------------------

    def compute_strain_denominations(self, nodes, edges) -> list:
        depth = self.mean_depth
        out_adj = {}
        in_deg = {u: 0 for u in nodes}
        for (u, v), w in edges.items():
            out_adj.setdefault(u, []).append((v, w))
            in_deg[v] = in_deg.get(v, 0) + 1
        live = set(nodes)

        def live_sources():
            have_in = {v for (u, v) in edges if u in live and v in live}
            return [u for u in live if u not in have_in]

        def live_sinks():
            have_out = {u for (u, v) in edges if u in live and v in live}
            return [u for u in live if u not in have_out]

        # sinks sorted by depth descending; the first is the summit
        end_nodes = sorted(live_sinks(), key=lambda g: -depth.get(g, 0.0))
        if not end_nodes:  # pure cycle; treat every node as its own strain
            return [[g] for g in nodes]
        highest_depth_node = end_nodes[0]

        counter = itertools.count()
        heap = []  # max-heap by depth: (-depth, seq, group)
        for g in live_sources():
            heapq.heappush(heap, (-depth.get(g, 0.0), next(counter), g))

        strains = []        # list of ordered group lists
        seen = set()        # group ids already in some strain / flooded
        cum = {}            # group -> cumulative (water-table) depth

        while heap:
            negd, _, current = heapq.heappop(heap)
            current_depth = -negd
            if current not in live:
                continue

            # closest end node by mean edge weight; ties prefer longer paths
            best = None
            for end in end_nodes:
                if end not in live:
                    continue
                res = _dijkstra(live, out_adj, current, end)
                if res is None or not res[1]:
                    continue
                cost, path = res
                cost /= len(path)
                if best is None or (cost < best[0] and len(path) >= len(best[1])):
                    best = (cost, path)
            if best is None:
                continue
            _, path = best
            closest = path[-1]

            closest_cum = cum.setdefault(closest, 0.0)
            depth_added = current_depth - closest_cum

            above_water = (current_depth > 0 and
                           (1.0 - closest_cum / current_depth)
                           >= MIN_DETECTABLE_DEPTH_EPSILON and depth_added > 0)
            if above_water or current not in seen:
                path = self._drop_excluded(path, current)
                at_capacity = self._nodes_at_capacity(path, depth_added, cum)
                if not at_capacity:
                    self._make_strain(path, seen, cum, heap, counter, strains,
                                      depth_added)
                else:
                    self._merge_paths(strains, path, edges, seen, cum,
                                      at_capacity, depth_added)
            else:
                # below the water table: flood the path, retire the source
                if current != highest_depth_node:
                    for g in path:
                        seen.add(g)
                        cum[g] = cum.get(g, 0.0) + depth_added
                    live.discard(current)
                    for g in live_sources():
                        heapq.heappush(heap, (-depth.get(g, 0.0),
                                              next(counter), g))

        hd = depth.get(highest_depth_node, 0.0)
        hd_cum = cum.setdefault(highest_depth_node, 0.0)
        if (hd > 0 and (1.0 - hd_cum / hd) >= MIN_DETECTABLE_DEPTH_EPSILON) \
                or highest_depth_node not in seen:
            seen.add(highest_depth_node)
            strains.append([highest_depth_node])
        return strains

    def _drop_excluded(self, path, current):
        excl = self.exclusive_groups.get(current)
        if not excl:
            return list(path)
        return [g for g in path if g not in excl]

    def _nodes_at_capacity(self, path, depth_added, cum):
        """Nodes whose water table would overflow their mean depth
        (linkage_engine.rs:757-807)."""
        out = []
        for g in path:
            node_cum = cum.get(g, 0.0)
            threshold = self.mean_depth.get(g, 0.0)
            updated = node_cum + depth_added
            if abs(node_cum - threshold) <= 1e-12 or (updated > threshold
                                                      and node_cum > 0.0):
                out.append(g)
        return out

    def _make_strain(self, path, seen, cum, heap, counter, strains,
                     depth_added):
        strain = []
        for idx, g in enumerate(path):
            if g not in strain:
                strain.append(g)
            seen.add(g)
            cum[g] = cum.get(g, 0.0) + depth_added
            if idx == 1:
                heapq.heappush(heap, (-self.mean_depth.get(g, 0.0),
                                      next(counter), g))
        strains.append(strain)

    def _merge_paths(self, strains, path, edges, seen, cum, at_capacity,
                     depth_added):
        groups_in_path = list(dict.fromkeys(path))
        candidates = []
        max_shared = 0
        for idx, strain in enumerate(strains):
            if any(g in self.exclusive_groups.get(pg, ()) for pg in
                   groups_in_path for g in strain):
                continue
            if not any(g in strain for g in at_capacity):
                continue
            shared = sum(1 for g in groups_in_path if g in strain)
            if shared > max_shared:
                max_shared = shared
                candidates = [idx]
            elif shared == max_shared:
                candidates.append(idx)
        if not candidates:
            return  # reference drops the path (linkage_engine.rs:567-716)
        if len(candidates) > 1:
            # tie-break: connectivity in the component graph, then length
            def edge_count(strain):
                return sum(1 for (u, v) in edges
                           if (u in groups_in_path and v in strain)
                           or (v in groups_in_path and u in strain))
            candidates.sort(key=lambda i: (-edge_count(strains[i]),
                                           -len(strains[i])))
        target = strains[candidates[0]]
        for g in groups_in_path:
            seen.add(g)
            cum[g] = cum.get(g, 0.0) + depth_added
            if g not in target:
                target.append(g)
