"""Read-threading (de Bruijn-style) local assembly.

Host-side component (graph algorithms are pointer-chasing — wrong shape for
an accelerator; the device consumes this module's haplotype output via the pair-HMM).

Semantics contract (reference/src/read_threading/):
- read_threading_graph.rs:111-140 per-sequence non-unique kmer detection;
  :484-660 threading (reads start at their first unique kmer, chains extend
  by suffix match, unique kmers merge via the kmer->vertex map);
- multi_sample_edge.rs: per-sample pruning multiplicities (top
  num_pruning_samples kept, min of those = pruning multiplicity);
- chain_pruner.rs: linear chains where every non-ref edge has pruning
  multiplicity < prune_factor are removed;
- read_threading_assembler.rs:203-450: kmer-size iteration (21, 33; +2 odd
  steps on cycles/low-complexity up to +6), coverage-keyed prune factor
  (2 if coverage > 10 else 0), k-best haplotype search, haplotype-vs-ref
  CIGAR via padded SW;
- graph_based_k_best_haplotype_finder.rs:64: k-best paths scored by
  log10(edge multiplicity / total outgoing multiplicity) at branch points.

Dangling-end recovery (abstract_read_threading_graph.rs:231-455) is
implemented for tails and heads in the common merge cases.
"""
from __future__ import annotations

import heapq
import threading
from dataclasses import dataclass, field

import numpy as np

from lorikeet_tpu_torch.ops.smith_waterman import (
    align, OverhangStrategy, STANDARD_NGS,
)

PRUNE_FACTOR_COVERAGE_THRESHOLD = 10.0
MAX_KMER_ITERATIONS_TO_ATTEMPT = 6
_DOT_LOCK = threading.Lock()
#: the graphs this process's regions took to the seq-graph step and those
#: of them whose seq graph the native builder zipped (no kmer graph as
#: Python objects); a pool worker ships them with each result
#: (parallel/pool.py WORKER_COUNTS)
ASM_COUNTS = {"asm_graphs": 0, "asm_native_zip": 0}
_COUNTS_LOCK = threading.Lock()
KMER_SIZE_ITERATION_INCREASE = 13
# dangling-end SW alignments with more elements are untrusted
# (read_threading_graph.rs:69)
MAX_CIGAR_COMPLEXITY = 3


def take_asm_counts() -> dict:
    """ASM_COUNTS as they stand, and zero them."""
    with _COUNTS_LOCK:
        out = dict(ASM_COUNTS)
        ASM_COUNTS.update(dict.fromkeys(ASM_COUNTS, 0))
    return out


class Edge:
    __slots__ = ("multiplicity", "is_ref", "current_sample", "samples")

    def __init__(self, is_ref=False, num_pruning_samples=1, initial=0):
        """``initial`` is the creation multiplicity: it seeds the kept
        per-sample list as its own entry AND counts toward the current
        sample (MultiSampleEdge::set pushes it and sets current,
        multi_sample_edge.rs:57-67), so it is deliberately represented
        twice.  Threading creates edges with the stretch count
        (read_threading_graph.rs:764); the reference's own unit test
        creates with 0."""
        self.multiplicity = initial
        self.is_ref = is_ref
        self.current_sample = initial
        self.samples = [initial]   # kept top multiplicities (len <= num_pruning_samples)

    def inc(self, n=1):
        self.multiplicity += n
        self.current_sample += n

    def flush_sample(self, cap=1):
        s = self.samples
        s.append(self.current_sample)
        if len(s) > cap:
            s.sort(reverse=True)
            del s[cap:]
        self.current_sample = 0

    def pruning_multiplicity(self, cap=1):
        """Minimum of the kept top-``cap`` values — the heap peek of
        {creation multiplicity} + per-sample totals, never 0-padded for
        samples beyond those flushed (multi_sample_edge.rs:94-96)."""
        vals = sorted(self.samples, reverse=True)[:cap]
        return vals[-1] if vals else self.current_sample


def read_stretches(rec, min_base_quality: int):
    """Maximal high-quality non-N stretches of a read's non-soft-clipped
    bases as [(name, bytes)] (GATK add_read splitting, kmer-independent)."""
    seq = rec.seq
    qual = rec.qual
    cigar = getattr(rec, "cigar", None)
    if cigar:
        lead = cigar[0][1] if cigar[0][0] == "S" else 0
        tail = cigar[-1][1] if cigar[-1][0] == "S" else 0
        if lead or tail:
            end = len(seq) - tail
            seq = seq[lead:end]
            qual = qual[lead:end]
    good = (qual >= min_base_quality) & (seq != ord("N"))
    edges = np.flatnonzero(np.diff(np.concatenate(
        ([False], good, [False])).view(np.int8)))
    return [(rec.name, seq[start:stop].tobytes())
            for start, stop in zip(edges[::2].tolist(), edges[1::2].tolist())]


def read_stretches_batch(recs, min_base_quality: int) -> list:
    """read_stretches over a whole read list in one vector pass: one
    concatenated good-mask with separator sentinels instead of per-read
    numpy round trips.  Returns a flat [(name, bytes)] list."""
    if not recs:
        return []
    n = len(recs)
    seq_views = []
    qual_views = []
    names = []
    for rec in recs:                       # light loop: views only, no copy
        seq = rec.seq
        qual = rec.qual
        cigar = getattr(rec, "cigar", None)
        if cigar:
            lead = cigar[0][1] if cigar[0][0] == "S" else 0
            tail = cigar[-1][1] if cigar[-1][0] == "S" else 0
            if lead or tail:
                end = len(seq) - tail
                seq = seq[lead:end]
                qual = qual[lead:end]
        seq_views.append(seq)
        qual_views.append(qual)
        names.append(rec.name)
    lens = np.fromiter(map(len, seq_views), np.int64, n)
    bounds = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=bounds[1:])
    total = int(bounds[-1])
    if total == 0:
        return []
    cat = np.concatenate(seq_views)        # one C memcpy pass, no zero-fill
    q = np.concatenate(qual_views)
    good = (q >= min_base_quality) & (cat != ord("N"))
    edges = np.flatnonzero(np.diff(np.concatenate(
        ([False], good, [False])).view(np.int8)))
    starts = edges[::2]
    stops = edges[1::2]
    # the concat has no separators: split any run crossing a read boundary
    inner = bounds[1:-1]
    inner = inner[(inner > 0) & (inner < total)]   # 0-length reads
    cross = inner[good[inner - 1] & good[inner]]
    if cross.size:
        starts = np.sort(np.concatenate([starts, cross]))
        stops = np.sort(np.concatenate([stops, cross]))
    ridx = np.searchsorted(bounds[1:], starts, side="right")
    cat_b = cat.tobytes()
    return [(names[r], cat_b[int(s):int(e)])
            for r, s, e in zip(ridx.tolist(), starts.tolist(),
                               stops.tolist())]


class ReadThreadingGraph:
    def __init__(self, kmer_size: int, num_pruning_samples: int = 1,
                 start_only_at_existing: bool = True):
        # False = GATK's default when dangling recovery is on: reads start
        # at their first unique kmer, creating recoverable dangling heads
        # (read_threading_graph.rs:239-248 is_threading_start;
        # read_threading_assembler.rs:980)
        self.kmer_size = kmer_size
        self.num_pruning_samples = num_pruning_samples
        self.start_only_at_existing = start_only_at_existing
        self.vertices = []         # vertex id -> kmer bytes
        self.out_edges = []        # vertex id -> {target: Edge}
        self.in_edges = []         # vertex id -> {source: Edge}
        self.kmer_to_vertex = {}   # unique kmer bytes -> vertex id
        self.non_unique = set()
        self.pending = []          # (name, seq bytes, count, is_ref)
        self.ref_path = []
        self.ref_source = None
        self.ref_sink = None
        self.built = False
        self.cycle_checked = None      # set by build() on the native path
        self.native_pruned = False
        self.native_zip = None     # zipped seq-graph arrays (native path)
        self.recovered_cyclic = False  # native recovery made a cycle
        self.vertex_last = None    # bytes: last base per vertex (native)

    # ---------------- construction ----------------
    def add_sequence(self, seq: bytes, count: int = 1, is_ref: bool = False,
                     name: str = "", sample_id: int = 0):
        self.pending.append((name, seq, count, is_ref, sample_id))

    def add_read(self, rec, min_base_quality: int):
        """Split the read at low-quality/N bases (GATK add_read semantics) and
        add each stretch longer than kmer_size.  Soft-clipped bases are
        excluded (run_local_assembly hard-clips them,
        read_threading_assembler.rs:237-242)."""
        for name, stretch in read_stretches(rec, min_base_quality):
            if len(stretch) >= self.kmer_size:
                self.add_sequence(stretch, 1, False, name,
                                  getattr(rec, "sample_index", 0))

    def add_stretches(self, stretches, sample_id: int = 0):
        """Pre-split (name, bytes) stretches (see read_stretches); the
        splitting is kmer-size independent so multi-k assembly computes it
        once.  Sequences must be added sample-grouped: per-sample pruning
        multiplicities roll at sample boundaries
        (multi_sample_edge.rs flush_single_sample_multiplicity)."""
        for name, stretch in stretches:
            if len(stretch) >= self.kmer_size:
                self.add_sequence(stretch, 1, False, name, sample_id)

    def _new_vertex(self, kmer: bytes) -> int:
        vid = len(self.vertices)
        self.vertices.append(kmer)
        self.out_edges.append({})
        self.in_edges.append({})
        if kmer not in self.non_unique and kmer not in self.kmer_to_vertex:
            self.kmer_to_vertex[kmer] = vid
        return vid

    def _edge(self, u: int, v: int, is_ref: bool, count: int = 0) -> Edge:
        """Get-or-create the edge u->v; a NEW edge takes ``count`` as its
        creation multiplicity (seeding the pruning heap), an existing one
        is incremented by it."""
        e = self.out_edges[u].get(v)
        if e is None:
            e = Edge(is_ref, self.num_pruning_samples, count)
            self.out_edges[u][v] = e
            self.in_edges[v][u] = e
        elif count:
            e.inc(count)
        if is_ref:
            e.is_ref = True
        return e

    def build(self, prune_factor: int = None, prepacked=None,
              allow_zip: bool = False, recovery_on: bool = True,
              min_dangling_branch_length: int = 1,
              min_matching_bases: int = -1, recover_all: bool = False):
        """Thread all pending sequences.  With the native graph library, the
        per-sample multiplicity flushes, the cycle check, and (when
        ``prune_factor`` is a positive int) low-weight chain pruning +
        orphan removal all happen in C++ before any Edge objects are
        materialized; ``self.cycle_checked`` then holds the cycle verdict
        and ``self.native_pruned`` whether pruning already ran.

        With ``allow_zip``, the C++ library (native/graph_recover.cpp)
        also recovers the dangling ends (when ``recovery_on``, with the
        last three arguments of :meth:`recover_dangling_ends`) and runs the
        reachability filter + kmer->seq chain zip: ``self.native_zip`` then
        holds the zipped seq-graph arrays and NO kmer-graph objects are
        materialized at all (vertices/edges stay empty; only the gate
        fields are valid).  A graph cyclic before recovery or after it
        (``self.recovered_cyclic``) comes back as its gates alone.  Where
        that library declines (too many pruning samples, a capacity
        overflow), the kmer graph is handed over as without ``allow_zip``."""
        assert not self.built
        k = self.kmer_size
        self.cycle_checked = None
        self.native_pruned = False
        self.native_zip = None
        self.recovered_cyclic = False
        # native C++ library when the toolchain is present (same thread
        # order, reference first; stable sort keeps sample grouping).  A
        # prepacked operand set is already ref-first, so only sort when the
        # native call will actually consume self.pending
        if prepacked is None:
            self.pending.sort(key=lambda t: not t[3])
        from lorikeet_tpu_torch.native import graph_native
        from lorikeet_tpu_torch.native.graph_recover_native import (
            build_graph_recover)
        gated = build_graph_recover(
            self.pending, k, self.num_pruning_samples, prune_factor or 0,
            self.start_only_at_existing, prepacked=prepacked,
            recovery_on=recovery_on,
            min_dangling_branch_length=min_dangling_branch_length,
            min_matching_bases=min_matching_bases,
            recover_all=recover_all) if allow_zip else None
        if gated is not None:
            cyc, n_nonuniq, n_map, nr = gated["gates"]
            self._complexity = (n_nonuniq, n_map)
            self.native_zip = gated["zip"]
            self.recovered_cyclic = gated["cyclic_after"]
            self.cycle_checked = cyc
            self.native_pruned = bool(prune_factor) and not cyc
            # sentinel endpoints: nr > 0 means the reference threaded; the
            # actual kmer-vertex ids are never consumed on the zip path
            self.ref_source = 0 if nr else None
            self.ref_sink = 0 if nr else None
            self.ref_path = []
            self.pending = []
            self.built = True
            return
        # the pruned kmer graph handed over (graph_build3 without its zip)
        native = graph_native.build_graph_native3(
            self.pending, k, self.num_pruning_samples, prune_factor or 0,
            self.start_only_at_existing, prepacked=prepacked,
            allow_zip=False)
        if native is not None:
            (vertices, (e_u, e_v, e_mult, e_ref, e_pm), ref_path, cyc,
             (n_nonuniq, n_map), last_bytes) = native["kmer"]
            self._complexity = (n_nonuniq, n_map)
            self.vertices = vertices
            self.vertex_last = last_bytes
            self.out_edges = [{} for _ in vertices]
            self.in_edges = [{} for _ in vertices]
            out, inn = self.out_edges, self.in_edges
            enew = Edge.__new__
            nps = self.num_pruning_samples
            for u, v, m, r, pm in zip(e_u.tolist(), e_v.tolist(),
                                      e_mult.tolist(), e_ref.tolist(),
                                      e_pm.tolist()):
                e = enew(Edge)
                e.multiplicity = m
                e.current_sample = 0
                e.is_ref = bool(r)
                # per-sample history compressed to what pruning reads:
                # pruning_multiplicity(nps) == pm
                e.samples = [pm] * nps
                out[u][v] = e
                inn[v][u] = e
            self.ref_path = ref_path.tolist()
            if self.ref_path:
                self.ref_source = self.ref_path[0]
                self.ref_sink = self.ref_path[-1]
            self.cycle_checked = cyc
            self.native_pruned = bool(prune_factor) and not cyc
            self.pending = []
            self.built = True
            return
        # per-sequence non-unique kmers, unioned (determine_non_unique_kmers)
        for _, seq, _, _, _ in self.pending:
            seen = set()
            for i in range(len(seq) - k + 1):
                km = seq[i:i + k]
                if km in seen:
                    self.non_unique.add(km)
                else:
                    seen.add(km)
        # thread the reference first, then reads, rolling per-sample
        # multiplicities at sample boundaries
        self.pending.sort(key=lambda t: not t[3])
        prev_sample = None
        for name, seq, count, is_ref, sample_id in self.pending:
            if prev_sample is not None and sample_id != prev_sample:
                self.flush_sample()
            prev_sample = sample_id
            self._thread(seq, count, is_ref)
        self.pending = []
        if self.ref_path:
            self.ref_source = self.ref_path[0]
            self.ref_sink = self.ref_path[-1]
        self._complexity = (len(self.non_unique), len(self.kmer_to_vertex))
        self.built = True

    def is_low_quality_graph(self) -> bool:
        """Too many non-unique kmers for this kmer size
        (read_threading_graph.rs:261-263): the assembler skips the size
        unless it is the last attempt."""
        n_nonuniq, n_map = getattr(self, "_complexity", (0, 1))
        return n_nonuniq * 4 > n_map

    def flush_sample(self):
        """Call between samples to roll per-sample multiplicities."""
        for outs in self.out_edges:
            for e in outs.values():
                e.flush_sample(self.num_pruning_samples)

    def _thread(self, seq: bytes, count: int, is_ref: bool):
        k = self.kmer_size
        if len(seq) < k + 1:
            return
        # find_start: ref starts at 0; reads at their first unique kmer
        if is_ref:
            start = 0
        else:
            start = None
            for i in range(len(seq) - k):
                km = seq[i:i + k]
                ok = (km in self.kmer_to_vertex
                      if self.start_only_at_existing
                      else km not in self.non_unique)
                if ok:
                    start = i
                    break
            if start is None:
                return
        if len(seq) <= start + k:
            return
        kmer = seq[start:start + k]
        vid = self.kmer_to_vertex.get(kmer)
        if vid is None:
            vid = self._new_vertex(kmer)
        if is_ref:
            self.ref_path = [vid]
        for i in range(start + 1, len(seq) - k + 1):
            vid = self._extend(vid, seq, i, count, is_ref)
            if is_ref:
                self.ref_path.append(vid)

    def _extend(self, prev: int, seq: bytes, kmer_start: int, count: int,
                is_ref: bool) -> int:
        k = self.kmer_size
        next_base = seq[kmer_start + k - 1]
        for target, e in self.out_edges[prev].items():
            if self.vertices[target][-1] == next_base:
                e.inc(count)
                if is_ref:
                    e.is_ref = True
                return target
        kmer = seq[kmer_start:kmer_start + k]
        vid = self.kmer_to_vertex.get(kmer)
        if vid is None:
            vid = self._new_vertex(kmer)
        self._edge(prev, vid, is_ref, count)
        return vid

    # ---------------- queries ----------------
    def sources(self):
        return [v for v in range(len(self.vertices))
                if not self.in_edges[v] and self.out_edges[v]]

    def sinks(self):
        return [v for v in range(len(self.vertices))
                if not self.out_edges[v] and self.in_edges[v]]

    def has_cycle(self) -> bool:
        # Kahn's algorithm: a DAG can be fully peeled from its sources;
        # anything left is on a cycle.  Cheaper constants than the
        # colored-DFS formulation at these graph sizes.
        n = len(self.vertices)
        indeg = [len(self.in_edges[v]) for v in range(n)]
        stack = [v for v in range(n) if not indeg[v]]
        seen = 0
        out_edges = self.out_edges
        while stack:
            v = stack.pop()
            seen += 1
            for w in out_edges[v]:
                indeg[w] -= 1
                if not indeg[w]:
                    stack.append(w)
        return seen != n

    def remove_edge(self, u, v):
        self.out_edges[u].pop(v, None)
        self.in_edges[v].pop(u, None)

    # ---------------- pruning ----------------
    def find_chains(self):
        """Linear chains as edge lists (chain_pruner.rs:58-121)."""
        chains = []
        chain_starts = list(self.sources())
        seen = set(chain_starts)
        qi = 0
        while qi < len(chain_starts):
            start = chain_starts[qi]
            qi += 1
            for target in list(self.out_edges[start]):
                chain = [(start, target)]
                last = target
                first = start
                while True:
                    outs = self.out_edges[last]
                    if len(outs) != 1 or len(self.in_edges[last]) > 1 or last == first:
                        break
                    nxt = next(iter(outs))
                    chain.append((last, nxt))
                    last = nxt
                chains.append(chain)
                if last not in seen:
                    seen.add(last)
                    chain_starts.append(last)
        return chains

    def prune_chains_adaptive(self, initial_error_rate: float = 0.001,
                              log_odds_threshold: float = 1.0,
                              seeding_log_odds_threshold: float = 4.0,
                              max_unpruned_variants: int = 100):
        """Adaptive likelihood-ratio chain pruning
        (adaptive_chain_pruner.rs:37-280, chain_pruner.rs:120-186): estimate
        the error rate from probable-error chains under the initial rate,
        re-run the classification, and remove non-ref error chains.

        Thresholds are log10 odds (the CLI convention) and converted to
        natural log here (haplotype_caller_engine.rs:164-171)."""
        log_odds_threshold *= np.log(10.0)
        seeding_log_odds_threshold *= np.log(10.0)
        chains = self.find_chains()
        if not chains:
            return
        probable = self._likely_error_chains(
            chains, initial_error_rate, log_odds_threshold,
            seeding_log_odds_threshold, max_unpruned_variants)
        error_count = sum(
            self.out_edges[chains[ci][-1][0]][chains[ci][-1][1]].multiplicity
            for ci in probable)
        total_bases = sum(self.out_edges[u][v].multiplicity
                          for chain in chains for u, v in chain)
        error_rate = error_count / total_bases if total_bases else 0.0
        to_remove = self._likely_error_chains(
            chains, error_rate, log_odds_threshold,
            seeding_log_odds_threshold, max_unpruned_variants)
        for ci in to_remove:
            chain = chains[ci]
            if any(self.out_edges[u][v].is_ref for u, v in chain):
                continue
            for u, v in chain:
                self.remove_edge(u, v)

    def _chain_log_odds(self, chain, error_rate: float):
        """(left, right) ln-odds that the chain is real variation
        (adaptive_chain_pruner.rs:197-246)."""
        from lorikeet_tpu_torch.utils.math import log_likelihood_ratio_constant_error
        first = chain[0][0]
        last = chain[-1][1]
        first_edge = self.out_edges[chain[0][0]][chain[0][1]]
        last_edge = self.out_edges[chain[-1][0]][chain[-1][1]]
        left_total = sum(e.multiplicity for e in self.out_edges[first].values())
        right_total = sum(e.multiplicity for e in self.in_edges[last].values())
        if not self.in_edges[first]:       # graph source
            left = 0.0
        else:
            left = log_likelihood_ratio_constant_error(
                left_total - first_edge.multiplicity, first_edge.multiplicity,
                error_rate)
        if not self.out_edges[last]:       # graph sink
            right = 0.0
        else:
            right = log_likelihood_ratio_constant_error(
                right_total - last_edge.multiplicity, last_edge.multiplicity,
                error_rate)
        return left, right

    def _likely_error_chains(self, chains, error_rate, log_odds_threshold,
                             seeding_log_odds_threshold,
                             max_unpruned_variants):
        """Returns the set of chain INDICES classified as probable errors."""
        import heapq
        odds = [self._chain_log_odds(c, error_rate) for c in chains]
        good_in = {}       # vertex -> [chain idx] with good right odds
        good_out = {}      # vertex -> [chain idx] with good left odds
        seed_count = {}    # vertex -> # seedable chains touching it
        for ci, chain in enumerate(chains):
            first, last = chain[0][0], chain[-1][1]
            first_is_ref = self.out_edges[chain[0][0]][chain[0][1]].is_ref
            if odds[ci][1] >= log_odds_threshold or first_is_ref:
                good_in.setdefault(last, []).append(ci)
            if odds[ci][0] >= log_odds_threshold or first_is_ref:
                good_out.setdefault(first, []).append(ci)
            if (odds[ci][0] >= seeding_log_odds_threshold
                    and odds[ci][1] >= seeding_log_odds_threshold):
                seed_count[first] = seed_count.get(first, 0) + 1
                seed_count[last] = seed_count.get(last, 0) + 1

        heap = []  # (-log_odds, chain idx)
        max_ci = max(range(len(chains)), key=lambda ci: (
            max(self.out_edges[u][v].multiplicity for u, v in chains[ci]),
            len(chains[ci])))
        heapq.heappush(heap, (-np.inf, max_ci))
        processed = set()
        for vertex, cnt in seed_count.items():
            if cnt > 2:
                for ci in good_out.get(vertex, ()):
                    heapq.heappush(heap, (-odds[ci][0], ci))
                for ci in good_in.get(vertex, ()):
                    heapq.heappush(heap, (-odds[ci][1], ci))
                processed.add(vertex)

        good_chains = set()
        have_good_outgoing = set()
        variant_count = 0
        while heap and variant_count <= max_unpruned_variants:
            _, ci = heapq.heappop(heap)
            if ci in good_chains:
                continue
            good_chains.add(ci)
            first = chains[ci][0][0]
            new_variant = first in have_good_outgoing
            have_good_outgoing.add(first)
            if new_variant:
                variant_count += 1
                if variant_count > max_unpruned_variants:
                    continue
            for vertex in (chains[ci][0][0], chains[ci][-1][1]):
                if vertex not in processed:
                    for cj in good_out.get(vertex, ()):
                        heapq.heappush(heap, (-odds[cj][0], cj))
                    for cj in good_in.get(vertex, ()):
                        heapq.heappush(heap, (-odds[cj][1], cj))
                    processed.add(vertex)
        return {ci for ci in range(len(chains)) if ci not in good_chains}

    def prune_low_weight_chains(self, prune_factor: int):
        if prune_factor <= 0:
            return
        for chain in self.find_chains():
            edges = [self.out_edges[u][v] for u, v in chain
                     if v in self.out_edges[u]]
            if edges and all(
                    e.pruning_multiplicity(self.num_pruning_samples) < prune_factor
                    and not e.is_ref for e in edges):
                for u, v in chain:
                    self.remove_edge(u, v)

    def remove_paths_not_connected_to_ref(self):
        """Drop vertices off every ref_source -> ref_sink path.  Runs AFTER
        dangling-end recovery (read_threading_assembler.rs:1134), never as
        part of pruning — recoverable dangling chains must survive it."""
        self._remove_orphans()

    def _remove_orphans(self):
        # disconnect vertices unreachable from ref source or not reaching sink
        if self.ref_source is None:
            return
        fwd = self._reachable(self.ref_source, self.out_edges)
        bwd = self._reachable(self.ref_sink, self.in_edges)
        for v in range(len(self.vertices)):
            if not (fwd[v] and bwd[v]):
                if self.out_edges[v]:
                    for t in list(self.out_edges[v]):
                        self.remove_edge(v, t)
                if self.in_edges[v]:
                    for s in list(self.in_edges[v]):
                        self.remove_edge(s, v)

    def _reachable(self, start, adj):
        # flat byte-mask DFS: ~3x faster than a set at assembly graph sizes
        seen = bytearray(len(self.vertices))
        seen[start] = 1
        stack = [start]
        push = stack.append
        while stack:
            for m in adj[stack.pop()]:
                if not seen[m]:
                    seen[m] = 1
                    push(m)
        return seen

    # ---------------- dangling end recovery ----------------
    def recover_dangling_ends(self, min_dangling_branch_length: int = 1,
                              min_matching_bases: int = -1,
                              recover_all: bool = False):
        """Merge dangling tails/heads into the reference path via SW
        (abstract_read_threading_graph.rs:231-455, read_threading_graph.rs:
        770-1100).  ``min_matching_bases < 0`` is the legacy gate (any
        non-zero suffix match merges); >= 0 requires that many matching
        bases at the junction.  ``recover_all`` keeps walking through fork
        vertices along the highest-multiplicity edge (recover branches with
        forks, read_threading_graph.rs:783,828)."""
        if self.ref_source is None:
            return 0
        recovered = 0
        ref_set = set(self.ref_path)
        for sink in list(self.sinks()):
            if sink in ref_set or sink == self.ref_sink:
                continue
            if self._recover_tail(sink, ref_set, min_dangling_branch_length,
                                  min_matching_bases, recover_all):
                recovered += 1
        for source in list(self.sources()):
            if source in ref_set or source == self.ref_source:
                continue
            if self._recover_head(source, ref_set,
                                  min_dangling_branch_length,
                                  min_matching_bases, recover_all):
                recovered += 1
        return recovered

    def _walk_back(self, vertex, adj, ref_set, recover_all=False):
        """Walk the linear chain from a dangling vertex until a reference or
        branching vertex; returns the vertex list (dangling end first).
        With ``recover_all`` forks don't stop the walk: it follows the
        highest-multiplicity incident edge (bounded by graph size)."""
        path = [vertex]
        cur = vertex
        limit = len(self.vertices) + 1
        while len(path) < limit:
            edges = adj[cur]
            if len(edges) == 1:
                nxt = next(iter(edges))
            elif recover_all and edges:
                nxt = max(edges, key=lambda t: edges[t].multiplicity)
            else:
                break
            if nxt in path:
                break
            path.append(nxt)
            cur = nxt
            if nxt in ref_set:
                break
            other = self.out_edges[nxt] if adj is self.in_edges else self.in_edges[nxt]
            if len(other) > 1 and not recover_all:
                break
        return path

    @staticmethod
    def _longest_suffix_match(ref_seq: bytes, dangling_seq: bytes,
                              ref_end: int) -> int:
        """Longest common suffix of dangling_seq and ref_seq[:ref_end+1]
        (abstract_read_threading_graph.rs:202-214)."""
        n = 0
        i = ref_end
        j = len(dangling_seq) - 1
        while i >= 0 and j >= 0 and ref_seq[i] == dangling_seq[j]:
            n += 1
            i -= 1
            j -= 1
        return n

    def _seq_of(self, path_rev):
        """Bases of a forward-ordered vertex path: first kmer + suffixes."""
        if not path_rev:
            return b""
        out = bytearray(self.vertices[path_rev[0]])
        for v in path_rev[1:]:
            out.append(self.vertices[v][-1])
        return bytes(out)

    def _matching_suffix(self, cigar, ref_seq, dangling_seq, min_matching):
        """Suffix-match gate shared by tail/head merges
        (read_threading_graph.rs:975-1000 merge_dangling_tail): the number
        of junction bases that actually match, capped at the final cigar M
        run; None when below the configured floor."""
        last_ref_index = sum(n for op, n in cigar if op in "MD") - 1
        matching = min(
            self._longest_suffix_match(ref_seq, dangling_seq, last_ref_index),
            cigar[-1][1])
        if min_matching >= 0:
            if matching < min_matching:
                return None
        elif matching == 0:
            return None
        return matching

    def _recover_tail(self, sink, ref_set, min_len, min_matching,
                      recover_all=False):
        path = self._walk_back(sink, self.in_edges, ref_set, recover_all)
        if len(path) < 2 or path[-1] not in ref_set:
            return
        branch = path[-1]
        fwd = path[::-1]  # branch..sink
        if len(fwd) - 1 < min_len:
            return
        try:
            ref_idx = self.ref_path.index(branch)
        except ValueError:
            return
        ref_fwd = self.ref_path[ref_idx:]
        # one base per vertex, starting at the shared branch base (GATK tail
        # path strings, get_bases_for_path without source expansion): string
        # index == vertex index, which the merge indices below rely on
        k1 = self.kmer_size - 1
        dangling_seq = self._seq_of(fwd)[k1:]
        ref_seq = self._seq_of(ref_fwd)[k1:]
        cigar, _ = align(ref_seq, dangling_seq, STANDARD_NGS, OverhangStrategy.LEADING_INDEL)
        # strip an uninteresting trailing deletion before gating
        # (AlignmentUtils::remove_trailing_deletions at helper creation,
        # read_threading_graph.rs:1416-1421)
        if cigar and cigar[-1][0] == "D":
            cigar = cigar[:-1]
        # cigar_is_okay_to_merge: <= 3 elements and the alignment must END
        # in a match run (abstract_read_threading_graph.rs:91-125,
        # MAX_CIGAR_COMPLEXITY = 3)
        if not cigar or len(cigar) > MAX_CIGAR_COMPLEXITY \
                or cigar[-1][0] != "M":
            return
        matching_suffix = self._matching_suffix(cigar, ref_seq, dangling_seq,
                                                min_matching)
        if matching_suffix is None:
            return
        # merge indices (merge_dangling_tail, read_threading_graph.rs:
        # 960-1042): the dangling vertex just before the matched suffix
        # connects to the reference vertex where that suffix begins
        last_ref_index = sum(n for op, n in cigar if op in "MD") - 1
        read_len = sum(n for op, n in cigar if op in "MIS=X")
        alt_index = max(read_len - matching_suffix - 1, 0)
        # left-aligned leading deletion covering the LCA: push the ref merge
        # point one position so the deletion keeps its full length
        leading_del = (cigar[0][0] == "D"
                       and cigar[0][1] + matching_suffix == last_ref_index + 1)
        ref_index = last_ref_index - matching_suffix + 1 + (1 if leading_del
                                                            else 0)
        if ref_index <= 0 or ref_index >= len(ref_fwd) \
                or alt_index >= len(fwd):
            return
        join_dang = fwd[alt_index]
        join_ref = ref_fwd[ref_index]
        if join_ref in self.out_edges[join_dang]:
            return False
        self._edge(join_dang, join_ref, False, 1)
        return True

    def _recover_head(self, source, ref_set, min_len, min_matching,
                      recover_all=False):
        path = self._walk_back(source, self.out_edges, ref_set, recover_all)
        if len(path) < 2 or path[-1] not in ref_set:
            return
        if len(path) - 1 < min_len:
            return
        branch = path[-1]
        try:
            ref_idx = self.ref_path.index(branch)
        except ValueError:
            return
        ref_back = self.ref_path[:ref_idx + 1]
        # reversed dangling bases (source end last): build the chain's
        # sequence in walk order, then reverse the BASES — reversing the
        # vertex path first and re-reading suffixes drops the divergent
        # head bases entirely (kmer suffix concatenation is directional)
        dangling_seq = self._seq_of(path)[::-1]
        # align reversed sequences so the head behaves like a tail
        ref_seq = self._seq_of(ref_back)[::-1]
        cigar, _ = align(ref_seq, dangling_seq, STANDARD_NGS, OverhangStrategy.LEADING_INDEL)
        # strip trailing deletion, then gate on complexity + leading M
        # (remove_trailing_deletions + cigar_is_okay_to_merge(first=True),
        # read_threading_graph.rs:944 / abstract_read_threading_graph.rs:91)
        if cigar and cigar[-1][0] == "D":
            cigar = cigar[:-1]
        if not cigar or len(cigar) > MAX_CIGAR_COMPLEXITY \
                or cigar[0][0] != "M":
            return
        # merge-point selection on the branch-first (reversed) strings
        # (read_threading_graph.rs merge_dangling_head{,_legacy}):
        n = min(len(ref_seq), len(dangling_seq))
        if min_matching is None or min_matching < 0:
            # legacy: last mismatch within the leading M run, capped at
            # max(1, leading_M_len // kmer_size) mismatches; a mismatch must
            # exist (best_prefix_match_legacy :1058-1062 is called with the
            # FIRST cigar element's length, which also seeds
            # get_max_mismatches_legacy :1142-1152)
            max_mm = max(1, cigar[0][1] // self.kmer_size)
            limit = min(cigar[0][1], n)
            mism = [i for i in range(limit)
                    if ref_seq[i] != dangling_seq[i]]
            if not mism or len(mism) > max_mm:
                return
            idx = mism[-1]
        else:
            # new: walk from the source end towards the branch counting
            # consecutive matches; require >= min_matching; merge at the
            # first mismatch met (best_prefix_match :1303-1350)
            ref_i = sum(cn for op, cn in cigar if op in "MD") - 1
            read_i = len(dangling_seq) - 1
            for op, cn in reversed(cigar):
                if op not in "M=X":
                    break
                stop = False
                for _ in range(cn):
                    if ref_i >= len(ref_seq) \
                            or ref_seq[ref_i] != dangling_seq[read_i]:
                        stop = True
                        break
                    ref_i -= 1
                    read_i -= 1
                    if ref_i < 0 or read_i < 0:
                        stop = True
                        break
                if stop:
                    break
            matches = len(dangling_seq) - 1 - read_i
            if matches < min_matching or read_i <= 0 or ref_i <= 0:
                return
            idx = read_i
            # the alignment may place the mismatch at different ref/read
            # offsets under indels; merge indices follow the read side for
            # the dangling path and the ref side for the reference path
            ref_merge = ref_i
        if min_matching is None or min_matching < 0:
            ref_merge = idx
        rp = ref_back[::-1]                 # branch-first reference vertices
        dp = path[::-1]                     # branch-first dangling vertices
        if ref_merge >= len(rp) - 1:
            return                          # can't push back the reference
        if idx >= len(dp):
            # the merge lands inside the source kmer: replace the source by
            # new vertices that borrow reference bases, so per-base merge
            # points exist (extend_dangling_path_against_reference
            # :1358-1420)
            off = sum((cn if op in "MD" else 0) - (cn if op in "MI" else 0)
                      for op, cn in cigar)
            num = idx - len(dp) + 2
            ref_node = len(dp) - 1 + off + num
            if ref_node < 0 or ref_node >= len(rp):
                return
            src_kmer = self.vertices[source]
            seq_ext = self.vertices[rp[ref_node]][:num] + src_kmer
            # unlink the old source from the successor the walk actually
            # followed (a forked source under recover_all has several)
            succ = dp[-2]   # the walk guarantees len(dp) >= 2
            old_edge = self.out_edges[source][succ]
            self.remove_edge(source, succ)
            dp = dp[:-1]
            prev = succ
            for i in range(num, 0, -1):
                nv = self._new_vertex(seq_ext[i:i + self.kmer_size])
                self._edge(nv, prev, False, old_edge.multiplicity)
                dp.append(nv)
                prev = nv
        join_ref = rp[ref_merge + 1]
        join_dang = dp[idx]
        if join_dang in self.out_edges[join_ref]:
            return False
        self._edge(join_ref, join_dang, False, 1)
        return True


# ---------------------------------------------------------------------------
# K-best haplotype search
# ---------------------------------------------------------------------------

@dataclass(order=True)
class _PQItem:
    neg_score: float
    tiebreak: int
    path: list = field(compare=False)


def k_best_paths(src, snk, out_edges_of, render, max_paths: int = 128):
    """Shared k-best source->sink search scored by sum of
    log10(mult/total_out) at branches
    (graph_based_k_best_haplotype_finder.rs:64) — the single home for the
    pop cap, bounded-cycle guard, scoring, and sequence dedup used by both
    the kmer-graph and sequence-graph haplotype finders.

    ``out_edges_of(vertex)`` yields a {target: edge} dict; ``render(path)``
    produces the hashable sequence used for dedup.  Returns
    [(score, vertex_path, rendered)] best-first.
    """
    if src is None or snk is None:
        return []
    results = []
    counter = 0
    heap = [_PQItem(0.0, counter, [src])]
    seen_seqs = set()
    max_pops = max_paths * 40
    pops = 0
    while heap and len(results) < max_paths and pops < max_pops:
        item = heapq.heappop(heap)
        pops += 1
        last = item.path[-1]
        if last == snk:
            seq = render(item.path)
            if seq not in seen_seqs:
                seen_seqs.add(seq)
                results.append((-item.neg_score, item.path, seq))
            continue
        outs = out_edges_of(last)
        total = sum(e.multiplicity for e in outs.values())
        for target, e in outs.items():
            if item.path.count(target) > 2:
                continue  # bounded cycle guard
            if total > 0 and e.multiplicity > 0:
                score = item.neg_score + (-np.log10(e.multiplicity / total))
            else:
                score = item.neg_score + 6.0
            counter += 1
            heapq.heappush(heap, _PQItem(score, counter, item.path + [target]))
    return results


def find_best_haplotypes(graph: ReadThreadingGraph, max_paths: int = 128):
    """K-best paths over the kmer graph; [(score, vertex_path)] best-first,
    deduplicated by sequence."""
    return [(score, path) for score, path, _ in k_best_paths(
        graph.ref_source, graph.ref_sink,
        lambda v: graph.out_edges[v], graph._seq_of, max_paths)]


# ---------------------------------------------------------------------------
# Assembly entry point
# ---------------------------------------------------------------------------

@dataclass
class AssembledHaplotype:
    bases: bytes
    cigar: list            # vs the padded reference window
    score: float
    is_ref: bool
    kmer_size: int
    alignment_start_offset: int = 0


MINIMUM_ACTIVITY_DENSITY_THRESHOLD = 0.2
DEFAULT_ADDITIONAL_KMERS = (19, 35, 47)


def compute_additional_kmer_sizes(activity_density: float,
                                  current_sizes) -> list:
    """Density-keyed extra kmer sizes for busy regions
    (assembly_region.rs:120-151): the denser the active positions, the more
    extra sizes; each candidate is bumped by +3 until it clears +-5 of every
    existing size."""
    if activity_density < MINIMUM_ACTIVITY_DENSITY_THRESHOLD:
        return []
    if activity_density - MINIMUM_ACTIVITY_DENSITY_THRESHOLD > 0.4:
        candidates = DEFAULT_ADDITIONAL_KMERS
    elif activity_density - MINIMUM_ACTIVITY_DENSITY_THRESHOLD > 0.2:
        candidates = DEFAULT_ADDITIONAL_KMERS[1:]
    else:
        candidates = DEFAULT_ADDITIONAL_KMERS[1:2]
    out = []
    existing = list(current_sizes)
    for k in candidates:
        while any(abs(cur - k) < 5 for cur in existing):
            k += 3
        out.append(k)
        existing.append(k)
    return out


def _ref_has_non_unique_kmers(ref_bytes: bytes, k: int) -> bool:
    """read_threading_graph.rs:111-140 applied to the reference alone: a
    kmer size fails when the reference repeats a kmer (unless allowed)."""
    seen = set()
    for i in range(len(ref_bytes) - k + 1):
        km = ref_bytes[i:i + k]
        if km in seen:
            return True
        seen.add(km)
    return False


def haplotypes_from_candidates(ref_bytes: bytes, candidates: list,
                               cigars: list) -> list:
    """[AssembledHaplotype], reference first, from
    :func:`assemble_candidates`' candidates and each one's CIGAR against the
    window (None: the alignment does not span it, and the candidate is
    dropped)."""
    out = [AssembledHaplotype(ref_bytes, [("M", len(ref_bytes))], 0.0, True,
                              0)]
    for (score, bases, k), cigar in zip(candidates, cigars):
        if cigar is not None:
            out.append(AssembledHaplotype(bases, cigar, score, False, k))
    return out


def region_pending(ref_bytes: bytes, reads_by_sample: dict,
                   min_base_quality: int) -> list:
    """A region's sequences in thread order, for every kmer size:
    [(name, bytes, count, is_ref, sample index)], the reference first,
    then each sample's read stretches (read_stretches_batch), samples in
    sorted order."""
    pending = [("ref", ref_bytes, 1, True, 0)]
    for sid, sample in enumerate(sorted(reads_by_sample)):
        pending += [(name, st, 1, False, sid) for name, st in
                    read_stretches_batch(reads_by_sample[sample],
                                         min_base_quality)]
    return pending


def assemble_candidates(
    ref_seq: np.ndarray,
    reads_by_sample: dict,
    kmer_sizes=(21, 33),
    min_base_quality: int = 10,
    prune_factor: int = 1,
    disable_prune_correction: bool = False,
    num_pruning_samples: int = 1,
    max_paths: int = 128,
    min_dangling_branch_length: int = 1,
    min_matching_bases: int = -1,
    recover_dangling_branches: bool = True,
    recover_all_dangling_branches: bool = False,
    allow_kmer_extension: bool = True,
    allow_non_unique_kmers_in_ref: bool = False,
    activity_density: float = 0.0,
    region_size: int = None,
    use_adaptive_pruning: bool = False,
    initial_error_rate_for_pruning: float = 0.001,
    pruning_log_odds_threshold: float = 1.0,
    pruning_seeding_log_odds_threshold: float = 4.0,
    max_unpruned_variants: int = 100,
    generate_seq_graph: bool = True,
    dot_path: str = None,
    dot_prefix: str = "",
) -> tuple:
    """One region's graphs and their k-best paths, before any CIGAR:
    (the window's bytes, the candidate haplotypes [(score, bases, kmer
    size)] in the order the paths came, each bases once and none equal to
    the window).  A candidate whose CIGAR fails is dropped by
    :func:`haplotypes_from_candidates`; a later path with its bases would
    fail the same way.

    ``ref_seq`` is the padded reference window; reads must already be
    clipped to it (read coordinates are not used here, only bases/quals).
    """
    ref_bytes = np.asarray(ref_seq, np.uint8).tobytes()
    n_reads = sum(len(v) for v in reads_by_sample.values())

    # coverage-keyed prune factor (read_threading_assembler.rs:246-255);
    # a no-op under adaptive pruning (chain_pruner.rs:30-37)
    if not disable_prune_correction and not use_adaptive_pruning:
        total_bases = sum(len(r.seq) for reads in reads_by_sample.values()
                          for r in reads)
        denom = region_size if region_size else len(ref_bytes)
        coverage = total_bases / max(denom, 1)
        prune_factor = 2 if coverage > PRUNE_FACTOR_COVERAGE_THRESHOLD else 0

    candidates = {ref_bytes: None}     # bases -> (score, bases, k)

    sizes = list(kmer_sizes)
    # density-keyed additional kmer sizes for busy regions
    # (assembly_region.rs:120-151; gated upstream by
    # --disable-automatic-kmer-adjustment passing density 0)
    sizes += compute_additional_kmer_sizes(activity_density, sizes)
    attempts = 0
    # quality splitting is kmer-independent: do it once for all sizes
    base_pending = region_pending(ref_bytes, reads_by_sample,
                                  min_base_quality)
    from lorikeet_tpu_torch.native.graph_native import pack_pending
    packed = pack_pending(base_pending)

    n_results = 0
    n_graphs = n_native_zip = 0

    def _retry_larger_k(k):
        """Append a larger kmer size (read_threading_assembler.rs:419-450):
        only when NO base size produced a result, flat +13 steps with the
        first bumped to odd, at most 6 attempts."""
        nonlocal attempts
        if (allow_kmer_extension and n_results == 0
                and attempts < MAX_KMER_ITERATIONS_TO_ATTEMPT
                and k == sizes[-1]):
            nk = k + KMER_SIZE_ITERATION_INCREASE
            if attempts == 0 and nk % 2 == 0:
                nk += 1
            sizes.append(nk)
            attempts += 1

    for k in sizes:
        if len(ref_bytes) < k + 2:
            # the reference records a Failed AssemblyResult here
            # (create_graph :935-938), which still counts as a result and
            # suppresses kmer expansion
            n_results += 1
            continue
        # non-unique ref kmers fail this kmer size unless explicitly allowed
        # (--allow-non-unique-kmers-in-ref; read_threading_assembler
        # create_graph ref-uniqueness gate)
        if not allow_non_unique_kmers_in_ref \
                and _ref_has_non_unique_kmers(ref_bytes, k):
            _retry_larger_k(k)
            continue
        graph = ReadThreadingGraph(
            k, num_pruning_samples,
            # GATK: reads start at their first unique kmer when dangling
            # recovery is on (read_threading_assembler.rs:980)
            start_only_at_existing=not recover_dangling_branches)
        # one shared pending list + one numpy packing across kmer sizes
        # (threading itself skips too-short sequences per k)
        graph.pending = list(base_pending)
        # the in-C++ recovery and zip apply only when nothing else
        # downstream can mutate the kmer graph before the seq-graph
        # conversion
        graph.build(prune_factor=None if use_adaptive_pruning
                    else prune_factor, prepacked=packed,
                    allow_zip=generate_seq_graph and not use_adaptive_pruning,
                    recovery_on=recover_dangling_branches,
                    min_dangling_branch_length=min_dangling_branch_length,
                    min_matching_bases=min_matching_bases,
                    recover_all=recover_all_dangling_branches)
        if not graph.native_pruned:
            graph.flush_sample()
        if graph.ref_source is None or graph.ref_sink is None:
            continue
        cyclic = graph.cycle_checked if graph.cycle_checked is not None \
            else graph.has_cycle()
        if cyclic:
            _retry_larger_k(k)
            continue
        # low-complexity gate (read_threading_assembler.rs:1064-1072):
        # skip this kmer size unless it is the final attempt
        if graph.is_low_quality_graph():
            if k != sizes[-1]:
                continue
            before = len(sizes)
            _retry_larger_k(k)
            if len(sizes) > before:
                continue
            # final attempt: allow the low-complexity graph
        if use_adaptive_pruning:
            graph.prune_chains_adaptive(initial_error_rate_for_pruning,
                                        pruning_log_odds_threshold,
                                        pruning_seeding_log_odds_threshold,
                                        max_unpruned_variants)
        elif not graph.native_pruned:
            graph.prune_low_weight_chains(prune_factor)
        if graph.recovered_cyclic:
            continue            # the native recovery made a cycle
        recovered = 0
        if graph.native_zip is None and recover_dangling_branches:
            recovered = graph.recover_dangling_ends(
                min_dangling_branch_length, min_matching_bases,
                recover_all_dangling_branches)
        # recovery is the only step that adds edges, so the post-recovery
        # cycle check is conditional on it having changed the graph
        if recovered and graph.has_cycle():
            continue
        # drop heading/trailing paths only AFTER recovery had its chance
        # (read_threading_assembler.rs:1134 remove_paths_not_connected_to_ref)
        if graph.native_zip is None:
            graph.remove_paths_not_connected_to_ref()
        n_results += 1
        if generate_seq_graph:
            # kmer graph -> sequence graph -> simplify -> k-best
            # (read_threading_assembler.rs:272-298 seq-graph pipeline);
            # the recovery and the zip ran in C++ unless the graph left it
            # as kmer-graph objects
            from lorikeet_tpu_torch.assembly.seq_graph import (
                SeqGraph, find_best_haplotypes_seq,
            )
            n_graphs += 1
            n_native_zip += graph.native_zip is not None
            sg = (SeqGraph.from_native_zip(*graph.native_zip)
                  if graph.native_zip is not None
                  else SeqGraph.from_kmer_graph(graph))
            sg.simplify()
            if dot_path:
                # --graph-output DOT dump (base_graph.rs:505); append is
                # atomic enough under the contig thread pool for debugging
                with _DOT_LOCK, open(dot_path, "a") as fh:
                    fh.write(sg.to_dot(f"{dot_prefix}k{k}"))
            scored = find_best_haplotypes_seq(sg, max_paths)
        else:
            scored = [(score, graph._seq_of(path))
                      for score, path in find_best_haplotypes(graph, max_paths)]
        for score, bases in scored:
            if bases not in candidates:
                candidates[bases] = (score, bases, k)

    with _COUNTS_LOCK:
        ASM_COUNTS["asm_graphs"] += n_graphs
        ASM_COUNTS["asm_native_zip"] += n_native_zip
    return ref_bytes, [c for c in candidates.values() if c is not None]
