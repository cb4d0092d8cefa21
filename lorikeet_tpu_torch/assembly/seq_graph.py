"""Sequence graph: kmer-graph collapse + the simplification suite.

Contracts:
- base_graph.rs:54 to_sequence_graph — kmer vertices collapse to their
  additional sequence (full kmer at sources, last base elsewhere), edges
  keep multiplicity + ref flag;
- seq_graph.rs:46-186 simplify_graph — iterate MergeDiamonds, MergeTails,
  SplitCommonSuffixes, MergeCommonSuffixes, zip_linear_chains until no
  transform fires (cycle-capped); the invariant is that the multiset of
  source->sink path sequences never changes;
- vertex_based_transformer.rs:23-358 — the four configurations, with
  shared prefix/suffix extraction from shared_vertex_sequence_splitter.rs
  and the >=10-base guard for merges touching sources/sinks
  (MIN_COMMON_SEQUENCE_TO_MERGE_SOURCE_SINK_VERTICES);
- graph_based_k_best_haplotype_finder.rs:64 — k-best paths scored by
  log10(edge multiplicity / total sibling multiplicity).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

MIN_COMMON_TO_MERGE_SOURCE_SINK = 10
MAX_SIMPLIFY_CYCLES = 100


@dataclass
class SeqEdge:
    multiplicity: int = 0
    is_ref: bool = False

    def merge(self, other: "SeqEdge"):
        self.multiplicity += other.multiplicity
        self.is_ref = self.is_ref or other.is_ref


class SeqGraph:
    def __init__(self):
        self.seqs = {}          # id -> bytes
        self.out_edges = {}     # id -> {id: SeqEdge}
        self.in_edges = {}      # id -> {id: SeqEdge}
        self._next = 0

    # ---- construction -----------------------------------------------------
    def add_vertex(self, seq: bytes) -> int:
        vid = self._next
        self._next += 1
        self.seqs[vid] = seq
        self.out_edges[vid] = {}
        self.in_edges[vid] = {}
        return vid

    def add_edge(self, u: int, v: int, multiplicity: int = 1,
                 is_ref: bool = False):
        e = self.out_edges[u].get(v)
        if e is None:
            e = SeqEdge()
            self.out_edges[u][v] = e
            self.in_edges[v][u] = e
        e.multiplicity += multiplicity
        e.is_ref = e.is_ref or is_ref

    def remove_vertex(self, v: int):
        for t in list(self.out_edges[v]):
            del self.in_edges[t][v]
        for s in list(self.in_edges[v]):
            del self.out_edges[s][v]
        del self.out_edges[v], self.in_edges[v], self.seqs[v]

    @classmethod
    def from_kmer_graph(cls, graph) -> "SeqGraph":
        """base_graph.rs:54 to_sequence_graph over a ReadThreadingGraph,
        fused with the first zip_linear_chains pass (seq_graph.rs:189):
        maximal linear kmer chains become single vertices directly, so the
        (large) kmer graph is never materialized as per-kmer seq vertices.
        Produces the same graph the two-step version reaches after one
        zip."""
        sg = cls()
        out_e, in_e = graph.out_edges, graph.in_edges
        kmers = graph.vertices
        # last base per vertex: native builds hand this over as one
        # pre-gathered bytes; dangling recovery may have appended vertices
        # since, so extend (or build) the tail from the kmer list
        last = getattr(graph, "vertex_last", None) or b""
        if len(last) < len(kmers):
            # v[-1] (not v[-1:]): an empty vertex must raise, not silently
            # misalign every subsequent index by contributing zero bytes
            last = last + bytes(v[-1] for v in kmers[len(last):])
            assert len(last) == len(kmers)
        # chain starts: vertices that cannot be merged into a predecessor
        n = len(kmers)
        is_start = [False] * n
        live = []
        for v in range(n):
            ins = in_e[v]
            if not out_e[v] and not ins:
                continue
            live.append(v)
            if len(ins) != 1:
                is_start[v] = True
            else:
                p = next(iter(ins))
                if len(out_e[p]) != 1 or p == v:
                    is_start[v] = True
        # break ties in cycles: any live vertex not reachable as a chain
        # member still needs a start; cycles are rejected upstream, so every
        # live vertex is covered by the rule above
        vmap = {}
        chains = []
        for v in live:
            if not is_start[v]:
                continue
            chain = [v]
            cur = v
            while True:
                outs = out_e[cur]
                if len(outs) != 1:
                    break
                t = next(iter(outs))
                if is_start[t] or t == v:
                    break
                chain.append(t)
                cur = t
            head = chain[0]
            head_is_source = not in_e[head]
            seq = (kmers[head] if head_is_source else last[head:head + 1]) \
                + bytes(map(last.__getitem__, chain[1:]))
            vid = sg.add_vertex(seq)
            for x in chain:
                vmap[x] = vid
            chains.append((head, chain[-1]))
        for head, tail in chains:
            for t, e in out_e[tail].items():
                sg.add_edge(vmap[tail], vmap[t], e.multiplicity, e.is_ref)
        return sg

    @classmethod
    def from_native_zip(cls, bounds, seq_bytes: bytes, edges) -> "SeqGraph":
        """Construct directly from the in-C++ zip (graph_build3 try_zip),
        which is from_kmer_graph + remove_paths_not_connected_to_ref fused
        into the native build — same vertex order, same edge order."""
        sg = cls()
        b = bounds.tolist()
        n = len(b) - 1
        seqs, out_e, in_e = sg.seqs, sg.out_edges, sg.in_edges
        for i in range(n):
            seqs[i] = seq_bytes[b[i]:b[i + 1]]
            out_e[i] = {}
            in_e[i] = {}
        sg._next = n
        eu, ev, em, er = edges
        for u, v, m, r in zip(eu.tolist(), ev.tolist(), em.tolist(),
                              er.tolist()):
            e = SeqEdge(m, bool(r))
            out_e[u][v] = e
            in_e[v][u] = e
        return sg

    # ---- queries ----------------------------------------------------------
    def sources(self):
        return [v for v in self.seqs if not self.in_edges[v]]

    def sinks(self):
        return [v for v in self.seqs if not self.out_edges[v]]

    def is_source(self, v):
        return not self.in_edges[v]

    def is_sink(self, v):
        return not self.out_edges[v]

    def ref_source(self):
        for v in self.seqs:
            if any(e.is_ref for e in self.out_edges[v].values()) and \
                    not any(e.is_ref for e in self.in_edges[v].values()):
                return v
        if len(self.seqs) == 1:
            # a ref-only graph zips to one edgeless vertex: it is both the
            # reference source and sink (single-haplotype degenerate case)
            return next(iter(self.seqs))
        return None

    def ref_sink(self):
        for v in self.seqs:
            if any(e.is_ref for e in self.in_edges[v].values()) and \
                    not any(e.is_ref for e in self.out_edges[v].values()):
                return v
        if len(self.seqs) == 1:
            return next(iter(self.seqs))
        return None

    def to_dot(self, name: str = "seqGraph") -> str:
        """DOT dump of the simplified graph (base_graph.rs:505
        print_graph role: vertex = sequence, edge label = multiplicity,
        reference edges red)."""
        lines = [f'digraph "{name}" {{']
        for v, seq in sorted(self.seqs.items()):
            label = seq.decode("ascii", "replace")
            if len(label) > 25:
                label = label[:11] + "..." + label[-11:]
            lines.append(f'  v{v} [label="{label}"];')
        for u in sorted(self.out_edges):
            for v, e in sorted(self.out_edges[u].items()):
                color = ' color=red' if e.is_ref else ""
                lines.append(
                    f'  v{u} -> v{v} [label="{e.multiplicity}"{color}];')
        lines.append("}")
        return "\n".join(lines) + "\n"

    def all_path_seqs(self, limit: int = 10000) -> set:
        """All source->sink path sequences (testing the invariant)."""
        out = set()
        stack = [(s, self.seqs[s]) for s in self.sources()]
        while stack and len(out) < limit:
            v, seq = stack.pop()
            if self.is_sink(v):
                out.add(seq)
                continue
            for t in self.out_edges[v]:
                stack.append((t, seq + self.seqs[t]))
        return out

    # ---- zip linear chains (seq_graph.rs:189) ------------------------------
    def zip_linear_chains(self) -> bool:
        did = False
        changed = True
        while changed:
            changed = False
            for v in list(self.seqs):
                if v not in self.seqs:
                    continue
                outs = self.out_edges[v]
                if len(outs) != 1:
                    continue
                t = next(iter(outs))
                if t == v or len(self.in_edges[t]) != 1:
                    continue
                # merge t into v
                self.seqs[v] = self.seqs[v] + self.seqs[t]
                edge_vt = outs[t]
                for t2, e in list(self.out_edges[t].items()):
                    del self.in_edges[t2][t]
                    self.add_edge(v, t2, e.multiplicity, e.is_ref)
                del self.out_edges[v][t]
                del self.in_edges[t][v], self.out_edges[t], \
                    self.in_edges[t], self.seqs[t]
                del edge_vt
                did = changed = True
        return did

    # ---- shared prefix/suffix extraction ----------------------------------
    @staticmethod
    def _common_prefix(seqs):
        if not seqs:
            return b""
        n = min(len(s) for s in seqs)
        out = 0
        for i in range(n):
            if len({s[i] for s in seqs}) == 1:
                out += 1
            else:
                break
        return seqs[0][:out]

    @staticmethod
    def _common_suffix(seqs, reserve: int = 0):
        """Longest common suffix of seqs with `reserve` leading bytes held
        back (so prefix+suffix never overlaps the shortest sequence)."""
        if not seqs:
            return b""
        n = min(len(s) - reserve for s in seqs)
        if n <= 0:
            return b""
        out = 0
        for i in range(1, n + 1):
            if len({s[-i] for s in seqs}) == 1:
                out = i
            else:
                break
        return seqs[0][len(seqs[0]) - out:]

    def _split_middles(self, middles, top, bottom,
                       require_min_common: bool) -> bool:
        """Rewire top -> middles -> bottom into
        top -> prefix -> cores -> suffix -> bottom.  Returns False when no
        common affix exists (vertex_based_transformer.rs MergeDiamonds /
        MergeTails via shared_vertex_sequence_splitter.rs)."""
        seqs = [self.seqs[m] for m in middles]
        prefix = self._common_prefix(seqs)
        suffix = self._common_suffix(seqs, reserve=len(prefix))
        if not prefix and not suffix:
            return False
        if require_min_common and len(prefix) + len(suffix) \
                < MIN_COMMON_TO_MERGE_SOURCE_SINK:
            return False

        cores = {m: self.seqs[m][len(prefix):len(self.seqs[m]) - len(suffix)]
                 for m in middles}
        pre_v = self.add_vertex(prefix)
        # a suffix vertex is also required (possibly empty-sequence) when a
        # middle IS the shared prefix/suffix: its path must survive as
        # prefix -> suffix (shared_vertex_sequence_splitter.rs always
        # materializes both; dropping the empty core loses a haplotype)
        suf_v = self.add_vertex(suffix) if (
            bottom is not None or suffix
            or any(not c for c in cores.values())) else None
        total_mult = 0
        any_ref_in = any_ref_out = False
        for m in middles:
            e_in = self.in_edges[m].get(top)
            e_out = (self.out_edges[m].get(bottom)
                     if bottom is not None else None)
            mult = e_in.multiplicity if e_in else 0
            total_mult += mult
            any_ref_in |= bool(e_in and e_in.is_ref)
            any_ref_out |= bool(e_out and e_out.is_ref)
            core = cores[m]
            out_mult = e_out.multiplicity if e_out else mult
            out_ref = e_out.is_ref if e_out else bool(e_in and e_in.is_ref)
            in_ref = bool(e_in and e_in.is_ref)
            if core:
                core_v = self.add_vertex(core)
                self.add_edge(pre_v, core_v, mult, in_ref)
                if suf_v is not None:
                    self.add_edge(core_v, suf_v, out_mult, out_ref)
                elif bottom is None:
                    pass                       # tail: core is a sink
            else:
                if suf_v is not None:
                    self.add_edge(pre_v, suf_v, mult, in_ref or out_ref)
            self.remove_vertex(m)
        if top is not None:
            self.add_edge(top, pre_v, total_mult, any_ref_in)
        if bottom is not None and suf_v is not None:
            self.add_edge(suf_v, bottom, total_mult, any_ref_out)
        return True

    # ---- the four transformers --------------------------------------------
    def merge_diamonds_once(self) -> bool:
        for v in list(self.seqs):
            if v not in self.seqs:
                continue
            middles = list(self.out_edges[v])
            if len(middles) <= 1:
                continue
            bottom = None
            ok = True
            for m in middles:
                if len(self.in_edges[m]) != 1 or not self.out_edges[m]:
                    ok = False
                    break
                for t in self.out_edges[m]:
                    if bottom is None:
                        bottom = t
                    elif bottom != t:
                        ok = False
                        break
                if not ok:
                    break
            if not ok or bottom is None or bottom == v:
                continue
            if len(self.in_edges[bottom]) != len(middles):
                continue
            # diamonds need any common affix (min 1); the 10-base guard is
            # only for merges that touch sources/sinks (MergeTails)
            if self._split_middles(middles, v, bottom, False):
                return True
        return False

    def merge_tails_once(self) -> bool:
        for v in list(self.seqs):
            if v not in self.seqs:
                continue
            middles = list(self.out_edges[v])
            if len(middles) <= 1:
                continue
            if not all(self.is_sink(m) and len(self.in_edges[m]) == 1
                       for m in middles):
                continue
            if self._split_middles(middles, v, None, True):
                return True
        return False

    def split_common_suffixes_once(self, already_split: set) -> bool:
        for z in list(self.seqs):
            if z not in self.seqs or z in already_split:
                continue
            preds = list(self.in_edges[z])
            if len(preds) <= 1:
                continue
            if not all(len(self.out_edges[p]) == 1 and z in self.out_edges[p]
                       and p != z for p in preds):
                continue
            suffix = self._common_suffix([self.seqs[p] for p in preds],
                                         reserve=1)
            if not suffix:
                continue
            suf_v = self.add_vertex(suffix)
            total = 0
            any_ref = False
            for p in preds:
                e = self.out_edges[p].pop(z)
                del self.in_edges[z][p]
                total += e.multiplicity
                any_ref |= e.is_ref
                self.seqs[p] = self.seqs[p][:len(self.seqs[p]) - len(suffix)]
                self.add_edge(p, suf_v, e.multiplicity, e.is_ref)
            self.add_edge(suf_v, z, total, any_ref)
            already_split.add(z)
            already_split.add(suf_v)
            return True
        return False

    def merge_common_suffixes_once(self) -> bool:
        """x+S -> y becomes x -> S+y when all of y's predecessors share
        suffix S and have no other outgoing edges
        (shared_sequence_merger.rs)."""
        for y in list(self.seqs):
            if y not in self.seqs:
                continue
            preds = list(self.in_edges[y])
            if len(preds) <= 1:
                continue
            if not all(len(self.out_edges[p]) == 1 and p != y for p in preds):
                continue
            if any(self.is_source(p) for p in preds):
                continue
            suffix = self._common_suffix([self.seqs[p] for p in preds],
                                         reserve=1)
            if not suffix:
                continue
            for p in preds:
                self.seqs[p] = self.seqs[p][:len(self.seqs[p]) - len(suffix)]
            self.seqs[y] = suffix + self.seqs[y]
            return True
        return False

    def simplify(self):
        """seq_graph.rs:46-96 simplify_graph loop."""
        self.zip_linear_chains()
        for _ in range(MAX_SIMPLIFY_CYCLES):
            did = False
            while self.merge_diamonds_once():
                did = True
            while self.merge_tails_once():
                did = True
            already = set()
            while self.split_common_suffixes_once(already):
                did = True
            while self.merge_common_suffixes_once():
                did = True
            did |= self.zip_linear_chains()
            if not did:
                break
        return self


def find_best_haplotypes_seq(sg: SeqGraph, max_paths: int = 128):
    """K-best ref-source -> ref-sink paths over a sequence graph; returns
    [(score, bases)].  Delegates to the shared k_best_paths search so the
    scoring/cap/cycle rules have a single home (graph.py)."""
    from lorikeet_tpu_torch.assembly.graph import k_best_paths
    return [(score, bases) for score, _, bases in k_best_paths(
        sg.ref_source(), sg.ref_sink(),
        lambda v: sg.out_edges[v],
        lambda path: b"".join(sg.seqs[v] for v in path),
        max_paths)]
