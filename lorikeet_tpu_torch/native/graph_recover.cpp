// Dangling-end recovery inside the native graph builder.
//
// graph_build.cpp threads, flushes, cycle-checks and prunes a region's
// kmer graph, and zips it into the sequence graph only when dangling-end
// recovery cannot change it.  This file adds the recovery itself, so that
// the recovered graph is zipped here too and no kmer graph has to be
// rebuilt as Python objects.  The steps, their order and their arithmetic
// are assembly/graph.py ReadThreadingGraph.recover_dangling_ends
// (_recover_tail, _recover_head, _walk_back, _matching_suffix), the
// conformance spec; the alignments run on sw.cpp's sw_align, the one the
// Python path calls.  Both sources are included whole: the Builder and
// try_zip come from graph_build.cpp unchanged.
#include "graph_build.cpp"
#include "sw.cpp"

#include <memory>
#include <optional>

namespace {

// smith_waterman.py STANDARD_NGS and OverhangStrategy.LEADING_INDEL
constexpr int32_t kSwMatch = 25, kSwMismatch = -50, kSwOpen = -110,
                  kSwExtend = -6;
// graph.py MAX_CIGAR_COMPLEXITY
constexpr size_t kMaxCigarComplexity = 3;

struct CigarElem { char op; int64_t len; };

// sw_align's codes: 0=M 1=I 2=D 4=S (smith_waterman.py _CIGAR_OPS)
char cigar_op(uint32_t code) {
    static const char kOps[] = "MIDNSHP=X";
    return kOps[code & 0xF];
}

template <class KO>
struct Recovery {
    Builder<KO>& b;
    const int min_len, min_matching;
    const bool recover_all;
    // live in-edges per vertex in creation order (the Python in_edges
    // dicts' order), as the Builder keeps its out-edges
    std::vector<int32_t> in_head, in_tail;
    std::vector<typename Builder<KO>::AdjNode> in_pool;
    std::vector<int32_t> ind, outd;           // live degrees
    std::vector<uint8_t> ref_set;
    std::vector<int32_t> ref_pos;             // first index on ref_path
    std::vector<int32_t> mark;                // walk membership stamps
    int32_t stamp = 0;
    // kmers of the vertices a head extension makes (stable addresses)
    std::vector<std::unique_ptr<uint8_t[]>> new_kmers;
    bool failed = false;                      // no faithful answer here

    Recovery(Builder<KO>& b_, int min_len_, int min_matching_,
             bool recover_all_)
        : b(b_), min_len(min_len_), min_matching(min_matching_),
          recover_all(recover_all_) {
        const int64_t n = (int64_t)b.vertex_kmer.size();
        in_head.assign(n, -1);
        in_tail.assign(n, -1);
        ind.assign(n, 0);
        outd.assign(n, 0);
        ref_set.assign(n, 0);
        ref_pos.assign(n, -1);
        mark.assign(n, 0);
        for (size_t ei = 0; ei < b.edges.size(); ei++) {
            if (b.removed[ei]) continue;
            in_append(b.edges[ei].v, (int32_t)ei);
            outd[b.edges[ei].u]++;
            ind[b.edges[ei].v]++;
        }
        for (size_t i = 0; i < b.ref_path.size(); i++) {
            const int32_t v = b.ref_path[i];
            ref_set[v] = 1;
            if (ref_pos[v] < 0) ref_pos[v] = (int32_t)i;
        }
    }

    int64_t n_vertices() const { return (int64_t)b.vertex_kmer.size(); }
    uint8_t last(int32_t v) const { return b.vertex_kmer[v][b.k - 1]; }

    void in_append(int32_t v, int32_t ei) {
        const int32_t node = (int32_t)in_pool.size();
        in_pool.push_back({ei, -1});
        if (in_head[v] < 0)
            in_head[v] = node;
        else
            in_pool[in_tail[v]].next = node;
        in_tail[v] = node;
    }

    // the live edge u->v, or -1
    int32_t find_edge(int32_t u, int32_t v) const {
        for (int32_t it = b.adj_head[u]; it >= 0; it = b.adj_pool[it].next) {
            const int32_t ei = b.adj_pool[it].ei;
            if (!b.removed[ei] && b.edges[ei].v == v) return ei;
        }
        return -1;
    }

    // graph.py _edge for a pair without an edge: a new non-ref edge whose
    // creation multiplicity is `mult`
    void add_edge(int32_t u, int32_t v, int32_t mult) {
        const int32_t ei = (int32_t)b.edges.size();
        b.edges.push_back({u, v, mult, 0});
        b.removed.push_back(0);
        b.adj_append(u, ei);
        in_append(v, ei);
        outd[u]++;
        ind[v]++;
    }

    void remove_edge(int32_t ei) {
        b.removed[ei] = 1;
        outd[b.edges[ei].u]--;
        ind[b.edges[ei].v]--;
    }

    int32_t new_vertex(const uint8_t* kmer) {
        new_kmers.emplace_back(new uint8_t[b.k]);
        std::memcpy(new_kmers.back().get(), kmer, b.k);
        const int32_t vid = (int32_t)b.vertex_kmer.size();
        b.vertex_kmer.push_back(new_kmers.back().get());
        b.adj_head.push_back(-1);
        b.adj_tail.push_back(-1);
        in_head.push_back(-1);
        in_tail.push_back(-1);
        ind.push_back(0);
        outd.push_back(0);
        ref_set.push_back(0);
        ref_pos.push_back(-1);
        mark.push_back(0);
        return vid;
    }

    // the one live neighbour, or under recover_all the first of the
    // highest multiplicity (Python's max over the dict), along in-edges
    // (`back`) or out-edges
    int32_t step(int32_t cur, bool back) const {
        int32_t best = -1, best_mult = 0;
        const int32_t head = back ? in_head[cur] : b.adj_head[cur];
        for (int32_t it = head; it >= 0;
             it = back ? in_pool[it].next : b.adj_pool[it].next) {
            const int32_t ei = back ? in_pool[it].ei : b.adj_pool[it].ei;
            if (b.removed[ei]) continue;
            const EdgeRec& e = b.edges[ei];
            if (best < 0 || e.mult > best_mult) {
                best = back ? e.u : e.v;
                best_mult = e.mult;
            }
        }
        return best;
    }

    // graph.py _walk_back: the chain from a dangling vertex to a
    // reference or branching vertex, dangling end first
    void walk(int32_t vertex, bool back, std::vector<int32_t>& path) {
        path.assign(1, vertex);
        mark[vertex] = ++stamp;
        int32_t cur = vertex;
        const size_t limit = (size_t)n_vertices() + 1;
        while (path.size() < limit) {
            const int deg = back ? ind[cur] : outd[cur];
            if (deg != 1 && !(recover_all && deg > 0)) break;
            const int32_t nxt = step(cur, back);
            if (mark[nxt] == stamp) break;
            path.push_back(nxt);
            mark[nxt] = stamp;
            cur = nxt;
            if (ref_set[nxt]) break;
            if ((back ? outd[nxt] : ind[nxt]) > 1 && !recover_all) break;
        }
    }

    // align(ref, alt, STANDARD_NGS, LEADING_INDEL), then the trailing
    // deletion stripped; false where sw_align fails (Python raises there)
    bool align(const std::vector<uint8_t>& ref,
               const std::vector<uint8_t>& alt,
               std::vector<CigarElem>& cigar) {
        const int32_t cap = (int32_t)(ref.size() + alt.size() + 4);
        std::vector<uint32_t> codes(cap);
        int32_t n = 0, offset = 0;
        if (sw_align(ref.data(), (int32_t)ref.size(), alt.data(),
                     (int32_t)alt.size(), kSwMatch, kSwMismatch, kSwOpen,
                     kSwExtend, LEADING_INDEL, codes.data(), cap, &n,
                     &offset) != 0) {
            failed = true;
            return false;
        }
        cigar.clear();
        for (int32_t i = 0; i < n; i++)
            cigar.push_back({cigar_op(codes[i]), (int64_t)(codes[i] >> 4)});
        if (!cigar.empty() && cigar.back().op == 'D') cigar.pop_back();
        return true;
    }

    static int64_t ref_span(const std::vector<CigarElem>& cigar) {
        int64_t n = 0;
        for (const CigarElem& c : cigar)
            if (c.op == 'M' || c.op == 'D') n += c.len;
        return n;
    }

    // graph.py _recover_tail; true when it added an edge
    bool recover_tail(int32_t sink, std::vector<int32_t>& path) {
        walk(sink, true, path);
        if (path.size() < 2 || !ref_set[path.back()]) return false;
        const std::vector<int32_t> fwd(path.rbegin(), path.rend());
        if ((int64_t)fwd.size() - 1 < min_len) return false;
        const int32_t ref_idx = ref_pos[fwd.front()];
        const int64_t n_ref = (int64_t)b.ref_path.size() - ref_idx;
        // one base per vertex from the shared branch base on
        std::vector<uint8_t> dangling(fwd.size()), ref(n_ref);
        for (size_t i = 0; i < fwd.size(); i++) dangling[i] = last(fwd[i]);
        for (int64_t i = 0; i < n_ref; i++)
            ref[i] = last(b.ref_path[ref_idx + i]);
        std::vector<CigarElem> cigar;
        if (!align(ref, dangling, cigar)) return false;
        if (cigar.empty() || cigar.size() > kMaxCigarComplexity
            || cigar.back().op != 'M')
            return false;
        // _matching_suffix
        const int64_t last_ref_index = ref_span(cigar) - 1;
        int64_t lsm = 0;
        for (int64_t i = last_ref_index, j = (int64_t)dangling.size() - 1;
             i >= 0 && j >= 0 && ref[i] == dangling[j]; i--, j--)
            lsm++;
        const int64_t matching = std::min(lsm, cigar.back().len);
        if (min_matching >= 0 ? matching < min_matching : matching == 0)
            return false;
        // merge indices
        int64_t read_len = 0;
        for (const CigarElem& c : cigar)
            if (c.op == 'M' || c.op == 'I' || c.op == 'S' || c.op == '='
                || c.op == 'X')
                read_len += c.len;
        const int64_t alt_index = std::max<int64_t>(read_len - matching - 1,
                                                    0);
        const bool leading_del = cigar.front().op == 'D'
            && cigar.front().len + matching == last_ref_index + 1;
        const int64_t ref_index = last_ref_index - matching + 1
            + (leading_del ? 1 : 0);
        if (ref_index <= 0 || ref_index >= n_ref
            || alt_index >= (int64_t)fwd.size())
            return false;
        const int32_t join_dang = fwd[alt_index];
        const int32_t join_ref = b.ref_path[ref_idx + ref_index];
        if (find_edge(join_dang, join_ref) >= 0) return false;
        add_edge(join_dang, join_ref, 1);
        return true;
    }

    // graph.py _recover_head; true when it added the merging edge
    bool recover_head(int32_t source, std::vector<int32_t>& path) {
        walk(source, false, path);
        if (path.size() < 2 || !ref_set[path.back()]) return false;
        if ((int64_t)path.size() - 1 < min_len) return false;
        const int k = b.k;
        const int32_t ref_idx = ref_pos[path.back()];
        // _seq_of(path) and _seq_of(ref_path[:ref_idx + 1]), reversed
        std::vector<uint8_t> dangling(b.vertex_kmer[path[0]],
                                      b.vertex_kmer[path[0]] + k);
        for (size_t i = 1; i < path.size(); i++)
            dangling.push_back(last(path[i]));
        std::reverse(dangling.begin(), dangling.end());
        const int32_t* rpath = b.ref_path.data();
        std::vector<uint8_t> ref(b.vertex_kmer[rpath[0]],
                                 b.vertex_kmer[rpath[0]] + k);
        for (int32_t i = 1; i <= ref_idx; i++) ref.push_back(last(rpath[i]));
        std::reverse(ref.begin(), ref.end());
        std::vector<CigarElem> cigar;
        if (!align(ref, dangling, cigar)) return false;
        if (cigar.empty() || cigar.size() > kMaxCigarComplexity
            || cigar.front().op != 'M')
            return false;
        const int64_t n = (int64_t)std::min(ref.size(), dangling.size());
        int64_t idx, ref_merge;
        if (min_matching < 0) {
            // legacy: the last mismatch within the leading M run, at most
            // max(1, leading M // k) of them, and one at least
            const int64_t max_mm = std::max<int64_t>(1, cigar[0].len / k);
            const int64_t limit = std::min(cigar[0].len, n);
            int64_t mism = 0, last_mm = -1;
            for (int64_t i = 0; i < limit; i++)
                if (ref[i] != dangling[i]) {
                    mism++;
                    last_mm = i;
                }
            if (mism == 0 || mism > max_mm) return false;
            idx = ref_merge = last_mm;
        } else {
            // walk from the source end counting matches; merge at the
            // first mismatch met
            int64_t ref_i = ref_span(cigar) - 1;
            int64_t read_i = (int64_t)dangling.size() - 1;
            for (auto c = cigar.rbegin(); c != cigar.rend(); ++c) {
                if (c->op != 'M' && c->op != '=' && c->op != 'X') break;
                bool stop = false;
                for (int64_t s = 0; s < c->len; s++) {
                    if (ref_i >= (int64_t)ref.size()
                        || ref[ref_i] != dangling[read_i]) {
                        stop = true;
                        break;
                    }
                    ref_i--;
                    read_i--;
                    if (ref_i < 0 || read_i < 0) {
                        stop = true;
                        break;
                    }
                }
                if (stop) break;
            }
            const int64_t matches = (int64_t)dangling.size() - 1 - read_i;
            if (matches < min_matching || read_i <= 0 || ref_i <= 0)
                return false;
            idx = read_i;
            ref_merge = ref_i;
        }
        // branch-first reference and dangling vertices
        const std::vector<int32_t> rp(b.ref_path.rend() - (ref_idx + 1),
                                      b.ref_path.rend());
        std::vector<int32_t> dp(path.rbegin(), path.rend());
        if (ref_merge >= (int64_t)rp.size() - 1) return false;
        if (idx >= (int64_t)dp.size()) {
            // the merge lands inside the source kmer: new vertices that
            // borrow reference bases replace the source
            // (extend_dangling_path_against_reference)
            int64_t off = 0;
            for (const CigarElem& c : cigar)
                off += (c.op == 'M' || c.op == 'D' ? c.len : 0)
                    - (c.op == 'M' || c.op == 'I' ? c.len : 0);
            const int64_t num = idx - (int64_t)dp.size() + 2;
            const int64_t ref_node = (int64_t)dp.size() - 1 + off + num;
            if (ref_node < 0 || ref_node >= (int64_t)rp.size()) return false;
            if (num > k) {             // idx < k + len(dp) - 1 rules it out
                failed = true;
                return false;
            }
            std::vector<uint8_t> ext(b.vertex_kmer[rp[ref_node]],
                                     b.vertex_kmer[rp[ref_node]] + num);
            ext.insert(ext.end(), b.vertex_kmer[source],
                       b.vertex_kmer[source] + k);
            // unlink the source from the successor the walk followed
            const int32_t succ = dp[dp.size() - 2];
            const int32_t old = find_edge(source, succ);
            const int32_t old_mult = b.edges[old].mult;
            remove_edge(old);
            dp.pop_back();
            int32_t prev = succ;
            for (int64_t i = num; i >= 1; i--) {
                const int32_t nv = new_vertex(ext.data() + i);
                add_edge(nv, prev, old_mult);
                dp.push_back(nv);
                prev = nv;
            }
        }
        const int32_t join_ref = rp[ref_merge + 1];
        const int32_t join_dang = dp[idx];
        if (find_edge(join_ref, join_dang) >= 0) return false;
        add_edge(join_ref, join_dang, 1);
        return true;
    }

    // graph.py recover_dangling_ends: tails over the non-ref sinks in
    // vertex order, then heads over the non-ref sources; true when an
    // edge was added
    bool run() {
        bool added = false;
        std::vector<int32_t> path;
        std::vector<int32_t> ends;
        for (int32_t v = 0; v < (int32_t)n_vertices(); v++)
            if (!outd[v] && ind[v] && !ref_set[v]) ends.push_back(v);
        for (const int32_t sink : ends) {
            added |= recover_tail(sink, path);
            if (failed) return added;
        }
        ends.clear();
        for (int32_t v = 0; v < (int32_t)n_vertices(); v++)
            if (!ind[v] && outd[v] && !ref_set[v]) ends.push_back(v);
        for (const int32_t source : ends) {
            added |= recover_head(source, path);
            if (failed) return added;
        }
        return added;
    }

    // graph.py has_cycle over the live edges (Kahn)
    bool has_cycle() const {
        const int64_t n = n_vertices();
        std::vector<int32_t> indeg(ind);
        std::vector<int32_t> stack;
        for (int64_t v = 0; v < n; v++)
            if (!indeg[v]) stack.push_back((int32_t)v);
        int64_t seen = 0;
        while (!stack.empty()) {
            const int32_t v = stack.back();
            stack.pop_back();
            seen++;
            for (int32_t it = b.adj_head[v]; it >= 0;
                 it = b.adj_pool[it].next) {
                const int32_t ei = b.adj_pool[it].ei;
                if (!b.removed[ei] && !--indeg[b.edges[ei].v])
                    stack.push_back(b.edges[ei].v);
            }
        }
        return seen != n;
    }
};

// graph_build3's threading, flushes, cycle check and pruning, then the
// dangling-end recovery and the zip.  out_counts = {ref_path_len,
// has_cycle, n_nonuniq, n_map, zipped, cyclic_after_recovery}: a graph
// cyclic before recovery or after it, or without a reference path, comes
// back as these gates alone (zipped 0), any other zipped.  Returns 0, or 1
// where Python has to build the graph another way (too many pruning
// samples, a capacity overflow).
template <class KO>
int run_recover(
    const uint8_t* seq_buf, const int64_t* seq_off, const int32_t* counts,
    const uint8_t* is_ref, const int32_t* sample_ids, int64_t n_seqs, int k,
    int num_pruning_samples, int prune_factor, int start_only_at_existing,
    int recovery_on, int min_dangling_branch_length, int min_matching_bases,
    int recover_all, int64_t* out_counts,
    uint8_t* zseq, int64_t* zv_bounds, int32_t* ze_u, int32_t* ze_v,
    int32_t* ze_mult, uint8_t* ze_ref, int64_t cap_z, int64_t* zcounts) {
    if (num_pruning_samples > kKeptInline) return 1;
    Builder<KO> b(k);
    b.buf = seq_buf;
    b.nps = num_pruning_samples > 0 ? num_pruning_samples : 1;
    b.start_only_at_existing = start_only_at_existing != 0;
    b.find_non_unique(seq_off, n_seqs);
    b.kmer_to_vertex.reserve(2048);
    for (int64_t s = 0; s < n_seqs; s++) {
        if (s > 0 && sample_ids[s] != sample_ids[s - 1]) b.flush_sample();
        b.thread(seq_buf + seq_off[s], seq_off[s + 1] - seq_off[s],
                 counts[s], is_ref[s] != 0);
    }
    b.flush_sample();

    const bool cycle = b.has_cycle();
    b.index_in_edges();
    if (!cycle) b.prune_low_weight_chains(prune_factor);

    out_counts[0] = (int64_t)b.ref_path.size();
    out_counts[1] = cycle ? 1 : 0;
    out_counts[2] = (int64_t)b.non_unique.size();
    out_counts[3] = (int64_t)b.kmer_to_vertex.size();
    out_counts[4] = 0;
    out_counts[5] = 0;
    if (cycle || b.ref_path.empty()) return 0;
    // outlives the zip, which reads the new vertices' kmers
    std::optional<Recovery<KO>> r;
    if (recovery_on) {
        r.emplace(b, min_dangling_branch_length, min_matching_bases,
                  recover_all != 0);
        const bool added = r->run();
        if (r->failed) return 1;
        if (added && r->has_cycle()) {
            out_counts[5] = 1;
            return 0;
        }
        // the zip reads the in-edges as a CSR: index the recovered edges
        // too, keeping the tombstones
        const std::vector<uint8_t> removed(b.removed);
        b.index_in_edges();
        b.removed = removed;
    }
    if (!try_zip(b, false, cap_z, zseq, zv_bounds, ze_u, ze_v, ze_mult,
                 ze_ref, zcounts))
        return 1;
    out_counts[4] = 1;
    return 0;
}

}  // namespace

// Thread, flush, cycle-check and prune as graph_build3 does, then recover
// the dangling ends (when recovery_on) and zip the seq graph: see
// run_recover.  zcounts = {n_seq_vertices, n_seq_edges, seq_bytes}.
extern "C" int graph_build_recover(
    const uint8_t* seq_buf, const int64_t* seq_off, const int32_t* counts,
    const uint8_t* is_ref, const int32_t* sample_ids, int64_t n_seqs, int k,
    int num_pruning_samples, int prune_factor, int start_only_at_existing,
    int recovery_on, int min_dangling_branch_length, int min_matching_bases,
    int recover_all, int64_t* out_counts,
    uint8_t* zseq, int64_t* zv_bounds, int32_t* ze_u, int32_t* ze_v,
    int32_t* ze_mult, uint8_t* ze_ref, int64_t cap_z, int64_t* zcounts) {
    if (k <= 64 && all_packable(seq_buf, seq_off[n_seqs]))
        return run_recover<PackKey>(
            seq_buf, seq_off, counts, is_ref, sample_ids, n_seqs, k,
            num_pruning_samples, prune_factor, start_only_at_existing,
            recovery_on, min_dangling_branch_length, min_matching_bases,
            recover_all, out_counts, zseq, zv_bounds, ze_u, ze_v, ze_mult,
            ze_ref, cap_z, zcounts);
    return run_recover<SvKey>(
        seq_buf, seq_off, counts, is_ref, sample_ids, n_seqs, k,
        num_pruning_samples, prune_factor, start_only_at_existing,
        recovery_on, min_dangling_branch_length, min_matching_bases,
        recover_all, out_counts, zseq, zv_bounds, ze_u, ze_v, ze_mult,
        ze_ref, cap_z, zcounts);
}
