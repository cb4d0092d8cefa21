// Read-threading graph construction — native host kernel.
//
// Exact semantics of assembly/graph.py::ReadThreadingGraph.build (the
// conformance spec), which mirrors the reference's threading algorithm
// (reference/src/read_threading/read_threading_graph.rs:111-140
// non-unique kmer detection, :484-660 threading: reads start at their first
// unique kmer, chains extend by suffix match, unique kmers merge through the
// kmer->vertex map).  Sequences must arrive reference-first, in thread
// order; the caller reconstructs its edge objects from the returned arrays.
//
// Kmer identity is templated: ACGT/acgt sequences with k <= 64 use packed
// 2-bit rolling keys (unsigned __int128) — one shift+or per position
// instead of hashing k bytes — with a byte-string fallback for any other
// alphabet or k.  Both instantiations share every line of graph logic.
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <algorithm>

namespace {

// top num_pruning_samples per-sample counts live INLINE: one heap vector
// per edge measured ~30-40% of the whole build (tens of thousands of tiny
// mallocs/frees per region).  nps > kKeptInline falls back to the Python
// path (no production config goes near it; reference default is 1).
constexpr int kKeptInline = 8;

struct EdgeRec {
    int32_t u, v;
    int32_t mult;
    uint8_t is_ref;
    int8_t kept_n = 0;             // valid entries in kept_arr (sorted desc)
    int32_t cur = 0;               // multiplicity within the current sample
    int32_t born = 0;              // flush counter at creation
    int32_t flushed = 0;           // flushes in which this edge was touched
    int32_t kept_arr[kKeptInline];
};

// ---- kmer key strategies --------------------------------------------------

// ---- open-addressing containers for packed keys ---------------------------
// libstdc++'s node-based unordered_{map,set} cost one allocation plus a
// pointer chase per kmer and dominate the build profile.  Packed keys are
// masked to 2k bits, so for k <= 63 the all-ones 128-bit value is
// impossible and serves as the empty sentinel; the k == 64 all-T corner
// is held in a dedicated side slot.  Linear probing at <= 50% load.

template <class HashT>
struct FlatMap128 {
    using K = unsigned __int128;
    static constexpr K kEmpty = ~(K)0;
    std::vector<K> keys;
    std::vector<int32_t> vals;
    size_t mask_ = 0;
    size_t count_ = 0;
    bool has_empty = false;
    int32_t empty_val = 0;
    HashT h;
    FlatMap128() { reserve(128); }
    size_t size() const { return count_ + (has_empty ? 1 : 0); }
    void reserve(size_t expect) {
        if (count_ || has_empty) return;      // only re-inits an empty map
        size_t cap = 64;
        while (cap < 2 * expect + 2) cap <<= 1;
        keys.assign(cap, kEmpty);
        vals.resize(cap);
        mask_ = cap - 1;
    }
    void grow() {
        std::vector<K> ok;
        std::vector<int32_t> ov;
        ok.swap(keys);
        ov.swap(vals);
        keys.assign(ok.size() * 2, kEmpty);
        vals.resize(ov.size() * 2);
        mask_ = keys.size() - 1;
        for (size_t j = 0; j < ok.size(); j++) {
            if (ok[j] == kEmpty) continue;
            size_t i = h(ok[j]) & mask_;
            while (keys[i] != kEmpty) i = (i + 1) & mask_;
            keys[i] = ok[j];
            vals[i] = ov[j];
        }
    }
    int32_t* find(K key) {
        if (key == kEmpty) return has_empty ? &empty_val : nullptr;
        size_t i = h(key) & mask_;
        while (true) {
            if (keys[i] == key) return &vals[i];
            if (keys[i] == kEmpty) return nullptr;
            i = (i + 1) & mask_;
        }
    }
    bool try_emplace(K key, int32_t val) {        // true when inserted
        if (key == kEmpty) {
            if (has_empty) return false;
            has_empty = true;
            empty_val = val;
            return true;
        }
        if ((count_ + 1) * 2 >= keys.size()) grow();
        size_t i = h(key) & mask_;
        while (true) {
            if (keys[i] == key) return false;
            if (keys[i] == kEmpty) {
                keys[i] = key;
                vals[i] = val;
                count_++;
                return true;
            }
            i = (i + 1) & mask_;
        }
    }
};

template <class HashT>
struct FlatEpochSet128 {
    // per-sequence "seen" set: next_epoch() replaces clear() (stale keys
    // keep their slots but read as absent; capacity covers the TOTAL kmer
    // count so stale occupancy never exceeds 50% load)
    using K = unsigned __int128;
    static constexpr K kEmpty = ~(K)0;
    std::vector<K> keys;
    std::vector<int32_t> ep;
    size_t mask_ = 0;
    size_t count_ = 0;
    int32_t cur = 0;
    bool has_empty = false;
    int32_t empty_ep = -1;
    HashT h;
    FlatEpochSet128() { reserve(512); }
    void reserve(size_t expect) {
        if (count_ || has_empty) return;
        size_t cap = 64;
        while (cap < 2 * expect + 2) cap <<= 1;
        keys.assign(cap, kEmpty);
        ep.resize(cap);
        mask_ = cap - 1;
        cur = 0;
    }
    void grow() {
        std::vector<K> ok;
        std::vector<int32_t> oe;
        ok.swap(keys);
        oe.swap(ep);
        keys.assign(ok.size() * 2, kEmpty);
        ep.resize(oe.size() * 2);
        mask_ = keys.size() - 1;
        for (size_t j = 0; j < ok.size(); j++) {
            if (ok[j] == kEmpty) continue;
            size_t i = h(ok[j]) & mask_;
            while (keys[i] != kEmpty) i = (i + 1) & mask_;
            keys[i] = ok[j];
            ep[i] = oe[j];
        }
    }
    void next_epoch() { cur++; }
    bool insert(K key) {          // true when first seen THIS epoch
        if (key == kEmpty) {
            if (has_empty && empty_ep == cur) return false;
            has_empty = true;
            empty_ep = cur;
            return true;
        }
        if ((count_ + 1) * 2 >= keys.size()) grow();
        size_t i = h(key) & mask_;
        while (true) {
            if (keys[i] == key) {
                if (ep[i] == cur) return false;
                ep[i] = cur;
                return true;
            }
            if (keys[i] == kEmpty) {
                keys[i] = key;
                ep[i] = cur;
                count_++;
                return true;
            }
            i = (i + 1) & mask_;
        }
    }
};

template <class K, class HashT>
struct StdMapAdapter {
    std::unordered_map<K, int32_t, HashT> m;
    void reserve(size_t n) { m.reserve(n); }
    size_t size() const { return m.size(); }
    int32_t* find(const K& k) {
        auto it = m.find(k);
        return it == m.end() ? nullptr : &it->second;
    }
    bool try_emplace(const K& k, int32_t v) {
        return m.try_emplace(k, v).second;
    }
};

template <class K, class HashT>
struct StdEpochSetAdapter {
    std::unordered_set<K, HashT> s;
    void reserve(size_t n) { s.reserve(n); }
    void next_epoch() { s.clear(); }
    bool insert(const K& k) { return s.insert(k).second; }
};

struct SvKey {
    using key_t = std::string_view;
    struct Hash {
        size_t operator()(key_t v) const {
            return std::hash<std::string_view>{}(v);
        }
    };
    int k;
    explicit SvKey(int k_) : k(k_) {}
    key_t make(const uint8_t* p) const {
        return key_t(reinterpret_cast<const char*>(p), (size_t)k);
    }
    key_t roll(key_t, const uint8_t* next_start) const {
        return make(next_start);   // no cheaper-than-make roll for bytes
    }
    template <class H> using map_t = StdMapAdapter<key_t, H>;
    template <class H> using eset_t = StdEpochSetAdapter<key_t, H>;
};

extern int8_t kBaseCode[256];

struct PackKey {
    using key_t = unsigned __int128;
    struct Hash {
        size_t operator()(key_t v) const {
            uint64_t x = (uint64_t)v ^ (uint64_t)(v >> 64) * 0x9e3779b97f4a7c15ULL;
            x ^= x >> 30;
            x *= 0xbf58476d1ce4e5b9ULL;
            x ^= x >> 27;
            x *= 0x94d049bb133111ebULL;
            return (size_t)(x ^ (x >> 31));
        }
    };
    int k;
    key_t mask;
    explicit PackKey(int k_) : k(k_) {
        mask = (k_ >= 64) ? ~(key_t)0
                          : (((key_t)1 << (2 * k_)) - 1);
    }
    key_t make(const uint8_t* p) const {
        key_t v = 0;
        for (int i = 0; i < k; ++i) v = (v << 2) | (key_t)kBaseCode[p[i]];
        return v;
    }
    key_t roll(key_t prev, const uint8_t* next_start) const {
        // key for the window STARTING at next_start, given the key of the
        // window one byte earlier: shift in the new last base
        return ((prev << 2) | (key_t)kBaseCode[next_start[k - 1]]) & mask;
    }
    template <class H> using map_t = FlatMap128<H>;
    template <class H> using eset_t = FlatEpochSet128<H>;
};

int8_t kBaseCode[256];
struct BaseCodeInit {
    BaseCodeInit() {
        std::memset(kBaseCode, -1, 256);
        kBaseCode['A'] = 0; kBaseCode['C'] = 1;
        kBaseCode['G'] = 2; kBaseCode['T'] = 3;
        kBaseCode['a'] = 0; kBaseCode['c'] = 1;
        kBaseCode['g'] = 2; kBaseCode['t'] = 3;
    }
} kBaseCodeInit;

bool all_packable(const uint8_t* buf, int64_t n) {
    for (int64_t i = 0; i < n; ++i)
        if (kBaseCode[buf[i]] < 0) return false;
    return true;
}

// ---- graph construction (shared logic, templated on the key strategy) -----------

template <class KO>
struct Builder {
    using key_t = typename KO::key_t;
    using Hash = typename KO::Hash;
    int k;
    KO ko;
    const uint8_t* buf;
    typename KO::template map_t<Hash> kmer_to_vertex;
    typename KO::template map_t<Hash> non_unique;      // value unused (set)
    std::vector<const uint8_t*> vertex_kmer;       // ptr into buf
    // pooled append-order adjacency (edge-creation order per vertex —
    // extend()'s suffix-match scan depends on it): one alloc-free linked
    // pool instead of a heap vector per vertex
    std::vector<int32_t> adj_head, adj_tail;       // per vertex, -1 = none
    struct AdjNode { int32_t ei, next; };
    std::vector<AdjNode> adj_pool;
    std::vector<EdgeRec> edges;
    std::vector<int32_t> ref_path;

    explicit Builder(int k_) : k(k_), ko(k_) {}

    void adj_append(int32_t u, int32_t ei) {
        const int32_t node = (int32_t)adj_pool.size();
        adj_pool.push_back({ei, -1});
        if (adj_head[u] < 0)
            adj_head[u] = node;
        else
            adj_pool[adj_tail[u]].next = node;
        adj_tail[u] = node;
    }

    int32_t new_vertex(const uint8_t* kp, key_t key) {
        const int32_t vid = (int32_t)vertex_kmer.size();
        vertex_kmer.push_back(kp);
        adj_head.push_back(-1);
        adj_tail.push_back(-1);
        if (!non_unique.find(key))
            kmer_to_vertex.try_emplace(key, vid);  // no-op if already mapped
        return vid;
    }

    int32_t get_or_new(const uint8_t* kp, key_t key) {
        const int32_t* it = kmer_to_vertex.find(key);
        if (it) return *it;
        return new_vertex(kp, key);
    }

    int32_t edge(int32_t u, int32_t v, bool is_ref) {
        for (int32_t it = adj_head[u]; it >= 0; it = adj_pool[it].next) {
            const int32_t ei = adj_pool[it].ei;
            if (edges[ei].v == v) {
                if (is_ref) edges[ei].is_ref = 1;
                return ei;
            }
        }
        const int32_t ei = (int32_t)edges.size();
        edges.push_back({u, v, 0, (uint8_t)(is_ref ? 1 : 0)});
        adj_append(u, ei);
        return ei;
    }

    std::vector<int32_t> touched;  // edges hit within the current sample
    int nps = 1;

    int flush_count = 0;

    void bump(int32_t ei, int32_t count) {
        EdgeRec& e = edges[ei];
        if (e.kept_n == 0 && e.mult == 0 && e.cur == 0) {
            // the creation multiplicity seeds the per-sample heap as its
            // own entry (MultiSampleEdge::set, multi_sample_edge.rs:57-67)
            e.kept_arr[0] = count;
            e.kept_n = 1;
            e.born = flush_count;
        }
        e.mult += count;
        if (e.cur == 0) touched.push_back(ei);
        e.cur += count;
    }

    // roll per-sample multiplicities at a sample boundary
    // (multi_sample_edge.rs flush_single_sample_multiplicity; untouched
    // edges' zero-flushes are accounted lazily in pruning_mult)
    void flush_sample() {
        for (const int32_t ei : touched) {
            EdgeRec& e = edges[ei];
            // sorted-desc insert of e.cur, capped at nps entries
            int pos = e.kept_n;
            while (pos > 0 && e.kept_arr[pos - 1] < e.cur) pos--;
            const int upto = std::min<int>(e.kept_n, nps - 1);
            for (int j = upto; j > pos; j--) e.kept_arr[j] = e.kept_arr[j - 1];
            if (pos < nps) e.kept_arr[pos] = e.cur;
            if (e.kept_n < nps) e.kept_n++;
            e.cur = 0;
            e.flushed++;
        }
        touched.clear();
        flush_count++;
    }

    // heap minimum of {seed} + per-sample totals, where samples that never
    // touched the edge flushed a 0 (multi_sample_edge.rs
    // get_pruning_multiplicity peeks the capped min-heap)
    int32_t pruning_mult(const EdgeRec& e) const {
        if ((int)e.kept_n >= nps) return e.kept_arr[nps - 1];
        // fewer positive values than capacity: a zero-flush survives if any
        const int zero_flushes = (flush_count - e.born) - e.flushed;
        if (zero_flushes > 0) return 0;
        return e.kept_n == 0 ? 0 : e.kept_arr[e.kept_n - 1];
    }

    int32_t extend(int32_t prev, const uint8_t* seq, int64_t kmer_start,
                   key_t key, int32_t count, bool is_ref) {
        const uint8_t next_base = seq[kmer_start + k - 1];
        for (int32_t it = adj_head[prev]; it >= 0; it = adj_pool[it].next) {
            const int32_t ei = adj_pool[it].ei;
            EdgeRec& e = edges[ei];
            if (vertex_kmer[e.v][k - 1] == next_base) {
                bump(ei, count);
                if (is_ref) e.is_ref = 1;
                return e.v;
            }
        }
        const int32_t vid = get_or_new(seq + kmer_start, key);
        const int32_t ei = edge(prev, vid, is_ref);
        bump(ei, count);
        return vid;
    }

    // reads start at their first unique kmer (GATK default when dangling
    // recovery is on: read_threading_graph.rs:239-248 is_threading_start
    // with start_threading_only_at_existing_vertex=false) — unknown start
    // kmers create new dangling-head chains that recovery can merge back
    bool start_only_at_existing = true;

    void thread(const uint8_t* seq, int64_t len, int32_t count, bool is_ref) {
        if (len < k + 1) return;
        int64_t start = 0;
        key_t key = ko.make(seq);
        if (!is_ref) {
            start = -1;
            key_t probe = key;
            for (int64_t i = 0; i < len - k; i++) {
                if (i > 0) probe = ko.roll(probe, seq + i);
                const bool ok = start_only_at_existing
                    ? kmer_to_vertex.find(probe) != nullptr
                    : non_unique.find(probe) == nullptr;
                if (ok) { start = i; key = probe; break; }
            }
            if (start < 0) return;
        }
        if (len <= start + k) return;
        int32_t vid = get_or_new(seq + start, key);
        if (is_ref) { ref_path.clear(); ref_path.push_back(vid); }
        for (int64_t i = start + 1; i <= len - k; i++) {
            key = ko.roll(key, seq + i);
            vid = extend(vid, seq, i, key, count, is_ref);
            if (is_ref) ref_path.push_back(vid);
        }
    }

    // per-sequence non-unique kmers, unioned (determine_non_unique_kmers)
    void find_non_unique(const int64_t* seq_off, int64_t n_seqs) {
        typename KO::template eset_t<Hash> seen;
        seen.reserve((size_t)(seq_off[n_seqs] - seq_off[0]) / 8 + 64);
        for (int64_t s = 0; s < n_seqs; s++) {
            const uint8_t* seq = buf + seq_off[s];
            const int64_t len = seq_off[s + 1] - seq_off[s];
            seen.next_epoch();
            key_t key{};
            for (int64_t i = 0; i + k <= len; i++) {
                key = (i == 0) ? ko.make(seq) : ko.roll(key, seq + i);
                if (!seen.insert(key)) non_unique.try_emplace(key, 0);
            }
        }
    }

    std::vector<uint8_t> removed;          // per-edge tombstones
    // CSR in-edges (built once post-threading): in_lst[in_off[v]..in_off[v+1])
    std::vector<int64_t> in_off;
    std::vector<int32_t> in_lst;

    void index_in_edges() {
        const int64_t n = (int64_t)vertex_kmer.size();
        removed.assign(edges.size(), 0);
        in_off.assign(n + 1, 0);
        for (const EdgeRec& e : edges) in_off[e.v + 1]++;
        for (int64_t v = 0; v < n; v++) in_off[v + 1] += in_off[v];
        in_lst.resize(edges.size());
        std::vector<int64_t> cur(in_off.begin(), in_off.end() - 1);
        for (size_t ei = 0; ei < edges.size(); ei++)
            in_lst[cur[edges[ei].v]++] = (int32_t)ei;
    }

    int in_deg(int32_t v) const {
        int d = 0;
        for (int64_t i = in_off[v]; i < in_off[v + 1]; i++)
            d += !removed[in_lst[i]];
        return d;
    }
    int out_deg(int32_t v) const {
        int d = 0;
        for (int32_t it = adj_head[v]; it >= 0; it = adj_pool[it].next)
            d += !removed[adj_pool[it].ei];
        return d;
    }

    // Kahn peel (graph.py has_cycle)
    bool has_cycle() const {
        const int64_t n = (int64_t)vertex_kmer.size();
        std::vector<int32_t> indeg(n, 0);
        for (const EdgeRec& e : edges) indeg[e.v]++;
        std::vector<int32_t> stack;
        for (int64_t v = 0; v < n; v++)
            if (!indeg[v]) stack.push_back((int32_t)v);
        int64_t seen = 0;
        while (!stack.empty()) {
            const int32_t v = stack.back();
            stack.pop_back();
            seen++;
            for (int32_t it = adj_head[v]; it >= 0; it = adj_pool[it].next)
                if (!--indeg[edges[adj_pool[it].ei].v])
                    stack.push_back(edges[adj_pool[it].ei].v);
        }
        return seen != n;
    }

    // linear chains + low-weight pruning + orphan removal
    // (chain_pruner.rs:58-121, low_weight_chain_pruner.rs,
    //  graph.py prune_low_weight_chains/_remove_orphans)
    void prune_low_weight_chains(int prune_factor) {
        if (prune_factor <= 0) return;
        const int64_t n = (int64_t)vertex_kmer.size();
        std::vector<int32_t> chain_starts;
        std::vector<uint8_t> seen(n, 0);
        for (int64_t v = 0; v < n; v++)
            if (in_deg((int32_t)v) == 0) {
                chain_starts.push_back((int32_t)v);
                seen[v] = 1;
            }
        // phase 1: enumerate all chains on the unpruned graph (python
        // find_chains computes the full chain list before any removal)
        std::vector<std::vector<int32_t>> chains;
        for (size_t qi = 0; qi < chain_starts.size(); qi++) {
            const int32_t first = chain_starts[qi];
            for (int32_t it0 = adj_head[first]; it0 >= 0;
                 it0 = adj_pool[it0].next) {
                const int32_t ei0 = adj_pool[it0].ei;
                std::vector<int32_t> chain{ei0};
                int32_t last = edges[ei0].v;
                while (out_deg(last) == 1 && in_deg(last) <= 1
                       && last != first) {
                    const int32_t nxt = adj_pool[adj_head[last]].ei;
                    chain.push_back(nxt);
                    last = edges[nxt].v;
                }
                chains.push_back(std::move(chain));
                if (!seen[last]) {
                    seen[last] = 1;
                    chain_starts.push_back(last);
                }
            }
        }
        // phase 2: prune chains whose every edge is non-ref and low-weight
        for (const auto& chain : chains) {
            bool all_low = true;
            for (const int32_t ei : chain)
                if (edges[ei].is_ref
                    || pruning_mult(edges[ei]) >= prune_factor) {
                    all_low = false;
                    break;
                }
            if (all_low)
                for (const int32_t ei : chain) removed[ei] = 1;
        }
    }
};

// Speculative seq-graph zip (graph.py remove_paths_not_connected_to_ref +
// seq_graph.py from_kmer_graph fused): only legal when no dangling-end
// recovery can change the graph afterwards.  Writes the zipped seq graph
// (vertex byte spans + inter-chain edges) and returns true, or returns
// false when it doesn't apply (dangling ends present with recovery on,
// capacity exceeded) — the caller then falls back to the full kmer-graph
// handover.
template <class KO>
bool try_zip(Builder<KO>& b, bool recovery_on, int64_t cap_z, uint8_t* zseq,
             int64_t* zv_bounds, int32_t* ze_u, int32_t* ze_v,
             int32_t* ze_mult, uint8_t* ze_ref, int64_t* zcounts) {
    const int64_t n = (int64_t)b.vertex_kmer.size();
    if (b.ref_path.empty() || n == 0) return false;
    std::vector<uint8_t> ref_set(n, 0);
    for (const int32_t v : b.ref_path) ref_set[v] = 1;
    // degrees over surviving (non-tombstoned) edges
    std::vector<int32_t> ind(n, 0), outd(n, 0);
    for (size_t ei = 0; ei < b.edges.size(); ei++) {
        if (b.removed[ei]) continue;
        outd[b.edges[ei].u]++;
        ind[b.edges[ei].v]++;
    }
    if (recovery_on) {
        // graph.py recover_dangling_ends candidates: non-ref sinks/sources
        for (int64_t v = 0; v < n; v++) {
            if (ref_set[v]) continue;
            if ((outd[v] == 0 && ind[v] > 0) || (ind[v] == 0 && outd[v] > 0))
                return false;
        }
    }
    // remove_paths_not_connected_to_ref: an edge survives iff both
    // endpoints are forward-reachable from ref_source AND backward-
    // reachable from ref_sink (python removes all edges of bad vertices)
    std::vector<uint8_t> fwd(n, 0), bwd(n, 0);
    std::vector<int32_t> stack;
    fwd[b.ref_path.front()] = 1;
    stack.push_back(b.ref_path.front());
    while (!stack.empty()) {
        const int32_t v = stack.back();
        stack.pop_back();
        for (int32_t it = b.adj_head[v]; it >= 0; it = b.adj_pool[it].next) {
            const int32_t ei = b.adj_pool[it].ei;
            if (!b.removed[ei] && !fwd[b.edges[ei].v]) {
                fwd[b.edges[ei].v] = 1;
                stack.push_back(b.edges[ei].v);
            }
        }
    }
    bwd[b.ref_path.back()] = 1;
    stack.push_back(b.ref_path.back());
    while (!stack.empty()) {
        const int32_t v = stack.back();
        stack.pop_back();
        for (int64_t i = b.in_off[v]; i < b.in_off[v + 1]; i++) {
            const int32_t ei = b.in_lst[i];
            if (!b.removed[ei] && !bwd[b.edges[ei].u]) {
                bwd[b.edges[ei].u] = 1;
                stack.push_back(b.edges[ei].u);
            }
        }
    }
    std::vector<uint8_t> live_edge(b.edges.size(), 0);
    for (size_t ei = 0; ei < b.edges.size(); ei++) {
        if (b.removed[ei]) continue;
        const EdgeRec& e = b.edges[ei];
        live_edge[ei] = fwd[e.u] && bwd[e.u] && fwd[e.v] && bwd[e.v];
    }
    std::fill(ind.begin(), ind.end(), 0);
    std::fill(outd.begin(), outd.end(), 0);
    std::vector<int32_t> only_in(n, -1), only_out(n, -1);
    for (size_t ei = 0; ei < b.edges.size(); ei++) {
        if (!live_edge[ei]) continue;
        const EdgeRec& e = b.edges[ei];
        outd[e.u]++;
        ind[e.v]++;
        only_out[e.u] = (int32_t)ei;     // valid only when outd == 1
        only_in[e.v] = (int32_t)ei;
    }
    // chain starts (seq_graph.py from_kmer_graph is_start rule)
    std::vector<uint8_t> is_start(n, 0);
    for (int64_t v = 0; v < n; v++) {
        if (!outd[v] && !ind[v]) continue;   // not live
        if (ind[v] != 1) {
            is_start[v] = 1;
        } else {
            const int32_t p = b.edges[only_in[v]].u;
            if (outd[p] != 1 || p == v) is_start[v] = 1;
        }
    }
    const int k = b.k;
    int64_t nsv = 0, nse = 0, so = 0;
    std::vector<int32_t> vmap(n, -1);
    std::vector<int32_t> tails;
    // pass 1: walk chains in vertex order, emit sequences + vmap
    for (int64_t v = 0; v < n; v++) {
        if (!is_start[v] || (!outd[v] && !ind[v])) continue;
        const bool head_is_source = ind[v] == 0;
        const int64_t need = head_is_source ? k : 1;
        if (so + need > cap_z) return false;
        if (head_is_source) {
            std::memcpy(zseq + so, b.vertex_kmer[v], k);
            so += k;
        } else {
            zseq[so++] = b.vertex_kmer[v][k - 1];
        }
        vmap[v] = (int32_t)nsv;
        int32_t cur = (int32_t)v;
        while (outd[cur] == 1) {
            const int32_t t = b.edges[only_out[cur]].v;
            if (is_start[t] || t == (int32_t)v) break;
            if (so + 1 > cap_z) return false;
            zseq[so++] = b.vertex_kmer[t][k - 1];
            vmap[t] = (int32_t)nsv;
            cur = t;
        }
        tails.push_back(cur);
        if (nsv + 1 >= cap_z) return false;
        zv_bounds[++nsv] = so;
    }
    zv_bounds[0] = 0;
    // pass 2: inter-chain edges in (chain, creation) order
    for (const int32_t tail : tails) {
        for (int32_t it = b.adj_head[tail]; it >= 0;
             it = b.adj_pool[it].next) {
            const int32_t ei = b.adj_pool[it].ei;
            if (!live_edge[ei]) continue;
            if (nse >= cap_z) return false;
            const EdgeRec& e = b.edges[ei];
            ze_u[nse] = vmap[tail];
            ze_v[nse] = vmap[e.v];
            ze_mult[nse] = e.mult;
            ze_ref[nse] = e.is_ref;
            nse++;
        }
    }
    zcounts[0] = nsv;
    zcounts[1] = nse;
    zcounts[2] = so;
    return true;
}

template <class KO>
int run_build3(
    const uint8_t* seq_buf, const int64_t* seq_off, const int32_t* counts,
    const uint8_t* is_ref, const int32_t* sample_ids, int64_t n_seqs, int k,
    int num_pruning_samples, int prune_factor, int start_only_at_existing,
    int allow_zip, int recovery_on,
    int64_t* vertex_kmer_off, int32_t* edge_u, int32_t* edge_v,
    int32_t* edge_mult, uint8_t* edge_is_ref, int32_t* edge_pm,
    int32_t* ref_path, int64_t cap, int64_t* out_counts,
    uint8_t* zseq, int64_t* zv_bounds, int32_t* ze_u, int32_t* ze_v,
    int32_t* ze_mult, uint8_t* ze_ref, int64_t cap_z, int64_t* zcounts) {
    if (num_pruning_samples > kKeptInline) return 1;  // python fallback
    Builder<KO> b(k);
    b.buf = seq_buf;
    b.nps = num_pruning_samples > 0 ? num_pruning_samples : 1;
    b.start_only_at_existing = start_only_at_existing != 0;
    b.find_non_unique(seq_off, n_seqs);
    b.kmer_to_vertex.reserve(2048);   // ~distinct kmers; growth handles big regions
    for (int64_t s = 0; s < n_seqs; s++) {
        if (s > 0 && sample_ids[s] != sample_ids[s - 1]) b.flush_sample();
        b.thread(seq_buf + seq_off[s], seq_off[s + 1] - seq_off[s],
                 counts[s], is_ref[s] != 0);
    }
    b.flush_sample();

    const bool cycle = b.has_cycle();
    b.index_in_edges();
    if (!cycle) b.prune_low_weight_chains(prune_factor);

    const int64_t nv = (int64_t)b.vertex_kmer.size();
    const int64_t nr = (int64_t)b.ref_path.size();
    if (nv > cap || (int64_t)b.edges.size() > cap || nr > cap) return 1;
    out_counts[0] = nv;
    out_counts[2] = nr;
    out_counts[3] = cycle ? 1 : 0;
    out_counts[4] = (int64_t)b.non_unique.size();
    out_counts[5] = (int64_t)b.kmer_to_vertex.size();
    out_counts[6] = 0;
    for (int64_t i = 0; i < nr; i++) ref_path[i] = b.ref_path[i];

    if (allow_zip && !cycle &&
        try_zip(b, recovery_on != 0, cap_z, zseq, zv_bounds, ze_u, ze_v,
                ze_mult, ze_ref, zcounts)) {
        // zip succeeded: Python only needs the gates + the seq graph
        out_counts[1] = 0;
        out_counts[6] = 1;
        return 0;
    }

    for (int64_t i = 0; i < nv; i++)
        vertex_kmer_off[i] = b.vertex_kmer[i] - seq_buf;
    int64_t ne = 0;
    for (size_t ei = 0; ei < b.edges.size(); ei++) {
        if (b.removed[ei]) continue;
        const EdgeRec& e = b.edges[ei];
        edge_u[ne] = e.u;
        edge_v[ne] = e.v;
        edge_mult[ne] = e.mult;
        edge_is_ref[ne] = e.is_ref;
        edge_pm[ne] = b.pruning_mult(e);
        ne++;
    }
    out_counts[1] = ne;
    return 0;
}

}  // namespace

// Returns 0 on success.  Outputs are caller-allocated; capacities must be
// >= the total kmer-position count (a safe upper bound for vertices, edges
// and the ref path alike).  out_counts = {n_vertices, n_edges, ref_path_len}.
extern "C" int graph_build(
    const uint8_t* seq_buf, const int64_t* seq_off, const int32_t* counts,
    const uint8_t* is_ref, int64_t n_seqs, int k,
    int64_t* vertex_kmer_off, int32_t* edge_u, int32_t* edge_v,
    int32_t* edge_mult, uint8_t* edge_is_ref, int32_t* ref_path,
    int64_t cap, int64_t* out_counts) {
    Builder<SvKey> b(k);
    b.buf = seq_buf;
    b.find_non_unique(seq_off, n_seqs);
    b.kmer_to_vertex.reserve(2048);   // ~distinct kmers; growth handles big regions
    for (int64_t s = 0; s < n_seqs; s++)
        b.thread(seq_buf + seq_off[s], seq_off[s + 1] - seq_off[s],
                 counts[s], is_ref[s] != 0);

    const int64_t nv = (int64_t)b.vertex_kmer.size();
    const int64_t ne = (int64_t)b.edges.size();
    const int64_t nr = (int64_t)b.ref_path.size();
    if (nv > cap || ne > cap || nr > cap) return 1;
    for (int64_t i = 0; i < nv; i++)
        vertex_kmer_off[i] = b.vertex_kmer[i] - seq_buf;
    for (int64_t i = 0; i < ne; i++) {
        edge_u[i] = b.edges[i].u;
        edge_v[i] = b.edges[i].v;
        edge_mult[i] = b.edges[i].mult;
        edge_is_ref[i] = b.edges[i].is_ref;
    }
    for (int64_t i = 0; i < nr; i++) ref_path[i] = b.ref_path[i];
    out_counts[0] = nv;
    out_counts[1] = ne;
    out_counts[2] = nr;
    return 0;
}

// Extended entry point: per-sample pruning multiplicities (sequences must arrive
// sample-grouped; `sample_ids` marks the grouping), Kahn cycle detection,
// and — when acyclic and prune_factor > 0 — low-weight chain pruning with
// orphan removal, all before any Python objects exist.
// out_counts = {n_vertices, n_edges, ref_path_len, has_cycle}.
extern "C" int graph_build2(
    const uint8_t* seq_buf, const int64_t* seq_off, const int32_t* counts,
    const uint8_t* is_ref, const int32_t* sample_ids, int64_t n_seqs, int k,
    int num_pruning_samples, int prune_factor, int start_only_at_existing,
    int64_t* vertex_kmer_off, int32_t* edge_u, int32_t* edge_v,
    int32_t* edge_mult, uint8_t* edge_is_ref, int32_t* edge_pm,
    int32_t* ref_path, int64_t cap, int64_t* out_counts) {
    int64_t out7[7];
    int64_t zcounts[3];
    const int rc = run_build3<SvKey>(
        seq_buf, seq_off, counts, is_ref, sample_ids, n_seqs, k,
        num_pruning_samples, prune_factor, start_only_at_existing,
        /*allow_zip=*/0, /*recovery_on=*/1,
        vertex_kmer_off, edge_u, edge_v, edge_mult, edge_is_ref, edge_pm,
        ref_path, cap, out7, nullptr, nullptr, nullptr, nullptr, nullptr,
        nullptr, 0, zcounts);
    if (rc != 0) return rc;
    for (int i = 0; i < 6; i++) out_counts[i] = out7[i];
    return 0;
}

// graph_build2 + speculative seq-graph zip: when the pruned graph is
// acyclic and dangling-end recovery cannot apply (no non-ref dangling
// sinks/sources, or recovery disabled), the reachability filter
// (remove_paths_not_connected_to_ref) and the kmer->seq chain zip run here
// and the kmer graph is never handed to Python at all.
// out_counts adds [6]=zip_done, and zcounts = {n_seq_vertices, n_seq_edges,
// seq_bytes} describes the zip outputs when zip_done.
extern "C" int graph_build3(
    const uint8_t* seq_buf, const int64_t* seq_off, const int32_t* counts,
    const uint8_t* is_ref, const int32_t* sample_ids, int64_t n_seqs, int k,
    int num_pruning_samples, int prune_factor, int start_only_at_existing,
    int allow_zip, int recovery_on,
    int64_t* vertex_kmer_off, int32_t* edge_u, int32_t* edge_v,
    int32_t* edge_mult, uint8_t* edge_is_ref, int32_t* edge_pm,
    int32_t* ref_path, int64_t cap, int64_t* out_counts,
    uint8_t* zseq, int64_t* zv_bounds, int32_t* ze_u, int32_t* ze_v,
    int32_t* ze_mult, uint8_t* ze_ref, int64_t cap_z, int64_t* zcounts) {
    const int64_t total = seq_off[n_seqs];
    if (k <= 64 && all_packable(seq_buf, total))
        return run_build3<PackKey>(
            seq_buf, seq_off, counts, is_ref, sample_ids, n_seqs, k,
            num_pruning_samples, prune_factor, start_only_at_existing,
            allow_zip, recovery_on, vertex_kmer_off, edge_u, edge_v,
            edge_mult, edge_is_ref, edge_pm, ref_path, cap, out_counts,
            zseq, zv_bounds, ze_u, ze_v, ze_mult, ze_ref, cap_z, zcounts);
    return run_build3<SvKey>(
        seq_buf, seq_off, counts, is_ref, sample_ids, n_seqs, k,
        num_pruning_samples, prune_factor, start_only_at_existing,
        allow_zip, recovery_on, vertex_kmer_off, edge_u, edge_v, edge_mult,
        edge_is_ref, edge_pm, ref_path, cap, out_counts, zseq, zv_bounds,
        ze_u, ze_v, ze_mult, ze_ref, cap_z, zcounts);
}
