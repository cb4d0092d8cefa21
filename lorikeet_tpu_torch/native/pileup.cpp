// Ref-vs-any pileup accumulation — native host kernel.
//
// Exact semantics of models/activity.py::accumulate_read (the conformance
// spec), which mirrors the reference's parse_record pileup walk
// (reference/src/haplotype/haplotype_caller_engine.rs:754-899) and its
// soft-clip/indel adjacency + HQ-soft-clip counting (:1584-1687):
//   - per aligned base (or deletion cell at qual 30) with qual >= bq,
//     accumulate the (qual, is_alt) GL table row and depth counters;
//   - is_alt = base mismatch vs reference, or adjacency to an S/I/D cigar
//     element;
//   - when an alt base is adjacent to a softclip specifically, add the
//     read's high-quality soft-clip count to the position's running average.
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

const uint8_t HQ_SC_QUAL = 28;  // HQ_BASE_QUALITY_SOFTCLIP_THRESHOLD

struct ReadView {
    const uint8_t* seq;
    const uint8_t* qual;
    const uint8_t* ops;
    const int32_t* lens;
    int n_ops;
    int len;
    int64_t pos;
};

void adjacency(const ReadView& r, bool sc_only, std::vector<uint8_t>& adj) {
    adj.assign(r.len, 0);
    int cursor = 0;
    for (int k = 0; k < r.n_ops; k++) {
        const uint8_t op = r.ops[k];
        const int n = r.lens[k];
        const bool trigger = sc_only ? (op == 'S')
                                     : (op == 'S' || op == 'I' || op == 'D');
        if (trigger) {
            if (cursor - 1 >= 0) adj[cursor - 1] = 1;
            const int after = cursor + ((op == 'S' || op == 'I') ? n : 0);
            if (after < r.len) adj[after] = 1;
        }
        if (op == 'M' || op == 'I' || op == 'S' || op == '=' || op == 'X')
            cursor += n;
    }
    // read position 0 is never adjacent (the reference scan's
    // past_query_pos break, haplotype_caller_engine.rs:1596-1650)
    if (r.len > 0) adj[0] = 0;
}

double count_hq_softclips(const ReadView& r) {
    double n_hq = 0.0;
    int cursor = 0;
    for (int k = 0; k < r.n_ops; k++) {
        const uint8_t op = r.ops[k];
        const int n = r.lens[k];
        if (op == 'S') {
            for (int j = 0; j < n; j++)
                if (r.qual[cursor + j] > HQ_SC_QUAL) n_hq += 1.0;
            cursor += n;
        } else if (op == 'M' || op == 'I' || op == '=' || op == 'X') {
            cursor += n;
        }
    }
    return n_hq;
}

}  // namespace

// table: [256, 2, n_gl] f64 GL contribution per (qual, is_alt) — one row
// per possible u8 qual.
// Outputs accumulated in place: gl [L, n_gl], read_counts/ref_depth/
// nonref_depth [L] i32, hq_sc_sum [L] f64, hq_sc_n [L] i32.
extern "C" void pileup_accumulate(
    const uint8_t* seq_buf, const uint8_t* qual_buf,
    const int64_t* read_off, const int32_t* read_len,
    const uint8_t* cigar_ops, const int32_t* cigar_lens,
    const int64_t* cigar_off, const int32_t* cigar_cnt,
    const int64_t* pos, int64_t n_reads,
    const uint8_t* ref_seq, int64_t chunk_start, int64_t chunk_end,
    int bq, const double* table, int n_gl,
    double* gl, int32_t* read_counts, int32_t* ref_depth,
    int32_t* nonref_depth, double* hq_sc_sum, int32_t* hq_sc_n) {
    std::vector<uint8_t> adj, sc_adj;
    struct SCEvent { int64_t p; int qpos; };
    std::vector<SCEvent> sc_events;

    for (int64_t r = 0; r < n_reads; r++) {
        ReadView rv{seq_buf + read_off[r], qual_buf + read_off[r],
                    cigar_ops + cigar_off[r], cigar_lens + cigar_off[r],
                    cigar_cnt[r], read_len[r], pos[r]};
        adjacency(rv, false, adj);
        sc_events.clear();
        int64_t p = rv.pos;
        int rc = 0;

        auto update = [&](int64_t idx, int q, int is_alt) {
            const double* row = table + ((std::size_t)q * 2 + is_alt) * n_gl;
            double* cell = gl + (std::size_t)idx * n_gl;
            for (int g = 0; g < n_gl; g++) cell[g] += row[g];
            read_counts[idx]++;
            if (is_alt) nonref_depth[idx]++; else ref_depth[idx]++;
        };

        for (int k = 0; k < rv.n_ops; k++) {
            const uint8_t op = rv.ops[k];
            const int n = rv.lens[k];
            if (op == 'D') {
                int64_t lo = chunk_start - p; if (lo < 0) lo = 0;
                int64_t hi = chunk_end - p; if (hi > n) hi = n;
                // a deletion neighbouring a soft clip counts HQ soft clips
                // at every cell (qpos None arm)
                const bool d_sc = (k > 0 && rv.ops[k - 1] == 'S')
                    || (k + 1 < rv.n_ops && rv.ops[k + 1] == 'S');
                for (int64_t j = lo; j < hi; j++) {
                    update(p + j - chunk_start, 30, 1);
                    if (d_sc) sc_events.push_back({p + j - chunk_start, -1});
                }
                p += n;
            } else if (op == 'I') {
                if (chunk_start <= p && p < chunk_end) {
                    const int q = rv.qual[rc];
                    if (q >= bq) {
                        const int64_t idx = p - chunk_start;
                        const int is_alt =
                            rv.seq[rc] != ref_seq[idx] || adj[rc];
                        update(idx, q, is_alt);
                        if (is_alt && adj[rc])
                            sc_events.push_back({idx, rc});
                    }
                }
                rc += n;
            } else if (op == 'M' || op == '=' || op == 'X') {
                int64_t lo = chunk_start - p; if (lo < 0) lo = 0;
                int64_t hi = chunk_end - p; if (hi > n) hi = n;
                for (int64_t j = lo; j < hi; j++) {
                    const int q = rv.qual[rc + j];
                    if (q < bq) continue;
                    const int64_t idx = p + j - chunk_start;
                    const int qpos = rc + (int)j;
                    const int is_alt =
                        rv.seq[qpos] != ref_seq[idx] || adj[qpos];
                    update(idx, q, is_alt);
                    if (is_alt && adj[qpos]) sc_events.push_back({idx, qpos});
                }
                rc += n;
                p += n;
            } else if (op == 'S') {
                rc += n;
            }
            // H and P are ignored
        }

        if (!sc_events.empty()) {
            adjacency(rv, true, sc_adj);
            double n_hq = -1.0;
            for (const auto& ev : sc_events) {
                if (ev.qpos >= 0 && !sc_adj[ev.qpos]) continue;
                if (n_hq < 0.0) n_hq = count_hq_softclips(rv);
                hq_sc_sum[ev.p] += n_hq;
                hq_sc_n[ev.p]++;
            }
        }
    }
}
