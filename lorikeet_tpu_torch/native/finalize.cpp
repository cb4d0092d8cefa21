// Columnar region finalization — native host kernel.
//
// Exact semantics of calling/clipping.py::finalize_region_reads (the
// conformance spec; fuzz-tested against it), which mirrors the reference's
// finalize_regions pipeline
// (reference/src/assembly/assembly_based_caller_utils.rs:97-186):
// revert-or-drop soft clips, hard-clip low-quality tails, adaptor clipping,
// clip to the padded region span, drop empties, then the overlapping
// mate-pair base-quality correction
// (reference/src/utils/fragment_utils.rs:27-149).
//
// One call finalizes a whole region's read set from the BAM's columnar
// buffers: no BamRecord objects, no per-read numpy, no intermediate copies.
// Outputs are (original index, new pos, kept query range, new cigar,
// adjusted quals); the caller materializes records once from these.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

constexpr int64_t I64_MAX = INT64_MAX;
constexpr uint8_t HALF_PCR_SNV_QUAL = 20;  // phred(1e-4)/2, fragment_utils.rs:9-14

inline bool consumes_query(uint8_t op) {
    return op == 'M' || op == 'I' || op == 'S' || op == '=' || op == 'X';
}
inline bool consumes_ref(uint8_t op) {
    return op == 'M' || op == 'D' || op == 'N' || op == '=' || op == 'X';
}
inline bool is_dn(uint8_t op) { return op == 'D' || op == 'N'; }

struct Op {
    uint8_t op;
    int32_t n;
};

// Mutable per-read clipping state: cigar + position + kept query subrange
// [klo, khi) of the ORIGINAL read (all clip ops keep contiguous ranges).
struct Rec {
    std::vector<Op> cig;
    int64_t pos = 0;
    int32_t klo = 0, khi = 0;        // original-query coords
    const uint8_t* seq0;             // original read base pointer
    const uint8_t* qual0;            // original read qual pointer

    int32_t len() const { return khi - klo; }
    int64_t ref_len() const {
        int64_t r = 0;
        for (const Op& o : cig)
            if (consumes_ref(o.op)) r += o.n;
        return r;
    }
    int64_t ref_end() const { return pos + ref_len(); }
    bool empty() const { return khi <= klo || cig.empty(); }
};

void merge_adjacent(std::vector<Op>& c) {
    size_t w = 0;
    for (size_t i = 0; i < c.size(); ++i) {
        if (w && c[w - 1].op == c[i].op)
            c[w - 1].n += c[i].n;
        else
            c[w++] = c[i];
    }
    c.resize(w);
}

// clipping.py clip_by_read_indices: keep CURRENT query bases [lo, hi).
void clip_by_read_indices(Rec& r, int64_t lo, int64_t hi) {
    const int64_t L = r.len();
    lo = std::max<int64_t>(0, lo);
    hi = std::min<int64_t>(L, hi);
    if (lo >= hi) {
        r.cig.clear();
        r.khi = r.klo;
        return;
    }
    std::vector<Op> nc;
    nc.reserve(r.cig.size());
    int64_t q = 0, rr = r.pos;
    int64_t new_pos = I64_MAX;           // sentinel: unset
    for (const Op& o : r.cig) {
        const bool cq = consumes_query(o.op), cr = consumes_ref(o.op);
        if (cq) {
            const int64_t l = std::max(q, lo), h = std::min(q + o.n, hi);
            if (h > l) {
                nc.push_back({o.op, (int32_t)(h - l)});
                if (cr && new_pos == I64_MAX) new_pos = rr + (l - q);
            }
            q += o.n;
            if (cr) rr += o.n;
        } else if (cr) {                 // D/N: keep only when interior
            if (lo < q && q < hi) nc.push_back(o);
            rr += o.n;
        }
        // H/P dropped
    }
    size_t b = 0, e = nc.size();
    while (b < e && is_dn(nc[b].op)) {
        if (new_pos != I64_MAX) new_pos += nc[b].n;
        ++b;
    }
    while (e > b && is_dn(nc[e - 1].op)) --e;
    nc = std::vector<Op>(nc.begin() + b, nc.begin() + e);
    merge_adjacent(nc);
    r.cig = std::move(nc);
    if (new_pos != I64_MAX) r.pos = new_pos;
    const int32_t klo0 = r.klo;
    r.klo = klo0 + (int32_t)lo;
    r.khi = klo0 + (int32_t)hi;
}

// clipping.py revert_soft_clips: S -> M, alignment start moves back.
void revert_soft_clips(Rec& r) {
    bool has_s = false;
    for (const Op& o : r.cig)
        if (o.op == 'S') { has_s = true; break; }
    if (!has_s) return;
    int64_t lead = (!r.cig.empty() && r.cig[0].op == 'S') ? r.cig[0].n : 0;
    int64_t new_pos = std::max<int64_t>(0, r.pos - lead);
    if (r.pos - lead < 0) {
        const int64_t pos0 = r.pos;
        clip_by_read_indices(r, lead - pos0, r.len());
        lead = (!r.cig.empty() && r.cig[0].op == 'S') ? r.cig[0].n : 0;
        new_pos = r.pos - lead;
    }
    for (Op& o : r.cig)
        if (o.op == 'S') o.op = 'M';
    merge_adjacent(r.cig);
    r.pos = new_pos;
}

// clipping.py hard_clip_soft_clips.
void hard_clip_soft_clips(Rec& r) {
    const int64_t lead =
        (!r.cig.empty() && r.cig[0].op == 'S') ? r.cig[0].n : 0;
    const int64_t tail =
        (r.cig.size() > 1 && r.cig.back().op == 'S') ? r.cig.back().n : 0;
    if (!lead && !tail) return;
    clip_by_read_indices(r, lead, r.len() - tail);
}

// clipping.py _low_qual_end_bounds over the CURRENT qual range.
void low_qual_end_bounds(const Rec& r, int32_t t, int64_t* lo_out,
                         int64_t* hi_out) {
    const uint8_t* q = r.qual0 + r.klo;
    int64_t hi = r.len(), lo = 0;
    if (hi && q[0] > t && q[hi - 1] > t) {
        *lo_out = 0;
        *hi_out = hi;
        return;
    }
    while (lo < hi && q[lo] <= t) ++lo;
    while (hi > lo && q[hi - 1] <= t) --hi;
    *lo_out = lo;
    *hi_out = hi;
}

// clipping.py query_ref_positions over the CURRENT record state.
void query_ref_positions(const Rec& r, std::vector<int64_t>& out) {
    out.assign(r.len(), -1);
    int64_t q = 0, rr = r.pos;
    for (const Op& o : r.cig) {
        if (o.op == 'S') {
            if (q == 0)
                for (int32_t i = 0; i < o.n; ++i) out[q + i] = rr - o.n + i;
            else
                for (int32_t i = 0; i < o.n; ++i) out[q + i] = rr + i;
            q += o.n;
        } else if (o.op == 'M' || o.op == '=' || o.op == 'X') {
            for (int32_t i = 0; i < o.n; ++i) out[q + i] = rr + i;
            q += o.n;
            rr += o.n;
        } else if (o.op == 'I') {
            q += o.n;
        } else if (is_dn(o.op)) {
            rr += o.n;
        }
    }
}

// clipping.py soft_clip_low_qual_ends: mark low-quality tails as S.
void soft_clip_low_qual_ends(Rec& r, int32_t t) {
    int64_t lo, hi;
    low_qual_end_bounds(r, t, &lo, &hi);
    const int64_t L = r.len();
    if (lo == 0 && hi == L) return;
    if (lo >= hi) {
        r.cig.clear();
        r.khi = r.klo;
        return;
    }
    std::vector<int64_t> refpos;
    query_ref_positions(r, refpos);
    std::vector<Op> nc;
    if (lo) nc.push_back({'S', (int32_t)lo});
    int64_t q = 0;
    int64_t new_pos = I64_MAX;
    for (const Op& o : r.cig) {
        if (consumes_query(o.op)) {
            const int64_t l = std::max(q, lo), h = std::min(q + o.n, hi);
            if (h > l) {
                nc.push_back({o.op, (int32_t)(h - l)});
                if (consumes_ref(o.op) && new_pos == I64_MAX)
                    new_pos = refpos[l] >= 0 ? refpos[l] : r.pos;
            }
            q += o.n;
        } else if (lo < q && q < hi) {
            nc.push_back(o);
        }
    }
    if (L - hi) nc.push_back({'S', (int32_t)(L - hi)});
    merge_adjacent(nc);
    r.cig = std::move(nc);
    if (new_pos != I64_MAX) r.pos = new_pos;
}

void hard_clip_low_qual_ends(Rec& r, int32_t t) {
    int64_t lo, hi;
    low_qual_end_bounds(r, t, &lo, &hi);
    if (lo == 0 && hi == r.len()) return;
    clip_by_read_indices(r, lo, hi);
}

// clipping.py hard_clip_to_region (end INCLUSIVE).
void hard_clip_to_region(Rec& r, int64_t start, int64_t end) {
    if (r.cig.size() == 1 && r.cig[0].op == 'M') {
        const int64_t n = r.cig[0].n;
        const int64_t lo = std::max<int64_t>(0, start - r.pos);
        // end+1-pos would overflow at end = INT64_MAX (the adaptor clip's
        // open upper bound); Python ints are arbitrary-precision here
        const int64_t hi =
            (end >= r.pos + n - 1) ? n
                                   : std::min<int64_t>(n, end + 1 - r.pos);
        if (lo <= 0 && hi >= n) return;
        if (lo >= hi) {
            r.cig.clear();
            r.khi = r.klo;
            return;
        }
        r.pos += lo;
        r.cig[0].n = (int32_t)(hi - lo);
        r.klo += (int32_t)lo;
        r.khi = r.klo + (int32_t)(hi - lo);
        return;
    }
    std::vector<int64_t> refpos;
    query_ref_positions(r, refpos);
    // eff[i] = cummax(pos-1, anchored[0..i]) — forward-filled left anchor
    const int64_t L = r.len();
    int64_t run = r.pos - 1;
    int64_t first = -1, last = -1;
    bool all_keep = true;
    for (int64_t i = 0; i < L; ++i) {
        if (refpos[i] >= 0 && refpos[i] > run) run = refpos[i];
        const bool keep = run >= start && run <= end;
        if (keep) {
            if (first < 0) first = i;
            last = i;
        } else {
            all_keep = false;
        }
    }
    if (all_keep) return;
    if (first < 0) {
        r.cig.clear();
        r.khi = r.klo;
        return;
    }
    clip_by_read_indices(r, first, last + 1);
}

struct Flags {
    bool paired, unmapped, mate_unmapped, reverse, mate_reverse;
};
inline Flags decode_flags(int32_t f) {
    return {bool(f & 1), bool(f & 4), bool(f & 8), bool(f & 16),
            bool(f & 32)};
}

// clipping.py _has_well_defined_fragment_size — on the ORIGINAL record.
inline bool well_defined_fragment(const Flags& fl, int64_t tlen, int64_t pos,
                                  int64_t orig_ref_end, int64_t mate_pos) {
    if (tlen == 0 || !fl.paired || fl.unmapped || fl.mate_unmapped)
        return false;
    if (fl.reverse == fl.mate_reverse) return false;
    if (fl.reverse) return orig_ref_end > mate_pos;
    return pos <= mate_pos + tlen;
}

// clipping.py adaptor_boundary + hard_clip_adaptor_sequence — on the
// CURRENT record state, with the original flags/tlen/mate_pos.
void hard_clip_adaptor(Rec& r, const Flags& fl, int64_t tlen,
                       int64_t mate_pos) {
    if (!fl.paired || fl.mate_unmapped || tlen == 0 ||
        fl.reverse == fl.mate_reverse)
        return;
    if (fl.reverse) {
        const int64_t boundary = mate_pos - 1;
        if (boundary < r.pos) return;
        hard_clip_to_region(r, boundary + 1, I64_MAX);
    } else {
        const int64_t boundary = r.pos + (tlen < 0 ? -tlen : tlen);
        if (boundary > r.ref_end() - 1) return;
        hard_clip_to_region(r, -1, boundary - 1);
    }
}

}  // namespace

extern "C" {

// Finalize one region's selected reads from columnar BAM buffers.
// Inputs are per-selected-read arrays (n entries), gathered by the caller.
// Outputs (kept reads, pos-sorted): original selection index, new pos, kept
// query range [klo,khi) of the original read, reference length of the new
// cigar, new cigar (concatenated ops/lens + per-read count), and the
// adjusted quals (concatenated, one run of khi-klo bytes per kept read).
// out_counts = {n_kept, total_cigar_elems, total_qual_bytes}.
// Returns 0 on success, 1 on output-capacity overflow.
int finalize_region(
    const uint8_t* seq_buf, const uint8_t* qual_buf, const uint8_t* ops_buf,
    const int32_t* lens_buf, const uint8_t* names_buf,
    const int64_t* read_off, const int32_t* read_len,
    const int64_t* cigar_off, const int32_t* cigar_cnt, const int64_t* pos,
    const int64_t* orig_ref_end, const int32_t* flag, const int64_t* mate_pos,
    const int64_t* tlen, const int64_t* name_off, const int32_t* name_len,
    int64_t n, int64_t padded_start, int64_t padded_end,
    int32_t min_tail_quality, int32_t dont_use_soft_clipped,
    int32_t soft_clip_low_qual, int32_t correct_overlap, int32_t* out_idx,
    int64_t* out_pos, int32_t* out_klo, int32_t* out_khi, int32_t* out_reflen,
    uint8_t* out_cigar_ops, int32_t* out_cigar_lens, int32_t* out_cigar_cnt,
    uint8_t* out_qual, int64_t cap_cigar, int64_t cap_qual,
    int64_t* out_counts) {
    std::vector<Rec> kept;
    std::vector<int32_t> kept_src;
    kept.reserve(n);
    kept_src.reserve(n);

    for (int64_t i = 0; i < n; ++i) {
        Rec r;
        r.pos = pos[i];
        r.klo = 0;
        r.khi = read_len[i];
        r.seq0 = seq_buf + read_off[i];
        r.qual0 = qual_buf + read_off[i];
        r.cig.reserve(cigar_cnt[i]);
        for (int32_t c = 0; c < cigar_cnt[i]; ++c)
            r.cig.push_back(
                {ops_buf[cigar_off[i] + c], lens_buf[cigar_off[i] + c]});

        const Flags fl = decode_flags(flag[i]);
        if (dont_use_soft_clipped ||
            !well_defined_fragment(fl, tlen[i], pos[i], orig_ref_end[i],
                                   mate_pos[i]))
            hard_clip_soft_clips(r);
        else
            revert_soft_clips(r);
        if (soft_clip_low_qual)
            soft_clip_low_qual_ends(r, min_tail_quality);
        else
            hard_clip_low_qual_ends(r, min_tail_quality);
        if (r.len() <= 0) continue;
        hard_clip_adaptor(r, fl, tlen[i], mate_pos[i]);
        if (r.empty()) continue;
        hard_clip_to_region(r, padded_start, padded_end);
        if (r.empty() || r.pos > padded_end || r.ref_end() <= padded_start)
            continue;
        kept.push_back(std::move(r));
        kept_src.push_back((int32_t)i);
    }

    // stable pos sort (kept.sort(key=pos) in the spec)
    std::vector<int32_t> order(kept.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = (int32_t)i;
    std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
        return kept[a].pos < kept[b].pos;
    });

    // write outputs + copy quals (pair adjustment mutates the copies)
    int64_t co = 0, qo = 0;
    std::vector<int64_t> qual_at(order.size());
    for (size_t oi = 0; oi < order.size(); ++oi) {
        const Rec& r = kept[order[oi]];
        const int64_t L = r.len();
        if (co + (int64_t)r.cig.size() > cap_cigar || qo + L > cap_qual)
            return 1;
        out_idx[oi] = kept_src[order[oi]];
        out_pos[oi] = r.pos;
        out_klo[oi] = r.klo;
        out_khi[oi] = r.khi;
        out_reflen[oi] = (int32_t)r.ref_len();
        out_cigar_cnt[oi] = (int32_t)r.cig.size();
        for (const Op& o : r.cig) {
            out_cigar_ops[co] = o.op;
            out_cigar_lens[co] = o.n;
            ++co;
        }
        std::memcpy(out_qual + qo, r.qual0 + r.klo, L);
        qual_at[oi] = qo;
        qo += L;
    }

    // overlapping mate-pair qual correction (fragment_utils.rs:27-149):
    // pairs by name among kept paired reads, exactly-2 groups only
    if (correct_overlap) {
        std::unordered_map<std::string_view, std::vector<int32_t>> by_name;
        by_name.reserve(order.size());
        for (size_t oi = 0; oi < order.size(); ++oi) {
            const int32_t src = out_idx[oi];
            if (flag[src] & 1) {
                std::string_view nm(
                    reinterpret_cast<const char*>(names_buf + name_off[src]),
                    (size_t)name_len[src]);
                by_name[nm].push_back((int32_t)oi);
            }
        }
        std::vector<int64_t> rp1, rp2;
        for (auto& [nm, grp] : by_name) {
            if (grp.size() != 2) continue;
            int32_t a = grp[0], b = grp[1];
            // first = smaller pos, stable on ties (sorted(key=pos))
            if (kept[order[b]].pos < kept[order[a]].pos) std::swap(a, b);
            const Rec& r1 = kept[order[a]];
            const Rec& r2 = kept[order[b]];
            if (r1.ref_end() <= r2.pos) continue;
            query_ref_positions(r1, rp1);
            query_ref_positions(r2, rp2);
            // two-pointer intersection over the increasing >=0 positions
            uint8_t* q1 = out_qual + qual_at[a];
            uint8_t* q2 = out_qual + qual_at[b];
            const uint8_t* s1 = r1.seq0 + r1.klo;
            const uint8_t* s2 = r2.seq0 + r2.klo;
            size_t i = 0, j = 0;
            while (i < rp1.size() && j < rp2.size()) {
                if (rp1[i] < 0) { ++i; continue; }
                if (rp2[j] < 0) { ++j; continue; }
                if (rp1[i] < rp2[j]) ++i;
                else if (rp2[j] < rp1[i]) ++j;
                else {
                    if (s1[i] == s2[j]) {
                        q1[i] = std::min(q1[i], HALF_PCR_SNV_QUAL);
                        q2[j] = std::min(q2[j], HALF_PCR_SNV_QUAL);
                    } else {
                        q1[i] = 0;
                        q2[j] = 0;
                    }
                    ++i;
                    ++j;
                }
            }
        }
    }

    out_counts[0] = (int64_t)order.size();
    out_counts[1] = co;
    out_counts[2] = qo;
    return 0;
}

}  // extern "C"
