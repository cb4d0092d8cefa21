// Exact float64 pair-HMM forward — native host kernel.
//
// Same numerics contract as ops/pairhmm.py::pairhmm_forward_np (the
// conformance spec validated against the GATK golden file), which itself
// mirrors the reference's scalar fallback
// (reference/src/pair_hmm/pair_hmm.rs:503-615, pair_hmm_model.rs:126-155):
//   - states M/I/D over (R+1) x (H+1), free deletions on row 0
//     (D[0][j] = 2^1020 / H)
//   - transitions per read row from phred quals; mm = 1 - min(1, ei + ed)
//   - prior = 1 - eq on base match or 'N', else eq / 3 (tristate)
//   - result = log10(sum_j M[R][j] + I[R][j]) - log10(2^1020)
//
// This replaces the per-pair numpy/lfilter host path for the batches
// that stay on the host; the row sweep is
// sequential in j only for D, and pairs parallelise across threads.
#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>
#include <thread>
#include <atomic>

namespace {

double QTAB[256];
const double INITIAL = 0x1p1020;       // 2^1020
const double LOG10_INITIAL = 1020.0 * 0.30102999566398119521;  // log10(2^1020)
const uint8_t NBASE = 'N';

struct Init {
    Init() {
        for (int i = 0; i < 256; i++) QTAB[i] = std::pow(10.0, -i / 10.0);
    }
} init_;

double forward_one(const uint8_t* hap, int H, const uint8_t* read,
                   const uint8_t* q, const uint8_t* iq, const uint8_t* dq,
                   const uint8_t* gcp, int R, int tristate,
                   std::vector<double>& scratch) {
    if (H <= 0 || R <= 0) return -INFINITY;
    scratch.resize(6 * (size_t)(H + 1));
    double* mprev = scratch.data();
    double* iprev = mprev + (H + 1);
    double* dprev = iprev + (H + 1);
    double* mcur  = dprev + (H + 1);
    double* icur  = mcur + (H + 1);
    double* dcur  = icur + (H + 1);

    const double dinit = INITIAL / H;
    for (int j = 0; j <= H; j++) { mprev[j] = 0.0; iprev[j] = 0.0; dprev[j] = dinit; }

    for (int i = 1; i <= R; i++) {
        const double ei = QTAB[iq[i - 1]];
        const double ed = QTAB[dq[i - 1]];
        const double eg = QTAB[gcp[i - 1]];
        const double mm = 1.0 - std::fmin(1.0, ei + ed);
        const double im = 1.0 - eg;
        const double mi = ei, ii = eg, md = ed, dd = eg;
        const double eq = QTAB[q[i - 1]];
        const double matchp = 1.0 - eq;
        const double misp = tristate ? eq / 3.0 : eq;
        const uint8_t rb = read[i - 1];

        mcur[0] = 0.0; icur[0] = 0.0; dcur[0] = 0.0;
        double dleft = 0.0;
        for (int j = 1; j <= H; j++) {
            const uint8_t hb = hap[j - 1];
            const double prior =
                (rb == hb || rb == NBASE || hb == NBASE) ? matchp : misp;
            const double m = prior * (mprev[j - 1] * mm
                                      + (iprev[j - 1] + dprev[j - 1]) * im);
            icur[j] = mprev[j] * mi + iprev[j] * ii;
            dleft = mcur[j - 1] * md + dleft * dd;
            dcur[j] = dleft;
            mcur[j] = m;
        }
        std::swap(mprev, mcur);
        std::swap(iprev, icur);
        std::swap(dprev, dcur);
    }
    double final_sum = 0.0;
    for (int j = 1; j <= H; j++) final_sum += mprev[j] + iprev[j];
    return std::log10(final_sum) - LOG10_INITIAL;
}

}  // namespace

extern "C" void pairhmm_forward_batch(
    const uint8_t* hap_buf, const int64_t* hap_off, const int32_t* hap_len,
    const uint8_t* read_buf, const uint8_t* q_buf, const uint8_t* iq_buf,
    const uint8_t* dq_buf, const uint8_t* gcp_buf,
    const int64_t* read_off, const int32_t* read_len,
    int64_t n_pairs, int tristate, int n_threads, double* out) {
    if (n_threads < 1) n_threads = 1;
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        std::vector<double> scratch;
        for (;;) {
            const int64_t k = next.fetch_add(1);
            if (k >= n_pairs) break;
            out[k] = forward_one(
                hap_buf + hap_off[k], hap_len[k],
                read_buf + read_off[k], q_buf + read_off[k],
                iq_buf + read_off[k], dq_buf + read_off[k],
                gcp_buf + read_off[k], read_len[k], tristate, scratch);
        }
    };
    if (n_threads == 1 || n_pairs == 1) {
        worker();
        return;
    }
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
}
