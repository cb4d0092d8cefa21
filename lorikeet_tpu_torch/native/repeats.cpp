// Tandem-repeat length at every read offset — native host kernel.
//
// Exact semantics of the PCR error model's repeat scan in the reference
// (reference/src/pair_hmm/pair_hmm_likelihood_calculation_engine.rs:528-612,
// find_tandem_repeat_units): at each offset, find the smallest backward unit
// (size 1..max_unit, ending at offset) repeating >1 times, the smallest
// forward unit (starting at offset+1) repeating >1 times, and combine:
// equal units sum their counts, unequal units add the backward extension of
// the forward unit.  Conformance spec is the scalar Python version
// (calling/likelihoods.py::_repeat_length_at).
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

inline int reps_backward(const uint8_t* b, int end, const uint8_t* unit, int s) {
    int reps = 0, pos = end;
    while (pos - s >= 0 && std::memcmp(b + pos - s, unit, s) == 0) {
        reps++;
        pos -= s;
    }
    return reps;
}

inline int reps_forward(const uint8_t* b, int start, int n, const uint8_t* unit, int s) {
    int reps = 0, pos = start;
    while (pos + s <= n && std::memcmp(b + pos, unit, s) == 0) {
        reps++;
        pos += s;
    }
    return reps;
}

}  // namespace

static void repeat_lengths_one(const uint8_t* b, int n, int max_unit,
                               int max_repeat, int32_t* out) {
    for (int i = 0; i < n; i++) {
        int best_bw = 0;
        const uint8_t* bw_unit = b + i;
        int bw_s = 1;
        for (int s = 1; s <= max_unit; s++) {
            if (i + 1 - s < 0) break;
            const uint8_t* unit = b + i + 1 - s;
            int reps = reps_backward(b, i + 1, unit, s);
            if (reps > 1) {
                best_bw = reps;
                bw_unit = unit;
                bw_s = s;
                break;
            }
            if (s == 1) best_bw = reps;
        }
        int max_rl;
        if (i < n - 1) {
            const uint8_t* fw_unit = b + i + 1;
            int fw_s = 1;
            int max_fw = 0;
            for (int s = 1; s <= max_unit; s++) {
                if (i + s + 1 > n) break;
                int reps = reps_forward(b, i + 1, n, fw_unit, s);
                if (reps > 1) {
                    max_fw = reps;
                    fw_s = s;
                    break;
                }
                if (s == 1) max_fw = reps;
            }
            const bool same =
                fw_s == bw_s && std::memcmp(fw_unit, bw_unit, fw_s) == 0;
            max_rl = same ? best_bw + max_fw
                          : max_fw + reps_backward(b, i + 1, fw_unit, fw_s);
        } else {
            max_rl = best_bw;
        }
        out[i] = std::min(max_rl, max_repeat);
    }
}

extern "C" void repeat_lengths(const uint8_t* b, int n, int max_unit,
                               int max_repeat, int32_t* out) {
    repeat_lengths_one(b, n, max_unit, max_repeat, out);
}

// Batched form: `offs` has n_seqs+1 entries delimiting concatenated
// sequences; out is parallel to the concatenated buffer.  One ctypes
// crossing per region instead of one per read.
extern "C" void repeat_lengths_batch(const uint8_t* b, const int64_t* offs,
                                     int n_seqs, int max_unit, int max_repeat,
                                     int32_t* out) {
    for (int k = 0; k < n_seqs; k++) {
        const int64_t lo = offs[k], hi = offs[k + 1];
        repeat_lengths_one(b + lo, (int)(hi - lo), max_unit, max_repeat,
                           out + lo);
    }
}
