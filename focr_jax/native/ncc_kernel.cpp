// Native host NCC kernel — the host execution tier and overflow fallback.
//
// Plays the role src/ncc.cpp (AVX2, reference) plays for the Rust binary:
// the host-side hot loop for normalized cross-correlation template search.
// This is an independent implementation written for compiler
// auto-vectorization (g++ -O3 -march=native) rather than hand-written
// intrinsics: the correlation accumulates one needle row at a time into a
// stride-1 i32 accumulator span, which vectorizes to the same u8->i16->i32
// madd pattern the reference hand-codes (ncc.cpp:106-142).
//
// Semantics replicated exactly (see focr_jax/oracle/ncc_oracle.py, the
// bit-exact spec both implementations are tested against):
//   * search domain y in [1, r_h-n_h+1), x in per-row [start, end)
//   * integer correlation acc (exact)
//   * f64 similarity  sim = (acc - (s_n*s_p)*(1/n)) * (rnorm_n * rnorm_p)
//     with the same association/order as the reference (ncc.cpp:206-215)
//   * emit iff sim != +inf && sim > (f64)(f32)threshold, scan order
//   * early-return at capacity (ncc.cpp:222-229)
//
// Zero-variance patches produce rnorm_p = inf and num = 0, so sim = nan and
// the comparison filters them — no special-casing, matching the reference.

#include <algorithm>
#include <cstdint>
#include <cmath>
#include <limits>
#include <vector>

namespace {

struct FMatch {
    uint16_t x;
    uint16_t y;
    float similarity;
};

}  // namespace

extern "C" {

// Search one needle over one page. Returns the number of matches written
// (<= cap); negative on argument errors.
int64_t focr_ncc_search_u8(
    const uint8_t* ref, int64_t r_w, int64_t r_h,
    const uint8_t* needle, int64_t n_w, int64_t n_h,
    const int64_t* patch_sum,    // [r_h * r_w], valid inside [start, end)
    const double* patch_rnorm,   // [r_h * r_w]
    const int64_t* start_end,    // [r_h][2]
    float threshold,
    FMatch* out, int64_t cap) {
    if (n_w > r_w || n_h > r_h || n_w <= 0 || n_h <= 0 || cap < 0) return -1;

    const int64_t n = n_w * n_h;
    int64_t s_n = 0, s2_n = 0;
    for (int64_t i = 0; i < n_h * n_w; ++i) {
        const int64_t v = needle[i];
        s_n += v;
        s2_n += v * v;
    }
    const double n_recip = 1.0 / static_cast<double>(n);
    const double norm2_n =
        static_cast<double>(s2_n) -
        static_cast<double>(s_n) * static_cast<double>(s_n) / static_cast<double>(n);
    const double rnorm_n = 1.0 / std::sqrt(norm2_n);
    const double thr = static_cast<double>(threshold);  // f64 of the f32 value
    const double s_n_d = static_cast<double>(s_n);
    const double inf = std::numeric_limits<double>::infinity();

    const int64_t y_searches = r_h - n_h + 1;
    std::vector<int32_t> acc(static_cast<size_t>(r_w));
    int64_t count = 0;

    for (int64_t y = 1; y < y_searches; ++y) {
        const int64_t start = start_end[2 * y];
        const int64_t end = start_end[2 * y + 1];
        if (start >= end) continue;
        const int64_t span = end - start;

        int32_t* a = acc.data();
        for (int64_t i = 0; i < span; ++i) a[i] = 0;
        for (int64_t dy = 0; dy < n_h; ++dy) {
            const uint8_t* row = ref + (y + dy) * r_w + start;
            const uint8_t* nd = needle + dy * n_w;
            for (int64_t dx = 0; dx < n_w; ++dx) {
                const int32_t nv = nd[dx];
                if (nv == 0) continue;
                const uint8_t* r = row + dx;
                for (int64_t i = 0; i < span; ++i) {  // stride-1: vectorizes
                    a[i] += nv * static_cast<int32_t>(r[i]);
                }
            }
        }

        const int64_t* sp_row = patch_sum + y * r_w;
        const double* rn_row = patch_rnorm + y * r_w;
        for (int64_t i = 0; i < span; ++i) {
            const int64_t x = start + i;
            const double num =
                static_cast<double>(a[i]) -
                (s_n_d * static_cast<double>(sp_row[x])) * n_recip;
            const double sim = num * (rnorm_n * rn_row[x]);
            if (sim != inf && sim > thr) {
                if (count >= cap) return count;  // scan-order truncation
                out[count].x = static_cast<uint16_t>(x);
                out[count].y = static_cast<uint16_t>(y);
                out[count].similarity = static_cast<float>(sim);
                ++count;
            }
        }
    }
    return count;
}

// Batch executor: search T needles of one size over one page, each into its
// own out slice of `cap` entries. Parallelized across needles with OpenMP
// when compiled with -fopenmp (the native equivalent of the reference's
// rayon fan-out, main.rs:442). counts[t] receives each needle's match count.
void focr_ncc_search_many_u8(
    const uint8_t* ref, int64_t r_w, int64_t r_h,
    const uint8_t* needles, int64_t t_count, int64_t n_w, int64_t n_h,
    const int64_t* patch_sum,
    const double* patch_rnorm,
    const int64_t* start_end,
    float threshold,
    FMatch* out, int64_t cap, int64_t* counts) {
#pragma omp parallel for schedule(dynamic)
    for (int64_t t = 0; t < t_count; ++t) {
        counts[t] = focr_ncc_search_u8(
            ref, r_w, r_h,
            needles + t * n_w * n_h, n_w, n_h,
            patch_sum, patch_rnorm, start_end,
            threshold, out + t * cap, cap);
    }
}

// Overlap-run winner scan for post-processing (models/post.py): given hits
// sorted by the composite (y << xbits) + x key (lexicographic y-then-x —
// the reference's two stable sort_by_key passes, ncc.rs:741, 753), emit the
// index of each run's winner. Run semantics replicate partition_by
// (ncc.rs:1036-1052): a run is anchored at its FIRST element and members
// satisfy key - anchor <= overlap (the key field widths guarantee runs
// never span text lines); the winner is the LAST maximal similarity (Rust
// max_by, ncc.rs:763). One linear pass — the NumPy formulation needed a
// searchsorted, a Python jump loop, and two reduceat passes. Returns the
// number of runs (= winners written).
int64_t focr_post_winners(
    const int64_t* key, const float* sim, int64_t n, int64_t overlap,
    int64_t* win_out) {
    int64_t nr = 0;
    int64_t i = 0;
    while (i < n) {
        const int64_t anchor = key[i];
        float best = sim[i];
        int64_t bi = i;
        int64_t j = i + 1;
        while (j < n && key[j] - anchor <= overlap) {
            if (sim[j] >= best) {  // last max wins ties
                best = sim[j];
                bi = j;
            }
            ++j;
        }
        win_out[nr++] = bi;
        i = j;
    }
    return nr;
}

// Fused sort + winner scan over UNSORTED hits: stable LSD radix sort of the
// composite (y << xbits) + x keys (16-bit digits; stability = the
// reference's stable sort_by_key passes, which the run anchor and last-max
// tie-break both depend on), then the focr_post_winners run scan over the
// sorted order. Emits each run winner's ORIGINAL index, in run (key) order.
// Replaces NumPy's comparison argsort + five full-array gathers in
// models/post.py::_winner_arrays — on a dense page (~27k hits) the argsort
// alone was ~20% of the host collect budget. Keys are non-negative.
int64_t focr_post_sort_winners(
    const int64_t* key, const float* sim, int64_t n, int64_t overlap,
    int64_t* win_out) {
    if (n <= 0) return 0;
    struct KI {
        int64_t k;
        int64_t i;  // original index: i64 like n (an i32 would silently
                    // truncate past 2^31 hits; alignment pads the struct to
                    // 16 bytes either way, so the wide index is free)
    };
    std::vector<KI> a(static_cast<size_t>(n)), b(static_cast<size_t>(n));
    int64_t maxk = 0;
    for (int64_t i = 0; i < n; ++i) {
        a[i].k = key[i];
        a[i].i = i;
        if (key[i] > maxk) maxk = key[i];
    }
    int passes = 1;  // only digits the max key reaches (page keys fit 3)
    while (passes < 4 && (maxk >> (16 * passes)) != 0) ++passes;
    std::vector<int64_t> cnt(1 << 16);
    for (int p = 0; p < passes; ++p) {
        const int sh = 16 * p;
        std::fill(cnt.begin(), cnt.end(), 0);
        for (int64_t i = 0; i < n; ++i) ++cnt[(a[i].k >> sh) & 0xffff];
        int64_t run = 0;
        for (int64_t d = 0; d < (1 << 16); ++d) {
            const int64_t c = cnt[d];
            cnt[d] = run;
            run += c;
        }
        for (int64_t i = 0; i < n; ++i) b[cnt[(a[i].k >> sh) & 0xffff]++] = a[i];
        a.swap(b);
    }
    int64_t nr = 0;
    int64_t i = 0;
    while (i < n) {
        const int64_t anchor = a[i].k;
        float best = sim[a[i].i];
        int64_t bi = a[i].i;
        int64_t j = i + 1;
        while (j < n && a[j].k - anchor <= overlap) {
            const float s = sim[a[j].i];
            if (s >= best) {  // last max wins ties
                best = s;
                bi = a[j].i;
            }
            ++j;
        }
        win_out[nr++] = bi;
        i = j;
    }
    return nr;
}

}  // extern "C"
