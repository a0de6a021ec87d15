// tapecraft — native host runtime for stringzilla_tpu.
//
// The device kernels consume dense, padded, lane-aligned blocks; everything the
// device cannot do — ragged→dense packing, corpus tokenization, sort-key
// export — is host work on the critical path of every engine call. The
// reference keeps this layer native too (its CPython bindings and ForkUnion
// runtime are C/C++; see reference c/stringzillas/runtime.cpp,
// python/stringzilla.c). This is this package's equivalent: a small C++17
// shared library driven through ctypes (no pybind11 in the image).
//
// All functions are plain-C ABI and operate on caller-owned buffers.
// Single-string ops are thread-free; the *batch* tape entry points fan out
// across cores (the role the reference's ForkUnion pool plays for its batch
// engines, reference include/stringzillas/types.hpp:133-234) — disjoint
// output cells, static byte-balanced partition, no shared state. The fan-out
// is capped by TC_THREADS (default: all hardware threads) and collapses to
// the inline loop when the work is too small to pay a spawn.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#if defined(__AES__) && defined(__SSSE3__)
#define TC_AESNI 1
#endif
#if defined(__SHA__) && defined(__SSE4_1__)
#define TC_SHANI 1
#endif
#endif

// Thread budget for batch entry points. TC_THREADS is re-read per call so
// tests can flip it without reloading the library; hardware count is cached.
static int tc_thread_budget_() {
    static const int hw = [] {
        int n = (int)std::thread::hardware_concurrency();
        return n > 0 ? n : 1;
    }();
    const char* env = std::getenv("TC_THREADS");
    if (env && *env) {
        long v = std::strtol(env, nullptr, 10);
        if (v >= 1) return v < 1024 ? (int)v : 1024;
    }
    return hw;
}

// Fan a tape loop [0, count) across threads, partitioned by *byte mass* (a
// tape's offsets are monotone), so a batch of one huge and many tiny docs
// still balances. `min_bytes` is the smallest per-thread share worth a spawn
// (~0.5 ms of hashing work); below it the loop runs inline. `body(lo, hi)`
// must only write output cells for rows in [lo, hi).
template <typename F>
static void tc_parallel_tape_(const int64_t* offsets, int64_t count,
                              int64_t min_bytes, F&& body) {
    int parts = tc_thread_budget_();
    int64_t total = (offsets && count > 0) ? offsets[count] - offsets[0] : 0;
    if (parts > 1 && min_bytes > 0 && total / parts < min_bytes)
        parts = (int)(total / min_bytes);
    if (parts > count) parts = (int)count;
    if (parts <= 1) { body((int64_t)0, count); return; }
    std::vector<int64_t> bounds((size_t)parts + 1);
    bounds[0] = 0;
    bounds[(size_t)parts] = count;
    for (int p = 1; p < parts; ++p) {
        int64_t target = offsets[0] + total / parts * p;
        bounds[(size_t)p] =
            std::lower_bound(offsets, offsets + count, target) - offsets;
    }
    std::vector<std::thread> pool;
    pool.reserve((size_t)parts - 1);
    for (int p = 1; p < parts; ++p)
        pool.emplace_back([&body, &bounds, p] {
            body(bounds[(size_t)p], bounds[(size_t)p + 1]);
        });
    body(bounds[0], bounds[1]);
    for (auto& t : pool) t.join();
}

// Same fan-out for loops without a tape (overlapping spans, plain counts):
// partitioned by row count.
template <typename F>
static void tc_parallel_n_(int64_t count, int64_t min_rows, F&& body) {
    int parts = tc_thread_budget_();
    if (parts > 1 && min_rows > 0 && count / parts < min_rows)
        parts = (int)(count / min_rows);
    if (parts > count) parts = (int)count;
    if (parts <= 1) { body((int64_t)0, count); return; }
    int64_t chunk = (count + parts - 1) / parts;
    std::vector<std::thread> pool;
    pool.reserve((size_t)parts - 1);
    for (int p = 1; p < parts; ++p) {
        int64_t lo = chunk * p;
        int64_t hi = lo + chunk < count ? lo + chunk : count;
        if (lo >= hi) break;
        pool.emplace_back([&body, lo, hi] { body(lo, hi); });
    }
    body((int64_t)0, chunk < count ? chunk : count);
    for (auto& t : pool) t.join();
}

extern "C" {

// Ragged → dense uint8 matrix. Strings selected by `indices` out of the tape
// (data, offsets[count+1]) are copied into `out` of shape [rows, row_len]
// (row-major), zero-padded. When `transpose` != 0, `out` is [row_len, rows]
// instead (the lane-packed layout: candidates across the minor axis).
void tc_pack_u8(const uint8_t* data, const int64_t* offsets,
                const int64_t* indices, int64_t count,
                uint8_t* out, int64_t rows, int64_t row_len,
                int transpose) {
    if (!transpose) {
        std::memset(out, 0, (size_t)(rows * row_len));
        for (int64_t r = 0; r < count; ++r) {
            int64_t idx = indices ? indices[r] : r;
            int64_t lo = offsets[idx], hi = offsets[idx + 1];
            int64_t n = hi - lo;
            if (n > row_len) n = row_len;
            std::memcpy(out + r * row_len, data + lo, (size_t)n);
        }
    } else {
        std::memset(out, 0, (size_t)(rows * row_len));
        for (int64_t r = 0; r < count; ++r) {
            int64_t idx = indices ? indices[r] : r;
            int64_t lo = offsets[idx], hi = offsets[idx + 1];
            int64_t n = hi - lo;
            if (n > row_len) n = row_len;
            for (int64_t i = 0; i < n; ++i)
                out[i * rows + r] = data[lo + i];
        }
    }
}

// Ragged → dense int32 matrix (the DP kernels take int32 characters).
// `fill` pre-fills the matrix (0 for candidates, -1 for Myers queries).
// Layout [row_len, rows] when transpose (chars down axis 0), else
// [rows, row_len]. Also writes per-string lengths (clamped to row_len).
void tc_pack_i32(const uint8_t* data, const int64_t* offsets,
                 const int64_t* indices, int64_t count,
                 int32_t* out, int64_t rows, int64_t row_len,
                 int transpose, int32_t fill, int32_t* lengths) {
    for (int64_t i = 0, total = rows * row_len; i < total; ++i) out[i] = fill;
    for (int64_t r = 0; r < count; ++r) {
        int64_t idx = indices ? indices[r] : r;
        int64_t lo = offsets[idx], hi = offsets[idx + 1];
        int64_t n = hi - lo;
        if (lengths) lengths[r] = (int32_t)n;
        if (n > row_len) n = row_len;
        if (!transpose) {
            int32_t* row = out + r * row_len;
            for (int64_t i = 0; i < n; ++i) row[i] = data[lo + i];
        } else {
            for (int64_t i = 0; i < n; ++i) out[i * rows + r] = data[lo + i];
        }
    }
}

// Same, but for pre-decoded 32-bit rune tapes (UTF-8 engines).
void tc_pack_runes_i32(const int32_t* data, const int64_t* offsets,
                       const int64_t* indices, int64_t count,
                       int32_t* out, int64_t rows, int64_t row_len,
                       int transpose, int32_t fill, int32_t* lengths) {
    for (int64_t i = 0, total = rows * row_len; i < total; ++i) out[i] = fill;
    for (int64_t r = 0; r < count; ++r) {
        int64_t idx = indices ? indices[r] : r;
        int64_t lo = offsets[idx], hi = offsets[idx + 1];
        int64_t n = hi - lo;
        if (lengths) lengths[r] = (int32_t)n;
        if (n > row_len) n = row_len;
        if (!transpose) {
            int32_t* row = out + r * row_len;
            for (int64_t i = 0; i < n; ++i) row[i] = data[lo + i];
        } else {
            for (int64_t i = 0; i < n; ++i) out[i * rows + r] = data[lo + i];
        }
    }
}

// Whitespace tokenization: writes token [start, end) pairs, returns count.
// A second pass with bounds==nullptr just counts (callers size the buffer).
// ASCII whitespace set matches the reference bench corpora (space, \t-\r).
static inline bool tc_is_ws(uint8_t b) {
    return b == ' ' || (b >= '\t' && b <= '\r');
}

int64_t tc_tokenize_ws(const uint8_t* data, int64_t n, int64_t* bounds,
                       int64_t cap) {
    int64_t count = 0;
    int64_t i = 0;
    while (i < n) {
        while (i < n && tc_is_ws(data[i])) ++i;
        if (i >= n) break;
        int64_t start = i;
        while (i < n && !tc_is_ws(data[i])) ++i;
        if (bounds && count < cap) {
            bounds[2 * count] = start;
            bounds[2 * count + 1] = i;
        }
        ++count;
    }
    return count;
}

// Newline split: one token per line (excluding the terminator), \r\n = one
// terminator. Returns line count.
int64_t tc_split_lines(const uint8_t* data, int64_t n, int64_t* bounds,
                       int64_t cap) {
    int64_t count = 0;
    int64_t start = 0;
    for (int64_t i = 0; i <= n; ++i) {
        bool end = i == n;
        bool nl = !end && (data[i] == '\n' || data[i] == '\r');
        if (end || nl) {
            if (end && start == i && count > 0) break;  // no trailing empty
            if (bounds && count < cap) {
                bounds[2 * count] = start;
                bounds[2 * count + 1] = i;
            }
            ++count;
            if (!end && data[i] == '\r' && i + 1 < n && data[i + 1] == '\n') ++i;
            start = i + 1;
            if (end) break;
        }
    }
    return count;
}

// Sort-key export: big-endian u32 pgram keys + u32 length tiebreak, the host
// half of the device argsort (see ops/sort.py; reference exports pointer-
// sized pgrams the same way, include/stringzilla/sort.h:9-16).
// out shape: [count, words_per_str + 1] u32, keys big-endian per 4 bytes.
void tc_pgram_keys(const uint8_t* data, const int64_t* starts,
                   const int64_t* ends, int64_t count,
                   uint32_t* out, int64_t words_per_str,
                   int uncased, int reverse) {
    // Rows are independent — fan the export across cores (the reference's
    // pgram export is equally embarrassingly parallel, sort.h:9-16).
    tc_parallel_n_(count, (int64_t)1 << 15, [&](int64_t lo_r, int64_t hi_r) {
    for (int64_t r = lo_r; r < hi_r; ++r) {
        int64_t lo = starts[r], hi = ends[r];
        int64_t n = hi - lo;
        uint32_t* row = out + r * (words_per_str + 1);
        for (int64_t w = 0; w < words_per_str; ++w) {
            uint32_t key = 0;
            for (int64_t b = 0; b < 4; ++b) {
                int64_t i = w * 4 + b;
                uint32_t byte = i < n ? data[lo + i] : 0;
                if (uncased && byte >= 'A' && byte <= 'Z') byte += 32;
                if (reverse) byte = 255u - byte;
                key = (key << 8) | byte;
            }
            row[w] = key;
        }
        row[words_per_str] = reverse ? ~(uint32_t)n : (uint32_t)n;
    }
    });
}

// Full-Unicode uncased sort-key export: keys are byte prefixes of the
// CASE-FOLDED string (progressive fold-on-export, the reference's
// sz_sequence_argsort_uncased design, include/stringzilla/sort.h:18-22,114)
// plus a folded-length tiebreak. Malformed UTF-8 decodes as U+FFFD per
// maximal subpart, giving malformed bytes a defined total order (they sort
// as the replacement character's bytes EF BF BD). ASCII-only strings skip
// the decode entirely. `out` shape: [count, words_per_str + 1] u32.
// Declared below tc_fold_one/tc_decode_one; defined after them.
static int64_t tc_fold_bytes_into_(const uint8_t* data, int64_t lo, int64_t hi,
                                   const uint32_t* fold1, const uint32_t* mkeys,
                                   const int64_t* moffs, const uint32_t* mvals,
                                   int64_t mcount, std::vector<uint8_t>& buf);

void tc_pgram_keys_unicode(const uint8_t* data, const int64_t* starts,
                           const int64_t* ends, int64_t count, uint32_t* out,
                           int64_t words_per_str, int reverse,
                           const uint32_t* fold1, const uint32_t* mkeys,
                           const int64_t* moffs, const uint32_t* mvals,
                           int64_t mcount) {
    std::vector<uint8_t> scratch;
    for (int64_t r = 0; r < count; ++r) {
        int64_t lo = starts[r], hi = ends[r];
        bool ascii = true;
        for (int64_t i = lo; i < hi; ++i)
            if (data[i] >= 0x80) { ascii = false; break; }
        const uint8_t* src = data + lo;
        int64_t n = hi - lo;
        if (!ascii) {
            scratch.clear();
            n = tc_fold_bytes_into_(data, lo, hi, fold1, mkeys, moffs, mvals,
                                    mcount, scratch);
            src = scratch.data();
        }
        uint32_t* row = out + r * (words_per_str + 1);
        for (int64_t w = 0; w < words_per_str; ++w) {
            uint32_t key = 0;
            for (int64_t b = 0; b < 4; ++b) {
                int64_t i = w * 4 + b;
                uint32_t byte = i < n ? src[i] : 0;
                if (ascii && byte >= 'A' && byte <= 'Z') byte += 32;
                if (reverse) byte = 255u - byte;
                key = (key << 8) | byte;
            }
            row[w] = key;
        }
        row[words_per_str] = reverse ? ~(uint32_t)n : (uint32_t)n;
    }
}

// 64-bit byte checksum over a tape slice (sz_bytesum analog for host tiers).
uint64_t tc_bytesum(const uint8_t* data, int64_t n) {
    uint64_t acc = 0;
    for (int64_t i = 0; i < n; ++i) acc += data[i];
    return acc;
}

// ---------------------------------------------------------------------------
// UTF-8 runtime: exact decode (U+FFFD per maximal subpart), encode, and
// table-driven full case folding. The host half of the Unicode tier — the
// property/fold tables are generated in Python (ops/ucd.py) and passed in
// as plain arrays; this file only knows UTF-8 framing, not Unicode data.
// ---------------------------------------------------------------------------

// Decode one rune starting at data[i]; writes the rune (or 0xFFFD) and
// returns bytes consumed (>= 1). Invalid sequences consume their maximal
// subpart, matching Python's errors="replace" / Unicode TR recommendation.
static inline int64_t tc_decode_one(const uint8_t* data, int64_t i, int64_t n,
                                    uint32_t* rune) {
    uint8_t b0 = data[i];
    if (b0 < 0x80) { *rune = b0; return 1; }
    if (b0 < 0xC2) { *rune = 0xFFFD; return 1; }  // stray cont / C0 / C1
    int64_t avail = n - i;
    if (b0 < 0xE0) {  // 2-byte
        if (avail >= 2 && (data[i + 1] & 0xC0) == 0x80) {
            *rune = ((uint32_t)(b0 & 0x1F) << 6) | (data[i + 1] & 0x3F);
            return 2;
        }
        *rune = 0xFFFD; return 1;
    }
    if (b0 < 0xF0) {  // 3-byte; first-cont range depends on the lead
        uint8_t lo = b0 == 0xE0 ? 0xA0 : 0x80;
        uint8_t hi = b0 == 0xED ? 0x9F : 0xBF;
        if (avail < 2 || data[i + 1] < lo || data[i + 1] > hi) { *rune = 0xFFFD; return 1; }
        if (avail < 3 || (data[i + 2] & 0xC0) != 0x80) { *rune = 0xFFFD; return 2; }
        *rune = ((uint32_t)(b0 & 0x0F) << 12) |
                ((uint32_t)(data[i + 1] & 0x3F) << 6) | (data[i + 2] & 0x3F);
        return 3;
    }
    if (b0 <= 0xF4) {  // 4-byte
        uint8_t lo = b0 == 0xF0 ? 0x90 : 0x80;
        uint8_t hi = b0 == 0xF4 ? 0x8F : 0xBF;
        if (avail < 2 || data[i + 1] < lo || data[i + 1] > hi) { *rune = 0xFFFD; return 1; }
        if (avail < 3 || (data[i + 2] & 0xC0) != 0x80) { *rune = 0xFFFD; return 2; }
        if (avail < 4 || (data[i + 3] & 0xC0) != 0x80) { *rune = 0xFFFD; return 3; }
        *rune = ((uint32_t)(b0 & 0x07) << 18) | ((uint32_t)(data[i + 1] & 0x3F) << 12) |
                ((uint32_t)(data[i + 2] & 0x3F) << 6) | (data[i + 3] & 0x3F);
        return 4;
    }
    *rune = 0xFFFD; return 1;  // F5..FF
}

static inline int64_t tc_encode_one(uint32_t r, uint8_t* out) {
    if (r < 0x80) { out[0] = (uint8_t)r; return 1; }
    if (r < 0x800) {
        out[0] = (uint8_t)(0xC0 | (r >> 6));
        out[1] = (uint8_t)(0x80 | (r & 0x3F));
        return 2;
    }
    if (r < 0x10000) {
        out[0] = (uint8_t)(0xE0 | (r >> 12));
        out[1] = (uint8_t)(0x80 | ((r >> 6) & 0x3F));
        out[2] = (uint8_t)(0x80 | (r & 0x3F));
        return 3;
    }
    out[0] = (uint8_t)(0xF0 | (r >> 18));
    out[1] = (uint8_t)(0x80 | ((r >> 12) & 0x3F));
    out[2] = (uint8_t)(0x80 | ((r >> 6) & 0x3F));
    out[3] = (uint8_t)(0x80 | (r & 0x3F));
    return 4;
}

// End of the pure-ASCII run starting at i (SWAR 8-byte probe).
static inline int64_t tc_ascii_run(const uint8_t* data, int64_t i, int64_t n) {
    // 64-byte vector blocks first (vectorized by -march), then SWAR + scalar.
    typedef uint8_t v64 __attribute__((vector_size(64)));
    while (i + 64 <= n) {
        v64 x;
        std::memcpy(&x, data + i, 64);
        uint64_t words[8];
        std::memcpy(words, &x, 64);
        uint64_t any = 0;
        for (int w = 0; w < 8; ++w) any |= words[w];
        if (any & 0x8080808080808080ull) break;
        i += 64;
    }
    while (i + 8 <= n) {
        uint64_t w;
        std::memcpy(&w, data + i, 8);
        if (w & 0x8080808080808080ull) break;
        i += 8;
    }
    while (i < n && data[i] < 0x80) ++i;
    return i;
}

// Decode the whole buffer. Returns rune count. When runes/offsets are
// non-null they receive the scalar values and the source byte offset of
// every rune (offsets has one extra slot for the end offset).
int64_t tc_utf8_decode(const uint8_t* data, int64_t n, uint32_t* runes,
                       int32_t* offsets) {
    int64_t count = 0, i = 0;
    while (i < n) {
        int64_t run_end = tc_ascii_run(data, i, n);
        if (runes == nullptr) {
            count += run_end - i;
        } else {
            for (int64_t j = i; j < run_end; ++j) runes[count + (j - i)] = data[j];
            for (int64_t j = i; j < run_end; ++j) offsets[count + (j - i)] = (int32_t)j;
            count += run_end - i;
        }
        i = run_end;
        if (i >= n) break;
        uint32_t r;
        int64_t used = tc_decode_one(data, i, n, &r);
        if (runes) { runes[count] = r; offsets[count] = (int32_t)i; }
        i += used;
        ++count;
    }
    if (runes && offsets) offsets[count] = (int32_t)n;
    return count;
}

int64_t tc_utf8_encode(const uint32_t* runes, int64_t count, uint8_t* out) {
    int64_t o = 0;
    for (int64_t k = 0; k < count; ++k) o += tc_encode_one(runes[k], out + o);
    return o;
}

// Full case folding over decoded runes. fold1 is a u32[0x110000] direct
// table (identity where unchanged, 0xFFFFFFFF marks multi-rune folds looked
// up in the mkeys/moffs/mvals expansion lists). Emits folded runes and the
// index of the *source rune* each folded rune came from (for offset
// mapping in uncased search). Output capacity must be >= 3 * count.
int64_t tc_fold_runes(const uint32_t* runes, int64_t count,
                      const uint32_t* fold1, const uint32_t* mkeys,
                      const int64_t* moffs, const uint32_t* mvals,
                      int64_t mcount, uint32_t* out_runes, int64_t* out_src) {
    int64_t o = 0;
    for (int64_t k = 0; k < count; ++k) {
        uint32_t r = runes[k];
        uint32_t f = r < 0x110000 ? fold1[r] : r;
        if (f != 0xFFFFFFFFu) {
            out_runes[o] = f;
            if (out_src) out_src[o] = k;
            ++o;
            continue;
        }
        // binary search the (rare, ~100-entry) multi-fold table
        int64_t lo = 0, hi = mcount;
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (mkeys[mid] < r) lo = mid + 1; else hi = mid;
        }
        if (lo >= mcount || mkeys[lo] != r) {  // caller-table mismatch:
            out_runes[o] = r;                  // identity fold, no OOB read
            if (out_src) out_src[o] = k;
            ++o;
            continue;
        }
        for (int64_t v = moffs[lo]; v < moffs[lo + 1]; ++v) {
            out_runes[o] = mvals[v];
            if (out_src) out_src[o] = k;
            ++o;
        }
    }
    return o;
}

// One-shot fold of a UTF-8 buffer to folded UTF-8 bytes, fused
// decode→fold→encode with an ASCII fast path (the hot shape for the
// uncased/fold benchmarks; reference hits 1.3 GB/s with AVX-512 here).
// Returns folded byte count; out capacity must be >= 3*n + 16.
int64_t tc_utf8_fold_bytes(const uint8_t* data, int64_t n,
                           const uint32_t* fold1, const uint32_t* mkeys,
                           const int64_t* moffs, const uint32_t* mvals,
                           int64_t mcount, uint8_t* out) {
    int64_t o = 0, i = 0;
    while (i < n) {
        int64_t run_end = tc_ascii_run(data, i, n);
        // ASCII: only A-Z fold, always 1:1 — this loop auto-vectorizes
        for (int64_t j = i; j < run_end; ++j) {
            uint8_t b = data[j];
            out[o + (j - i)] = (uint8_t)(b + (((uint8_t)(b - 'A') < 26) ? 32 : 0));
        }
        o += run_end - i;
        i = run_end;
        if (i >= n) break;
        uint32_t r;
        int64_t used = tc_decode_one(data, i, n, &r);
        i += used;
        uint32_t f = fold1[r];
        if (f != 0xFFFFFFFFu) {
            o += tc_encode_one(f, out + o);
            continue;
        }
        int64_t lo = 0, hi = mcount;
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (mkeys[mid] < r) lo = mid + 1; else hi = mid;
        }
        if (lo >= mcount || mkeys[lo] != r) {  // caller-table mismatch
            o += tc_encode_one(r, out + o);
            continue;
        }
        for (int64_t v = moffs[lo]; v < moffs[lo + 1]; ++v)
            o += tc_encode_one(mvals[v], out + o);
    }
    return o;
}

// Body of the Unicode-uncased key export's fold step (declared above
// tc_pgram_keys_unicode): fold [lo, hi) into `buf`, return folded length.
static int64_t tc_fold_bytes_into_(const uint8_t* data, int64_t lo, int64_t hi,
                                   const uint32_t* fold1, const uint32_t* mkeys,
                                   const int64_t* moffs, const uint32_t* mvals,
                                   int64_t mcount, std::vector<uint8_t>& buf) {
    buf.resize((size_t)(3 * (hi - lo) + 16));
    return tc_utf8_fold_bytes(data + lo, hi - lo, fold1, mkeys, moffs, mvals,
                              mcount, buf.data());
}

// ---------------------------------------------------------------------------
// Case-insensitive substring search, folding on the fly (reference design:
// sz_utf8_uncased_search, include/stringzilla/utf8_uncased.h:957 — the
// haystack is never materialized in folded form). Returns 1 and fills
// (*out_off, *out_len) with the byte span in the ORIGINAL haystack on a
// match; 0 otherwise. `nd` is the needle's folded rune sequence. Matches may
// start/end inside a multi-rune fold expansion (spans cover whole source
// runes), mirroring the array-based Python fallback's semantics.

static inline int64_t tc_fold_one(uint32_t r, const uint32_t* fold1,
                                  const uint32_t* mkeys, const int64_t* moffs,
                                  const uint32_t* mvals, int64_t mcount,
                                  uint32_t out[4]) {
    uint32_t f = r < 0x110000u ? fold1[r] : r;
    if (f != 0xFFFFFFFFu) { out[0] = f; return 1; }
    int64_t lo = 0, hi = mcount;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (mkeys[mid] < r) lo = mid + 1; else hi = mid;
    }
    // Caller-supplied tables may disagree with fold1's multi-fold sentinel;
    // treat a missing key as identity fold instead of reading past moffs.
    if (lo >= mcount || mkeys[lo] != r) { out[0] = r; return 1; }
    int64_t o = 0;
    for (int64_t v = moffs[lo]; v < moffs[lo + 1]; ++v) out[o++] = mvals[v];
    return o;
}

// Verify a candidate match: folded comparison of nd[0..k) starting at byte
// `i`, skipping the first `skip` folded elements of the rune at `i`.
// On success sets *end_byte to the exclusive byte end of the last source rune.
static int tc_uncased_verify(const uint8_t* data, int64_t i, int64_t n,
                             int64_t skip, const uint32_t* nd, int64_t k,
                             const uint32_t* fold1, const uint32_t* mkeys,
                             const int64_t* moffs, const uint32_t* mvals,
                             int64_t mcount, int64_t* end_byte) {
    int64_t matched = 0, pos = i;
    while (matched < k) {
        if (pos >= n) return 0;
        uint32_t r;
        int64_t used;
        if (data[pos] < 0x80) { r = data[pos]; used = 1; }
        else used = tc_decode_one(data, pos, n, &r);
        uint32_t f[4];
        int64_t m = tc_fold_one(r, fold1, mkeys, moffs, mvals, mcount, f);
        for (int64_t e = skip; e < m && matched < k; ++e)
            if (f[e] != nd[matched++]) return 0;
        skip = 0;
        pos += used;
    }
    *end_byte = pos;
    return 1;
}

// SWAR mask: high bit set in every byte of `w` equal to b1 or b2
// (b1x8/b2x8 are the bytes replicated 8x).
static inline uint64_t tc_ci_mask_(uint64_t w, uint64_t b1x8, uint64_t b2x8) {
    uint64_t x1 = w ^ b1x8, x2 = w ^ b2x8;
    uint64_t z1 = (x1 - 0x0101010101010101ull) & ~x1 & 0x8080808080808080ull;
    uint64_t z2 = (x2 - 0x0101010101010101ull) & ~x2 & 0x8080808080808080ull;
    return z1 | z2;
}

static inline uint64_t tc_load8_(const uint8_t* p) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    return w;
}

// 64-byte vector lane (GCC vector extensions — AVX-512/AVX2/SSE emitted per
// -march; no intrinsics, portable to any g++ target).
typedef uint8_t tc_v64_ __attribute__((vector_size(64)));

static inline tc_v64_ tc_vload64_(const uint8_t* p) {
    tc_v64_ v;
    std::memcpy(&v, p, 64);
    return v;
}

static inline tc_v64_ tc_vsplat_(uint8_t b) {
    return tc_v64_{} + b;
}

int tc_utf8_uncased_find(const uint8_t* data, int64_t n, const uint32_t* nd,
                         int64_t k, int64_t start_rune, const uint32_t* fold1,
                         const uint32_t* mkeys, const int64_t* moffs,
                         const uint32_t* mvals, int64_t mcount,
                         int64_t* out_off, int64_t* out_len) {
    if (k == 0) { *out_off = 0; *out_len = 0; return 1; }
    uint32_t first = nd[0];
    int first_is_ascii = first < 0x80;
    uint8_t c1 = (uint8_t)first;
    uint8_t c2 = (first >= 'a' && first <= 'z') ? (uint8_t)(first - 32) : c1;
    uint64_t c1x8 = 0x0101010101010101ull * c1;
    uint64_t c2x8 = 0x0101010101010101ull * c2;
    // Second probe at the needle's LAST folded rune — legal only inside an
    // all-ASCII window where source bytes map 1:1 to folded runes (ASCII
    // never multi-folds, and nothing non-ASCII hides in the window). This
    // is the reference's "anomaly offsets" candidate filter
    // (find/serial.h:35) adapted to on-the-fly folding.
    int nd_all_ascii = 1;
    for (int64_t t = 0; t < k; ++t) nd_all_ascii &= nd[t] < 0x80;
    uint8_t l1 = (uint8_t)nd[k - 1];
    uint8_t l2 = (l1 >= 'a' && l1 <= 'z') ? (uint8_t)(l1 - 32) : l1;
    uint64_t l1x8 = 0x0101010101010101ull * l1;
    uint64_t l2x8 = 0x0101010101010101ull * l2;
    int use_last = nd_all_ascii && k > 1;
    // Anomaly offsets (find/serial.h:35): probe the needle's two RAREST
    // folded bytes (static English/byte frequency rank) instead of
    // first/last — 'q' in "the unique…" filters ~100× harder than 't'.
    static const uint8_t kFreqRank[26] = {
        // a  b  c  d  e  f  g  h  i  j  k  l  m
          22, 9, 14, 15, 25, 11, 10, 18, 21, 2, 5, 16, 12,
        // n  o  p  q  r  s  t  u  v  w  x  y  z
          20, 23, 8, 1, 19, 17, 24, 13, 6, 7, 3, 13, 4};
    int64_t pa = 0, pb = k - 1;
    if (nd_all_ascii && k > 1) {
        auto rank = [&](uint8_t b) -> int {
            if (b >= 'a' && b <= 'z') return kFreqRank[b - 'a'];
            if (b == ' ') return 26;  // most common byte in text
            return 0;                 // digits/punct/rare bytes: best filters
        };
        pa = 0;
        for (int64_t t = 1; t < k; ++t)
            if (rank((uint8_t)nd[t]) < rank((uint8_t)nd[pa])) pa = t;
        pb = pa == 0 ? 1 : 0;
        for (int64_t t = 0; t < k; ++t)
            if (t != pa && rank((uint8_t)nd[t]) < rank((uint8_t)nd[pb])) pb = t;
    }
    uint8_t a1 = (uint8_t)nd[pa];
    uint8_t a2 = (a1 >= 'a' && a1 <= 'z') ? (uint8_t)(a1 - 32) : a1;
    uint8_t b1 = (uint8_t)nd[pb];
    uint8_t b2 = (b1 >= 'a' && b1 <= 'z') ? (uint8_t)(b1 - 32) : b1;

    int64_t i = 0, fr = 0;  // byte cursor, folded-rune counter
    while (i < n) {
        if (data[i] < 0x80) {
            int64_t run_end = tc_ascii_run(data, i, n);
            if (!first_is_ascii) { fr += run_end - i; i = run_end; continue; }
            int64_t j = i;
            // Vector fast lane: 64 window-starts per step, candidates =
            // starts whose two anomaly-offset bytes BOTH case-match — legal
            // only where the whole window sits inside the ASCII run (source
            // bytes map 1:1 to folded runes there; ASCII never multi-folds).
            int64_t vec_end = use_last ? run_end - k - 63 : run_end - 64;
            tc_v64_ A1 = tc_vsplat_(a1), A2 = tc_vsplat_(a2);
            tc_v64_ B1 = tc_vsplat_(b1), B2 = tc_vsplat_(b2);
            tc_v64_ C1 = tc_vsplat_(c1), C2 = tc_vsplat_(c2);
            for (; j <= vec_end; j += 64) {
                tc_v64_ x = tc_vload64_(data + j + (use_last ? pa : 0));
                tc_v64_ m = use_last
                    ? (tc_v64_)((x == A1) | (x == A2))
                    : (tc_v64_)((x == C1) | (x == C2));
                if (use_last) {
                    tc_v64_ y = tc_vload64_(data + j + pb);
                    m &= (tc_v64_)((y == B1) | (y == B2));
                }
                uint64_t words[8];
                std::memcpy(words, &m, 64);
                uint64_t any = 0;
                for (int w = 0; w < 8; ++w) any |= words[w];
                if (!any) continue;
                for (int w = 0; w < 8; ++w) {
                    uint64_t bits = words[w] & 0x8080808080808080ull;
                    while (bits) {
                        int64_t pos = j + w * 8 + (__builtin_ctzll(bits) >> 3);
                        bits &= bits - 1;
                        if (fr + (pos - i) < start_rune) continue;
                        int64_t end;
                        if (tc_uncased_verify(data, pos, n, 0, nd, k, fold1,
                                              mkeys, moffs, mvals, mcount,
                                              &end)) {
                            *out_off = pos;
                            *out_len = end - pos;
                            return 1;
                        }
                    }
                }
            }
            // Vector tail: first-byte probe only — these windows may cross
            // the run end (where the 1:1 byte↔rune mapping stops), so the
            // last-byte filter is invalid and the verifier decides instead.
            for (; j < run_end; j += 64) {
                tc_v64_ x;
                int64_t avail = n - j;
                if (avail >= 64) {
                    x = tc_vload64_(data + j);
                } else {
                    uint8_t tmp[64] = {0};
                    std::memcpy(tmp, data + j, avail);
                    std::memcpy(&x, tmp, 64);
                }
                tc_v64_ m = (tc_v64_)((x == C1) | (x == C2));
                uint64_t words[8];
                std::memcpy(words, &m, 64);
                for (int w = 0; w < 8 && j + w * 8 < run_end; ++w) {
                    uint64_t bits = words[w] & 0x8080808080808080ull;
                    while (bits) {
                        int64_t pos = j + w * 8 + (__builtin_ctzll(bits) >> 3);
                        bits &= bits - 1;
                        if (pos >= run_end) break;
                        if (fr + (pos - i) < start_rune) continue;
                        int64_t end;
                        if (tc_uncased_verify(data, pos, n, 0, nd, k, fold1,
                                              mkeys, moffs, mvals, mcount,
                                              &end)) {
                            *out_off = pos;
                            *out_len = end - pos;
                            return 1;
                        }
                    }
                }
            }
            fr += run_end - i;
            i = run_end;
            continue;
        }
        uint32_t r;
        int64_t used = tc_decode_one(data, i, n, &r);
        uint32_t f[4];
        int64_t m = tc_fold_one(r, fold1, mkeys, moffs, mvals, mcount, f);
        for (int64_t e = 0; e < m; ++e) {
            if (f[e] == first && fr + e >= start_rune) {
                int64_t end;
                if (tc_uncased_verify(data, i, n, e, nd, k, fold1, mkeys,
                                      moffs, mvals, mcount, &end)) {
                    *out_off = i;
                    *out_len = end - i;
                    return 1;
                }
            }
        }
        fr += m;
        i += used;
    }
    return 0;
}

// Stable argsort of a dense key matrix keys[n][w] (u32 rows, column 0 most
// significant — the pgram-key layout tc_pgram_keys emits).  The reference
// quick-sorts exported pgrams and recurses into equal runs
// (sort/serial.h:25-105); here: one MSD pass bucketing on the top 16 bits
// (counting sort, stable), then an introsort per bucket comparing the full
// key rows with the original index as the final tiebreak — adaptive like
// the reference's recursion (unique prefixes never look at deeper words).
void tc_argsort_keys(const uint32_t* keys, int64_t n, int32_t w,
                     int64_t* order) {
    if (n <= 0) return;
    auto cmp = [keys, w](int64_t a, int64_t b) {
        const uint32_t* ra = keys + a * w;
        const uint32_t* rb = keys + b * w;
        if ((ra[0] & 0xFFFF) != (rb[0] & 0xFFFF))
            return (ra[0] & 0xFFFF) < (rb[0] & 0xFFFF);
        for (int32_t c = 1; c < w; ++c)
            if (ra[c] != rb[c]) return ra[c] < rb[c];
        return a < b;  // stability
    };
    int parts = tc_thread_budget_();
    const int64_t kMinRows = 1 << 16;  // below ~64K rows the spawns dominate
    if (parts > 1 && n / parts < kMinRows) parts = (int)(n / kMinRows);
    if (parts <= 1) {
        std::vector<int64_t> counts(65537, 0);
        for (int64_t i = 0; i < n; ++i) ++counts[(keys[i * w] >> 16) + 1];
        for (int64_t d = 0; d < 65536; ++d) counts[d + 1] += counts[d];
        for (int64_t i = 0; i < n; ++i)
            order[counts[keys[i * w] >> 16]++] = i;
        // counts[d] is now the exclusive end of bucket d
        int64_t lo = 0;
        for (int64_t d = 0; d < 65536; ++d) {
            int64_t hi = counts[d];
            if (hi - lo > 1) std::sort(order + lo, order + hi, cmp);
            lo = hi;
        }
        return;
    }
    // Parallel MSD counting sort (stable), three phases — buckets are
    // independent after the scatter, so the per-bucket introsorts fan out
    // the same way the reference's equal-run recursion does across its
    // ForkUnion pool.
    // Phase 1: per-thread histograms over contiguous row ranges.
    int64_t chunk = (n + parts - 1) / parts;
    std::vector<int64_t> hist((size_t)parts * 65536, 0);
    {
        std::vector<std::thread> pool;
        pool.reserve((size_t)parts);
        for (int p = 0; p < parts; ++p)
            pool.emplace_back([&, p] {
                int64_t lo = chunk * p;
                int64_t hi = lo + chunk < n ? lo + chunk : n;
                int64_t* h = hist.data() + (size_t)p * 65536;
                for (int64_t i = lo; i < hi; ++i) ++h[keys[i * w] >> 16];
            });
        for (auto& t : pool) t.join();
    }
    // Exclusive prefix bucket-major, thread-minor: thread p's cursor for
    // bucket d starts after every earlier bucket and after threads < p's
    // rows in d — earlier input rows land earlier, keeping stability.
    std::vector<int64_t> bend(65536);  // exclusive end of each bucket
    {
        int64_t running = 0;
        for (int64_t d = 0; d < 65536; ++d) {
            for (int p = 0; p < parts; ++p) {
                int64_t c = hist[(size_t)p * 65536 + d];
                hist[(size_t)p * 65536 + d] = running;
                running += c;
            }
            bend[d] = running;
        }
    }
    // Phase 2: parallel stable scatter.
    {
        std::vector<std::thread> pool;
        pool.reserve((size_t)parts);
        for (int p = 0; p < parts; ++p)
            pool.emplace_back([&, p] {
                int64_t lo = chunk * p;
                int64_t hi = lo + chunk < n ? lo + chunk : n;
                int64_t* cur = hist.data() + (size_t)p * 65536;
                for (int64_t i = lo; i < hi; ++i)
                    order[cur[keys[i * w] >> 16]++] = i;
            });
        for (auto& t : pool) t.join();
    }
    // Phase 3: per-bucket introsort, buckets packed into contiguous chunks
    // balanced by element mass (bend is monotone).
    {
        std::vector<std::thread> pool;
        pool.reserve((size_t)parts);
        auto sort_span = [&](int64_t d_lo, int64_t d_hi) {
            int64_t lo = d_lo ? bend[d_lo - 1] : 0;
            for (int64_t d = d_lo; d < d_hi; ++d) {
                int64_t hi = bend[d];
                if (hi - lo > 1) std::sort(order + lo, order + hi, cmp);
                lo = hi;
            }
        };
        int64_t d_prev = 0;
        for (int p = 1; p < parts; ++p) {
            int64_t target = n / parts * p;
            int64_t d_cut = std::lower_bound(bend.begin(), bend.end(), target)
                            - bend.begin();
            if (d_cut > 65536) d_cut = 65536;
            if (d_cut > d_prev)
                pool.emplace_back(sort_span, d_prev, d_cut);
            d_prev = d_cut > d_prev ? d_cut : d_prev;
        }
        sort_span(d_prev, 65536);
        for (auto& t : pool) t.join();
    }
}

// ---------------------------------------------------------------------------
// UAX-29 sentence / UAX-14 line segmentation — the per-element automata that
// the Python tier (ops/segment.py) keeps as its oracle. Class tables are
// caller-supplied u8[0x110000] arrays generated at runtime from the stdlib
// UCD (ops/ucd.py); class ids follow ucd.SB_VALUES / ucd.LB_VALUES order.
// Reference analog: sz_utf8_sentences (utf8_sentences.h:37) and
// sz_utf8_linebreaks (utf8_linebreaks.h:41).

// SB_VALUES order (ops/ucd.py):
enum {
    SB_Other = 0, SB_CR, SB_LF, SB_Extend, SB_Sep, SB_Format, SB_Sp,
    SB_Lower, SB_Upper, SB_OLetter, SB_Numeric, SB_ATerm, SB_SContinue,
    SB_STerm, SB_Close
};

static inline bool sb_para(uint8_t c) {
    return c == SB_Sep || c == SB_CR || c == SB_LF;
}

// Word-character ([A-Za-z0-9_]) byte mask — shared by the WB and LB
// vectorized ASCII tiers.
static inline tc_v64_ tc_wb_vec_w_(tc_v64_ x) {
    tc_v64_ low = x | tc_vsplat_(0x20);
    return (tc_v64_)((low >= tc_vsplat_('a')) & (low <= tc_vsplat_('z'))) |
           (tc_v64_)((x >= tc_vsplat_('0')) & (x <= tc_vsplat_('9'))) |
           (tc_v64_)(x == tc_vsplat_('_'));
}

static inline bool sb_sig(uint8_t c) {
    return c == SB_OLetter || c == SB_Upper || c == SB_Lower || c == SB_Sep ||
           c == SB_CR || c == SB_LF || c == SB_ATerm || c == SB_STerm;
}

// With no pending terminator (term == 0) every class outside
// {ATerm, STerm, CR, LF, Sep, Extend, Format} only shifts the (prior, pc)
// pipeline — so the scan can skip straight to the next byte that could
// matter: '.', '!', '?', CR, LF, or any non-ASCII lead.  Verified against
// the caller's table per call.
static inline bool tc_sb_vec_check_(const uint8_t* sb) {
    for (int b = 0; b < 0x80; ++b) {
        if (b == '.' || b == '!' || b == '?' || b == 0x0D || b == 0x0A)
            continue;  // scanned for; the automaton owns them
        uint8_t c = sb[b];
        if (c == SB_ATerm || c == SB_STerm || c == SB_CR || c == SB_LF ||
            c == SB_Sep || c == SB_Extend || c == SB_Format)
            return false;
    }
    return true;
}

// Advances *pi to the next significant byte (or n).  Requires data[*pi]
// to be ASCII-insignificant already.
static inline void tc_sb_skip_(const uint8_t* data, int64_t n, int64_t* pi) {
    int64_t i = *pi + 1;
    const uint64_t hi = 0x8080808080808080ull;
    while (i + 64 <= n) {
        tc_v64_ x = tc_vload64_(data + i);
        tc_v64_ sig = (tc_v64_)(x > tc_vsplat_(0x7F)) |
                      (tc_v64_)(x == tc_vsplat_('.')) |
                      (tc_v64_)(x == tc_vsplat_('!')) |
                      (tc_v64_)(x == tc_vsplat_('?')) |
                      (tc_v64_)(x == tc_vsplat_(0x0D)) |
                      (tc_v64_)(x == tc_vsplat_(0x0A));
        uint64_t ws[8];
        std::memcpy(ws, &sig, 64);
        for (int k = 0; k < 8; ++k) {
            uint64_t b = ws[k] & hi;
            if (b) {
                *pi = i + k * 8 + (__builtin_ctzll(b) >> 3);
                return;
            }
        }
        i += 64;
    }
    while (i < n && data[i] < 0x80 && data[i] != '.' && data[i] != '!' &&
           data[i] != '?' && data[i] != 0x0D && data[i] != 0x0A)
        ++i;
    *pi = i;
}

// Returns the number of sentence-break byte offsets written to out (≤ cap;
// call with out==nullptr to count). Semantics identical to
// ops/segment.py::sentence_breaks (SB1-SB11 on SB5-collapsed elements).
// One streaming pass — no rune buffers; the SB8 lookahead ("first
// significant class after here") is computed on demand and memoized, which
// stays O(n) because rescans always start past the previous answer.
}  // extern "C" — pause: emitters templated on offset width (int64/int32)
template <typename OutT>
static int64_t tc_sb_breaks_t_(const uint8_t* data, int64_t n,
                               const uint8_t* sb, OutT* out, int64_t cap) {
    if (n <= 0) return 0;
    const bool vec_ok = tc_sb_vec_check_(sb);
    int64_t count = 0;
    int term = 0;
    bool seen_sp = false;
    uint8_t pc = 255, prior = 255;  // element classes C[k-1], C[k-2]
    uint8_t prev_raw = 255;         // raw class of the previous rune
    int64_t sig_pos = -1;           // memoized lookahead: byte pos of the
    uint8_t sig_cls = 255;          //   next significant rune + its class
    bool first = true;
    int64_t i = 0;
    while (i < n) {
        // Skip tier: with no pending terminator, jump to the next byte
        // that can change the automaton; the two bytes before the landing
        // point re-seed the (prior, pc) pipeline exactly.
        if (term == 0 && vec_ok && (first || !sb_para(pc)) &&
            data[i] < 0x80 && data[i] != '.' && data[i] != '!' &&
            data[i] != '?' && data[i] != 0x0D && data[i] != 0x0A) {
            int64_t start = i;
            tc_sb_skip_(data, n, &i);
            prior = i - start >= 2 ? sb[data[i - 2]] : (first ? 255 : pc);
            pc = sb[data[i - 1]];
            prev_raw = pc;
            first = false;
            continue;
        }
        uint32_t r;
        int64_t used;
        uint8_t cc;
        if (data[i] < 0x80) {
            cc = sb[data[i]];
            used = 1;
        } else {
            used = tc_decode_one(data, i, n, &r);
            cc = sb[r];
        }
        // SB5 collapse: Extend/Format attach unless after sot/ParaSep
        if ((cc == SB_Extend || cc == SB_Format) && !first &&
            !sb_para(prev_raw)) {
            prev_raw = cc;
            i += used;
            continue;
        }
        prev_raw = cc;
        if (first) {
            first = false;
            pc = cc;
            i += used;
            continue;
        }
        // element transition pc -> cc at byte offset i
        if (pc == SB_CR && cc == SB_LF) {  // SB3
            term = 0;
            seen_sp = false;
        } else {
            if (sb_para(pc)) {  // SB4
                if (out && count < cap) out[count] = i;
                ++count;
                term = 0;
                seen_sp = false;
            } else if (term) {
                bool handled = false;
                if (cc == SB_Close && !seen_sp) {
                    handled = true;  // SB9
                } else if (cc == SB_Sp) {
                    seen_sp = true;  // SB9/SB10
                    handled = true;
                } else if (sb_para(cc) || cc == SB_SContinue ||
                           cc == SB_ATerm || cc == SB_STerm) {
                    handled = true;  // SB9/SB10/SB8a
                } else if (term == SB_ATerm && cc == SB_Lower) {
                    handled = true;  // SB8 degenerate: cur IS the Lower
                } else if (term == SB_ATerm && cc == SB_Upper && !seen_sp &&
                           pc == SB_ATerm &&
                           (prior == SB_Upper || prior == SB_Lower)) {
                    handled = true;  // SB7
                } else if (term == SB_ATerm && cc == SB_Numeric &&
                           pc == SB_ATerm) {
                    handled = true;  // SB6
                } else if (term == SB_ATerm && !sb_sig(cc)) {
                    // SB8: eventual Lower across a run of non-significant
                    if (sig_pos < i + used) {  // memo stale — rescan
                        int64_t j = i + used;
                        sig_cls = 255;
                        sig_pos = n;
                        while (j < n) {
                            uint32_t r2;
                            int64_t u2;
                            uint8_t c2;
                            if (data[j] < 0x80) {
                                c2 = sb[data[j]];
                                u2 = 1;
                            } else {
                                u2 = tc_decode_one(data, j, n, &r2);
                                c2 = sb[r2];
                            }
                            if (sb_sig(c2)) {
                                sig_pos = j;
                                sig_cls = c2;
                                break;
                            }
                            j += u2;
                        }
                    }
                    if (sig_cls == SB_Lower) handled = true;  // SB8
                }
                if (!handled) {  // SB11
                    if (out && count < cap) out[count] = i;
                    ++count;
                    term = 0;
                    seen_sp = false;
                }
            }
            if (cc == SB_ATerm || cc == SB_STerm) {
                term = cc;
                seen_sp = false;
            } else if (term && !(cc == SB_Close && !seen_sp) &&
                       cc != SB_Sp && !sb_para(cc)) {
                term = 0;
                seen_sp = false;
            }
        }
        prior = pc;
        pc = cc;
        i += used;
    }
    return count;
}

extern "C" {
int64_t tc_sb_breaks(const uint8_t* data, int64_t n, const uint8_t* sb,
                     int64_t* out, int64_t cap) {
    return tc_sb_breaks_t_(data, n, sb, out, cap);
}
// 32-bit offset export: halves the output-bandwidth bill of boundary
// materialization (the dominant cost at GB/s scan rates); n < 2^31 only.
int64_t tc_sb_breaks32(const uint8_t* data, int64_t n, const uint8_t* sb,
                       int32_t* out, int64_t cap) {
    return tc_sb_breaks_t_(data, n, sb, out, cap);
}
// (extern "C" stays open for the rest of the file)

// LB_VALUES order (ops/ucd.py):
enum {
    LB_XX = 0, LB_BK, LB_CR, LB_LF, LB_CM, LB_NL, LB_SG, LB_WJ, LB_ZW,
    LB_GL, LB_SP, LB_ZWJ, LB_B2, LB_BA, LB_BB, LB_HY, LB_CB, LB_CL, LB_CP,
    LB_EX, LB_IN, LB_NS, LB_OP, LB_QU, LB_IS, LB_NU, LB_PO, LB_PR, LB_SY,
    LB_AI, LB_AL, LB_CJ, LB_EB, LB_EM, LB_H2, LB_H3, LB_HL, LB_ID, LB_JL,
    LB_JT, LB_JV, LB_RI, LB_SA, LB_AK, LB_AP, LB_AS, LB_VF, LB_VI
};

// The full LB2-LB31 pair cascade with all stateful context as parameters.
// 0 = no break, 1 = opportunity, 2 = mandatory.
static int lb_decide(uint8_t pc, uint8_t cc, uint8_t prior, int sp_before,
                     int64_t ri_run, int zwj_prev) {
    if (pc == LB_CR && cc == LB_LF) return 0;
    if (pc == LB_BK || pc == LB_CR || pc == LB_LF || pc == LB_NL)
        return 2;  // LB4/LB5
    if (cc == LB_BK || cc == LB_CR || cc == LB_LF || cc == LB_NL)
        return 0;  // LB6
    if (cc == LB_SP || cc == LB_ZW) return 0;  // LB7
    if (pc == LB_ZW || (pc == LB_SP && sp_before == LB_ZW)) return 1;  // LB8
    if (zwj_prev) return 0;  // LB8a
    if (pc == LB_WJ || cc == LB_WJ) return 0;  // LB11
    if (pc == LB_GL) return 0;  // LB12
    if (cc == LB_GL && pc != LB_SP && pc != LB_BA && pc != LB_HY)
        return 0;  // LB12a
    if (cc == LB_CL || cc == LB_CP || cc == LB_EX || cc == LB_IS ||
        cc == LB_SY) return 0;  // LB13
    if (sp_before == LB_OP && (pc == LB_OP || pc == LB_SP)) return 0;  // LB14
    if (pc == LB_QU && cc == LB_OP) return 0;  // LB15
    if ((sp_before == LB_CL || sp_before == LB_CP) && cc == LB_NS &&
        (pc == LB_CL || pc == LB_CP || pc == LB_SP)) return 0;  // LB16
    if (sp_before == LB_B2 && cc == LB_B2 && (pc == LB_B2 || pc == LB_SP))
        return 0;  // LB17
    if (pc == LB_SP) return 1;  // LB18
    if (pc == LB_QU || cc == LB_QU) return 0;  // LB19
    if (pc == LB_CB || cc == LB_CB) return 1;  // LB20
    if (cc == LB_BA || cc == LB_HY || cc == LB_NS || pc == LB_BB)
        return 0;  // LB21
    if (prior == LB_HL && (pc == LB_HY || pc == LB_BA)) return 0;  // LB21a
    if (pc == LB_SY && cc == LB_HL) return 0;  // LB21b
    if (cc == LB_IN) return 0;  // LB22
    if (((pc == LB_AL || pc == LB_HL) && cc == LB_NU) ||
        (pc == LB_NU && (cc == LB_AL || cc == LB_HL))) return 0;  // LB23
    if ((pc == LB_PR && (cc == LB_ID || cc == LB_EB || cc == LB_EM)) ||
        ((pc == LB_ID || pc == LB_EB || pc == LB_EM) && cc == LB_PO))
        return 0;  // LB23a
    if (((pc == LB_PR || pc == LB_PO) && (cc == LB_AL || cc == LB_HL)) ||
        ((pc == LB_AL || pc == LB_HL) && (cc == LB_PR || cc == LB_PO)))
        return 0;  // LB24
    if (((pc == LB_CL || pc == LB_CP || pc == LB_NU) &&
         (cc == LB_PO || cc == LB_PR)) ||
        ((pc == LB_PO || pc == LB_PR) && (cc == LB_OP || cc == LB_NU)) ||
        ((pc == LB_HY || pc == LB_IS || pc == LB_NU || pc == LB_SY) &&
         cc == LB_NU)) return 0;  // LB25
    if (pc == LB_JL && (cc == LB_JL || cc == LB_JV || cc == LB_H2 ||
                        cc == LB_H3)) return 0;  // LB26
    if ((pc == LB_JV || pc == LB_H2) && (cc == LB_JV || cc == LB_JT))
        return 0;
    if ((pc == LB_JT || pc == LB_H3) && cc == LB_JT) return 0;
    if ((pc == LB_JL || pc == LB_JV || pc == LB_JT || pc == LB_H2 ||
         pc == LB_H3) && cc == LB_PO) return 0;  // LB27
    if (pc == LB_PR && (cc == LB_JL || cc == LB_JV || cc == LB_JT ||
                        cc == LB_H2 || cc == LB_H3)) return 0;
    if ((pc == LB_AL || pc == LB_HL) && (cc == LB_AL || cc == LB_HL))
        return 0;  // LB28
    if (pc == LB_IS && (cc == LB_AL || cc == LB_HL)) return 0;  // LB29
    if (((pc == LB_AL || pc == LB_HL || pc == LB_NU) && cc == LB_OP) ||
        (pc == LB_CP && (cc == LB_AL || cc == LB_HL || cc == LB_NU)))
        return 0;  // LB30
    if (pc == LB_RI && cc == LB_RI && (ri_run % 2) == 1) return 0;  // LB30a
    if (pc == LB_EB && cc == LB_EM) return 0;  // LB30b
    return 1;  // LB31
}

#define LB_NCLS 48

// Precomputed decisions for pairs whose outcome needs no history: when
// pc != SP, sp_before == pc by construction; pc in {HY, BA} (LB21a), the
// RI×RI pair (LB30a) and a raw ZWJ predecessor (LB8a) go the slow lane.
static uint8_t lb_pair_tab[LB_NCLS][LB_NCLS];
static bool lb_tab_ready = false;

static void lb_tab_init(void) {
    for (int p = 0; p < LB_NCLS; ++p)
        for (int c = 0; c < LB_NCLS; ++c)
            lb_pair_tab[p][c] =
                (uint8_t)lb_decide((uint8_t)p, (uint8_t)c, 255, p, 0, 0);
    lb_tab_ready = true;
}

// Break opportunities: writes byte offsets to out and 0/1 mandatory flags
// to mand, returns the count (≤ cap; out==nullptr counts only). Semantics
// identical to ops/segment.py::line_breaks (LB2-LB31 core cascade). One
// streaming pass: decode + LB1 + LB9/10 attachment inline; the common
// stateless pairs hit the precomputed table.
static inline bool tc_ascii_w_(uint8_t b) {
    uint8_t low = b | 0x20;
    return (low >= 'a' && low <= 'z') || (b >= '0' && b <= '9') || b == '_';
}

static inline uint8_t tc_lb_resolve_(const uint8_t* lb, uint8_t b) {
    uint8_t c = lb[b];
    if (c == LB_AI || c == LB_SG || c == LB_XX || c == LB_SA) return LB_AL;
    if (c == LB_CJ) return LB_NS;
    return c;
}

}  // extern "C" — pause: templated offset width
template <typename OutT>
static int64_t tc_lb_breaks_t_(const uint8_t* data, int64_t n,
                               const uint8_t* lb, OutT* out, uint8_t* mand,
                               int64_t cap) {
    if (n <= 0) return 0;
    if (!lb_tab_ready) lb_tab_init();
    // Vectorized tier legality: in runs of [A-Za-z0-9_ ] the whole cascade
    // reduces to "break opportunity exactly at a word start after spaces"
    // (LB7/18/23/28 — no break inside words, none before spaces, none
    // between letters and digits).  Verified against the caller's table and
    // the generated pair cascade so a UCD change disables the tier.
    bool vec_ok = tc_lb_resolve_(lb, 0x20) == LB_SP;
    for (int b = 0; b < 0x80 && vec_ok; ++b)
        if (tc_ascii_w_((uint8_t)b)) {
            uint8_t c = tc_lb_resolve_(lb, (uint8_t)b);
            vec_ok &= c == LB_AL || c == LB_NU;
        }
    vec_ok &= lb_pair_tab[LB_AL][LB_AL] == 0 && lb_pair_tab[LB_AL][LB_NU] == 0 &&
              lb_pair_tab[LB_NU][LB_AL] == 0 && lb_pair_tab[LB_NU][LB_NU] == 0 &&
              lb_pair_tab[LB_AL][LB_SP] == 0 && lb_pair_tab[LB_NU][LB_SP] == 0 &&
              lb_decide(LB_SP, LB_AL, LB_AL, LB_AL, 0, 0) == 1 &&
              lb_decide(LB_SP, LB_NU, LB_NU, LB_NU, 0, 0) == 1 &&
              lb_decide(LB_SP, LB_SP, LB_AL, LB_AL, 0, 0) == 0;
    int64_t count = 0;
    uint8_t pc = 255, prior = 255;  // element classes C[k-1], C[k-2]
    uint8_t prev_raw = 255;         // raw (post-LB1) class of previous rune
    int sp_before = 0;
    int64_t ri_run = 0;
    int64_t lb_vec_resume = 0;  // next position worth probing with the vector
    bool first = true;
    int64_t i = 0;
    while (i < n) {
        // ---- [A-Za-z0-9_ ] vector tier ----
        if (vec_ok && !first && i >= lb_vec_resume && data[i] < 0x80 &&
            prev_raw != LB_ZWJ) {
            uint8_t pb = data[i - 1];
            bool prevw = tc_ascii_w_(pb), prevs = pb == 0x20;
            bool curok = tc_ascii_w_(data[i]) || data[i] == 0x20;
            // A space run whose last non-space predecessor is OP/ZW/QU/...
            // carries LB8/14-17 context — only enter mid-space-run when the
            // context is a plain word.
            if (curok && (prevw || (prevs && (sp_before == LB_AL ||
                                              sp_before == LB_NU)))) {
                const uint64_t hi = 0x8080808080808080ull;
                int64_t start = i;
                while (i + 64 <= n) {
                    tc_v64_ x = tc_vload64_(data + i);
                    tc_v64_ xp = tc_vload64_(data + i - 1);
                    tc_v64_ W = tc_wb_vec_w_(x);
                    tc_v64_ S = (tc_v64_)(x == tc_vsplat_(0x20));
                    tc_v64_ badv = ~(W | S);
                    uint64_t ws[8];
                    std::memcpy(ws, &badv, 64);
                    uint64_t anybad = 0;
                    for (int k = 0; k < 8; ++k) anybad |= ws[k];
                    int64_t fb = 64;  // first non-tier byte (64 = clean)
                    if (anybad & hi)
                        for (int k = 0; k < 8; ++k)
                            if (ws[k] & hi) {
                                fb = k * 8 + (__builtin_ctzll(ws[k] & hi) >> 3);
                                break;
                            }
                    if (fb == 0) {
                        lb_vec_resume = i + 1;
                        break;
                    }
                    // opportunity exactly at word starts after a space
                    tc_v64_ B = W & (tc_v64_)(xp == tc_vsplat_(0x20));
                    std::memcpy(ws, &B, 64);
                    for (int k = 0; k < 8; ++k) {
                        uint64_t Bb = ws[k] & hi;
                        int64_t base = k * 8;
                        if (base >= fb) break;
                        if (fb - base < 8)
                            Bb &= (1ull << ((fb - base) * 8)) - 1;
                        if (out) {
                            while (Bb) {
                                int64_t pos =
                                    i + base + (__builtin_ctzll(Bb) >> 3);
                                Bb &= Bb - 1;
                                if (count < cap) {
                                    out[count] = pos;
                                    if (mand) mand[count] = 0;
                                }
                                ++count;
                            }
                        } else {
                            count += __builtin_popcountll(Bb);
                        }
                    }
                    i += fb;
                    if (fb < 64) {
                        lb_vec_resume = i + 1;
                        break;
                    }
                }
                if (i > start) {
                    prior = i - start >= 2 ? tc_lb_resolve_(lb, data[i - 2])
                                           : pc;
                    pc = data[i - 1] == 0x20 ? LB_SP
                                             : tc_lb_resolve_(lb, data[i - 1]);
                    prev_raw = pc;
                    // last non-space byte of the consumed region (or the
                    // pre-tier byte) refreshes the LB14-17 space context
                    int64_t j = i - 1;
                    while (j >= start - 1 && data[j] == 0x20) --j;
                    if (j >= start - 1)
                        sp_before = tc_lb_resolve_(lb, data[j]);
                    continue;
                }
            }
        }
        uint32_t r;
        int64_t used;
        uint8_t c;
        if (data[i] < 0x80) {
            c = lb[data[i]];
            used = 1;
        } else {
            used = tc_decode_one(data, i, n, &r);
            c = lb[r];
        }
        // LB1 resolution
        if (c == LB_AI || c == LB_SG || c == LB_XX || c == LB_SA) c = LB_AL;
        else if (c == LB_CJ) c = LB_NS;
        // LB9/LB10: attach CM/ZWJ to base (not after BK/CR/LF/NL/SP/ZW/sot)
        bool cmz = (c == LB_CM || c == LB_ZWJ);
        if (cmz && !first &&
            !(prev_raw == LB_BK || prev_raw == LB_CR || prev_raw == LB_LF ||
              prev_raw == LB_NL || prev_raw == LB_SP || prev_raw == LB_ZW)) {
            prev_raw = c;
            i += used;
            continue;
        }
        int zwj_prev = (prev_raw == LB_ZWJ);
        if (cmz) c = LB_AL;  // LB10 standalone (before raw tracking — the
                             // Python tier computes zwj_raw post-rewrite)
        prev_raw = c;
        if (first) {
            first = false;
            pc = c;
            if (pc != LB_SP) sp_before = pc;
            i += used;
            continue;
        }
        uint8_t cc = c;
        // state maintained exactly as the Python scan does at loop top
        if (pc != LB_SP) sp_before = pc;
        ri_run = (pc == LB_RI) ? ri_run + 1 : 0;
        int emit;
        if (pc != LB_SP && pc != LB_HY && pc != LB_BA && !zwj_prev &&
            !(pc == LB_RI && cc == LB_RI))
            emit = lb_pair_tab[pc][cc];
        else
            emit = lb_decide(pc, cc, prior, sp_before, ri_run, zwj_prev);
        if (emit) {
            if (out && count < cap) {
                out[count] = i;
                if (mand) mand[count] = (uint8_t)(emit == 2);
            }
            ++count;
        }
        prior = pc;
        pc = cc;
        i += used;
    }
    return count;
}

extern "C" {
int64_t tc_lb_breaks(const uint8_t* data, int64_t n, const uint8_t* lb,
                     int64_t* out, uint8_t* mand, int64_t cap) {
    return tc_lb_breaks_t_(data, n, lb, out, mand, cap);
}
int64_t tc_lb_breaks32(const uint8_t* data, int64_t n, const uint8_t* lb,
                       int32_t* out, uint8_t* mand, int64_t cap) {
    return tc_lb_breaks_t_(data, n, lb, out, mand, cap);
}
// (extern "C" stays open)

// GCB_VALUES order (ops/ucd.py):
enum {
    GB_Other = 0, GB_CR, GB_LF, GB_Control, GB_Extend, GB_ZWJ, GB_RI,
    GB_Prepend, GB_SpacingMark, GB_L, GB_V, GB_T, GB_LV, GB_LVT
};

// UAX-29 extended-grapheme-cluster boundaries (byte offsets, excluding 0
// and n). Streaming GB1-GB13/GB999; semantics identical to
// ops/segment.py::grapheme_breaks (the differential oracle). The mostly-
// ASCII fast path: Other×Other always breaks, so plain-text runs write
// one offset per byte without re-entering the automaton.
}  // extern "C" — pause: templated offset width
template <typename OutT>
static int64_t tc_gb_breaks_t_(const uint8_t* data, int64_t n,
                               const uint8_t* gcb, const uint8_t* ep,
                               OutT* out, int64_t cap) {
    if (n <= 0) return 0;
    bool gb_vec_ok = true;  // every printable-ASCII byte must be plain Other
    for (int b = 0x20; b <= 0x7E; ++b)
        gb_vec_ok &= gcb[b] == GB_Other && ep[b] == 0;
    int64_t count = 0;
    uint32_t r;
    int64_t i = tc_decode_one(data, 0, n, &r);
    uint8_t pc = gcb[r];
    // GB11 chain: lnee_incl = ExtPict of nearest non-Extend at/before prev;
    // lnee_prev = same, strictly before prev.
    bool lnee_prev = false, lnee_incl = ep[r] != 0;
    int64_t ri_run = pc == GB_RI ? 1 : 0;
    while (i < n) {
        if (data[i] < 0x80 && pc == GB_Other && gcb[data[i]] == GB_Other) {
            // Printable-ASCII blocks are all GB_Other (GB999: boundary at
            // every byte) — one range check per 64 bytes, then a straight
            // auto-vectorizable offset fill.  Verified against the
            // caller's table once per call via gb_vec_ok.
            while (gb_vec_ok && i + 64 <= n) {
                tc_v64_ x = tc_vload64_(data + i);
                tc_v64_ bad = (tc_v64_)(x < tc_vsplat_(0x20)) |
                              (tc_v64_)(x > tc_vsplat_(0x7E));
                uint64_t bs[8];
                std::memcpy(bs, &bad, 64);
                uint64_t any = 0;
                for (int k = 0; k < 8; ++k) any |= bs[k];
                if (any & 0x8080808080808080ull) break;
                if (out && count + 64 <= cap) {
                    for (int t = 0; t < 64; ++t) out[count + t] = i + t;
                } else if (out) {
                    for (int t = 0; t < 64 && count + t < cap; ++t)
                        out[count + t] = i + t;
                }
                count += 64;
                i += 64;
            }
            // scalar tail of the ASCII Other run
            while (i < n && data[i] < 0x80 && gcb[data[i]] == GB_Other) {
                if (out && count < cap) out[count] = i;
                ++count;
                ++i;
            }
            lnee_prev = false;
            lnee_incl = false;
            ri_run = 0;
            continue;
        }
        int64_t used = tc_decode_one(data, i, n, &r);
        uint8_t cc = gcb[r];
        bool cep = ep[r] != 0;
        bool brk;
        if (pc == GB_CR && cc == GB_LF) brk = false;  // GB3
        else if (pc == GB_Control || pc == GB_CR || pc == GB_LF ||
                 cc == GB_Control || cc == GB_CR || cc == GB_LF)
            brk = true;  // GB4/GB5
        else {
            bool nb = false;
            nb |= pc == GB_L && (cc == GB_L || cc == GB_V || cc == GB_LV ||
                                 cc == GB_LVT);               // GB6
            nb |= (pc == GB_LV || pc == GB_V) &&
                  (cc == GB_V || cc == GB_T);                 // GB7
            nb |= (pc == GB_LVT || pc == GB_T) && cc == GB_T; // GB8
            nb |= cc == GB_Extend || cc == GB_ZWJ ||
                  cc == GB_SpacingMark;                       // GB9/9a
            nb |= pc == GB_Prepend;                           // GB9b
            nb |= pc == GB_ZWJ && cep && lnee_prev;           // GB11
            nb |= cc == GB_RI && pc == GB_RI && (ri_run & 1); // GB12/13
            brk = !nb;
        }
        if (brk) {
            if (out && count < cap) out[count] = i;
            ++count;
        }
        ri_run = cc == GB_RI ? (pc == GB_RI ? ri_run + 1 : 1) : 0;
        lnee_prev = lnee_incl;
        if (cc != GB_Extend) lnee_incl = cep;
        pc = cc;
        i += used;
    }
    return count;
}

extern "C" {
int64_t tc_gb_breaks(const uint8_t* data, int64_t n, const uint8_t* gcb,
                     const uint8_t* ep, int64_t* out, int64_t cap) {
    return tc_gb_breaks_t_(data, n, gcb, ep, out, cap);
}
int64_t tc_gb_breaks32(const uint8_t* data, int64_t n, const uint8_t* gcb,
                       const uint8_t* ep, int32_t* out, int64_t cap) {
    return tc_gb_breaks_t_(data, n, gcb, ep, out, cap);
}
// (extern "C" stays open)

// WB_VALUES order (ops/ucd.py):
enum {
    WB_Other = 0, WB_CR, WB_LF, WB_Newline, WB_Extend, WB_ZWJ, WB_RI,
    WB_Format, WB_Katakana, WB_Hebrew_Letter, WB_ALetter, WB_Single_Quote,
    WB_Double_Quote, WB_MidNumLet, WB_MidLetter, WB_MidNum, WB_Numeric,
    WB_ExtendNumLet, WB_WSegSpace
};

static inline bool wb_ahl(uint8_t c) {
    return c == WB_ALetter || c == WB_Hebrew_Letter;
}
static inline bool wb_midl(uint8_t c) {
    return c == WB_MidLetter || c == WB_MidNumLet || c == WB_Single_Quote;
}
static inline bool wb_midn(uint8_t c) {
    return c == WB_MidNum || c == WB_MidNumLet || c == WB_Single_Quote;
}
static inline bool wb_sep(uint8_t c) {
    return c == WB_CR || c == WB_LF || c == WB_Newline;
}

// Break between elements p1 and c0 (classes p2 p1 c0 nx on the WB4-
// collapsed sequence)?  rp_zwj/ep0: raw-rune ZWJ adjacency + ExtPict of
// c0's first rune (WB3c);  ri_odd: c0 is the second flag of an RI pair.
static inline bool wb_boundary_(uint8_t p2, uint8_t p1, uint8_t c0,
                                uint8_t nx, bool rp_zwj, bool ep0,
                                bool ri_odd) {
    if (p1 == WB_CR && c0 == WB_LF) return false;      // WB3
    if (wb_sep(p1) || wb_sep(c0)) return true;         // WB3a/3b
    if (rp_zwj && ep0) return false;                   // WB3c
    if (p1 == WB_WSegSpace && c0 == WB_WSegSpace) return false;  // WB3d
    if (wb_ahl(p1) && wb_ahl(c0)) return false;        // WB5
    if (wb_ahl(p1) && wb_midl(c0) && wb_ahl(nx)) return false;   // WB6
    if (wb_ahl(p2) && wb_midl(p1) && wb_ahl(c0)) return false;   // WB7
    if (p1 == WB_Hebrew_Letter && c0 == WB_Single_Quote) return false;
    if (p1 == WB_Hebrew_Letter && c0 == WB_Double_Quote &&
        nx == WB_Hebrew_Letter) return false;          // WB7b
    if (p2 == WB_Hebrew_Letter && p1 == WB_Double_Quote &&
        c0 == WB_Hebrew_Letter) return false;          // WB7c
    if (p1 == WB_Numeric && c0 == WB_Numeric) return false;      // WB8
    if (wb_ahl(p1) && c0 == WB_Numeric) return false;  // WB9
    if (p1 == WB_Numeric && wb_ahl(c0)) return false;  // WB10
    if (p2 == WB_Numeric && wb_midn(p1) && c0 == WB_Numeric) return false;
    if (p1 == WB_Numeric && wb_midn(c0) && nx == WB_Numeric) return false;
    if (p1 == WB_Katakana && c0 == WB_Katakana) return false;    // WB13
    if ((wb_ahl(p1) || p1 == WB_Numeric || p1 == WB_Katakana ||
         p1 == WB_ExtendNumLet) && c0 == WB_ExtendNumLet) return false;
    if (p1 == WB_ExtendNumLet &&
        (wb_ahl(c0) || c0 == WB_Numeric || c0 == WB_Katakana)) return false;
    if (p1 == WB_RI && c0 == WB_RI && ri_odd) return false;      // WB15/16
    return true;  // WB999
}

// Precomputed (p2, p1, c0, nx) break table for the common case (no raw-
// ZWJ adjacency, no RI pair): the 20-branch rule cascade becomes one L1
// load.  Class 19 doubles as the "none" sentinel (255 maps to it).
static uint8_t wb_tab_[20 * 20 * 20 * 20];
static bool wb_tab_ready_ = false;
static inline uint8_t wb_cls20_(uint8_t c) { return c > 19 ? 19 : c; }

// "Simple" classes: every WB rule that involves them reads at most the two
// classes flanking the boundary — no lookahead (WB6/7b/12), no look-behind-2
// (WB7/7c/11), no raw-rune state (WB3c ZWJ, WB15/16 RI, WB4 attach).  ASCII
// text consists entirely of simple classes except ' " . : , ; — which is
// what makes the fast tier below pay: boundaries between simple elements
// come from one 19x19 pair table.
static bool wb_simple_[19];
static uint8_t wb_pair_[19 * 19];
static void wb_tab_init_(void) {
    for (int p2 = 0; p2 < 20; ++p2)
        for (int p1 = 0; p1 < 20; ++p1)
            for (int c0 = 0; c0 < 20; ++c0)
                for (int nx = 0; nx < 20; ++nx)
                    wb_tab_[((p2 * 20 + p1) * 20 + c0) * 20 + nx] =
                        wb_boundary_((uint8_t)(p2 == 19 ? 255 : p2),
                                     (uint8_t)(p1 == 19 ? 255 : p1),
                                     (uint8_t)(c0 == 19 ? 255 : c0),
                                     (uint8_t)(nx == 19 ? 255 : nx),
                                     false, false, false);
    for (int c = 0; c < 19; ++c)
        wb_simple_[c] = !(c == WB_Extend || c == WB_ZWJ || c == WB_RI ||
                          c == WB_Format || c == WB_Single_Quote ||
                          c == WB_Double_Quote || c == WB_MidNumLet ||
                          c == WB_MidLetter || c == WB_MidNum);
    for (int a = 0; a < 19; ++a)
        for (int b = 0; b < 19; ++b)
            wb_pair_[a * 19 + b] = wb_boundary_(255, (uint8_t)a, (uint8_t)b,
                                                255, false, false, false);
    wb_tab_ready_ = true;
}

// ---- vectorized ASCII tier for word segmentation ----
//
// In pure-ASCII text containing none of the context-sensitive bytes
// (quotes, mid-punctuation ". : , ;", CR/LF/VT/FF), the WB rules collapse
// to three merged byte classes: W = [A-Za-z0-9_] (letters, digits and
// ExtendNumLet never break against each other — WB5/8/9/10/13a/13b),
// SP = 0x20 (WSegSpace runs never break internally — WB3d), O = every
// other byte (Other breaks against everything — WB999).  Boundaries are
// then exactly: W-run starts, SP-run starts, and every O byte — one pass
// of mask algebra per 64-byte block in the 0x80-per-byte SWAR domain.
//
// The classification is verified against the caller-supplied class table
// once per call (tc_wb_vec_check_): if a future UCD moves an ASCII byte,
// the tier disables itself and the element pipeline handles everything.

static inline bool tc_wb_vec_check_(const uint8_t* wb) {
    for (int b = 0; b < 0x80; ++b) {
        bool w = (b >= 'A' && b <= 'Z') || (b >= 'a' && b <= 'z') ||
                 (b >= '0' && b <= '9') || b == '_';
        bool sp = b == 0x20;
        bool special = b == '"' || b == '\'' || b == ',' || b == '.' ||
                       b == ':' || b == ';' ||
                       (b >= 0x0A && b <= 0x0D);
        if (special) continue;  // never vectorized; the pipeline owns these
        uint8_t c = wb[b];
        if (w ? !(c == WB_ALetter || c == WB_Numeric || c == WB_ExtendNumLet)
              : sp ? c != WB_WSegSpace : c != WB_Other)
            return false;
    }
    return true;
}

}  // extern "C" — pause: templated offset width

// mask → positions-of-set-bits expansion table (boundary emit fast path)
static struct Tc_Idx8_ {
    uint8_t t[256][8];
    Tc_Idx8_() {
        for (int m = 0; m < 256; ++m) {
            int j = 0;
            for (int b = 0; b < 8; ++b)
                if (m & (1 << b)) t[m][j++] = (uint8_t)b;
            for (; j < 8; ++j) t[m][j] = 0;
        }
    }
} tc_idx8_s_;
#define tc_idx8_ tc_idx8_s_.t

template <typename OutT>
static inline bool tc_wb_vector_stage_(const uint8_t* data, int64_t n,
                                       int64_t* pi, int64_t* pcount,
                                       OutT* out, int64_t cap,
                                       int64_t* resume) {
    int64_t i = *pi, count = *pcount;
    bool progressed = false;
    const uint64_t hi = 0x8080808080808080ull;
    while (i + 64 <= n) {
        tc_v64_ x = tc_vload64_(data + i);
        tc_v64_ xp = tc_vload64_(data + i - 1);  // prev-byte context for free
        tc_v64_ bad = (tc_v64_)(x > tc_vsplat_(0x7F)) |
                      (tc_v64_)((x >= tc_vsplat_(0x0A)) & (x <= tc_vsplat_(0x0D))) |
                      (tc_v64_)(x == tc_vsplat_('"')) |
                      (tc_v64_)(x == tc_vsplat_('\'')) |
                      (tc_v64_)(x == tc_vsplat_(',')) |
                      (tc_v64_)(x == tc_vsplat_('.')) |
                      (tc_v64_)(x == tc_vsplat_(':')) |
                      (tc_v64_)(x == tc_vsplat_(';'));
        uint64_t bs[8];
        std::memcpy(bs, &bad, 64);
        uint64_t anybad = 0;
        for (int k = 0; k < 8; ++k) anybad |= bs[k];
        int64_t fb = 64;  // first bad byte in this block (64 = clean)
        if (anybad & hi)
            for (int k = 0; k < 8; ++k)
                if (bs[k] & hi) {
                    fb = k * 8 + (__builtin_ctzll(bs[k] & hi) >> 3);
                    break;
                }
        if (fb == 0) {
            *resume = i + 1;  // no clean prefix; don't re-probe per element
            break;
        }
        tc_v64_ W = tc_wb_vec_w_(x), Wp = tc_wb_vec_w_(xp);
        tc_v64_ S = (tc_v64_)(x == tc_vsplat_(0x20));
        tc_v64_ Sp = (tc_v64_)(xp == tc_vsplat_(0x20));
        // Boundary = W-run start | SP-run start | every O byte (bad bytes
        // never survive the fb cut, which keeps O honest).
        tc_v64_ B = (W & ~Wp) | (S & ~Sp) | ~(W | S);
        uint64_t ws[8];
        std::memcpy(ws, &B, 64);
        for (int k = 0; k < 8; ++k) {
            uint64_t Bb = ws[k] & hi;
            int64_t base = k * 8;
            if (base >= fb) break;
            if (fb - base < 8)  // partial word: keep bits below fb only
                Bb &= (1ull << ((fb - base) * 8)) - 1;
            if (out) {
                // Compress the 8 byte-MSB flags to a bitmask, then expand
                // via a 256-entry delta table: 8 unconditional stores per
                // 8 input bytes, no per-boundary branch (the ctz loop it
                // replaces dominated export mode at ~1 boundary / 3 bytes).
                unsigned m = (unsigned)((Bb * 0x0002040810204081ull) >> 56);
                const uint8_t* d = tc_idx8_[m];
                int c8 = __builtin_popcount(m);
                if (count + 8 <= cap) {
                    int64_t p0 = i + base;
                    for (int t = 0; t < 8; ++t)
                        out[count + t] = (OutT)(p0 + d[t]);
                } else {
                    for (int t = 0; t < c8; ++t)
                        if (count + t < cap)
                            out[count + t] = (OutT)(i + base + d[t]);
                }
                count += c8;
            } else {  // count/drain mode: popcount, no enumeration
                count += __builtin_popcountll(Bb);
            }
        }
        i += fb;
        progressed = true;
        if (fb < 64) {
            *resume = i + 1;  // stop at the special; element tier takes over
            break;
        }
    }
    *pi = i;
    *pcount = count;
    return progressed;
}

// UAX-29 word boundaries (byte offsets of boundary element starts,
// excluding 0 and n). One streaming pass with a one-element lookahead
// pipeline; semantics identical to ops/segment.py::word_breaks. Runs of
// one same class in {ALetter, Hebrew_Letter, Numeric, Katakana,
// WSegSpace} collapse without re-entering the pair logic (no rule breaks
// inside such a run, and p2 == p1 == class afterwards either way).
static inline bool wb_decide_(uint8_t p2, uint8_t p1, uint8_t c0, uint8_t nx,
                              bool rp_zwj0, bool ep0, int64_t ri_run) {
    if (rp_zwj0 || (p1 == WB_RI && c0 == WB_RI))  // rare stateful rules
        return wb_boundary_(p2, p1, c0, nx, rp_zwj0, ep0,
                            p1 == WB_RI && c0 == WB_RI && (ri_run & 1));
    return wb_tab_[((wb_cls20_(p2) * 20 + wb_cls20_(p1)) * 20 +
                    wb_cls20_(c0)) * 20 + wb_cls20_(nx)] != 0;
}

template <typename OutT>
static int64_t tc_wb_breaks_t_(const uint8_t* data, int64_t n,
                               const uint8_t* wb, const uint8_t* ep,
                               OutT* out, int64_t cap) {
    if (n <= 0) return 0;
    if (!wb_tab_ready_) wb_tab_init_();
    const bool vec_ok = tc_wb_vec_check_(wb);
    int64_t vec_resume = 0;  // next position worth probing with the vector
    int64_t count = 0;
    // pipeline of collapsed elements: classes p2, p1, c0; byte offset of
    // c0; WB3c context of c0; RI run ending at p1.
    uint8_t p2 = 255, p1 = 255, c0 = 255;
    int64_t off0 = -1;
    bool rp_zwj0 = false, ep0 = false;
    int64_t ri_run = 0;
    bool have_c0 = false;
    uint8_t prev_raw = 255;  // raw class of the previous rune
    int64_t i = 0;
    while (i < n) {
        // ---- ASCII-simple fast tier: while the pipeline context and the
        // upcoming bytes are all simple classes, boundaries need no
        // lookahead — one flush of the pending (p1, c0) decision, then one
        // 19x19 pair-table load per element.  Exits (leaving the pipeline
        // consistent: boundary at off0 already emitted, p1 = 255 marks it)
        // on any complex class or non-ASCII byte.
        if (have_c0 && c0 < 19 && wb_simple_[c0] && !rp_zwj0 &&
            data[i] < 0x80 && wb_simple_[wb[data[i]]]) {
            do {
                // Once the pending decision is flushed (p1 == 255) the
                // vector stage takes whole clean 64-byte blocks; the last
                // consumed byte's class (always simple by construction)
                // re-seeds the element pipeline.  The stage derives its
                // run-continuation context from the BYTE before i, so the
                // previous rune must be ASCII-simple (an attached ZWJ or a
                // multi-byte element would make that byte lie about c0).
                if (p1 == 255 && vec_ok && i >= vec_resume && i + 64 <= n &&
                    data[i - 1] < 0x80 && prev_raw < 19 &&
                    wb_simple_[prev_raw] &&
                    tc_wb_vector_stage_(data, n, &i, &count, out, cap,
                                        &vec_resume)) {
                    c0 = wb[data[i - 1]];
                    off0 = i - 1;
                    ep0 = false;
                    rp_zwj0 = false;
                    prev_raw = c0;
                    if (i >= n || data[i] >= 0x80) break;
                }
                uint8_t cc = wb[data[i]];
                if (!wb_simple_[cc]) break;
                int64_t at = i++;
                // Collapse a same-class run only when the class does not
                // break against itself (Other x Other DOES break, WB999 —
                // those runs must surface every internal boundary).
                if (!wb_pair_[cc * 19 + cc])
                    while (i < n && data[i] < 0x80 && wb[data[i]] == cc) ++i;
                if (p1 != 255) {  // flush pending (p1, c0), lookahead = cc
                    if (wb_decide_(p2, p1, c0, cc, rp_zwj0, ep0, ri_run)) {
                        if (out && count < cap) out[count] = off0;
                        ++count;
                    }
                    p1 = 255;
                    p2 = 255;
                    ri_run = 0;
                }
                if (wb_pair_[c0 * 19 + cc]) {  // (c0, cc): lookahead-free
                    if (out && count < cap) out[count] = at;
                    ++count;
                }
                c0 = cc;
                off0 = at;
                ep0 = false;
                rp_zwj0 = false;
                prev_raw = cc;
            } while (i < n && data[i] < 0x80);
            if (i >= n) break;
            continue;  // complex class / non-ASCII: full pipeline resumes
        }
        uint32_t r;
        int64_t used;
        if (data[i] < 0x80) {
            r = data[i];
            used = 1;
        } else {
            used = tc_decode_one(data, i, n, &r);
        }
        uint8_t cc = wb[r];
        // WB4: Extend/Format/ZWJ attach unless after sot / CR / LF / NL
        if ((cc == WB_Extend || cc == WB_Format || cc == WB_ZWJ) &&
            prev_raw != 255 && !wb_sep(prev_raw)) {
            prev_raw = cc;
            i += used;
            continue;
        }
        // element starts at byte i with class cc
        bool rp_zwj = prev_raw == WB_ZWJ;
        bool epc = ep[r] != 0;
        prev_raw = cc;
        int64_t at = i;
        i += used;
        // same-class run collapse (ASCII inner loop): gobble runes whose
        // element class repeats; each absorbed element shifts p2=p1=cc.
        bool collapsible = cc == WB_ALetter || cc == WB_Hebrew_Letter ||
                           cc == WB_Numeric || cc == WB_Katakana ||
                           cc == WB_WSegSpace;
        if (have_c0 && c0 == cc && collapsible && !rp_zwj0 && !rp_zwj) {
            // decide the pending boundary (p1 vs c0) with next = cc, then
            // absorb the run: boundaries inside it never break.
            if (p1 != 255) {
                if (wb_decide_(p2, p1, c0, cc, rp_zwj0, ep0, ri_run)) {
                    if (out && count < cap) out[count] = off0;
                    ++count;
                }
            }
            p2 = cc;
            p1 = cc;
            ri_run = 0;
            while (i < n && data[i] < 0x80 && wb[data[i]] == cc) ++i;
            // the run's last element becomes c0 (offset = unknown start of
            // the final rune — but boundaries only ever fire at element
            // starts AFTER c0, so off0 is never emitted for run members;
            // use `at` of the LAST absorbed element: re-derive cheaply.
            c0 = cc;
            off0 = at;  // placeholder; a run never breaks internally and
                        // the next boundary uses the NEXT element's offset
            rp_zwj0 = false;
            ep0 = epc;
            have_c0 = true;
            prev_raw = cc;
            continue;
        }
        if (have_c0) {
            if (p1 != 255) {
                if (wb_decide_(p2, p1, c0, cc, rp_zwj0, ep0, ri_run)) {
                    if (out && count < cap) out[count] = off0;
                    ++count;
                }
            }
            ri_run = c0 == WB_RI ? (p1 == WB_RI ? ri_run + 1 : 1) : 0;
            p2 = p1;
            p1 = c0;
        }
        c0 = cc;
        off0 = at;
        rp_zwj0 = rp_zwj;
        ep0 = epc;
        have_c0 = true;
    }
    if (have_c0 && p1 != 255) {  // final boundary: next = none
        if (wb_decide_(p2, p1, c0, 255, rp_zwj0, ep0, ri_run)) {
            if (out && count < cap) out[count] = off0;
            ++count;
        }
    }
    return count;
}

extern "C" {
int64_t tc_wb_breaks(const uint8_t* data, int64_t n, const uint8_t* wb,
                     const uint8_t* ep, int64_t* out, int64_t cap) {
    return tc_wb_breaks_t_(data, n, wb, ep, out, cap);
}
int64_t tc_wb_breaks32(const uint8_t* data, int64_t n, const uint8_t* wb,
                       const uint8_t* ep, int32_t* out, int64_t cap) {
    return tc_wb_breaks_t_(data, n, wb, ep, out, cap);
}
// (extern "C" stays open)

// ---- 64-bit AES-mixing hash (the reference's sz_hash contract) ----
//
// Host-tier production path: same dual-state construction the Python/numpy
// oracle in ops/hash.py implements from the reference's published spec
// (README.md:758-814, hash/serial.h:297-599) — an AES lane advanced one
// AESENC round per 16-byte block plus a shuffle+add u64 "sum" lane, short
// (<=64 B) 128-bit and long 512-bit 4-lane variants, the final block
// deferred to finalization.  AES-NI when the build has it; a scalar
// FIPS-197 round otherwise.  Bit-identical to the golden vectors either
// way (tests/golden/hash_vectors.json).

static const uint8_t tc_aes_sbox_[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16,
};

// Sum-lane byte permutation (aHash's, hash/serial.h:220-231).
static const uint8_t tc_hash_shuf_[16] = {4, 11, 9,  6, 8, 13, 15, 5,
                                          14, 3, 1, 12, 0, 7,  10, 2};

// 1024 bits of pi (BBP hex digits; public constant, README.md:766-773).
static const uint64_t tc_hash_pi_[16] = {
    0x243F6A8885A308D3ull, 0x13198A2E03707344ull, 0xA4093822299F31D0ull,
    0x082EFA98EC4E6C89ull, 0x452821E638D01377ull, 0xBE5466CF34E90C6Cull,
    0xC0AC29B7C97C50DDull, 0x3F84D5B5B5470917ull, 0x9216D5D98979FB1Bull,
    0xD1310BA698DFB5ACull, 0x2FFD72DBD01ADFB7ull, 0xB8E1AFED6A267E96ull,
    0xBA7C9045F12C7F99ull, 0x24A19947B3916CF7ull, 0x0801F2E2858EFC16ull,
    0x636920D871574E69ull,
};

struct tc_b16_ { uint8_t b[16]; };

static inline void tc_aesenc_(tc_b16_& s, const uint8_t* key) {
#ifdef TC_AESNI
    __m128i v = _mm_loadu_si128((const __m128i*)s.b);
    __m128i k = _mm_loadu_si128((const __m128i*)key);
    _mm_storeu_si128((__m128i*)s.b, _mm_aesenc_si128(v, k));
#else
    // SubBytes∘ShiftRows: output byte p takes SBOX[in[(5p) mod 16]].
    uint8_t t[16];
    for (int p = 0; p < 16; ++p) t[p] = tc_aes_sbox_[s.b[(5 * p) & 15]];
    // MixColumns over each 4-byte column, then AddRoundKey.
    for (int c = 0; c < 4; ++c) {
        const uint8_t* col = t + 4 * c;
        uint8_t x = (uint8_t)(col[0] ^ col[1] ^ col[2] ^ col[3]);
        for (int r = 0; r < 4; ++r) {
            uint8_t ab = (uint8_t)(col[r] ^ col[(r + 1) & 3]);
            uint8_t dbl = (uint8_t)((uint8_t)(ab << 1) ^ ((ab >> 7) * 0x1B));
            s.b[4 * c + r] = (uint8_t)(col[r] ^ x ^ dbl ^ key[4 * c + r]);
        }
    }
#endif
}

static inline void tc_sumstep_(tc_b16_& s, const uint8_t* data) {
#ifdef TC_AESNI
    __m128i v = _mm_loadu_si128((const __m128i*)s.b);
    __m128i sh = _mm_loadu_si128((const __m128i*)tc_hash_shuf_);
    __m128i d = _mm_loadu_si128((const __m128i*)data);
    _mm_storeu_si128((__m128i*)s.b,
                     _mm_add_epi64(_mm_shuffle_epi8(v, sh), d));
#else
    uint8_t t[16];
    for (int i = 0; i < 16; ++i) t[i] = s.b[tc_hash_shuf_[i]];
    uint64_t a0, a1, d0, d1;
    std::memcpy(&a0, t, 8);
    std::memcpy(&a1, t + 8, 8);
    std::memcpy(&d0, data, 8);
    std::memcpy(&d1, data + 8, 8);
    a0 += d0;
    a1 += d1;
    std::memcpy(s.b, &a0, 8);
    std::memcpy(s.b + 8, &a1, 8);
#endif
}

static inline tc_b16_ tc_u64x2_(uint64_t lo, uint64_t hi) {
    tc_b16_ r;
    std::memcpy(r.b, &lo, 8);
    std::memcpy(r.b + 8, &hi, 8);
    return r;
}

static inline uint64_t tc_lo64_(const tc_b16_& s) {
    uint64_t v;
    std::memcpy(&v, s.b, 8);
    return v;
}

uint64_t tc_hash(const uint8_t* data, int64_t n, uint64_t seed) {
    tc_b16_ kwl = tc_u64x2_(seed + (uint64_t)n, seed);
    if (n <= 64) {
        tc_b16_ aes = tc_u64x2_(seed ^ tc_hash_pi_[0], seed ^ tc_hash_pi_[1]);
        tc_b16_ sum = tc_u64x2_(seed ^ tc_hash_pi_[8], seed ^ tc_hash_pi_[9]);
        uint8_t padded[64] = {0};
        if (n > 0) std::memcpy(padded, data, (size_t)n);
        int nb = n <= 16 ? 1 : (int)((n + 15) / 16);
        for (int b = 0; b < nb; ++b) {
            tc_aesenc_(aes, padded + 16 * b);
            tc_sumstep_(sum, padded + 16 * b);
        }
        tc_b16_ mixed = sum;
        tc_aesenc_(mixed, aes.b);
        tc_b16_ r = mixed;
        tc_aesenc_(r, kwl.b);
        tc_aesenc_(r, mixed.b);
        return tc_lo64_(r);
    }
    tc_b16_ aes[4], sum[4];
    for (int l = 0; l < 4; ++l) {
        aes[l] = tc_u64x2_(seed ^ tc_hash_pi_[2 * l],
                           seed ^ tc_hash_pi_[2 * l + 1]);
        sum[l] = tc_u64x2_(seed ^ tc_hash_pi_[8 + 2 * l],
                           seed ^ tc_hash_pi_[9 + 2 * l]);
    }
    int64_t off = 0;
    while (off + 64 < n) {  // final (possibly full) block deferred
        for (int l = 0; l < 4; ++l) {
            tc_aesenc_(aes[l], data + off + 16 * l);
            tc_sumstep_(sum[l], data + off + 16 * l);
        }
        off += 64;
    }
    uint8_t ins[64] = {0};
    std::memcpy(ins, data + off, (size_t)(n - off));
    tc_b16_ mixed[4];
    for (int l = 0; l < 4; ++l) {
        tc_aesenc_(aes[l], ins + 16 * l);
        tc_sumstep_(sum[l], ins + 16 * l);
        mixed[l] = sum[l];
        tc_aesenc_(mixed[l], aes[l].b);
    }
    tc_aesenc_(mixed[0], mixed[1].b);
    tc_aesenc_(mixed[2], mixed[3].b);
    tc_aesenc_(mixed[0], mixed[2].b);
    tc_b16_ r = mixed[0];
    tc_aesenc_(r, kwl.b);
    tc_aesenc_(r, mixed[0].b);
    return tc_lo64_(r);
}

// One hash per tape entry (the host-bytes-in batch path of the hashing
// engines; device tier is only worth the link crossing for resident data).
void tc_hash_batch(const uint8_t* data, const int64_t* offsets, int64_t count,
                   uint64_t seed, uint64_t* out) {
    tc_parallel_tape_(offsets, count, (int64_t)1 << 20,
                      [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i)
            out[i] =
                tc_hash(data + offsets[i], offsets[i + 1] - offsets[i], seed);
    });
}

// Hashes over (start, end) spans of one buffer — the zero-copy Strs path:
// spans may overlap or sit in any order, so no offsets discipline.
void tc_hash_bounds(const uint8_t* data, const int64_t* starts,
                    const int64_t* ends, int64_t count, uint64_t seed,
                    uint64_t* out) {
    tc_parallel_n_(count, (int64_t)4096, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i)
            out[i] = tc_hash(data + starts[i], ends[i] - starts[i], seed);
    });
}

// AES-CTR pseudo-random fill (sz_fill_random, hash/serial.h:953-968):
// block i encrypts [nonce+i, nonce+i] under key nonce^PI[2(i%4) .. +1].
void tc_fill_random(uint8_t* out, int64_t n, uint64_t nonce) {
    int64_t nb = (n + 15) / 16;
    for (int64_t i = 0; i < nb; ++i) {
        uint64_t ctr = nonce + (uint64_t)i;
        tc_b16_ blk = tc_u64x2_(ctr, ctr);
        int pi = (int)(i & 3) * 2;
        tc_b16_ key = tc_u64x2_(nonce ^ tc_hash_pi_[pi],
                                nonce ^ tc_hash_pi_[pi + 1]);
        tc_aesenc_(blk, key.b);
        int64_t take = n - 16 * i < 16 ? n - 16 * i : 16;
        std::memcpy(out + 16 * i, blk.b, (size_t)take);
    }
}

// ---- SHA-256 (FIPS 180-4) ----
//
// Same derivation discipline as ops/sha256.py: H0/K computed from integer
// square/cube roots of the first primes at first use, not pasted.  SHA-NI
// two-rounds-at-a-time when available, scalar compression otherwise.

static uint32_t tc_sha_h0_[8];
static uint32_t tc_sha_k_[64];
static bool tc_sha_ready_ = false;

static uint64_t tc_iroot_(unsigned __int128 x, int k) {
    uint64_t lo = 0, hi = (uint64_t)1 << 42;
    while (lo + 1 < hi) {  // floor k-th root by binary search
        uint64_t mid = lo + (hi - lo) / 2;
        unsigned __int128 p = 1;
        bool over = false;
        for (int i = 0; i < k; ++i) {
            p *= mid;
            if (p > x) { over = true; break; }
        }
        if (over) hi = mid; else lo = mid;
    }
    return lo;
}

static void tc_sha_init_(void) {
    if (tc_sha_ready_) return;
    int primes[64], np = 0;
    for (int c = 2; np < 64; ++c) {
        bool ok = true;
        for (int j = 0; j < np && primes[j] * primes[j] <= c; ++j)
            if (c % primes[j] == 0) { ok = false; break; }
        if (ok) primes[np++] = c;
    }
    for (int i = 0; i < 8; ++i)
        tc_sha_h0_[i] = (uint32_t)tc_iroot_(
            (unsigned __int128)primes[i] << 64, 2);
    for (int i = 0; i < 64; ++i)
        tc_sha_k_[i] = (uint32_t)tc_iroot_(
            (unsigned __int128)primes[i] << 96, 3);
    tc_sha_ready_ = true;
}

static inline uint32_t tc_rotr32_(uint32_t x, int r) {
    return (x >> r) | (x << (32 - r));
}

static void tc_sha256_block_scalar_(uint32_t st[8], const uint8_t* p) {
    uint32_t w[64];
    for (int t = 0; t < 16; ++t)
        w[t] = ((uint32_t)p[4 * t] << 24) | ((uint32_t)p[4 * t + 1] << 16) |
               ((uint32_t)p[4 * t + 2] << 8) | p[4 * t + 3];
    for (int t = 16; t < 64; ++t) {
        uint32_t s0 = tc_rotr32_(w[t - 15], 7) ^ tc_rotr32_(w[t - 15], 18) ^
                      (w[t - 15] >> 3);
        uint32_t s1 = tc_rotr32_(w[t - 2], 17) ^ tc_rotr32_(w[t - 2], 19) ^
                      (w[t - 2] >> 10);
        w[t] = w[t - 16] + s0 + w[t - 7] + s1;
    }
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
    for (int t = 0; t < 64; ++t) {
        uint32_t S1 = tc_rotr32_(e, 6) ^ tc_rotr32_(e, 11) ^ tc_rotr32_(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = h + S1 + ch + tc_sha_k_[t] + w[t];
        uint32_t S0 = tc_rotr32_(a, 2) ^ tc_rotr32_(a, 13) ^ tc_rotr32_(a, 22);
        uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
        uint32_t t2 = S0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

#ifdef TC_SHANI
static void tc_sha256_blocks_ni_(uint32_t st[8], const uint8_t* p,
                                 int64_t nblocks) {
    const __m128i bswap = _mm_set_epi64x(0x0c0d0e0f08090a0bll,
                                         0x0405060700010203ll);
    __m128i tmp = _mm_loadu_si128((const __m128i*)&st[0]);
    __m128i s1 = _mm_loadu_si128((const __m128i*)&st[4]);
    tmp = _mm_shuffle_epi32(tmp, 0xB1);        // CDAB
    s1 = _mm_shuffle_epi32(s1, 0x1B);          // EFGH
    __m128i s0 = _mm_alignr_epi8(tmp, s1, 8);  // ABEF
    s1 = _mm_blend_epi16(s1, tmp, 0xF0);       // CDGH
    while (nblocks-- > 0) {
        __m128i save0 = s0, save1 = s1, w[4];
        for (int g = 0; g < 4; ++g) {
            w[g] = _mm_shuffle_epi8(
                _mm_loadu_si128((const __m128i*)(p + 16 * g)), bswap);
            __m128i wk = _mm_add_epi32(
                w[g], _mm_loadu_si128((const __m128i*)&tc_sha_k_[4 * g]));
            s1 = _mm_sha256rnds2_epu32(s1, s0, wk);
            s0 = _mm_sha256rnds2_epu32(s0, s1, _mm_shuffle_epi32(wk, 0x0E));
        }
        for (int g = 4; g < 16; ++g) {
            __m128i sig0 = _mm_sha256msg1_epu32(w[(g - 4) & 3], w[(g - 3) & 3]);
            __m128i t = _mm_alignr_epi8(w[(g - 1) & 3], w[(g - 2) & 3], 4);
            w[g & 3] = _mm_sha256msg2_epu32(_mm_add_epi32(sig0, t),
                                            w[(g - 1) & 3]);
            __m128i wk = _mm_add_epi32(
                w[g & 3], _mm_loadu_si128((const __m128i*)&tc_sha_k_[4 * g]));
            s1 = _mm_sha256rnds2_epu32(s1, s0, wk);
            s0 = _mm_sha256rnds2_epu32(s0, s1, _mm_shuffle_epi32(wk, 0x0E));
        }
        s0 = _mm_add_epi32(s0, save0);
        s1 = _mm_add_epi32(s1, save1);
        p += 64;
    }
    tmp = _mm_shuffle_epi32(s0, 0x1B);       // FEBA
    s1 = _mm_shuffle_epi32(s1, 0xB1);        // DCHG
    s0 = _mm_blend_epi16(tmp, s1, 0xF0);     // DCBA
    s1 = _mm_alignr_epi8(s1, tmp, 8);        // HGFE → EFGH order for store
    _mm_storeu_si128((__m128i*)&st[0], s0);
    _mm_storeu_si128((__m128i*)&st[4], s1);
}
#endif

// One 64-byte compression block (exported so a streaming FFI consumer can
// keep its own state struct; `state` is 8 u32 words, updated in place).
void tc_sha256_compress(uint32_t* state, const uint8_t* block,
                        int64_t nblocks) {
    tc_sha_init_();
#ifdef TC_SHANI
    tc_sha256_blocks_ni_(state, block, nblocks);
#else
    for (int64_t i = 0; i < nblocks; ++i)
        tc_sha256_block_scalar_(state, block + 64 * i);
#endif
}

void tc_sha256(const uint8_t* data, int64_t n, uint8_t* out32) {
    tc_sha_init_();
    uint32_t st[8];
    std::memcpy(st, tc_sha_h0_, sizeof(st));
    int64_t full = n / 64;
    if (full) tc_sha256_compress(st, data, full);
    uint8_t tail[128] = {0};
    int64_t rem = n - 64 * full;
    std::memcpy(tail, data + 64 * full, (size_t)rem);
    tail[rem] = 0x80;
    int64_t tlen = rem + 1 + 8 <= 64 ? 64 : 128;
    uint64_t bits = (uint64_t)n * 8;
    for (int i = 0; i < 8; ++i)
        tail[tlen - 1 - i] = (uint8_t)(bits >> (8 * i));
    tc_sha256_compress(st, tail, tlen / 64);
    for (int i = 0; i < 8; ++i) {
        out32[4 * i] = (uint8_t)(st[i] >> 24);
        out32[4 * i + 1] = (uint8_t)(st[i] >> 16);
        out32[4 * i + 2] = (uint8_t)(st[i] >> 8);
        out32[4 * i + 3] = (uint8_t)st[i];
    }
}

void tc_sha256_batch(const uint8_t* data, const int64_t* offsets,
                     int64_t count, uint8_t* out) {
    tc_parallel_tape_(offsets, count, (int64_t)1 << 20,
                      [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i)
            tc_sha256(data + offsets[i], offsets[i + 1] - offsets[i],
                      out + 32 * i);
    });
}

int tc_version(void) { return 7; }

}  // extern "C"
