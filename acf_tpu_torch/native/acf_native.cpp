// acf_native — native data-plane helpers for acf_tpu_torch: the port's own
// copy of the JAX package's native/acf_native.cpp (same C ABI, same parse
// rules), so that the port reads nothing outside its package.
//
// The reference's data layer is pandas + per-line python loops
// (reference Dataset.py:150-327, utils.py:44-79). This library provides a
// columnar parser for the two on-disk formats the framework ingests:
//
//   * 2-column whitespace rows:  "uid iid"           (Video/Beauty/Steam)
//   * 4-column numeric rows:     "uid\tiid\trating\tts"  (.rating files)
//
// plus a sliding-window generator for Caser-style training instances
// (reference Caser.py:67-91 builds them with a python loop per user).
//
// Exposed as a plain C ABI consumed via ctypes
// (acf_tpu_torch/data/native_io.py builds it at first use).
// Build: g++ -O3 -shared -fPIC acf_native.cpp -o libacf_native.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <sys/stat.h>

namespace {

// Read a whole file into a malloc'd buffer. Returns size or -1.
long read_all(const char* path, char** out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    struct stat st;
    if (fstat(fileno(f), &st) != 0) { std::fclose(f); return -1; }
    long n = (long)st.st_size;
    char* buf = (char*)std::malloc((size_t)n + 1);
    if (!buf) { std::fclose(f); return -1; }
    long got = (long)std::fread(buf, 1, (size_t)n, f);
    std::fclose(f);
    if (got != n) { std::free(buf); return -1; }
    buf[n] = '\0';
    *out = buf;
    return n;
}

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

inline const char* parse_long(const char* p, const char* end, int64_t* out,
                              bool* ok) {
    p = skip_ws(p, end);
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
    int64_t v = 0;
    const char* start = p;
    while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
    *ok = (p != start);
    *out = neg ? -v : v;
    return p;
}

inline const char* parse_double(const char* p, const char* end, double* out,
                                bool* ok) {
    p = skip_ws(p, end);
    char* stop = nullptr;
    double v = std::strtod(p, &stop);
    *ok = (stop != p && stop <= end);
    *out = v;
    return stop ? stop : p;
}

}  // namespace

extern "C" {

// Number of non-empty lines in the file (pre-allocation pass).
long acf_count_rows(const char* path) {
    char* buf;
    long n = read_all(path, &buf);
    if (n < 0) return -1;
    long rows = 0;
    bool in_line = false;
    for (long i = 0; i < n; ++i) {
        if (buf[i] == '\n') {
            if (in_line) ++rows;
            in_line = false;
        } else if (buf[i] != '\r') {
            in_line = true;
        }
    }
    if (in_line) ++rows;
    std::free(buf);
    return rows;
}

// Parse the first two integer columns of each line. Returns rows parsed,
// or -1 on IO error. Lines with fewer than 2 numeric fields are skipped.
long acf_parse2(const char* path, int64_t* u, int64_t* i, long cap) {
    char* buf;
    long n = read_all(path, &buf);
    if (n < 0) return -1;
    const char* p = buf;
    const char* end = buf + n;
    long rows = 0;
    while (p < end && rows < cap) {
        const char* line_end = (const char*)memchr(p, '\n', (size_t)(end - p));
        if (!line_end) line_end = end;
        bool ok1, ok2;
        int64_t a, b;
        const char* q = parse_long(p, line_end, &a, &ok1);
        q = parse_long(q, line_end, &b, &ok2);
        if (ok1 && ok2) {
            u[rows] = a;
            i[rows] = b;
            ++rows;
        }
        p = line_end + 1;
    }
    std::free(buf);
    return rows;
}

// Parse 4 numeric columns: uid, iid, rating (float), timestamp (int).
long acf_parse4(const char* path, int64_t* u, int64_t* i, double* r,
                int64_t* t, long cap) {
    char* buf;
    long n = read_all(path, &buf);
    if (n < 0) return -1;
    const char* p = buf;
    const char* end = buf + n;
    long rows = 0;
    while (p < end && rows < cap) {
        const char* line_end = (const char*)memchr(p, '\n', (size_t)(end - p));
        if (!line_end) line_end = end;
        bool ok1, ok2, ok3, ok4;
        int64_t a, b, ts;
        double rv;
        const char* q = parse_long(p, line_end, &a, &ok1);
        q = parse_long(q, line_end, &b, &ok2);
        q = parse_double(q, line_end, &rv, &ok3);
        q = parse_long(q, line_end, &ts, &ok4);
        if (ok1 && ok2 && ok3 && ok4) {
            u[rows] = a;
            i[rows] = b;
            r[rows] = rv;
            t[rows] = ts;
            ++rows;
        }
        p = line_end + 1;
    }
    std::free(buf);
    return rows;
}

// Sliding-window instances for Caser (reference Caser.py:67-91): for each
// user with hist_len > L, emit windows [s, s+L) plus the following
// `target_len` items (front-padded with 0 at the sequence tail).
//
// hist: [num_users, width] right-aligned 0-padded int32 matrix.
// Pass out_* = nullptr to query the number of windows.
long acf_caser_windows(const int32_t* hist, const int32_t* hist_len,
                       long num_users, long width, long L, long target_len,
                       int32_t* out_user, int32_t* out_seq, int32_t* out_tgt) {
    long count = 0;
    for (long uu = 1; uu < num_users; ++uu) {
        long nn = hist_len[uu];
        if (nn < L + 1) continue;
        const int32_t* h = hist + uu * width + (width - nn);
        long windows = nn - L;
        if (out_user) {
            for (long s = 0; s < windows; ++s) {
                long w = count + s;
                out_user[w] = (int32_t)uu;
                std::memcpy(out_seq + w * L, h + s, (size_t)L * 4);
                long avail = nn - (s + L);
                long take = avail < target_len ? avail : target_len;
                int32_t* tgt = out_tgt + w * target_len;
                for (long k = 0; k < target_len - take; ++k) tgt[k] = 0;
                std::memcpy(tgt + (target_len - take), h + s + L,
                            (size_t)take * 4);
            }
        }
        count += windows;
    }
    return count;
}

}  // extern "C"
