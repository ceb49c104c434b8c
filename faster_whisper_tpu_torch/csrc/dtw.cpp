// Monotonic DTW over a (N, M) cost matrix with backtrace: the word-
// timestamp alignment step.  The port's copy of the JAX package's
// native/dtw.cpp, loaded by dtw.py through ops/_build.py.
//
// Semantics are exactly dtw.py::_dtw_path_numpy (the numpy plain version,
// held index for index by tests/test_torch_alignment.py): f64 accumulation,
// ties prefer match (diag) then insertion, backtrace from (N, M).
//
// Build: g++ -std=c++17 -O3 -shared -fPIC -o libdtw.so dtw.cpp

#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// cost: (n, m) row-major f64. out_text/out_time: caller-allocated
// buffers of capacity n + m (the path length is at most n + m).
// Returns the path length (entries are written in FORWARD order).
long fwt_dtw(const double* cost, long n, long m,
             long* out_text, long* out_time) {
    const double INF = std::numeric_limits<double>::infinity();
    // acc has a virtual row/col 0; trace codes: 0 diag, 1 up, 2 left
    std::vector<double> prev(m + 1, INF), cur(m + 1, INF);
    std::vector<int8_t> trace((n + 1) * (m + 1), 0);
    prev[0] = 0.0;

    for (long i = 1; i <= n; ++i) {
        cur[0] = INF;
        const double* crow = cost + (i - 1) * m;
        int8_t* trow = trace.data() + i * (m + 1);
        for (long j = 1; j <= m; ++j) {
            const double c0 = prev[j - 1];  // match
            const double c1 = prev[j];      // insertion
            const double c2 = cur[j - 1];   // deletion
            double best = c0;
            int8_t t = 0;
            if (c1 < best) { best = c1; t = 1; }
            if (c2 < best) { best = c2; t = 2; }
            cur[j] = crow[j - 1] + best;
            trow[j] = t;
        }
        std::swap(prev, cur);
    }

    long i = n, j = m, k = 0;
    const long cap = n + m;
    // backtrace (reverse order), then flip in place
    while ((i > 0 || j > 0) && k < cap) {
        out_text[k] = i - 1;
        out_time[k] = j - 1;
        int8_t t;
        if (i > 0 && j > 0) t = trace[i * (m + 1) + j];
        else if (i > 0) t = 1;
        else t = 2;
        if (t == 0) { --i; --j; }
        else if (t == 1) { --i; }
        else { --j; }
        ++k;
    }
    for (long a = 0, b = k - 1; a < b; ++a, --b) {
        long tt = out_text[a]; out_text[a] = out_text[b]; out_text[b] = tt;
        long tm = out_time[a]; out_time[a] = out_time[b]; out_time[b] = tm;
    }
    return k;
}

}  // extern "C"
