// Fast ASCII table parser for the dataset loaders.
//
// The reference's loaders are native C++ (ifstream + istringstream per line,
// kernel.cu:305-556); this is the port's native equivalent, built
// for throughput: one read() of the whole file, strtof over the buffer, no
// per-line stream objects. A ~100k-line snap/tab/dat file parses in
// milliseconds instead of the seconds the pure-Python fallback needs.
//
// C ABI (ctypes-friendly, see n_body_problem_tpu_torch/io/native.py):
//   nb_parse_table(path, n_cols, skip_blank, out, cap_rows) -> n_rows
//     Parses up to n_cols whitespace-separated floats per line, padding
//     short lines with zeros (matching istringstream's failed-extraction
//     semantics of leaving prior values — the reference leaves garbage, we
//     normalize to zero; loaders only consume fully-formed columns).
//     Pass out=nullptr to count rows; call again with a buffer.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct FileBuf {
    char* data = nullptr;
    size_t size = 0;
    bool ok = false;

    explicit FileBuf(const char* path) {
        FILE* f = std::fopen(path, "rb");
        if (!f) return;
        std::fseek(f, 0, SEEK_END);
        long n = std::ftell(f);
        if (n < 0) { std::fclose(f); return; }
        std::fseek(f, 0, SEEK_SET);
        data = static_cast<char*>(std::malloc(static_cast<size_t>(n) + 1));
        if (!data) { std::fclose(f); return; }
        size = std::fread(data, 1, static_cast<size_t>(n), f);
        data[size] = '\0';
        std::fclose(f);
        ok = true;
    }
    ~FileBuf() { std::free(data); }
    FileBuf(const FileBuf&) = delete;
    FileBuf& operator=(const FileBuf&) = delete;
};

inline bool is_blank_line(const char* p, const char* end) {
    for (; p < end && *p != '\n'; ++p)
        if (*p != ' ' && *p != '\t' && *p != '\r') return false;
    return true;
}

}  // namespace

extern "C" {

long nb_parse_table(const char* path, int n_cols, int skip_blank,
                    float* out, long cap_rows) {
    FileBuf buf(path);
    if (!buf.ok || n_cols <= 0) return -1;

    long rows = 0;
    char* p = buf.data;
    char* const end = buf.data + buf.size;
    while (p < end) {
        char* line_end = static_cast<char*>(std::memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        if (skip_blank && is_blank_line(p, line_end)) {
            p = line_end + 1;
            continue;
        }
        if (out) {
            if (rows >= cap_rows) return -2;  // caller's buffer too small
            float* row = out + rows * n_cols;
            char* q = p;
            for (int c = 0; c < n_cols; ++c) {
                char* next = nullptr;
                float v = std::strtof(q, &next);
                if (next == q || next > line_end) {  // short line: zero-fill
                    for (; c < n_cols; ++c) row[c] = 0.0f;
                    break;
                }
                row[c] = v;
                q = next;
            }
        }
        ++rows;
        p = line_end + 1;
    }
    return rows;
}

// Token-stream parse for NEMO snap bodies (sections with differing widths).
long nb_parse_tokens(const char* path, long skip_lines, double* out, long cap) {
    FileBuf buf(path);
    if (!buf.ok) return -1;
    char* p = buf.data;
    char* const end = buf.data + buf.size;
    for (long i = 0; i < skip_lines && p < end; ++i) {
        char* nl = static_cast<char*>(std::memchr(p, '\n', end - p));
        p = nl ? nl + 1 : end;
    }
    long count = 0;
    while (p < end) {
        char* next = nullptr;
        double v = std::strtod(p, &next);
        if (next == p) { ++p; continue; }
        if (out) {
            if (count >= cap) return -2;
            out[count] = v;
        }
        ++count;
        p = next;
    }
    return count;
}

}  // extern "C"
