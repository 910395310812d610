// Host-side native routines for speechless_tpu_torch (a copy of speechless_tpu/native).
//
// Levenshtein edit distance over UTF-32 codepoint sequences. Replaces the reference's
// `editdistance` C++ dependency (the original speechless net.py:33,37) on the eval path.
// Exposed through a plain C ABI and loaded from Python via ctypes.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Edit distance between two uint32 codepoint arrays. Two-row DP, O(min(n,m)) memory.
int64_t sl_levenshtein(const uint32_t* a, int64_t len_a, const uint32_t* b, int64_t len_b) {
    if (len_a < len_b) {
        std::swap(a, b);
        std::swap(len_a, len_b);
    }
    if (len_b == 0) return len_a;

    std::vector<int64_t> row(static_cast<size_t>(len_b) + 1);
    for (int64_t j = 0; j <= len_b; ++j) row[static_cast<size_t>(j)] = j;

    for (int64_t i = 1; i <= len_a; ++i) {
        int64_t diagonal = row[0];  // previous[j-1]
        row[0] = i;
        const uint32_t ca = a[i - 1];
        for (int64_t j = 1; j <= len_b; ++j) {
            const int64_t substitute = diagonal + (ca != b[j - 1] ? 1 : 0);
            const int64_t remove = row[static_cast<size_t>(j)] + 1;   // previous[j] + 1
            const int64_t insert = row[static_cast<size_t>(j - 1)] + 1;  // current[j-1] + 1
            diagonal = row[static_cast<size_t>(j)];
            row[static_cast<size_t>(j)] = std::min(substitute, std::min(remove, insert));
        }
    }
    return row[static_cast<size_t>(len_b)];
}

}  // extern "C"
