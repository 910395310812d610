// Native ARPA n-gram language model: loader + Katz back-off scorer.
//
// The host-side native equivalent of the reference's KenLM dependency (SURVEY.md §2b):
// beam-search LM fusion calls score_word() per candidate word, and large ARPA files load
// far faster (and smaller) here than as Python dicts. C ABI consumed via ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr float kUnknownLogProb = -99.0f;

struct NgramEntry {
    float log_prob;
    float backoff;
};

uint64_t combine_hash(uint64_t hash, uint32_t word_id) {
    // 64-bit mix (splitmix-style) — collision probability negligible for LM sizes.
    uint64_t x = hash ^ (0x9E3779B97F4A7C15ULL + word_id + (hash << 6) + (hash >> 2));
    x ^= x >> 30;
    x *= 0xBF58476D1CE4E5B9ULL;
    x ^= x >> 27;
    return x;
}

struct LanguageModel {
    int order = 0;
    std::unordered_map<std::string, uint32_t> vocabulary;
    // One table per n-gram order; key = combined hash of word ids.
    std::vector<std::unordered_map<uint64_t, NgramEntry>> tables;
    uint32_t bos_id = UINT32_MAX;
    uint32_t unk_id = UINT32_MAX;

    uint32_t lookup(const char* word) const {
        auto it = vocabulary.find(word);
        return it == vocabulary.end() ? UINT32_MAX : it->second;
    }

    uint64_t hash_ngram(const uint32_t* ids, int count) const {
        uint64_t hash = 0x811C9DC5ULL;
        for (int i = 0; i < count; ++i) hash = combine_hash(hash, ids[i]);
        return hash;
    }

    // log10 P(ids[count-1] | ids[0..count-1)) with back-off.
    float score(const uint32_t* ids, int count) const {
        if (count > order) {
            ids += count - order;
            count = order;
        }
        const auto& table = tables[static_cast<size_t>(count - 1)];
        auto it = table.find(hash_ngram(ids, count));
        if (it != table.end()) return it->second.log_prob;
        if (count == 1) {
            if (unk_id != UINT32_MAX) {
                auto unk = tables[0].find(hash_ngram(&unk_id, 1));
                if (unk != tables[0].end()) return unk->second.log_prob;
            }
            return kUnknownLogProb;
        }
        float backoff = 0.0f;
        const auto& context_table = tables[static_cast<size_t>(count - 2)];
        auto context_it = context_table.find(hash_ngram(ids, count - 1));
        if (context_it != context_table.end()) backoff = context_it->second.backoff;
        return backoff + score(ids + 1, count - 1);
    }
};

std::vector<std::string> split_whitespace(const std::string& line) {
    std::vector<std::string> parts;
    std::istringstream stream(line);
    std::string token;
    while (stream >> token) parts.push_back(token);
    return parts;
}

}  // namespace

extern "C" {

void* sl_ngram_load_impl(const char* path);

// Load an ARPA file; returns an opaque handle (nullptr on failure).
// Exceptions (e.g. bad_alloc on oversized models) must not cross the C ABI.
void* sl_ngram_load(const char* path) {
    try {
        return sl_ngram_load_impl(path);
    } catch (...) {
        return nullptr;
    }
}

void* sl_ngram_load_impl(const char* path) {
    std::ifstream file(path);
    if (!file) return nullptr;

    auto* lm = new LanguageModel();
    std::string line;
    int current_order = 0;
    bool in_ngrams = false;

    auto intern = [lm](const std::string& word) -> uint32_t {
        auto it = lm->vocabulary.find(word);
        if (it != lm->vocabulary.end()) return it->second;
        uint32_t id = static_cast<uint32_t>(lm->vocabulary.size());
        lm->vocabulary.emplace(word, id);
        return id;
    };

    std::vector<uint32_t> ids;
    while (std::getline(file, line)) {
        // Trim trailing CR and surrounding whitespace.
        while (!line.empty() && (line.back() == '\r' || line.back() == '\n')) line.pop_back();
        if (line.empty()) continue;
        if (line == "\\end\\") break;
        if (line.size() > 2 && line[0] == '\\' && line.find("-grams:") != std::string::npos) {
            current_order = std::atoi(line.c_str() + 1);
            while (static_cast<int>(lm->tables.size()) < current_order) lm->tables.emplace_back();
            lm->order = current_order;
            in_ngrams = true;
            continue;
        }
        if (line[0] == '\\' || !in_ngrams || current_order == 0) continue;

        std::vector<std::string> parts = split_whitespace(line);
        if (static_cast<int>(parts.size()) < current_order + 1) continue;
        const float log_prob = std::strtof(parts[0].c_str(), nullptr);
        float backoff = 0.0f;
        if (static_cast<int>(parts.size()) >= current_order + 2) {
            backoff = std::strtof(parts[static_cast<size_t>(current_order) + 1].c_str(),
                                  nullptr);
        }
        ids.clear();
        for (int i = 0; i < current_order; ++i) {
            ids.push_back(intern(parts[static_cast<size_t>(i) + 1]));
        }
        lm->tables[static_cast<size_t>(current_order - 1)]
            [lm->hash_ngram(ids.data(), current_order)] = {log_prob, backoff};
    }

    if (lm->tables.empty()) {
        delete lm;
        return nullptr;
    }
    lm->bos_id = lm->lookup("<s>");
    lm->unk_id = lm->lookup("<unk>");
    return lm;
}

void sl_ngram_free(void* handle) { delete static_cast<LanguageModel*>(handle); }

int sl_ngram_order(void* handle) { return static_cast<LanguageModel*>(handle)->order; }

// log10 P(word | <s> context...); context is a space-separated word string (may be empty).
float sl_ngram_score_word(void* handle, const char* context, const char* word) {
    auto* lm = static_cast<LanguageModel*>(handle);
    std::vector<uint32_t> ids;
    if (lm->bos_id != UINT32_MAX) ids.push_back(lm->bos_id);
    std::istringstream stream(context);
    std::string token;
    while (stream >> token) {
        uint32_t id = lm->lookup(token.c_str());
        ids.push_back(id == UINT32_MAX ? (lm->unk_id != UINT32_MAX ? lm->unk_id : 0xFFFFFFF0u)
                                       : id);
    }
    uint32_t word_id = lm->lookup(word);
    if (word_id == UINT32_MAX) {
        // Unknown word: score as <unk> unigram (with context back-off weights applied).
        word_id = lm->unk_id != UINT32_MAX ? lm->unk_id : 0xFFFFFFF1u;
    }
    ids.push_back(word_id);
    const int count = static_cast<int>(ids.size());
    return lm->score(ids.data(), count);
}

// 1 if the word is in the LM vocabulary (excluding markers), else 0.
int sl_ngram_is_valid_word(void* handle, const char* word) {
    auto* lm = static_cast<LanguageModel*>(handle);
    if (strcmp(word, "<s>") == 0 || strcmp(word, "</s>") == 0 || strcmp(word, "<unk>") == 0) {
        return 0;
    }
    return lm->lookup(word) != UINT32_MAX ? 1 : 0;
}

}  // extern "C"
