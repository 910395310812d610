// Batched CTC prefix beam search with optional word-level n-gram LM fusion.
//
// Production-speed replacement for the host Python beam in ops/decode.py (which mirrors
// the original speechless forked-TF KenLM beam decoder, its net.py:438-454).
// Semantics are kept exactly equal to the Python implementation so the two are
// parity-tested against each other:
//   * per-prefix (ends-in-blank, ends-in-non-blank) probability split, float64 log-space;
//   * merge_repeated=False semantics (the "AA<blank>AA" -> "AA" contract);
//   * LM fusion at word boundaries: lm_weight * log10 P(word|context) + word_count_weight
//     + valid_word_count_weight * [word in vocabulary], plus trailing-word scoring at the
//     end of the sequence;
//   * candidate first-touch order tracks the Python dict insertion order, so top-W ties
//     break identically to Python's stable sort.
//
// Performance design: the per-frame candidate set is held in flat, stamp-cleared slot
// arrays (one stay slot per beam, one extension slot per (beam, class)) so the hot loop
// does no hashing and no allocation; logaddexp only runs where probability mass actually
// merges (blank/repeat stays and materialized-child joins), and each candidate's score is
// computed once before selection. Prefixes live in a trie that only materializes beam
// survivors (<= W nodes per frame), keeping memory O(W * T). An optional per-frame class
// floor (`class_log_prob_floor`) skips extensions by negligible classes — the standard
// production pruning; 0 disables it for exact-parity runs. Utterances in a batch are
// independent and decode on a thread pool.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <thread>
#include <vector>

extern "C" {
// From ngram_lm.cpp (same shared library).
int sl_ngram_order(void* handle);
float sl_ngram_score_word(void* handle, const char* context, const char* word);
int sl_ngram_is_valid_word(void* handle, const char* word);
}

namespace {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();

inline double logaddexp(double a, double b) {
    if (a == kNegInf) return b;
    if (b == kNegInf) return a;
    const double hi = a > b ? a : b;
    return hi + std::log1p(std::exp(-std::fabs(a - b)));
}

void append_utf8(std::string* out, uint32_t cp) {
    if (cp < 0x80) {
        out->push_back(static_cast<char>(cp));
    } else if (cp < 0x800) {
        out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
        out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
        out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
        out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
        out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else {
        out->push_back(static_cast<char>(0xF0 | (cp >> 18)));
        out->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
        out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
        out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
}

struct Node {
    int32_t parent;      // -1 for the root
    int32_t symbol;      // class index; -1 for the root
    double lm_score;     // accumulated LM contribution of this prefix
    double space_bonus;  // cached LM bonus of extending this prefix with a space
                         // (prefix-determined); NaN = not yet computed
};

// One per-frame candidate slot. Slots are identified by index: slot i < W is "stay at
// beam i's prefix"; slot W + i*C + c is "extend beam i's prefix with class c".
struct Slot {
    double p_blank;
    double p_non_blank;
    double lm_score;
    double score;     // filled during selection
    int32_t node;     // materialized trie node, or -1 if the prefix is new this frame
    int32_t parent;   // for unmaterialized slots: parent node + extending symbol
    int32_t symbol;
    uint32_t seq;     // first-touch order (Python dict-insertion tie-break)
};

struct BeamEntry {
    int32_t node;
    double p_blank;
    double p_non_blank;
};

class UtteranceDecoder {
  public:
    UtteranceDecoder(const float* log_probs, int frames, int classes, int blank,
                     int beam_width, void* lm, const uint32_t* alphabet, int space_index,
                     double lm_weight, double word_count_weight,
                     double valid_word_count_weight, double class_log_prob_floor)
        : log_probs_(log_probs), frames_(frames), classes_(classes), blank_(blank),
          beam_width_(beam_width), lm_(lm), alphabet_(alphabet), space_index_(space_index),
          lm_weight_(lm_weight), word_count_weight_(word_count_weight),
          valid_word_count_weight_(valid_word_count_weight),
          class_floor_(class_log_prob_floor), lm_order_(lm ? sl_ngram_order(lm) : 0) {}

    // Decodes into out_tokens (capacity t_capacity, -1 padded); returns symbol count.
    int decode(int32_t* out_tokens, int t_capacity) {
        const int w = beam_width_;
        const size_t slot_count = static_cast<size_t>(w) * (classes_ + 1);
        slots_.assign(slot_count, Slot{});
        stamps_.assign(slot_count, -1);
        nodes_.clear();
        nodes_.push_back({-1, -1, 0.0, std::numeric_limits<double>::quiet_NaN()});
        children_.clear();
        children_.resize(static_cast<size_t>(classes_), -1);
        node_to_beam_.assign(1, -1);
        beams_.assign(1, {0, 0.0, kNegInf});

        std::vector<int32_t> touched;
        touched.reserve(slot_count);
        std::vector<int32_t> order;
        order.reserve(slot_count);

        for (int t = 0; t < frames_; ++t) {
            const float* row = log_probs_ + static_cast<size_t>(t) * classes_;
            const double row_blank = row[blank_];
            stamp_ = t;
            next_seq_ = 0;
            touched.clear();
            for (size_t i = 0; i < beams_.size(); ++i) {
                node_to_beam_[static_cast<size_t>(beams_[i].node)] =
                    static_cast<int32_t>(i);
            }

            for (size_t i = 0; i < beams_.size(); ++i) {
                const BeamEntry& beam = beams_[i];
                const double total = logaddexp(beam.p_blank, beam.p_non_blank);
                const int32_t last = nodes_[static_cast<size_t>(beam.node)].symbol;
                // Blank emission: the prefix is unchanged and now ends in blank.
                Slot& stay = touch_stay(static_cast<int32_t>(i), beam.node, &touched);
                stay.p_blank = logaddexp(stay.p_blank, total + row_blank);

                const int32_t* child_row =
                    children_.data() + static_cast<size_t>(beam.node) * classes_;
                for (int c = 0; c < classes_; ++c) {
                    if (c == blank_) continue;
                    const double p_c = row[c];
                    if (p_c < class_floor_ && c != last) continue;
                    double extend_mass;
                    if (c == last) {
                        // Repeat without a separating blank collapses onto the prefix;
                        // extension is only reachable from the ends-in-blank mass.
                        stay.p_non_blank =
                            logaddexp(stay.p_non_blank, beam.p_non_blank + p_c);
                        if (p_c < class_floor_) continue;
                        extend_mass = beam.p_blank + p_c;
                    } else {
                        extend_mass = total + p_c;
                    }
                    const int32_t child = child_row[c];
                    if (child >= 0) {
                        const int32_t j = node_to_beam_[static_cast<size_t>(child)];
                        if (j >= 0) {
                            // The extension re-reaches a prefix that is itself in the
                            // beam: merge with its stay slot (the Python dict merge).
                            Slot& joined = touch_stay(j, child, &touched);
                            joined.p_non_blank =
                                logaddexp(joined.p_non_blank, extend_mass);
                            continue;
                        }
                    }
                    Slot& ext = touch_extend(static_cast<int32_t>(i), beam.node, c,
                                             child, &touched);
                    ext.p_non_blank = logaddexp(ext.p_non_blank, extend_mass);
                }
            }
            for (const BeamEntry& beam : beams_) {
                node_to_beam_[static_cast<size_t>(beam.node)] = -1;
            }

            // Score once per candidate, then keep the top `beam_width`; ties break by
            // first-touch order (== Python's stable sort over dict insertion order).
            for (const int32_t s : touched) {
                Slot& slot = slots_[static_cast<size_t>(s)];
                slot.score = (slot.p_blank == kNegInf
                                  ? slot.p_non_blank
                                  : logaddexp(slot.p_blank, slot.p_non_blank)) +
                             slot.lm_score;
            }
            order.assign(touched.begin(), touched.end());
            const auto better = [this](int32_t a, int32_t b) {
                const Slot& sa = slots_[static_cast<size_t>(a)];
                const Slot& sb = slots_[static_cast<size_t>(b)];
                if (sa.score != sb.score) return sa.score > sb.score;
                return sa.seq < sb.seq;
            };
            const size_t keep = std::min(static_cast<size_t>(w), order.size());
            if (keep < order.size()) {
                std::nth_element(order.begin(), order.begin() + keep, order.end(), better);
            }
            std::sort(order.begin(), order.begin() + keep, better);

            beams_.clear();
            for (size_t i = 0; i < keep; ++i) {
                const Slot& slot = slots_[static_cast<size_t>(order[i])];
                int32_t node = slot.node;
                if (node < 0) node = materialize(slot.parent, slot.symbol, slot.lm_score);
                beams_.push_back({node, slot.p_blank, slot.p_non_blank});
            }
            if (beams_.empty()) beams_.assign(1, {0, 0.0, kNegInf});
        }

        // Final ranking adds the trailing (unterminated) word's LM bonus; the first
        // maximum in beam order wins, matching Python's `max`.
        int32_t best_node = beams_.front().node;
        double best_score = kNegInf;
        bool first = true;
        for (const BeamEntry& beam : beams_) {
            double score = logaddexp(beam.p_blank, beam.p_non_blank) +
                           nodes_[static_cast<size_t>(beam.node)].lm_score;
            if (lm_ != nullptr) score += trailing_word_bonus(beam.node);
            if (first || score > best_score) {
                best_score = score;
                best_node = beam.node;
                first = false;
            }
        }

        // Walk the prefix back to the root and emit front-to-back.
        std::vector<int32_t> symbols;
        for (int32_t n = best_node; n > 0; n = nodes_[static_cast<size_t>(n)].parent) {
            symbols.push_back(nodes_[static_cast<size_t>(n)].symbol);
        }
        const int count = std::min<int>(static_cast<int>(symbols.size()), t_capacity);
        for (int i = 0; i < count; ++i) {
            out_tokens[i] = symbols[static_cast<size_t>(symbols.size()) - 1 - i];
        }
        return count;
    }

  private:
    Slot& reset_slot(int32_t index, std::vector<int32_t>* touched) {
        Slot& slot = slots_[static_cast<size_t>(index)];
        stamps_[static_cast<size_t>(index)] = stamp_;
        slot.p_blank = kNegInf;
        slot.p_non_blank = kNegInf;
        slot.seq = ++next_seq_;
        touched->push_back(index);
        return slot;
    }

    Slot& touch_stay(int32_t beam_index, int32_t node, std::vector<int32_t>* touched) {
        if (stamps_[static_cast<size_t>(beam_index)] == stamp_) {
            return slots_[static_cast<size_t>(beam_index)];
        }
        Slot& slot = reset_slot(beam_index, touched);
        slot.node = node;
        slot.lm_score = nodes_[static_cast<size_t>(node)].lm_score;
        return slot;
    }

    Slot& touch_extend(int32_t beam_index, int32_t parent, int c, int32_t existing_child,
                       std::vector<int32_t>* touched) {
        const int32_t index =
            beam_width_ + beam_index * classes_ + c;
        if (stamps_[static_cast<size_t>(index)] == stamp_) {
            return slots_[static_cast<size_t>(index)];
        }
        Slot& slot = reset_slot(index, touched);
        slot.node = existing_child;  // >= 0 when materialized in an earlier frame
        slot.parent = parent;
        slot.symbol = c;
        if (existing_child >= 0) {
            slot.lm_score = nodes_[static_cast<size_t>(existing_child)].lm_score;
        } else {
            slot.lm_score = nodes_[static_cast<size_t>(parent)].lm_score +
                            (lm_ != nullptr && c == space_index_
                                 ? cached_space_bonus(parent)
                                 : 0.0);
        }
        return slot;
    }

    double cached_space_bonus(int32_t node) {
        Node& entry = nodes_[static_cast<size_t>(node)];
        if (std::isnan(entry.space_bonus)) {
            entry.space_bonus = word_completed_bonus(node);
        }
        return entry.space_bonus;
    }

    int32_t materialize(int32_t parent, int32_t symbol, double lm_score) {
        const int32_t id = static_cast<int32_t>(nodes_.size());
        nodes_.push_back({parent, symbol, lm_score,
                          std::numeric_limits<double>::quiet_NaN()});
        children_.resize(children_.size() + static_cast<size_t>(classes_), -1);
        children_[static_cast<size_t>(parent) * classes_ + symbol] = id;
        node_to_beam_.push_back(-1);
        return id;
    }

    // The word ending at `last_char_node` (exclusive of any terminating space), plus up to
    // lm_order-1 preceding context words. Empty word -> no bonus (consecutive spaces and
    // leading spaces score nothing, as in the Python beam).
    double word_completed_bonus(int32_t last_char_node) {
        std::string word;
        int32_t n = collect_word_backwards(last_char_node, &word);
        if (word.empty()) return 0.0;
        return word_bonus(n, word);
    }

    double trailing_word_bonus(int32_t node) {
        const Node& tail = nodes_[static_cast<size_t>(node)];
        if (tail.symbol < 0 || tail.symbol == space_index_) return 0.0;
        return word_completed_bonus(node);
    }

    // Collects the word whose last character is `node` (walking to the preceding space or
    // the root), reversing it into UTF-8. Returns the node *before* the word.
    int32_t collect_word_backwards(int32_t node, std::string* word) {
        std::vector<uint32_t> codepoints;
        int32_t n = node;
        while (n > 0) {
            const Node& current = nodes_[static_cast<size_t>(n)];
            if (current.symbol == space_index_) break;
            codepoints.push_back(alphabet_[current.symbol]);
            n = current.parent;
        }
        for (size_t i = codepoints.size(); i-- > 0;) append_utf8(word, codepoints[i]);
        return n;
    }

    double word_bonus(int32_t context_end, const std::string& word) {
        // Up to lm_order-1 context words, nearest-last, joined with single spaces —
        // exactly the string the Python NativeArpaLanguageModel scorer builds.
        std::vector<std::string> context_words;
        int32_t n = context_end;
        while (n > 0 && static_cast<int>(context_words.size()) < lm_order_ - 1) {
            while (n > 0 && nodes_[static_cast<size_t>(n)].symbol == space_index_) {
                n = nodes_[static_cast<size_t>(n)].parent;
            }
            if (n <= 0) break;
            std::string context_word;
            n = collect_word_backwards(n, &context_word);
            if (!context_word.empty()) context_words.push_back(std::move(context_word));
        }
        std::string context;
        for (size_t i = context_words.size(); i-- > 0;) {
            context += context_words[i];
            if (i != 0) context += ' ';
        }
        double bonus = lm_weight_ * static_cast<double>(sl_ngram_score_word(
                                        lm_, context.c_str(), word.c_str())) +
                       word_count_weight_;
        if (sl_ngram_is_valid_word(lm_, word.c_str())) bonus += valid_word_count_weight_;
        return bonus;
    }

    const float* log_probs_;
    const int frames_, classes_, blank_, beam_width_;
    void* lm_;
    const uint32_t* alphabet_;
    const int space_index_;
    const double lm_weight_, word_count_weight_, valid_word_count_weight_;
    const double class_floor_;
    const int lm_order_;

    std::vector<Node> nodes_;
    std::vector<int32_t> children_;      // flat (node, class) -> child node, -1 = none
    std::vector<int32_t> node_to_beam_;  // node -> index in the current beam, -1 = absent
    std::vector<BeamEntry> beams_;
    std::vector<Slot> slots_;
    std::vector<int32_t> stamps_;
    int32_t stamp_ = -1;
    uint32_t next_seq_ = 0;
};

}  // namespace

extern "C" {

// Decode a batch. log_probs: (batch, t_max, classes) float32 row-major; lengths: (batch,)
// valid frame counts; out_tokens: (batch, t_max) int32, -1 padded; out_counts: (batch,).
// alphabet: `classes` unicode codepoints (may be null when lm is null).
// class_log_prob_floor: skip extensions whose per-frame log-prob is below this (0 = off).
// Returns 0 on success. Exceptions must not cross the C ABI.
int sl_ctc_beam_search(const float* log_probs, int batch, int t_max, int classes,
                       const int32_t* lengths, int blank, int beam_width, void* lm,
                       const uint32_t* alphabet, int space_index, double lm_weight,
                       double word_count_weight, double valid_word_count_weight,
                       double class_log_prob_floor, int num_threads, int32_t* out_tokens,
                       int32_t* out_counts) {
    if (batch < 0 || t_max < 0 || classes <= 0 || beam_width <= 0) return 1;
    if (blank < 0 || blank >= classes) return 1;
    if (lm != nullptr && (alphabet == nullptr || space_index < 0 ||
                          space_index >= classes)) {
        return 1;
    }
    const double floor =
        class_log_prob_floor == 0.0 ? kNegInf : class_log_prob_floor;
    std::fill(out_tokens, out_tokens + static_cast<size_t>(batch) * t_max, -1);

    std::atomic<int> next(0);
    std::atomic<int> failures(0);
    auto worker = [&]() {
        try {
            for (int b = next.fetch_add(1); b < batch; b = next.fetch_add(1)) {
                UtteranceDecoder decoder(
                    log_probs + static_cast<size_t>(b) * t_max * classes,
                    std::min(std::max(lengths[b], 0), t_max), classes, blank, beam_width,
                    lm, alphabet, space_index, lm_weight, word_count_weight,
                    valid_word_count_weight, floor);
                out_counts[b] = decoder.decode(out_tokens + static_cast<size_t>(b) * t_max,
                                               t_max);
            }
        } catch (...) {
            failures.fetch_add(1);
        }
    };

    int threads = num_threads > 0 ? num_threads
                                  : static_cast<int>(std::thread::hardware_concurrency());
    threads = std::max(1, std::min(threads, batch > 0 ? batch : 1));
    if (threads == 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        pool.reserve(static_cast<size_t>(threads));
        for (int i = 0; i < threads; ++i) pool.emplace_back(worker);
        for (auto& t : pool) t.join();
    }
    return failures.load() == 0 ? 0 : 2;
}

}  // extern "C"
