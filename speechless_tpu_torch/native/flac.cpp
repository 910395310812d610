// Native FLAC decoder for the host-side audio pipeline of speechless_tpu_torch (a copy of
// speechless_tpu/native/flac.cpp).
//
// Replaces the original speechless's librosa/audioread/ffmpeg decode path for
// LibriSpeech's .flac files: a self-contained decoder for the FLAC subset used by speech
// corpora (16-bit PCM, constant or variable blocksize, fixed + LPC predictors, Rice-coded
// residuals, all stereo decorrelation modes). Exposed through a C ABI consumed via ctypes.
//
// Format reference: https://xiph.org/flac/format.html

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

class BitReader {
  public:
    BitReader(const uint8_t* data, size_t size) : data_(data), size_(size) {}

    bool ok() const { return ok_; }
    size_t byte_position() const { return position_; }

    void align_to_byte() {
        if (bit_ != 0) {
            bit_ = 0;
            ++position_;
        }
    }

    uint64_t read_bits(int count) {
        uint64_t value = 0;
        for (int i = 0; i < count; ++i) {
            value = (value << 1) | read_bit();
        }
        return value;
    }

    int64_t read_signed(int count) {
        uint64_t raw = read_bits(count);
        // Sign-extend.
        if (count > 0 && (raw >> (count - 1)) & 1) {
            raw |= ~((uint64_t(1) << count) - 1);
        }
        return static_cast<int64_t>(raw);
    }

    uint32_t read_unary() {
        uint32_t count = 0;
        while (ok_ && read_bit() == 0) ++count;
        return count;
    }

    void skip_bytes(size_t count) {
        bit_ = 0;
        position_ += count;
        if (position_ > size_) ok_ = false;
    }

    bool at_end() {
        return position_ >= size_;
    }

  private:
    int read_bit() {
        if (position_ >= size_) {
            ok_ = false;
            return 0;
        }
        int bit = (data_[position_] >> (7 - bit_)) & 1;
        if (++bit_ == 8) {
            bit_ = 0;
            ++position_;
        }
        return bit;
    }

    const uint8_t* data_;
    size_t size_;
    size_t position_ = 0;
    int bit_ = 0;
    bool ok_ = true;
};

int64_t zigzag_decode(uint64_t value) {
    return static_cast<int64_t>(value >> 1) ^ -static_cast<int64_t>(value & 1);
}

// Decode one Rice-partitioned residual section into samples[warmup..block_size).
bool decode_residual(BitReader& reader, int block_size, int predictor_order,
                     std::vector<int64_t>& samples) {
    const int method = static_cast<int>(reader.read_bits(2));
    if (method > 1) return false;
    const int param_bits = method == 0 ? 4 : 5;
    const uint32_t escape = method == 0 ? 0xF : 0x1F;

    const int partition_order = static_cast<int>(reader.read_bits(4));
    const int partitions = 1 << partition_order;
    if (block_size % partitions != 0) return false;
    const int partition_samples = block_size >> partition_order;

    int index = predictor_order;
    for (int p = 0; p < partitions; ++p) {
        int count = partition_samples - (p == 0 ? predictor_order : 0);
        if (count < 0) return false;
        const uint32_t param = static_cast<uint32_t>(reader.read_bits(param_bits));
        if (param == escape) {
            const int raw_bits = static_cast<int>(reader.read_bits(5));
            for (int i = 0; i < count; ++i) {
                samples[index++] = raw_bits == 0 ? 0 : reader.read_signed(raw_bits);
            }
        } else {
            for (int i = 0; i < count; ++i) {
                const uint32_t quotient = reader.read_unary();
                const uint64_t remainder = param == 0 ? 0 : reader.read_bits(param);
                samples[index++] = zigzag_decode((uint64_t(quotient) << param) | remainder);
            }
        }
        if (!reader.ok()) return false;
    }
    return true;
}

bool decode_subframe(BitReader& reader, int block_size, int bits_per_sample,
                     std::vector<int64_t>& samples) {
    if (reader.read_bits(1) != 0) return false;  // padding bit must be zero
    const int type = static_cast<int>(reader.read_bits(6));
    int wasted_bits = 0;
    if (reader.read_bits(1) == 1) {
        wasted_bits = 1 + static_cast<int>(reader.read_unary());
        bits_per_sample -= wasted_bits;
    }
    if (bits_per_sample <= 0 || bits_per_sample > 33) return false;

    samples.assign(block_size, 0);

    if (type == 0) {  // CONSTANT
        const int64_t value = reader.read_signed(bits_per_sample);
        for (int i = 0; i < block_size; ++i) samples[i] = value;
    } else if (type == 1) {  // VERBATIM
        for (int i = 0; i < block_size; ++i) samples[i] = reader.read_signed(bits_per_sample);
    } else if (type >= 8 && type <= 12) {  // FIXED, order 0-4
        const int order = type & 0x07;
        if (order > block_size) return false;
        for (int i = 0; i < order; ++i) samples[i] = reader.read_signed(bits_per_sample);
        if (!decode_residual(reader, block_size, order, samples)) return false;
        for (int i = order; i < block_size; ++i) {
            int64_t prediction = 0;
            switch (order) {
                case 0: prediction = 0; break;
                case 1: prediction = samples[i - 1]; break;
                case 2: prediction = 2 * samples[i - 1] - samples[i - 2]; break;
                case 3: prediction = 3 * samples[i - 1] - 3 * samples[i - 2] +
                                     samples[i - 3]; break;
                case 4: prediction = 4 * samples[i - 1] - 6 * samples[i - 2] +
                                     4 * samples[i - 3] - samples[i - 4]; break;
            }
            samples[i] += prediction;  // residual was stored in samples[i]
        }
    } else if (type >= 32) {  // LPC, order 1-32
        const int order = (type & 0x1F) + 1;
        if (order > block_size) return false;
        for (int i = 0; i < order; ++i) samples[i] = reader.read_signed(bits_per_sample);
        const int precision = static_cast<int>(reader.read_bits(4)) + 1;
        if (precision >= 16) return false;  // 0b1111 is invalid
        const int shift = static_cast<int>(reader.read_signed(5));
        if (shift < 0) return false;
        int64_t coefficients[32];
        for (int i = 0; i < order; ++i) coefficients[i] = reader.read_signed(precision);
        if (!decode_residual(reader, block_size, order, samples)) return false;
        for (int i = order; i < block_size; ++i) {
            int64_t prediction = 0;
            for (int j = 0; j < order; ++j) {
                prediction += coefficients[j] * samples[i - 1 - j];
            }
            samples[i] += prediction >> shift;
        }
    } else {
        return false;  // reserved subframe type
    }

    if (wasted_bits > 0) {
        for (int i = 0; i < block_size; ++i) samples[i] <<= wasted_bits;
    }
    return reader.ok();
}

// Skip a UTF-8-style coded number (frame/sample index).
bool skip_utf8_number(BitReader& reader) {
    const uint32_t first = static_cast<uint32_t>(reader.read_bits(8));
    int extra = 0;
    if ((first & 0x80) == 0) extra = 0;
    else if ((first & 0xE0) == 0xC0) extra = 1;
    else if ((first & 0xF0) == 0xE0) extra = 2;
    else if ((first & 0xF8) == 0xF0) extra = 3;
    else if ((first & 0xFC) == 0xF8) extra = 4;
    else if ((first & 0xFE) == 0xFC) extra = 5;
    else if (first == 0xFE) extra = 6;
    else return false;
    for (int i = 0; i < extra; ++i) reader.read_bits(8);
    return reader.ok();
}

struct StreamInfo {
    uint32_t sample_rate = 0;
    int channels = 0;
    int bits_per_sample = 0;
    uint64_t total_samples = 0;
};

}  // namespace

extern "C" {

namespace {

// Decode body; may throw (bad_alloc etc.) — wrapped by the C ABI entry point below.
int decode_flac_impl(const char* path, float** out_samples, int64_t* out_count,
                     int32_t* out_sample_rate) {
    *out_samples = nullptr;
    *out_count = 0;
    *out_sample_rate = 0;

    FILE* file = fopen(path, "rb");
    if (!file) return 1;
    fseek(file, 0, SEEK_END);
    const long file_size = ftell(file);
    fseek(file, 0, SEEK_SET);
    std::vector<uint8_t> data(static_cast<size_t>(file_size));
    if (fread(data.data(), 1, data.size(), file) != data.size()) {
        fclose(file);
        return 2;
    }
    fclose(file);

    if (data.size() < 42 || memcmp(data.data(), "fLaC", 4) != 0) return 3;

    BitReader reader(data.data(), data.size());
    reader.skip_bytes(4);

    StreamInfo info;
    bool last_block = false;
    while (!last_block) {
        last_block = reader.read_bits(1) != 0;
        const int block_type = static_cast<int>(reader.read_bits(7));
        const size_t length = static_cast<size_t>(reader.read_bits(24));
        if (block_type == 0) {  // STREAMINFO
            reader.read_bits(16);  // min block size
            reader.read_bits(16);  // max block size
            reader.read_bits(24);  // min frame size
            reader.read_bits(24);  // max frame size
            info.sample_rate = static_cast<uint32_t>(reader.read_bits(20));
            info.channels = static_cast<int>(reader.read_bits(3)) + 1;
            info.bits_per_sample = static_cast<int>(reader.read_bits(5)) + 1;
            info.total_samples = reader.read_bits(36);
            reader.skip_bytes(16);  // md5
        } else {
            reader.skip_bytes(length);
        }
        if (!reader.ok()) return 4;
    }
    if (info.sample_rate == 0 || info.channels < 1 || info.channels > 8) return 5;

    std::vector<float> output;
    // Cap the header-driven reserve: a corrupt STREAMINFO can claim up to 2^36-1 samples.
    const uint64_t kMaxReserve = 1ULL << 28;  // ~1 GB of float32
    if (info.total_samples > 0 && info.total_samples < kMaxReserve) {
        output.reserve(static_cast<size_t>(info.total_samples));
    }

    std::vector<std::vector<int64_t>> channels(static_cast<size_t>(info.channels));
    const float scale = 1.0f / static_cast<float>(int64_t(1) << (info.bits_per_sample - 1));

    while (!reader.at_end()) {
        // Frame header.
        const uint64_t sync = reader.read_bits(14);
        if (!reader.ok()) break;  // clean EOF
        if (sync != 0x3FFE) return 6;
        reader.read_bits(1);  // reserved
        reader.read_bits(1);  // blocking strategy
        const int block_size_code = static_cast<int>(reader.read_bits(4));
        const int sample_rate_code = static_cast<int>(reader.read_bits(4));
        const int channel_assignment = static_cast<int>(reader.read_bits(4));
        const int sample_size_code = static_cast<int>(reader.read_bits(3));
        reader.read_bits(1);  // reserved
        if (!skip_utf8_number(reader)) return 7;

        int block_size = 0;
        switch (block_size_code) {
            case 0: return 8;  // reserved
            case 1: block_size = 192; break;
            case 6: block_size = static_cast<int>(reader.read_bits(8)) + 1; break;
            case 7: block_size = static_cast<int>(reader.read_bits(16)) + 1; break;
            default:
                block_size = (block_size_code <= 5) ? (576 << (block_size_code - 2))
                                                    : (256 << (block_size_code - 8));
        }
        if (sample_rate_code == 12) reader.read_bits(8);
        else if (sample_rate_code == 13 || sample_rate_code == 14) reader.read_bits(16);

        int bits_per_sample = info.bits_per_sample;
        switch (sample_size_code) {
            case 0: break;  // from STREAMINFO
            case 1: bits_per_sample = 8; break;
            case 2: bits_per_sample = 12; break;
            case 4: bits_per_sample = 16; break;
            case 5: bits_per_sample = 20; break;
            case 6: bits_per_sample = 24; break;
            case 7: bits_per_sample = 32; break;
            default: return 9;
        }
        reader.read_bits(8);  // header CRC-8

        int channel_count = info.channels;
        bool left_side = false, right_side = false, mid_side = false;
        if (channel_assignment <= 7) {
            channel_count = channel_assignment + 1;
        } else if (channel_assignment == 8) {
            channel_count = 2; left_side = true;
        } else if (channel_assignment == 9) {
            channel_count = 2; right_side = true;
        } else if (channel_assignment == 10) {
            channel_count = 2; mid_side = true;
        } else {
            return 10;
        }

        channels.resize(static_cast<size_t>(channel_count));
        for (int c = 0; c < channel_count; ++c) {
            int channel_bits = bits_per_sample;
            // The difference (side) channel carries one extra bit.
            if ((left_side && c == 1) || (right_side && c == 0) || (mid_side && c == 1)) {
                ++channel_bits;
            }
            if (!decode_subframe(reader, block_size, channel_bits,
                                 channels[static_cast<size_t>(c)])) {
                return 11;
            }
        }
        reader.align_to_byte();
        reader.read_bits(16);  // frame CRC-16

        // Undo stereo decorrelation.
        if (left_side) {
            for (int i = 0; i < block_size; ++i) {
                channels[1][i] = channels[0][i] - channels[1][i];
            }
        } else if (right_side) {
            for (int i = 0; i < block_size; ++i) {
                channels[0][i] = channels[1][i] + channels[0][i];
            }
        } else if (mid_side) {
            for (int i = 0; i < block_size; ++i) {
                int64_t mid = channels[0][i];
                const int64_t side = channels[1][i];
                mid = (mid << 1) | (side & 1);
                channels[0][i] = (mid + side) >> 1;
                channels[1][i] = (mid - side) >> 1;
            }
        }

        for (int i = 0; i < block_size; ++i) {
            float sum = 0.0f;
            for (int c = 0; c < channel_count; ++c) {
                sum += static_cast<float>(channels[static_cast<size_t>(c)][i]) * scale;
            }
            output.push_back(sum / static_cast<float>(channel_count));
        }
        if (info.total_samples > 0 && output.size() >= info.total_samples) break;
    }

    if (info.total_samples > 0 && output.size() > info.total_samples) {
        output.resize(static_cast<size_t>(info.total_samples));
    }

    float* result = static_cast<float*>(malloc(output.size() * sizeof(float)));
    if (!result) return 12;
    memcpy(result, output.data(), output.size() * sizeof(float));
    *out_samples = result;
    *out_count = static_cast<int64_t>(output.size());
    *out_sample_rate = static_cast<int32_t>(info.sample_rate);
    return 0;
}

}  // namespace

// Decode a FLAC file to mono float32 (channel mean, scaled to [-1, 1]).
// On success returns 0 and sets *out_samples (malloc'd; free with sl_free_buffer),
// *out_count and *out_sample_rate. Returns nonzero error codes on failure.
// C++ exceptions must not cross the C ABI (ctypes would SIGABRT the process).
int sl_decode_flac(const char* path, float** out_samples, int64_t* out_count,
                   int32_t* out_sample_rate) {
    try {
        return decode_flac_impl(path, out_samples, out_count, out_sample_rate);
    } catch (...) {
        *out_samples = nullptr;
        *out_count = 0;
        *out_sample_rate = 0;
        return 13;
    }
}

void sl_free_buffer(float* buffer) { free(buffer); }

}  // extern "C"
