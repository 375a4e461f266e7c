// Host-side fast paths of the PyTorch port: WAV PCM decoding with channel
// mixdown, polyphase FIR decimation and CRC32C, with a plain C interface
// bound with ctypes (basic_pitch_torch/native.py). A copy of the entry
// points of the JAX package's host library
// (`basic_pitch_tpu/native/bp_native.cpp`, everything before its packer;
// the packer is csrc/pcm_pack.cpp), built with the same g++ flags (-O3
// -shared -fPIC, no -march) by basic_pitch_torch/_build.py;
// tests/test_torch_params.py pins the code equal.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// PCM decoding: interleaved payloads -> float32 mono (channel mean)
// ---------------------------------------------------------------------------

void decode_pcm16_mono(const int16_t* in, int64_t n_frames, int32_t n_channels,
                       float* out) {
    const float scale = 1.0f / 32768.0f;
    if (n_channels == 1) {
        for (int64_t i = 0; i < n_frames; ++i) out[i] = in[i] * scale;
        return;
    }
    const float inv = 1.0f / n_channels;
    for (int64_t i = 0; i < n_frames; ++i) {
        int32_t acc = 0;
        for (int32_t c = 0; c < n_channels; ++c) acc += in[i * n_channels + c];
        out[i] = acc * scale * inv;
    }
}

void decode_pcm24_mono(const uint8_t* in, int64_t n_frames, int32_t n_channels,
                       float* out) {
    const float scale = 1.0f / 8388608.0f;
    const float inv = 1.0f / n_channels;
    for (int64_t i = 0; i < n_frames; ++i) {
        double acc = 0.0;
        for (int32_t c = 0; c < n_channels; ++c) {
            const uint8_t* p = in + 3 * (i * n_channels + c);
            int32_t v = (int32_t)(p[0] | (p[1] << 8) | (p[2] << 16));
            if (v >= (1 << 23)) v -= (1 << 24);
            acc += v;
        }
        out[i] = (float)(acc * scale * inv);
    }
}

void decode_pcm32_mono(const int32_t* in, int64_t n_frames, int32_t n_channels,
                       float* out) {
    const double scale = 1.0 / 2147483648.0;
    const double inv = 1.0 / n_channels;
    for (int64_t i = 0; i < n_frames; ++i) {
        double acc = 0.0;
        for (int32_t c = 0; c < n_channels; ++c) acc += in[i * n_channels + c];
        out[i] = (float)(acc * scale * inv);
    }
}

void decode_float32_mono(const float* in, int64_t n_frames, int32_t n_channels,
                         float* out) {
    if (n_channels == 1) {
        memcpy(out, in, sizeof(float) * (size_t)n_frames);
        return;
    }
    const float inv = 1.0f / n_channels;
    for (int64_t i = 0; i < n_frames; ++i) {
        float acc = 0.0f;
        for (int32_t c = 0; c < n_channels; ++c) acc += in[i * n_channels + c];
        out[i] = acc * inv;
    }
}

// ---------------------------------------------------------------------------
// Polyphase rational resampling (upfirdn with centered taps)
//
// y[j] = sum_k h[k] * x_up[j * down + offset - k], x_up = zero-stuffed input.
// Matches scipy.signal.resample_poly's zero-phase alignment when given the
// same (odd, symmetric) taps: offset = (n_taps - 1) / 2.
// ---------------------------------------------------------------------------

void resample_poly_f32(const float* x, int64_t n_in, int32_t up, int32_t down,
                       const double* taps, int32_t n_taps, float* out,
                       int64_t n_out) {
    const int64_t center = (n_taps - 1) / 2;
    for (int64_t j = 0; j < n_out; ++j) {
        const int64_t pos = j * (int64_t)down + center;  // index into x_up
        // x_up[m] nonzero only when m % up == 0, x index m / up
        // k = pos - m with 0 <= k < n_taps
        int64_t m_hi = pos;                       // largest m (k = 0)
        int64_t m_lo = pos - (n_taps - 1);        // smallest m
        // snap m_hi down to a multiple of up
        int64_t rem = m_hi % up;
        if (rem < 0) rem += up;
        m_hi -= rem;
        double acc = 0.0;
        for (int64_t m = m_hi; m >= m_lo && m >= 0; m -= up) {
            const int64_t xi = m / up;
            if (xi >= n_in) continue;
            acc += (double)x[xi] * taps[pos - m] * up;
        }
        out[j] = (float)acc;
    }
}

// Pure decimation (up == 1) specialization: contiguous inner loop over taps.
void resample_down_f32(const float* x, int64_t n_in, int32_t down,
                       const double* taps, int32_t n_taps, float* out,
                       int64_t n_out) {
    const int64_t center = (n_taps - 1) / 2;
    for (int64_t j = 0; j < n_out; ++j) {
        const int64_t pos = j * (int64_t)down + center;  // x index at k = 0
        const int64_t k_lo = (pos >= n_in) ? pos - n_in + 1 : 0;
        const int64_t k_hi = (pos < n_taps) ? pos + 1 : n_taps;  // exclusive
        double acc = 0.0;
        const float* xp = x + pos;
        for (int64_t k = k_lo; k < k_hi; ++k) acc += (double)xp[-k] * taps[k];
        out[j] = (float)acc;
    }
}

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli), slice-by-8
// ---------------------------------------------------------------------------

struct CrcTable {
    uint32_t t[8][256];
    CrcTable() {
        for (int i = 0; i < 256; ++i) {
            uint32_t c = (uint32_t)i;
            for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0);
            t[0][i] = c;
        }
        for (int s = 1; s < 8; ++s)
            for (int i = 0; i < 256; ++i)
                t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
    }
};

// C++11 guarantees thread-safe initialization of function-local statics —
// concurrent first use from loader threads must not race a lazy init
static const CrcTable& crc_tables() {
    static const CrcTable tables;
    return tables;
}

uint32_t crc32c(const uint8_t* data, int64_t n) {
    const auto& tbl = crc_tables();
    const uint32_t (*crc_table)[256] = tbl.t;
    uint32_t crc = 0xFFFFFFFFu;
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        crc ^= (uint32_t)data[i] | ((uint32_t)data[i + 1] << 8) |
               ((uint32_t)data[i + 2] << 16) | ((uint32_t)data[i + 3] << 24);
        crc = crc_table[7][crc & 0xFF] ^ crc_table[6][(crc >> 8) & 0xFF] ^
              crc_table[5][(crc >> 16) & 0xFF] ^ crc_table[4][crc >> 24] ^
              crc_table[3][data[i + 4]] ^ crc_table[2][data[i + 5]] ^
              crc_table[1][data[i + 6]] ^ crc_table[0][data[i + 7]];
    }
    for (; i < n; ++i) crc = (crc >> 8) ^ crc_table[0][(crc ^ data[i]) & 0xFF];
    return crc ^ 0xFFFFFFFFu;
}

}  // extern "C"
