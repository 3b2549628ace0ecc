// Native host-side data-preparation kernels for the input pipeline.
//
// A copy of padertorch_tpu/native/_dataprep.cpp.  These run on the host,
// in the prefetch threads, while the card trains: AudioReader decodes
// int16 PCM through pcm16_to_float32.  Called through ctypes, they release
// the GIL, so all prefetch threads convert in parallel.
//
// Build: c++ -O3 -shared -fPIC _dataprep.cpp -o _dataprep.so, done by
// padertorch_tpu_torch/native/dataprep.py at first use into
// padertorch_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// int16 PCM -> float32 in [-1, 1]
void pcm16_to_float32(const int16_t* in, float* out, int64_t n) {
    const float scale = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; ++i) {
        out[i] = in[i] * scale;
    }
}

// mu-law encode float32 in [-1, 1] -> uint8 indices (mu = 255).
// Matches padertorch_tpu_torch.ops.mu_law.mu_law_encode.
void mu_law_encode_f32(const float* in, uint8_t* out, int64_t n,
                       int32_t mu_quantization) {
    const float mu = (float)(mu_quantization - 1);
    const float scaling = logf(1.0f + mu);
    for (int64_t i = 0; i < n; ++i) {
        float x = in[i];
        float sign = x < 0.0f ? -1.0f : 1.0f;
        float x_mu = sign * logf(1.0f + mu * fabsf(x)) / scaling;
        float enc = (x_mu + 1.0f) * 0.5f * mu + 0.5f;
        out[i] = (uint8_t)enc;
    }
}

// mu-law decode uint8 indices -> float32 in [-1, 1].
void mu_law_decode_u8(const uint8_t* in, float* out, int64_t n,
                      int32_t mu_quantization) {
    const float mu = (float)(mu_quantization - 1);
    for (int64_t i = 0; i < n; ++i) {
        float signal = 2.0f * (in[i] / mu) - 1.0f;
        float sign = signal < 0.0f ? -1.0f : 1.0f;
        float magnitude =
            (1.0f / mu) * (powf(1.0f + mu, fabsf(signal)) - 1.0f);
        out[i] = sign * magnitude;
    }
}

// Frame a 1-D signal into overlapping windows: out[(n_frames, length)].
void frame_signal_f32(const float* in, float* out, int64_t n_frames,
                      int64_t length, int64_t shift) {
    for (int64_t f = 0; f < n_frames; ++f) {
        std::memcpy(out + f * length, in + f * shift,
                    length * sizeof(float));
    }
}

// Zero-pad + stack variable-length float32 rows into a dense batch.
// lengths: per-row valid lengths; out is (n_rows, max_len), pre-zeroed by
// the caller or overwritten fully here.
void pad_stack_f32(const float* const* rows, const int64_t* lengths,
                   float* out, int64_t n_rows, int64_t max_len) {
    for (int64_t r = 0; r < n_rows; ++r) {
        std::memcpy(out + r * max_len, rows[r],
                    lengths[r] * sizeof(float));
        std::memset(out + r * max_len + lengths[r], 0,
                    (max_len - lengths[r]) * sizeof(float));
    }
}

}  // extern "C"
