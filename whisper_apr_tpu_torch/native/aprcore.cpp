// Copied from whisper_apr_tpu/native/aprcore.cpp; keep the two in step.
//
// aprcore — the host runtime in C++: the Kaiser-sinc resampler, LZ4 block
// decoding, the word-timestamp DTW, CRC-32, PCM16 conversion and the VAD's
// frame features, behind a C ABI bound with ctypes (native/__init__.py).
// Below this header the file equals the original byte for byte, so the
// port's outputs equal the JAX package's bit for bit when both are built
// with the same compiler and flags.
//
// Build (native/__init__.py, at first use): g++ -O3 -shared -fPIC
// -std=c++17 aprcore.cpp -o libaprcore_<hash>.so. No -march=native and no
// -ffast-math: either lets the compiler contract the resampler's and the
// DTW's multiply-adds into FMAs, which changes the bits.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CRC-32 (IEEE 802.3, reference: src/format/checksum.rs:20-90)
// ---------------------------------------------------------------------------

static uint32_t crc_table[256];
static bool crc_init_done = false;

static void crc_init() {
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = i;
        for (int j = 0; j < 8; ++j)
            c = (c & 1) ? (c >> 1) ^ 0xEDB88320u : c >> 1;
        crc_table[i] = c;
    }
    crc_init_done = true;
}

uint32_t aprcore_crc32(const uint8_t* data, uint64_t len, uint32_t seed) {
    if (!crc_init_done) crc_init();
    uint32_t c = seed ^ 0xFFFFFFFFu;
    for (uint64_t i = 0; i < len; ++i)
        c = crc_table[(c ^ data[i]) & 0xFFu] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// Kaiser-windowed sinc resampler
// (numerics mirror reference: src/audio/resampler.rs:136-226 and the Python
//  SincResampler in audio/resample.py — same taps, same renormalization)
// ---------------------------------------------------------------------------

static double bessel_i0(double x) {
    // power-series I0, converges quickly for |x| <= ~20
    double sum = 1.0, term = 1.0;
    for (int k = 1; k < 64; ++k) {
        term *= (x / (2.0 * k)) * (x / (2.0 * k));
        sum += term;
        if (term < 1e-18 * sum) break;
    }
    return sum;
}

// out must hold ceil(n_in * target / source) floats; returns output length
int64_t aprcore_resample_sinc(const float* in, int64_t n_in,
                              int32_t source_rate, int32_t target_rate,
                              int32_t half_len, double beta,
                              float* out) {
    if (n_in <= 0 || source_rate <= 0 || target_rate <= 0) return -1;
    const double ratio = (double)target_rate / (double)source_rate;
    if (source_rate == target_rate) {
        std::memcpy(out, in, sizeof(float) * (size_t)n_in);
        return n_in;
    }
    const int64_t n_out = (int64_t)std::ceil((double)n_in * ratio);
    const double cutoff = ratio < 1.0 ? ratio : 1.0;
    const double i0_beta = bessel_i0(beta);

    for (int64_t oi = 0; oi < n_out; ++oi) {
        const double in_pos = (double)oi / ratio;
        const int64_t center = (int64_t)std::floor(in_pos);
        const double frac = in_pos - (double)center;

        double sum = 0.0, wsum = 0.0;
        for (int64_t k = -half_len; k <= half_len; ++k) {
            const int64_t idx = center + k;
            if (idx < 0 || idx >= n_in) continue;
            const double x = (double)k - frac;
            // windowed sinc (reference: resampler.rs:205-226)
            const double sa = cutoff * x;
            const double sinc = std::fabs(sa) < 1e-10
                ? 1.0 : std::sin(M_PI * sa) / (M_PI * sa);
            const double wa = x / (double)half_len;
            double win = 0.0;
            if (std::fabs(wa) <= 1.0) {
                const double a = 1.0 - wa * wa;
                win = bessel_i0(beta * std::sqrt(a > 0 ? a : 0.0)) / i0_beta;
            }
            const double w = sinc * win;
            sum += (double)in[idx] * w;
            wsum += w;
        }
        out[oi] = std::fabs(wsum) > 1e-10 ? (float)(sum / wsum) : 0.0f;
    }
    return n_out;
}

// ---------------------------------------------------------------------------
// PCM conversion (reference: src/audio/wav.rs sample decoding)
// ---------------------------------------------------------------------------

// interleaved PCM16 -> mono f32 (multi-channel averaged)
int64_t aprcore_pcm16_to_f32_mono(const int16_t* in, int64_t n_samples,
                                  int32_t n_channels, float* out) {
    if (n_channels <= 0) return -1;
    const int64_t n_frames = n_samples / n_channels;
    const float inv = 1.0f / 32768.0f / (float)n_channels;
    for (int64_t i = 0; i < n_frames; ++i) {
        float acc = 0.0f;
        for (int32_t c = 0; c < n_channels; ++c)
            acc += (float)in[i * n_channels + c];
        out[i] = acc * inv;
    }
    return n_frames;
}

// ---------------------------------------------------------------------------
// Energy + zero-crossing-rate frames (VAD hot loop, reference: src/vad.rs)
// ---------------------------------------------------------------------------

void aprcore_frame_energy_zcr(const float* in, int64_t n, int32_t frame_size,
                              float* energy_out, float* zcr_out) {
    const int64_t n_frames = n / frame_size;
    for (int64_t f = 0; f < n_frames; ++f) {
        const float* fr = in + f * frame_size;
        double e = 0.0;
        int crossings = 0;
        for (int32_t i = 0; i < frame_size; ++i) {
            e += (double)fr[i] * (double)fr[i];
            if (i > 0 && std::signbit(fr[i]) != std::signbit(fr[i - 1]))
                ++crossings;
        }
        energy_out[f] = (float)std::sqrt(e / frame_size);
        zcr_out[f] = (float)crossings / (float)(frame_size - 1);
    }
}

// ---------------------------------------------------------------------------
// LZ4 block decompression (the .apr load hot path; reference: the pure-Rust
// decompressor in src/format/compress.rs:1-60 — here native C++, the byte
// loop Python is worst at)
// ---------------------------------------------------------------------------

// Decodes one LZ4 BLOCK (no frame header) into dst. Returns bytes written,
// or -1 on malformed input / capacity overflow.
int64_t aprcore_lz4_decompress_block(const uint8_t* src, int64_t src_len,
                                     uint8_t* dst, int64_t dst_cap) {
    int64_t si = 0, di = 0;
    while (si < src_len) {
        const uint8_t token = src[si++];
        // literals
        int64_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (si >= src_len) return -1;
                b = src[si++];
                lit += b;
            } while (b == 255);
        }
        if (si + lit > src_len || di + lit > dst_cap) return -1;
        std::memcpy(dst + di, src + si, (size_t)lit);
        si += lit;
        di += lit;
        if (si >= src_len) break;  // last sequence has no match part
        // match
        if (si + 2 > src_len) return -1;
        const int64_t offset = (int64_t)src[si] | ((int64_t)src[si + 1] << 8);
        si += 2;
        if (offset == 0 || offset > di) return -1;
        int64_t mlen = (token & 0x0F) + 4;
        if ((token & 0x0F) == 15) {
            uint8_t b;
            do {
                if (si >= src_len) return -1;
                b = src[si++];
                mlen += b;
            } while (b == 255);
        }
        if (di + mlen > dst_cap) return -1;
        // overlapping copies must run byte-by-byte (offset < mlen repeats)
        const uint8_t* from = dst + di - offset;
        if (offset >= mlen) {
            std::memcpy(dst + di, from, (size_t)mlen);
            di += mlen;
        } else {
            for (int64_t i = 0; i < mlen; ++i, ++di) dst[di] = from[i];
        }
    }
    return di;
}

// ---------------------------------------------------------------------------
// Monotonic DTW over a token x frame cost matrix (word-timestamp alignment;
// reference: src/timestamps/alignment.rs picks per-token argmax peaks — the
// DTW path is strictly better: a globally optimal monotonic assignment of
// decode tokens to encoder frames, as in openai/whisper's timing pass)
// ---------------------------------------------------------------------------

// cost: row-major [n, m] (lower = better match). Writes the backtraced path
// (text index, frame index) pairs into out_ti/out_tj (capacity n + m) and
// returns its length, or -1 on bad input. Steps: diagonal, down (advance
// token), right (advance frame); ties prefer the diagonal.
int64_t aprcore_dtw(const float* cost, int64_t n, int64_t m,
                    int32_t* out_ti, int32_t* out_tj) {
    if (n <= 0 || m <= 0) return -1;
    const double INF = 1e30;
    // rolling two-row DP over (n+1) x (m+1); ptr keeps full backtrace
    std::vector<double> prev((size_t)m + 1, INF), cur((size_t)m + 1, INF);
    std::vector<uint8_t> ptr((size_t)n * (size_t)m);
    prev[0] = 0.0;
    for (int64_t i = 1; i <= n; ++i) {
        cur[0] = INF;
        const float* crow = cost + (size_t)(i - 1) * (size_t)m;
        for (int64_t j = 1; j <= m; ++j) {
            const double d0 = prev[j - 1];  // diagonal
            const double d1 = prev[j];      // down  (new token, same frame)
            const double d2 = cur[j - 1];   // right (same token, next frame)
            double best = d0;
            uint8_t p = 0;
            if (d1 < best) { best = d1; p = 1; }
            if (d2 < best) { best = d2; p = 2; }
            cur[j] = (double)crow[j - 1] + best;
            ptr[(size_t)(i - 1) * (size_t)m + (size_t)(j - 1)] = p;
        }
        std::swap(prev, cur);
    }
    int64_t i = n, j = m, k = 0;
    std::vector<int32_t> ti, tj;
    ti.reserve((size_t)(n + m));
    tj.reserve((size_t)(n + m));
    while (i > 0 && j > 0) {
        ti.push_back((int32_t)(i - 1));
        tj.push_back((int32_t)(j - 1));
        const uint8_t p = ptr[(size_t)(i - 1) * (size_t)m + (size_t)(j - 1)];
        if (p == 0) { --i; --j; }
        else if (p == 1) { --i; }
        else { --j; }
    }
    const int64_t len = (int64_t)ti.size();
    for (int64_t q = 0; q < len; ++q) {  // reverse into the out buffers
        out_ti[q] = ti[(size_t)(len - 1 - q)];
        out_tj[q] = tj[(size_t)(len - 1 - q)];
    }
    return len;
}

}  // extern "C"
