// audio_separator_tpu_torch WAV sample writer: the float stem turned into the
// bytes of a WAV file's data chunk in one pass, with no libav.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (audio_separator_tpu_torch/io/audio.py), which writes the RIFF header and
// the buffer. The input is a (channels, frames) view of float32 samples with
// element strides of either sign, so planar and interleaved arrays are read
// in place; the output is interleaved.
//
// The arithmetic is numpy's, operation for operation, so the bytes equal
// those of the numpy writer the module falls back to:
//   y = x * s                         (only when a scale applies)
//   y = clip(y, -1, 1)                (NaN passes through)
//   32-bit: y as IEEE float32
//   16-bit: round_half_even(y * 32767.0f) as int16 (24-bit: * 8388607.0f, as
//           the low three bytes of an int32); NaN becomes 0
// Built with -ffp-contract=off and without fast-math, so that no product is
// fused into another and no float expression is reassociated.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// The bits of |x| compare as unsigned integers in the order of the values,
// and every NaN's above infinity's: one integer max finds the peak and any
// NaN, and vectorises where a float max with NaN semantics does not.
constexpr uint32_t kAbs = 0x7fffffffu;

// A run of `n` samples `step` elements apart.
uint32_t absmax_run(const float* p, int64_t n, int64_t step, uint32_t top) {
  uint32_t a;
  if (step == 1) {  // the common case, kept apart so that it vectorises
    for (int64_t i = 0; i < n; ++i) {
      std::memcpy(&a, p + i, sizeof a);
      a &= kAbs;
      top = a > top ? a : top;
    }
  } else {
    for (int64_t i = 0; i < n; ++i) {
      std::memcpy(&a, p + i * step, sizeof a);
      a &= kAbs;
      top = a > top ? a : top;
    }
  }
  return top;
}

inline float clip1(float y) { return y < -1.0f ? -1.0f : (y > 1.0f ? 1.0f : y); }

// Round half to even for |v| < 2^23, as numpy's round: |v| + 2^23 lies in
// [2^23, 2^24), where the float spacing is 1, so the addition rounds |v| to
// an integer in the current (nearest-even) mode and the subtraction is exact.
inline int32_t quantise(float y, float full_scale) {
  float v = clip1(y) * full_scale;
  float r = std::copysign((std::fabs(v) + 8388608.0f) - 8388608.0f, v);
  return static_cast<int32_t>(v == v ? r : 0.0f);
}

template <bool kScaled>
inline float sample(float x, float s) {
  return kScaled ? x * s : x;
}

// Frame-major over the output, so that each sample is stored once, in order.
// The layouts a caller hands in get loops of their own, which the compiler
// vectorises: interleaved (or contiguous mono) input is one flat run, and
// planar stereo input knows its channel count.
template <bool kScaled, int kChannels, typename Put>
void frames(const float* x, int64_t channels, int64_t n, int64_t cs, int64_t fs, float s,
            Put put) {
  const int64_t ch = kChannels ? kChannels : channels;
  if (fs == ch && (cs == 1 || ch == 1)) {
    for (int64_t i = 0; i < n * ch; ++i) put(i, sample<kScaled>(x[i], s));
  } else if (fs == 1) {
    for (int64_t f = 0; f < n; ++f)
      for (int64_t c = 0; c < ch; ++c) put(f * ch + c, sample<kScaled>(x[c * cs + f], s));
  } else {
    for (int64_t f = 0; f < n; ++f)
      for (int64_t c = 0; c < ch; ++c) put(f * ch + c, sample<kScaled>(x[c * cs + f * fs], s));
  }
}

template <bool kScaled, typename Put>
void by_channels(const float* x, int64_t channels, int64_t n, int64_t cs, int64_t fs, float s,
                 Put put) {
  if (channels == 2) {
    frames<kScaled, 2>(x, channels, n, cs, fs, s, put);
  } else {
    frames<kScaled, 0>(x, channels, n, cs, fs, s, put);
  }
}

template <typename Put>
void run(const float* x, int64_t channels, int64_t n, int64_t cs, int64_t fs, int scaled, float s,
         Put put) {
  if (scaled) {
    by_channels<true>(x, channels, n, cs, fs, s, put);
  } else {
    by_channels<false>(x, channels, n, cs, fs, s, put);
  }
}

}  // namespace

extern "C" {

// max |x| over the view; NaN if any sample is NaN (numpy's max propagates it).
float aw_peak(const float* x, int64_t channels, int64_t frames, int64_t cs, int64_t fs) {
  uint32_t top = 0;
  if ((cs == 1 && fs == channels) || (fs == 1 && cs == frames)) {
    top = absmax_run(x, channels * frames, 1, top);  // one contiguous block
  } else {
    for (int64_t c = 0; c < channels; ++c) top = absmax_run(x + c * cs, frames, fs, top);
  }
  float value;
  std::memcpy(&value, &top, sizeof value);
  return value;
}

// The data chunk of a `width`-byte WAV (2, 3, or 4 = IEEE float) into `out`,
// which holds channels * frames * width bytes. `scale` is applied only when
// `scaled` is set; it is narrowed to float32 here, as numpy narrows a float64
// factor that multiplies a float32 array.
void aw_encode(const float* x, int64_t channels, int64_t n, int64_t cs, int64_t fs, int scaled,
               double scale, int width, unsigned char* out) {
  const float s = static_cast<float>(scale);
  if (width == 4) {
    float* dst = reinterpret_cast<float*>(out);
    run(x, channels, n, cs, fs, scaled, s, [dst](int64_t i, float y) { dst[i] = clip1(y); });
  } else if (width == 2) {
    int16_t* dst = reinterpret_cast<int16_t*>(out);
    run(x, channels, n, cs, fs, scaled, s, [dst](int64_t i, float y) {
      dst[i] = static_cast<int16_t>(quantise(y, 32767.0f));
    });
  } else {
    run(x, channels, n, cs, fs, scaled, s, [out](int64_t i, float y) {
      int32_t q = quantise(y, 8388607.0f);
      out[3 * i] = static_cast<unsigned char>(q);
      out[3 * i + 1] = static_cast<unsigned char>(q >> 8);
      out[3 * i + 2] = static_cast<unsigned char>(q >> 16);
    });
  }
}

}  // extern "C"
