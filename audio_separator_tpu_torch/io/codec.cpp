// audio_separator_tpu_torch native codec runtime (the same C++ as the JAX
// package's io/codec.cpp, kept as this package's own copy).
//
// Replaces the reference's process-boundary audio I/O stack (ffmpeg subprocess
// via pydub, libsndfile via soundfile, librosa.load — ref:
// audio_separator/separator/common_separator.py:217-451) with an in-process
// C++ library built on libavformat/libavcodec/libswresample.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (audio_separator_tpu_torch/io/audio.py). All PCM crossing the boundary is
// interleaved float32.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/audio_fifo.h>
#include <libavutil/opt.h>
#include <libavutil/channel_layout.h>
#include <libswresample/swresample.h>
}

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

void set_error(const std::string& msg, int averr = 0) {
  if (averr != 0) {
    char buf[AV_ERROR_MAX_STRING_SIZE] = {0};
    av_strerror(averr, buf, sizeof(buf));
    g_error = msg + ": " + buf;
  } else {
    g_error = msg;
  }
}

struct DecoderCtx {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  int stream_index = -1;
  int in_sr = 0;
  int out_sr = 0;

  ~DecoderCtx() {
    if (swr) swr_free(&swr);
    if (codec) avcodec_free_context(&codec);
    if (fmt) avformat_close_input(&fmt);
    if (pkt) av_packet_free(&pkt);
    if (frame) av_frame_free(&frame);
  }
};

// Open `path` and prepare a decoder + resampler to interleaved f32 at
// (target_sr or native, target_channels or native).
bool open_decoder(const char* path, int target_sr, int target_channels,
                  DecoderCtx& d, int* out_sr, int* out_channels) {
  int err = avformat_open_input(&d.fmt, path, nullptr, nullptr);
  if (err < 0) { set_error(std::string("cannot open ") + path, err); return false; }
  err = avformat_find_stream_info(d.fmt, nullptr);
  if (err < 0) { set_error("no stream info", err); return false; }

  const AVCodec* dec = nullptr;
  d.stream_index = av_find_best_stream(d.fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &dec, 0);
  if (d.stream_index < 0 || !dec) { set_error("no audio stream"); return false; }
  AVStream* st = d.fmt->streams[d.stream_index];

  d.codec = avcodec_alloc_context3(dec);
  if (!d.codec) { set_error("codec alloc failed"); return false; }
  err = avcodec_parameters_to_context(d.codec, st->codecpar);
  if (err < 0) { set_error("codec params", err); return false; }
  // Single-threaded decode: this library is called from one Python thread and
  // shares a heap with heavyweight runtimes (XLA, torch); libav's internal
  // frame-threading buys nothing here and removes a class of heap races.
  d.codec->thread_count = 1;
  err = avcodec_open2(d.codec, dec, nullptr);
  if (err < 0) { set_error("codec open", err); return false; }

  int in_sr = d.codec->sample_rate;
  int in_ch = d.codec->ch_layout.nb_channels;
  int sr = target_sr > 0 ? target_sr : in_sr;
  int ch = target_channels > 0 ? target_channels : in_ch;

  AVChannelLayout out_layout;
  av_channel_layout_default(&out_layout, ch);
  AVChannelLayout in_layout;
  if (d.codec->ch_layout.order == AV_CHANNEL_ORDER_UNSPEC) {
    av_channel_layout_default(&in_layout, in_ch);
  } else {
    av_channel_layout_copy(&in_layout, &d.codec->ch_layout);
  }

  err = swr_alloc_set_opts2(&d.swr, &out_layout, AV_SAMPLE_FMT_FLT, sr,
                            &in_layout, d.codec->sample_fmt, in_sr, 0, nullptr);
  // swr holds its own copies; release ours (custom-order layouts allocate).
  av_channel_layout_uninit(&in_layout);
  av_channel_layout_uninit(&out_layout);
  if (err < 0 || !d.swr) { set_error("swr alloc", err); return false; }
  err = swr_init(d.swr);
  if (err < 0) { set_error("swr init", err); return false; }

  d.pkt = av_packet_alloc();
  d.frame = av_frame_alloc();
  d.in_sr = in_sr;
  d.out_sr = sr;
  *out_sr = sr;
  *out_channels = ch;
  return true;
}

bool drain_frame(DecoderCtx& d, int ch, std::vector<float>& out) {
  // Convert d.frame (or flush when frame == nullptr) into `out`.
  const uint8_t** in_data =
      d.frame ? const_cast<const uint8_t**>(d.frame->extended_data) : nullptr;
  int in_count = d.frame ? d.frame->nb_samples : 0;
  int64_t delay = swr_get_delay(d.swr, d.in_sr);
  int max_out =
      (int)av_rescale_rnd(delay + in_count, d.out_sr, d.in_sr, AV_ROUND_UP) + 256;
  size_t old = out.size();
  out.resize(old + (size_t)max_out * ch);
  uint8_t* out_ptr = reinterpret_cast<uint8_t*>(out.data() + old);
  int got = swr_convert(d.swr, &out_ptr, max_out, in_data, in_count);
  if (got < 0) { set_error("swr convert", got); return false; }
  out.resize(old + (size_t)got * ch);
  return true;
}

}  // namespace

extern "C" {

const char* as_last_error() { return g_error.c_str(); }

void as_free(float* p) { free(p); }

// Probe basic stream properties without decoding the whole file.
// Returns 0 on success. frames may be -1 when the container doesn't know.
int as_probe(const char* path, int* sample_rate, int* channels,
             long long* frames, int* bits_per_sample) {
  DecoderCtx d;
  int sr = 0, ch = 0;
  if (!open_decoder(path, 0, 0, d, &sr, &ch)) return -1;
  *sample_rate = sr;
  *channels = ch;
  AVStream* st = d.fmt->streams[d.stream_index];
  *frames = st->duration > 0
                ? av_rescale_q(st->duration, st->time_base, {1, sr})
                : -1;
  int bps = d.codec->bits_per_raw_sample;
  if (bps == 0) bps = av_get_bytes_per_sample(d.codec->sample_fmt) * 8;
  *bits_per_sample = bps;
  return 0;
}

// Decode `path` fully to interleaved float32.
// target_sr / target_channels of 0 mean "keep native".
// On success returns 0 and the caller owns *out_data (free with as_free).
int as_decode(const char* path, int target_sr, int target_channels,
              float** out_data, long long* out_frames, int* out_channels,
              int* out_sample_rate) {
  DecoderCtx d;
  int sr = 0, ch = 0;
  if (!open_decoder(path, target_sr, target_channels, d, &sr, &ch)) return -1;

  std::vector<float> pcm;
  pcm.reserve(1 << 20);

  int err;
  while ((err = av_read_frame(d.fmt, d.pkt)) >= 0) {
    if (d.pkt->stream_index != d.stream_index) {
      av_packet_unref(d.pkt);
      continue;
    }
    err = avcodec_send_packet(d.codec, d.pkt);
    av_packet_unref(d.pkt);
    if (err < 0 && err != AVERROR(EAGAIN)) { set_error("send packet", err); return -1; }
    while ((err = avcodec_receive_frame(d.codec, d.frame)) >= 0) {
      if (!drain_frame(d, ch, pcm)) return -1;
      av_frame_unref(d.frame);
    }
    if (err != AVERROR(EAGAIN) && err != AVERROR_EOF) {
      set_error("receive frame", err);
      return -1;
    }
  }
  if (err != AVERROR_EOF) {
    // A mid-stream read error (corruption, I/O failure) must not be
    // reported as a successful decode of a silently truncated track.
    set_error("read frame", err);
    return -1;
  }
  // Flush decoder, then resampler.
  avcodec_send_packet(d.codec, nullptr);
  while (avcodec_receive_frame(d.codec, d.frame) >= 0) {
    if (!drain_frame(d, ch, pcm)) return -1;
    av_frame_unref(d.frame);
  }
  {
    AVFrame* save = d.frame;
    d.frame = nullptr;
    if (!drain_frame(d, ch, pcm)) { d.frame = save; return -1; }
    d.frame = save;
  }

  long long frames = (long long)(pcm.size() / ch);
  float* buf = (float*)malloc(pcm.size() * sizeof(float));
  if (!buf) { set_error("oom"); return -1; }
  memcpy(buf, pcm.data(), pcm.size() * sizeof(float));
  *out_data = buf;
  *out_frames = frames;
  *out_channels = ch;
  *out_sample_rate = sr;
  return 0;
}

// Encode interleaved float32 PCM to `path`.
// `format`: "wav" | "flac" | "mp3" | "ogg" | "opus" | "m4a"/"aac" | "aiff".
// `bit_depth`: 16, 24, 32 (32 = float for wav); best effort per codec.
// `bitrate_kbps`: lossy-codec bitrate; 0 = codec default.
//
// Input PCM is resampled to the nearest encoder-supported rate when the
// codec restricts rates (e.g. opus: 48 kHz); frames are re-blocked through
// an AVAudioFifo so arbitrary swr output sizes meet fixed encoder framing.
int as_encode(const char* path, const float* data, long long frames,
              int channels, int sample_rate, const char* format,
              int bit_depth, int bitrate_kbps) {
  std::string fmt = format ? format : "wav";
  AVFormatContext* oc = nullptr;
  AVCodecContext* c = nullptr;
  SwrContext* swr = nullptr;
  AVAudioFifo* fifo = nullptr;
  AVFrame* frame = nullptr;
  AVFrame* in_frame = nullptr;
  AVPacket* pkt = nullptr;
  bool ok = false;
  bool header_written = false;

  int err = avformat_alloc_output_context2(&oc, nullptr,
                                           fmt == "m4a" ? "mp4" : fmt.c_str(),
                                           path);
  if (err < 0 || !oc) { set_error("output ctx", err); return -1; }

  auto cleanup = [&]() {
    if (frame) av_frame_free(&frame);
    if (in_frame) av_frame_free(&in_frame);
    if (pkt) av_packet_free(&pkt);
    if (fifo) av_audio_fifo_free(fifo);
    if (swr) swr_free(&swr);
    if (c) avcodec_free_context(&c);
    if (oc) {
      if (!(oc->oformat->flags & AVFMT_NOFILE) && oc->pb) avio_closep(&oc->pb);
      avformat_free_context(oc);
      oc = nullptr;
    }
  };

  AVCodecID codec_id;
  if (fmt == "wav" || fmt == "aiff") {
    codec_id = bit_depth >= 32 ? AV_CODEC_ID_PCM_F32LE
               : bit_depth == 24 ? AV_CODEC_ID_PCM_S24LE
                                 : AV_CODEC_ID_PCM_S16LE;
    if (fmt == "aiff")
      codec_id = bit_depth == 24 ? AV_CODEC_ID_PCM_S24BE : AV_CODEC_ID_PCM_S16BE;
  } else {
    codec_id = oc->oformat->audio_codec;
  }
  const AVCodec* enc = avcodec_find_encoder(codec_id);
  if (!enc) { set_error("no encoder for format " + fmt); cleanup(); return -1; }

  AVStream* st = avformat_new_stream(oc, nullptr);
  c = avcodec_alloc_context3(enc);
  if (!st || !c) { set_error("stream alloc"); cleanup(); return -1; }

  // Pick an encoder-supported sample rate, preferring the input rate, else
  // the smallest supported rate >= input (opus: 48000), else the largest.
  int enc_rate = sample_rate;
  {
    const int* rates = nullptr;
#if LIBAVCODEC_VERSION_MAJOR >= 61
    int nr = 0;
    avcodec_get_supported_config(nullptr, enc, AV_CODEC_CONFIG_SAMPLE_RATE, 0,
                                 (const void**)&rates, &nr);
#else
    rates = enc->supported_samplerates;
#endif
    if (rates && rates[0] != 0) {
      bool native_ok = false;
      int best_up = 0, best_any = 0;
      for (const int* r = rates; *r != 0; ++r) {
        if (*r == sample_rate) native_ok = true;
        if (*r >= sample_rate && (best_up == 0 || *r < best_up)) best_up = *r;
        if (*r > best_any) best_any = *r;
      }
      if (!native_ok) enc_rate = best_up ? best_up : best_any;
    }
  }

  c->sample_rate = enc_rate;
  av_channel_layout_default(&c->ch_layout, channels);
  if (bitrate_kbps > 0) c->bit_rate = (int64_t)bitrate_kbps * 1000;

  // Pick a sample format the encoder supports, preferring float.
  c->sample_fmt = AV_SAMPLE_FMT_FLT;
  const enum AVSampleFormat* fmts = nullptr;
#if LIBAVCODEC_VERSION_MAJOR >= 61
  int nf = 0;
  avcodec_get_supported_config(nullptr, enc, AV_CODEC_CONFIG_SAMPLE_FORMAT, 0,
                               (const void**)&fmts, &nf);
#else
  fmts = enc->sample_fmts;
#endif
  if (fmts && fmts[0] != AV_SAMPLE_FMT_NONE) {
    c->sample_fmt = fmts[0];
    for (const enum AVSampleFormat* p = fmts; *p != AV_SAMPLE_FMT_NONE; ++p) {
      if (*p == AV_SAMPLE_FMT_FLT || *p == AV_SAMPLE_FMT_FLTP) { c->sample_fmt = *p; break; }
      if (fmt == "flac" && bit_depth == 16 && *p == AV_SAMPLE_FMT_S16) { c->sample_fmt = *p; break; }
      if (fmt == "flac" && bit_depth > 16 && *p == AV_SAMPLE_FMT_S32) { c->sample_fmt = *p; break; }
    }
  }
  if (fmt == "flac") {
    // FLAC is integer-only; honour bit depth via sample format.
    c->sample_fmt = bit_depth > 16 ? AV_SAMPLE_FMT_S32 : AV_SAMPLE_FMT_S16;
    if (bit_depth == 24) c->bits_per_raw_sample = 24;
  }
  if (oc->oformat->flags & AVFMT_GLOBALHEADER)
    c->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;

  // ffmpeg builds without libvorbis/libopus fall back to the native
  // encoders, which are flagged experimental — allow them rather than fail.
  c->strict_std_compliance = FF_COMPLIANCE_EXPERIMENTAL;
  err = avcodec_open2(c, enc, nullptr);
  if (err < 0) { set_error("encoder open", err); cleanup(); return -1; }
  avcodec_parameters_from_context(st->codecpar, c);
  st->time_base = {1, enc_rate};

  if (!(oc->oformat->flags & AVFMT_NOFILE)) {
    err = avio_open(&oc->pb, path, AVIO_FLAG_WRITE);
    if (err < 0) { set_error("avio open", err); cleanup(); return -1; }
  }
  err = avformat_write_header(oc, nullptr);
  if (err < 0) { set_error("write header", err); cleanup(); return -1; }
  header_written = true;

  err = swr_alloc_set_opts2(&swr, &c->ch_layout, c->sample_fmt, enc_rate,
                            &c->ch_layout, AV_SAMPLE_FMT_FLT, sample_rate, 0,
                            nullptr);
  if (err < 0 || !swr || swr_init(swr) < 0) { set_error("encode swr"); cleanup(); return -1; }

  fifo = av_audio_fifo_alloc(c->sample_fmt, channels, 1 << 15);
  frame = av_frame_alloc();
  in_frame = av_frame_alloc();
  pkt = av_packet_alloc();
  if (!fifo || !frame || !in_frame || !pkt) { set_error("alloc"); cleanup(); return -1; }

  const int enc_chunk = c->frame_size > 0 ? c->frame_size : 4096;
  const int in_chunk = 8192;
  int64_t pts = 0;

  auto send_and_mux = [&](AVFrame* f) -> bool {
    int e = avcodec_send_frame(c, f);
    if (e < 0) { set_error("send frame", e); return false; }
    while ((e = avcodec_receive_packet(c, pkt)) >= 0) {
      av_packet_rescale_ts(pkt, c->time_base, st->time_base);
      pkt->stream_index = st->index;
      e = av_interleaved_write_frame(oc, pkt);
      if (e < 0) { set_error("write frame", e); return false; }
    }
    if (e != AVERROR(EAGAIN) && e != AVERROR_EOF) { set_error("recv packet", e); return false; }
    return true;
  };

  // Drain `min_keep`-gated frames from the FIFO into the encoder.
  auto drain_fifo = [&](int min_keep) -> bool {
    while (av_audio_fifo_size(fifo) > min_keep) {
      int n = av_audio_fifo_size(fifo);
      if (n > enc_chunk) n = enc_chunk;
      if (min_keep > 0 && n < enc_chunk) break;  // wait for a full frame
      frame->nb_samples = n;
      av_channel_layout_copy(&frame->ch_layout, &c->ch_layout);
      frame->format = c->sample_fmt;
      frame->sample_rate = enc_rate;
      if (av_frame_get_buffer(frame, 0) < 0) { set_error("frame buffer"); return false; }
      if (av_audio_fifo_read(fifo, (void**)frame->extended_data, n) < n) {
        set_error("fifo read"); return false;
      }
      frame->pts = pts;
      pts += n;
      if (!send_and_mux(frame)) return false;
      av_frame_unref(frame);
    }
    return true;
  };

  // Push converted samples (in encoder format/rate) into the FIFO.
  auto convert_into_fifo = [&](const uint8_t** src, int n_in) -> bool {
    int64_t delay = swr_get_delay(swr, sample_rate);
    int max_out = (int)av_rescale_rnd(delay + n_in, enc_rate, sample_rate,
                                      AV_ROUND_UP) + 256;
    in_frame->nb_samples = max_out;
    av_channel_layout_copy(&in_frame->ch_layout, &c->ch_layout);
    in_frame->format = c->sample_fmt;
    in_frame->sample_rate = enc_rate;
    if (av_frame_get_buffer(in_frame, 0) < 0) { set_error("swr buffer"); return false; }
    int got = swr_convert(swr, in_frame->extended_data, max_out, src, n_in);
    if (got < 0) { set_error("encode convert", got); return false; }
    if (got > 0 &&
        av_audio_fifo_write(fifo, (void**)in_frame->extended_data, got) < got) {
      set_error("fifo write"); av_frame_unref(in_frame); return false;
    }
    av_frame_unref(in_frame);
    return true;
  };

  ok = true;
  long long pos = 0;
  while (pos < frames && ok) {
    int n = (int)((frames - pos) < in_chunk ? (frames - pos) : in_chunk);
    const uint8_t* src = reinterpret_cast<const uint8_t*>(data + pos * channels);
    ok = convert_into_fifo(&src, n) && drain_fifo(enc_chunk - 1);
    pos += n;
  }
  if (ok) ok = convert_into_fifo(nullptr, 0);  // flush resampler tail
  if (ok) ok = drain_fifo(0);                  // drain everything (short last frame ok)
  if (ok) ok = send_and_mux(nullptr);          // flush encoder
  if (ok) {
    err = av_write_trailer(oc);
    if (err < 0) { set_error("trailer", err); ok = false; }
  } else if (header_written) {
    av_write_trailer(oc);  // keep the container parsable even on error
  }

  cleanup();
  return ok ? 0 : -1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Optional CLI build (-DAUDSEP_CLI): the same codec as a tiny subprocess for
// heap isolation. Used by the test suite (an upstream allocator bug corrupts
// long in-process sessions; see tests/conftest.py) and available in
// production via AUDSEP_CODEC_SUBPROCESS=1.
//
//   audsep_codec probe  <path>
//       -> stdout: "<sr> <ch> <frames> <bits>"
//   audsep_codec decode <path> <target_sr|0> <target_ch|0> <out.raw>
//       -> out.raw: int64 frames, int32 ch, int32 sr, then f32 interleaved
//   audsep_codec encode <path> <in.raw> <frames> <ch> <sr> <fmt> <depth> <kbps>
//       -> in.raw: f32 interleaved

#ifdef AUDSEP_CLI
#include <cstdio>
#include <cstdlib>

int main(int argc, char** argv) {
  if (argc < 3) { fprintf(stderr, "usage: %s probe|decode|encode ...\n", argv[0]); return 2; }
  std::string cmd = argv[1];
  if (cmd == "probe") {
    int sr = 0, ch = 0, bits = 0;
    long long frames = 0;
    if (as_probe(argv[2], &sr, &ch, &frames, &bits) != 0) {
      fprintf(stderr, "%s\n", as_last_error());
      return 1;
    }
    printf("%d %d %lld %d\n", sr, ch, frames, bits);
    return 0;
  }
  if (cmd == "decode") {
    if (argc != 6) { fprintf(stderr, "decode args\n"); return 2; }
    float* data = nullptr;
    long long frames = 0;
    int ch = 0, sr = 0;
    if (as_decode(argv[2], atoi(argv[3]), atoi(argv[4]), &data, &frames, &ch, &sr) != 0) {
      fprintf(stderr, "%s\n", as_last_error());
      return 1;
    }
    FILE* f = fopen(argv[5], "wb");
    if (!f) { fprintf(stderr, "cannot open %s\n", argv[5]); return 1; }
    int64_t fr64 = frames;
    int32_t ch32 = ch, sr32 = sr;
    fwrite(&fr64, sizeof(fr64), 1, f);
    fwrite(&ch32, sizeof(ch32), 1, f);
    fwrite(&sr32, sizeof(sr32), 1, f);
    fwrite(data, sizeof(float), (size_t)frames * ch, f);
    fclose(f);
    as_free(data);
    return 0;
  }
  if (cmd == "encode") {
    if (argc != 10) { fprintf(stderr, "encode args\n"); return 2; }
    const char* out_path = argv[2];
    const char* raw_path = argv[3];
    long long frames = atoll(argv[4]);
    int ch = atoi(argv[5]);
    int sr = atoi(argv[6]);
    const char* fmtname = argv[7];
    int depth = atoi(argv[8]);
    int kbps = atoi(argv[9]);
    FILE* f = fopen(raw_path, "rb");
    if (!f) { fprintf(stderr, "cannot open %s\n", raw_path); return 1; }
    size_t count = (size_t)frames * ch;
    float* data = (float*)malloc(count * sizeof(float));
    if (!data || fread(data, sizeof(float), count, f) != count) {
      fprintf(stderr, "raw read failed\n");
      return 1;
    }
    fclose(f);
    int rc = as_encode(out_path, data, frames, ch, sr, fmtname, depth, kbps);
    if (rc != 0) fprintf(stderr, "%s\n", as_last_error());
    free(data);
    return rc == 0 ? 0 : 1;
  }
  fprintf(stderr, "unknown command %s\n", cmd.c_str());
  return 2;
}
#endif  // AUDSEP_CLI
