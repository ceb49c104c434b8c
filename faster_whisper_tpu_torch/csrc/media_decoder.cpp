// Native media decoder of faster_whisper_tpu_torch, a host (CPU) library.
// The port's copy of the JAX package's native/media_decoder.cpp, loaded by
// media_native.py through ops/_build.py.
//
// Decodes any container/codec FFmpeg's libavformat/libavcodec understand
// (MP3, M4A/AAC, OGG, Opus, WebM, ...) from an in-memory buffer to
// interleaved s16 PCM at a caller-chosen rate and channel count, using
// libswresample for the rate/layout conversion: the decode path the
// reference reaches through PyAV (s16 resample to mono/stereo at the
// target rate, invalid frames skipped), linked directly against the
// system FFmpeg C libraries with a plain C ABI.
//
// Built at first use by ops/_build.py with the host g++ into build/,
// linked with -lavformat -lavcodec -lavutil -lswresample.  It is not part
// of the default build set: a machine without FFmpeg's headers builds
// everything else.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/mem.h>
#include <libswresample/swresample.h>
}

namespace {

struct MemCtx {
  const uint8_t* data;
  size_t size;
  size_t pos;
};

int mem_read(void* opaque, uint8_t* buf, int buf_size) {
  MemCtx* m = static_cast<MemCtx*>(opaque);
  size_t remain = m->size - m->pos;
  if (remain == 0) return AVERROR_EOF;
  size_t n = remain < static_cast<size_t>(buf_size) ? remain
                                                    : static_cast<size_t>(buf_size);
  memcpy(buf, m->data + m->pos, n);
  m->pos += n;
  return static_cast<int>(n);
}

int64_t mem_seek(void* opaque, int64_t offset, int whence) {
  MemCtx* m = static_cast<MemCtx*>(opaque);
  if (whence == AVSEEK_SIZE) return static_cast<int64_t>(m->size);
  int64_t np;
  switch (whence & ~AVSEEK_FORCE) {
    case SEEK_SET: np = offset; break;
    case SEEK_CUR: np = static_cast<int64_t>(m->pos) + offset; break;
    case SEEK_END: np = static_cast<int64_t>(m->size) + offset; break;
    default: return -1;
  }
  if (np < 0 || np > static_cast<int64_t>(m->size)) return -1;
  m->pos = static_cast<size_t>(np);
  return np;
}

struct Decoder {
  AVFormatContext* fmt = nullptr;
  AVIOContext* avio = nullptr;
  AVCodecContext* ctx = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frm = nullptr;
  AVChannelLayout out_layout{};

  ~Decoder() {
    if (swr) swr_free(&swr);
    if (frm) av_frame_free(&frm);
    if (pkt) av_packet_free(&pkt);
    if (ctx) avcodec_free_context(&ctx);
    if (fmt) avformat_close_input(&fmt);
    if (avio) {
      av_freep(&avio->buffer);
      avio_context_free(&avio);
    }
    av_channel_layout_uninit(&out_layout);
  }
};

}  // namespace

extern "C" {

// Returns 0 on success.  *out is malloc'd interleaved s16
// (*out_frames x channels); caller frees with fwt_media_free.
int fwt_media_decode(const uint8_t* data, size_t size, int target_rate,
                     int channels, int16_t** out, int64_t* out_frames) {
  if (!data || size == 0 || target_rate <= 0 ||
      (channels != 1 && channels != 2) || !out || !out_frames)
    return -1;
  av_log_set_level(AV_LOG_QUIET);

  Decoder d;
  MemCtx mem{data, size, 0};

  const int kBuf = 1 << 16;
  uint8_t* iobuf = static_cast<uint8_t*>(av_malloc(kBuf));
  if (!iobuf) return -2;
  d.avio = avio_alloc_context(iobuf, kBuf, 0, &mem, mem_read, nullptr, mem_seek);
  if (!d.avio) {
    av_free(iobuf);
    return -2;
  }

  d.fmt = avformat_alloc_context();
  if (!d.fmt) return -2;
  d.fmt->pb = d.avio;
  d.fmt->flags |= AVFMT_FLAG_CUSTOM_IO;

  if (avformat_open_input(&d.fmt, nullptr, nullptr, nullptr) < 0) {
    d.fmt = nullptr;  // freed by avformat_open_input on failure
    return -3;
  }
  if (avformat_find_stream_info(d.fmt, nullptr) < 0) return -3;

  int si = av_find_best_stream(d.fmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
  if (si < 0) return -4;
  AVStream* st = d.fmt->streams[si];

  const AVCodec* dec = avcodec_find_decoder(st->codecpar->codec_id);
  if (!dec) return -5;
  d.ctx = avcodec_alloc_context3(dec);
  if (!d.ctx) return -2;
  if (avcodec_parameters_to_context(d.ctx, st->codecpar) < 0) return -5;
  if (avcodec_open2(d.ctx, dec, nullptr) < 0) return -5;

  av_channel_layout_default(&d.out_layout, channels);

  d.pkt = av_packet_alloc();
  d.frm = av_frame_alloc();
  if (!d.pkt || !d.frm) return -2;

  std::vector<int16_t> pcm;

  auto convert = [&](const AVFrame* f) {
    if (!d.swr) {
      AVChannelLayout in_layout;
      if (f->ch_layout.nb_channels > 0) {
        av_channel_layout_copy(&in_layout, &f->ch_layout);
      } else {
        av_channel_layout_default(&in_layout, 1);
      }
      int rc = swr_alloc_set_opts2(
          &d.swr, &d.out_layout, AV_SAMPLE_FMT_S16, target_rate, &in_layout,
          static_cast<AVSampleFormat>(f->format), f->sample_rate, 0, nullptr);
      av_channel_layout_uninit(&in_layout);
      if (rc < 0 || swr_init(d.swr) < 0) {
        if (d.swr) swr_free(&d.swr);
        return false;
      }
    }
    int cap = swr_get_out_samples(d.swr, f->nb_samples);
    if (cap <= 0) return true;
    size_t old = pcm.size();
    pcm.resize(old + static_cast<size_t>(cap) * channels);
    uint8_t* outp = reinterpret_cast<uint8_t*>(pcm.data() + old);
    int got = swr_convert(d.swr, &outp, cap,
                          const_cast<const uint8_t**>(f->extended_data),
                          f->nb_samples);
    if (got < 0) got = 0;
    pcm.resize(old + static_cast<size_t>(got) * channels);
    return true;
  };

  // Demux + decode; invalid packets are skipped, matching the reference's
  // tolerance of InvalidDataError frames (faster_whisper/audio.py:79-88).
  while (av_read_frame(d.fmt, d.pkt) >= 0) {
    if (d.pkt->stream_index == si) {
      if (avcodec_send_packet(d.ctx, d.pkt) >= 0) {
        while (avcodec_receive_frame(d.ctx, d.frm) >= 0) {
          if (!convert(d.frm)) {
            av_frame_unref(d.frm);
            av_packet_unref(d.pkt);
            return -6;
          }
          av_frame_unref(d.frm);
        }
      }
    }
    av_packet_unref(d.pkt);
  }

  // Flush the decoder.
  avcodec_send_packet(d.ctx, nullptr);
  while (avcodec_receive_frame(d.ctx, d.frm) >= 0) {
    if (!convert(d.frm)) {
      av_frame_unref(d.frm);
      return -6;
    }
    av_frame_unref(d.frm);
  }

  // Flush the resampler's internal delay line.
  if (d.swr) {
    for (;;) {
      int cap = swr_get_out_samples(d.swr, 0);
      if (cap <= 0) cap = 4096;
      size_t old = pcm.size();
      pcm.resize(old + static_cast<size_t>(cap) * channels);
      uint8_t* outp = reinterpret_cast<uint8_t*>(pcm.data() + old);
      int got = swr_convert(d.swr, &outp, cap, nullptr, 0);
      if (got <= 0) {
        pcm.resize(old);
        break;
      }
      pcm.resize(old + static_cast<size_t>(got) * channels);
    }
  }

  int64_t frames = static_cast<int64_t>(pcm.size() / channels);
  int16_t* buf = static_cast<int16_t*>(malloc(pcm.size() * sizeof(int16_t) + 1));
  if (!buf) return -2;
  if (!pcm.empty()) memcpy(buf, pcm.data(), pcm.size() * sizeof(int16_t));
  *out = buf;
  *out_frames = frames;
  return 0;
}

void fwt_media_free(int16_t* p) { free(p); }

}  // extern "C"
