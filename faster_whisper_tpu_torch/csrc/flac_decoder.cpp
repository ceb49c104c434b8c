// Native FLAC decoder of faster_whisper_tpu_torch, a host (CPU) library.
//
// The C-ABI fast path of decode_audio for FLAC, equal sample for sample to
// the numpy decoder in faster_whisper_tpu_torch/flac.py (same format
// coverage: STREAMINFO, frame headers with UTF-8 ordinals,
// constant/verbatim/fixed/LPC subframes, Rice residual partitions, stereo
// decorrelation), which stays as its plain version.
//
// Built at first use by ops/_build.py with the host g++ into build/.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;      // byte position
  uint64_t buf = 0;    // bit buffer (ms-aligned value)
  int bits = 0;        // bits available in buf

  explicit BitReader(const uint8_t* d, size_t n, size_t start)
      : data(d), size(n), pos(start) {}

  bool fill(int need) {
    while (bits < need) {
      if (pos >= size) return false;
      buf = (buf << 8) | data[pos++];
      bits += 8;
    }
    return true;
  }

  // read n bits (n <= 32)
  inline uint32_t read(int n) {
    if (n == 0) return 0;
    if (!fill(n)) return 0;
    bits -= n;
    uint32_t out = static_cast<uint32_t>((buf >> bits) & ((1ull << n) - 1));
    buf &= (1ull << bits) - 1;
    return out;
  }

  inline int64_t read_signed(int n) {
    int64_t v = read(n);
    if (v >= (1ll << (n - 1))) v -= (1ll << n);
    return v;
  }

  inline uint32_t read_unary() {
    uint32_t count = 0;
    for (;;) {
      if (bits == 0) {
        if (pos >= size) return count;
        buf = data[pos++];
        bits = 8;
      }
      if (buf == 0) {
        count += bits;
        bits = 0;
        continue;
      }
      // position of highest set bit
      int top = 63 - __builtin_clzll(buf);
      int zeros = bits - 1 - top;
      count += zeros;
      bits = top;
      buf &= (1ull << bits) - 1;
      return count;
    }
  }

  void align() {
    int drop = bits % 8;
    bits -= drop;
    buf &= (1ull << bits) - 1;
  }

  size_t byte_position() const { return pos - bits / 8; }
};

bool decode_residual(BitReader& br, int blocksize, int order,
                     std::vector<int64_t>& res) {
  uint32_t method = br.read(2);
  if (method > 1) return false;
  int pbits = 4 + static_cast<int>(method);
  uint32_t escape = (1u << pbits) - 1;
  int porder = static_cast<int>(br.read(4));
  int nparts = 1 << porder;
  int psize = blocksize >> porder;

  res.resize(blocksize - order);
  size_t idx = 0;
  for (int p = 0; p < nparts; p++) {
    int count = psize - (p == 0 ? order : 0);
    uint32_t param = br.read(pbits);
    if (param == escape) {
      int raw = static_cast<int>(br.read(5));
      if (raw == 0) {
        for (int i = 0; i < count; i++) res[idx++] = 0;
      } else {
        for (int i = 0; i < count; i++) res[idx++] = br.read_signed(raw);
      }
    } else {
      for (int i = 0; i < count; i++) {
        uint64_t q = br.read_unary();
        uint64_t u = (q << param) | br.read(static_cast<int>(param));
        res[idx++] = static_cast<int64_t>(u >> 1) ^ -static_cast<int64_t>(u & 1);
      }
    }
  }
  return true;
}

bool decode_subframe(BitReader& br, int blocksize, int bps,
                     std::vector<int64_t>& out) {
  if (br.read(1) != 0) return false;
  int type = static_cast<int>(br.read(6));
  int wasted = 0;
  if (br.read(1)) wasted = 1 + static_cast<int>(br.read_unary());
  bps -= wasted;

  out.resize(blocksize);
  std::vector<int64_t> res;

  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < blocksize; i++) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; i++) out[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED
    int order = type - 8;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(bps);
    if (!decode_residual(br, blocksize, order, res)) return false;
    switch (order) {
      case 0:
        for (int i = 0; i < blocksize; i++) out[i] = res[i];
        break;
      case 1:
        for (int i = 1; i < blocksize; i++) out[i] = res[i - 1] + out[i - 1];
        break;
      case 2:
        for (int i = 2; i < blocksize; i++)
          out[i] = res[i - 2] + 2 * out[i - 1] - out[i - 2];
        break;
      case 3:
        for (int i = 3; i < blocksize; i++)
          out[i] = res[i - 3] + 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
        break;
      case 4:
        for (int i = 4; i < blocksize; i++)
          out[i] = res[i - 4] + 4 * out[i - 1] - 6 * out[i - 2] +
                   4 * out[i - 3] - out[i - 4];
        break;
    }
  } else if (type >= 32) {  // LPC
    int order = type - 31;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(bps);
    int precision = static_cast<int>(br.read(4)) + 1;
    int shift = static_cast<int>(br.read_signed(5));
    int64_t coeffs[32];
    for (int i = 0; i < order; i++) coeffs[i] = br.read_signed(precision);
    if (!decode_residual(br, blocksize, order, res)) return false;
    for (int i = order; i < blocksize; i++) {
      int64_t acc = 0;
      for (int j = 0; j < order; j++) acc += coeffs[j] * out[i - 1 - j];
      out[i] = res[i - order] + (acc >> shift);
    }
  } else {
    return false;
  }

  if (wasted)
    for (int i = 0; i < blocksize; i++) out[i] <<= wasted;
  return true;
}

uint64_t read_utf8_ordinal(BitReader& br) {
  uint32_t first = br.read(8);
  if (first < 0x80) return first;
  int n = 0;
  uint32_t mask = 0x40;
  while (first & mask) {
    n++;
    mask >>= 1;
  }
  uint64_t value = first & (mask - 1);
  for (int i = 0; i < n; i++) value = (value << 6) | (br.read(8) & 0x3F);
  return value;
}

}  // namespace

extern "C" {

// Decodes a FLAC stream.  On success returns 0 and fills the outputs:
// *out_samples: malloc'd interleaved int32 samples (n_samples * channels).
// Caller frees with fwt_flac_free.
int fwt_flac_decode(const uint8_t* data, size_t size, int32_t** out_samples,
                    int64_t* out_n_samples, int32_t* out_channels,
                    int32_t* out_rate, int32_t* out_bps) {
  if (size < 42 || memcmp(data, "fLaC", 4) != 0) return -1;

  size_t pos = 4;
  const uint8_t* si = nullptr;
  for (;;) {
    if (pos + 4 > size) return -2;
    uint8_t header = data[pos];
    uint32_t length = (data[pos + 1] << 16) | (data[pos + 2] << 8) | data[pos + 3];
    if ((header & 0x7F) == 0) si = data + pos + 4;
    pos += 4 + length;
    if (header & 0x80) break;
  }
  if (!si) return -3;

  uint32_t rate = (si[10] << 12) | (si[11] << 4) | (si[12] >> 4);
  int channels = ((si[12] >> 1) & 0x7) + 1;
  int bps = (((si[12] & 1) << 4) | (si[13] >> 4)) + 1;
  uint64_t total = (static_cast<uint64_t>(si[13] & 0x0F) << 32) |
                   (static_cast<uint64_t>(si[14]) << 24) | (si[15] << 16) |
                   (si[16] << 8) | si[17];

  std::vector<int32_t> pcm;
  if (total) pcm.reserve(static_cast<size_t>(total) * channels);

  std::vector<int64_t> ch[8];
  uint64_t decoded = 0;

  while (pos + 2 < size) {
    if (data[pos] != 0xFF || (data[pos + 1] & 0xFC) != 0xF8) {
      pos++;
      continue;
    }
    BitReader br(data, size, pos);
    br.read(16);  // sync + reserved + blocking strategy
    int bs_code = static_cast<int>(br.read(4));
    int sr_code = static_cast<int>(br.read(4));
    int chan_code = static_cast<int>(br.read(4));
    int size_code = static_cast<int>(br.read(3));
    br.read(1);
    read_utf8_ordinal(br);

    int blocksize;
    if (bs_code == 0) return -4;
    else if (bs_code == 1) blocksize = 192;
    else if (bs_code <= 5) blocksize = 576 << (bs_code - 2);
    else if (bs_code == 6) blocksize = static_cast<int>(br.read(8)) + 1;
    else if (bs_code == 7) blocksize = static_cast<int>(br.read(16)) + 1;
    else blocksize = 256 << (bs_code - 8);

    if (sr_code == 12) br.read(8);
    else if (sr_code == 13 || sr_code == 14) br.read(16);
    br.read(8);  // header CRC

    static const int bps_map[8] = {0, 8, 12, -1, 16, 20, 24, 32};
    int fbps = size_code == 0 ? bps : bps_map[size_code];
    if (fbps <= 0) return -5;

    int nch;
    bool ok = true;
    if (chan_code < 8) {
      nch = chan_code + 1;
      for (int c = 0; c < nch && ok; c++)
        ok = decode_subframe(br, blocksize, fbps, ch[c]);
    } else {
      nch = 2;
      if (chan_code == 8) {  // left/side
        ok = decode_subframe(br, blocksize, fbps, ch[0]) &&
             decode_subframe(br, blocksize, fbps + 1, ch[1]);
        if (ok)
          for (int i = 0; i < blocksize; i++) ch[1][i] = ch[0][i] - ch[1][i];
      } else if (chan_code == 9) {  // right/side
        ok = decode_subframe(br, blocksize, fbps + 1, ch[0]) &&
             decode_subframe(br, blocksize, fbps, ch[1]);
        if (ok)
          for (int i = 0; i < blocksize; i++) ch[0][i] = ch[1][i] + ch[0][i];
      } else if (chan_code == 10) {  // mid/side
        ok = decode_subframe(br, blocksize, fbps, ch[0]) &&
             decode_subframe(br, blocksize, fbps + 1, ch[1]);
        if (ok) {
          for (int i = 0; i < blocksize; i++) {
            int64_t side = ch[1][i];
            int64_t mid2 = (ch[0][i] << 1) | (side & 1);
            ch[0][i] = (mid2 + side) >> 1;
            ch[1][i] = (mid2 - side) >> 1;
          }
        }
      } else {
        return -6;
      }
    }
    if (!ok) return -7;

    br.align();
    pos = br.byte_position() + 2;  // skip frame CRC-16

    int keep = blocksize;
    if (total && decoded + keep > total) keep = static_cast<int>(total - decoded);
    for (int i = 0; i < keep; i++)
      for (int c = 0; c < nch; c++)
        pcm.push_back(static_cast<int32_t>(ch[c][i]));
    decoded += keep;
    if (total && decoded >= total) break;
  }

  int64_t n = static_cast<int64_t>(pcm.size()) / channels;
  int32_t* buf = static_cast<int32_t*>(malloc(pcm.size() * sizeof(int32_t)));
  if (!buf) return -8;
  memcpy(buf, pcm.data(), pcm.size() * sizeof(int32_t));

  *out_samples = buf;
  *out_n_samples = n;
  *out_channels = channels;
  *out_rate = static_cast<int32_t>(rate);
  *out_bps = bps;
  return 0;
}

void fwt_flac_free(int32_t* p) { free(p); }

}  // extern "C"
