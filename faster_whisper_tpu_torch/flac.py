"""FLAC decoding: the native decoder and its plain numpy version.

``decode_flac_native`` runs the port's C++ decoder
(``csrc/flac_decoder.cpp``, built with the host ``g++`` at first use by
``ops/_build.py``); ``decode_audio`` decodes FLAC through it.
``decode_flac`` is the same decoder in pure Python and numpy, the port's
copy of ``faster_whisper_tpu/flac.py``: the plain version that the tests
hold the native one to, sample for sample.

Both implement the FLAC stream format: STREAMINFO metadata, frame headers
with UTF-8 coded ordinals, constant/verbatim/fixed/LPC subframes,
Rice-coded residual partitions, and left-side/right-side/mid-side stereo
decorrelation.
"""

from typing import Tuple

import numpy as np


class _BitReader:
    __slots__ = ("data", "pos", "bitbuf", "bitcnt")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.bitbuf = 0
        self.bitcnt = 0

    def _fill(self, need: int):
        data, pos = self.data, self.pos
        while self.bitcnt < need:
            self.bitbuf = (self.bitbuf << 8) | data[pos]
            pos += 1
            self.bitcnt += 8
        self.pos = pos

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.bitcnt < n:
            self._fill(n)
        self.bitcnt -= n
        out = (self.bitbuf >> self.bitcnt) & ((1 << n) - 1)
        self.bitbuf &= (1 << self.bitcnt) - 1
        return out

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        count = 0
        while True:
            if self.bitcnt == 0:
                self.bitbuf = self.data[self.pos]
                self.pos += 1
                self.bitcnt = 8
            # Find highest set bit within the buffered bits.
            if self.bitbuf == 0:
                count += self.bitcnt
                self.bitcnt = 0
                continue
            top = self.bitbuf.bit_length()
            zeros = self.bitcnt - top
            count += zeros
            # consume the zeros and the terminating 1
            self.bitcnt = top - 1
            self.bitbuf &= (1 << self.bitcnt) - 1
            return count

    def align_to_byte(self):
        self.bitcnt -= self.bitcnt % 8
        self.bitbuf &= (1 << self.bitcnt) - 1

    def byte_position(self) -> int:
        return self.pos - self.bitcnt // 8


_FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _read_utf8_coded_number(br: _BitReader) -> int:
    first = br.read(8)
    if first < 0x80:
        return first
    n = 0
    mask = 0x40
    while first & mask:
        n += 1
        mask >>= 1
    value = first & (mask - 1)
    for _ in range(n):
        value = (value << 6) | (br.read(8) & 0x3F)
    return value


def _decode_residual(br: _BitReader, blocksize: int, predictor_order: int):
    """Rice-coded residual: 2-bit method, 4-bit partition order, per-partition
    Rice parameter with escape to raw bits."""
    method = br.read(2)
    if method > 1:
        raise ValueError("invalid FLAC residual coding method")
    param_bits = 4 + method
    escape = (1 << param_bits) - 1
    partition_order = br.read(4)
    n_partitions = 1 << partition_order
    part_size = blocksize >> partition_order

    residual = np.empty(blocksize - predictor_order, dtype=np.int64)
    idx = 0
    for p in range(n_partitions):
        count = part_size - (predictor_order if p == 0 else 0)
        param = br.read(param_bits)
        if param == escape:
            raw_bits = br.read(5)
            if raw_bits == 0:
                residual[idx : idx + count] = 0
            else:
                for i in range(count):
                    residual[idx + i] = br.read_signed(raw_bits)
        else:
            read_unary = br.read_unary
            read = br.read
            for i in range(count):
                q = read_unary()
                u = (q << param) | read(param)
                residual[idx + i] = (u >> 1) ^ -(u & 1)
        idx += count
    return residual


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> np.ndarray:
    if br.read(1) != 0:
        raise ValueError("invalid FLAC subframe padding bit")
    sf_type = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted

    if sf_type == 0:  # CONSTANT
        value = br.read_signed(bps)
        samples = np.full(blocksize, value, dtype=np.int64)
    elif sf_type == 1:  # VERBATIM
        samples = np.empty(blocksize, dtype=np.int64)
        for i in range(blocksize):
            samples[i] = br.read_signed(bps)
    elif 8 <= sf_type <= 12:  # FIXED, order 0-4
        order = sf_type - 8
        samples = np.empty(blocksize, dtype=np.int64)
        for i in range(order):
            samples[i] = br.read_signed(bps)
        residual = _decode_residual(br, blocksize, order)
        coeffs = _FIXED_COEFFS[order]
        s = samples
        if order == 0:
            s[:] = residual
        else:
            for i in range(order, blocksize):
                acc = residual[i - order]
                for j, c in enumerate(coeffs):
                    acc += c * s[i - 1 - j]
                s[i] = acc
    elif sf_type >= 32:  # LPC, order 1-32
        order = sf_type - 31
        samples = np.empty(blocksize, dtype=np.int64)
        for i in range(order):
            samples[i] = br.read_signed(bps)
        precision = br.read(4) + 1
        shift = br.read_signed(5)
        coeffs = [br.read_signed(precision) for _ in range(order)]
        residual = _decode_residual(br, blocksize, order)
        s = samples
        rng = range(order)
        for i in range(order, blocksize):
            acc = 0
            base = i - 1
            for j in rng:
                acc += coeffs[j] * s[base - j]
            s[i] = residual[i - order] + (acc >> shift)
    else:
        raise ValueError(f"reserved FLAC subframe type {sf_type}")

    if wasted:
        samples <<= wasted
    return samples


def decode_flac_native(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a FLAC stream with the native library.

    Returns (samples, sample_rate) where samples is float32 of shape
    (num_samples, channels) scaled to [-1, 1), equal to ``decode_flac``'s.
    Raises ``ValueError`` on a malformed stream, and ``RuntimeError`` when
    the library does not build.
    """
    import ctypes

    from faster_whisper_tpu_torch.ops import _build

    lib = _build.load("flac_decoder.cpp")
    samples = ctypes.POINTER(ctypes.c_int32)()
    n = ctypes.c_int64()
    channels, rate, bps = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.fwt_flac_decode(
        bytes(data), len(data), ctypes.byref(samples), ctypes.byref(n),
        ctypes.byref(channels), ctypes.byref(rate), ctypes.byref(bps),
    )
    if rc != 0:
        raise ValueError(f"malformed FLAC stream (native decoder code {rc})")
    try:
        count = n.value * channels.value
        pcm = np.zeros(0, np.float32)
        if count:
            pcm = np.ctypeslib.as_array(samples, shape=(count,)).astype(np.float32)
    finally:
        lib.fwt_flac_free(samples)
    scale = float(1 << (bps.value - 1))
    return pcm.reshape(n.value, channels.value) / scale, int(rate.value)


def decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a FLAC stream.

    Returns (samples, sample_rate) where samples is float32 of shape
    (num_samples, channels) scaled to [-1, 1).
    """
    samples, sample_rate, bps, _md5 = decode_flac_raw(data)
    scale = float(1 << (bps - 1))
    return (samples.astype(np.float32) / scale), sample_rate


def decode_flac_raw(data: bytes):
    """Decode a FLAC stream to integer PCM.

    Returns (samples, sample_rate, bits_per_sample, md5) where samples is an
    int64 array of shape (num_samples, channels) and md5 is the STREAMINFO
    checksum of the unencoded audio (bytes), usable to verify the decode.
    """
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")

    pos = 4
    streaminfo = None
    while True:
        header = data[pos]
        last = header & 0x80
        block_type = header & 0x7F
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        body = data[pos + 4 : pos + 4 + length]
        if block_type == 0:
            streaminfo = body
        pos += 4 + length
        if last:
            break
    if streaminfo is None:
        raise ValueError("FLAC stream missing STREAMINFO")

    si = int.from_bytes(streaminfo, "big")
    bits_total = len(streaminfo) * 8
    # Layout (bits): 16 16 24 24 | 20 rate | 3 channels-1 | 5 bps-1 | 36 total
    off = bits_total - (16 + 16 + 24 + 24)

    def si_field(width, cursor=[16 + 16 + 24 + 24]):
        start = cursor[0]
        cursor[0] += width
        return (si >> (bits_total - start - width)) & ((1 << width) - 1)

    sample_rate = si_field(20)
    channels = si_field(3) + 1
    bps_default = si_field(5) + 1
    total_samples = si_field(36)
    md5 = streaminfo[-16:]
    del off

    out = []
    n = len(data)
    decoded = 0
    while pos < n - 1:
        # Frame sync: 11111111 111110xx
        if data[pos] != 0xFF or (data[pos + 1] & 0xFC) != 0xF8:
            pos += 1
            continue
        br = _BitReader(data, pos)
        br.read(14)  # sync
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        chan_code = br.read(4)
        size_code = br.read(3)
        br.read(1)  # reserved
        _read_utf8_coded_number(br)

        if bs_code == 0:
            raise ValueError("reserved FLAC block size code")
        elif bs_code == 1:
            blocksize = 192
        elif bs_code <= 5:
            blocksize = 576 << (bs_code - 2)
        elif bs_code == 6:
            blocksize = br.read(8) + 1
        elif bs_code == 7:
            blocksize = br.read(16) + 1
        else:
            blocksize = 256 << (bs_code - 8)

        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)

        br.read(8)  # CRC-8 of the frame header

        bps_map = {0: bps_default, 1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
        bps = bps_map.get(size_code)
        if bps is None:
            raise ValueError("reserved FLAC sample size code")

        if chan_code < 8:
            n_ch = chan_code + 1
            chans = [_decode_subframe(br, blocksize, bps) for _ in range(n_ch)]
        elif chan_code == 8:  # left/side
            left = _decode_subframe(br, blocksize, bps)
            side = _decode_subframe(br, blocksize, bps + 1)
            chans = [left, left - side]
        elif chan_code == 9:  # right/side
            side = _decode_subframe(br, blocksize, bps + 1)
            right = _decode_subframe(br, blocksize, bps)
            chans = [right + side, right]
        elif chan_code == 10:  # mid/side
            mid = _decode_subframe(br, blocksize, bps)
            side = _decode_subframe(br, blocksize, bps + 1)
            mid2 = (mid << 1) | (side & 1)
            chans = [(mid2 + side) >> 1, (mid2 - side) >> 1]
        else:
            raise ValueError("reserved FLAC channel assignment")

        br.align_to_byte()
        pos = br.byte_position() + 2  # skip frame CRC-16

        out.append(np.stack(chans, axis=1))
        decoded += blocksize
        if total_samples and decoded >= total_samples:
            break

    if not out:
        samples = np.zeros((0, channels), dtype=np.int64)
    else:
        samples = np.concatenate(out, axis=0)
        if total_samples:
            samples = samples[:total_samples]
    return samples, sample_rate, bps_default, md5
