"""Minimal FLAC encoder (a copy of `speechless_tpu/features/flac_encoder.py`; pure
Python, no ffmpeg or soundfile needed).

Supports 16-bit mono/stereo with CONSTANT, VERBATIM and FIXED(order 0-2, Rice-coded)
subframes, enough for speech corpora: it writes the decoder's test vectors
(`tests/test_torch_flac.py`, decoder: `native/flac.cpp`) and the FLAC request of
`chip_smoke.py`."""
import struct


class BitWriter:
    def __init__(self):
        self.bytes = bytearray()
        self._acc = 0
        self._bits = 0

    def write(self, value, count):
        value &= (1 << count) - 1
        self._acc = (self._acc << count) | value
        self._bits += count
        while self._bits >= 8:
            self._bits -= 8
            self.bytes.append((self._acc >> self._bits) & 0xFF)
        self._acc &= (1 << self._bits) - 1

    def write_signed(self, value, count):
        self.write(value & ((1 << count) - 1), count)

    def write_unary(self, value):
        for _ in range(value):
            self.write(0, 1)
        self.write(1, 1)

    def align(self):
        if self._bits:
            self.write(0, 8 - self._bits)

    def getvalue(self):
        self.align()
        return bytes(self.bytes)


def _zigzag(value):
    return (abs(value) << 1) - (1 if value < 0 else 0) if value != 0 else 0


def write_rice(writer, residuals, param):
    for r in residuals:
        z = _zigzag(r)
        writer.write_unary(z >> param)
        if param:
            writer.write(z & ((1 << param) - 1), param)


FIXED_PREDICT = {
    0: lambda s, i: 0,
    1: lambda s, i: s[i - 1],
    2: lambda s, i: 2 * s[i - 1] - s[i - 2],
}


def write_subframe(writer, samples, bps, mode):
    writer.write(0, 1)  # padding
    if mode == "constant":
        writer.write(0, 6)
        writer.write(0, 1)  # no wasted bits
        writer.write_signed(samples[0], bps)
    elif mode == "verbatim":
        writer.write(1, 6)
        writer.write(0, 1)
        for s in samples:
            writer.write_signed(s, bps)
    elif mode.startswith("fixed"):
        order = int(mode[-1])
        writer.write(8 | order, 6)
        writer.write(0, 1)
        for s in samples[:order]:
            writer.write_signed(s, bps)
        residuals = [samples[i] - FIXED_PREDICT[order](samples, i)
                     for i in range(order, len(samples))]
        writer.write(0, 2)   # rice method 0
        writer.write(0, 4)   # partition order 0
        param = 6
        writer.write(param, 4)
        write_rice(writer, residuals, param)
    else:
        raise ValueError(mode)


def encode_flac(path, channels_data, sample_rate=16000, bps=16, block_size=4096,
                subframe_mode="verbatim"):
    """channels_data: list of per-channel int sample lists (equal lengths)."""
    n_channels = len(channels_data)
    total = len(channels_data[0])

    out = bytearray(b"fLaC")
    # STREAMINFO metadata block (last=1, type=0, length=34)
    out += struct.pack(">BBH", 0x80, 0, 34)[0:1] + struct.pack(">I", 34)[1:4]
    info = BitWriter()
    # STREAMINFO min/max block size: per the FLAC spec (RFC 9639) the final frame
    # is EXCLUDED from min/max, and a fixed blocking strategy (every frame header
    # below sets strategy bit 0) is declared by min == max == block_size — a
    # shorter last frame is expected and does not make the stream variable-size.
    info.write(block_size, 16)
    info.write(block_size, 16)
    info.write(0, 24)
    info.write(0, 24)
    info.write(sample_rate, 20)
    info.write(n_channels - 1, 3)
    info.write(bps - 1, 5)
    info.write(total, 36)
    streaminfo = info.getvalue() + b"\x00" * 16
    assert len(streaminfo) == 34
    out += streaminfo

    frame_index = 0
    for start in range(0, total, block_size):
        chunk = [ch[start:start + block_size] for ch in channels_data]
        size = len(chunk[0])
        writer = BitWriter()
        writer.write(0x3FFE, 14)
        writer.write(0, 1)  # reserved
        writer.write(0, 1)  # fixed blocksize strategy
        writer.write(7, 4)  # block size: 16 bits - 1 follows
        writer.write(0, 4)  # sample rate from STREAMINFO
        writer.write(n_channels - 1, 4)  # independent channels
        writer.write(4, 3)  # 16 bits per sample
        writer.write(0, 1)
        # UTF-8 frame number (single byte for < 128)
        assert frame_index < 128
        writer.write(frame_index, 8)
        writer.write(size - 1, 16)
        writer.write(0, 8)  # CRC-8 (decoder skips it)
        for ch in chunk:
            write_subframe(writer, ch, bps, subframe_mode)
        writer.align()
        writer.write(0, 16)  # CRC-16 (decoder skips it)
        out += writer.getvalue()
        frame_index += 1

    with open(path, "wb") as f:
        f.write(bytes(out))
