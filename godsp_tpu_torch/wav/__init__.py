"""RIFF/WAVE ingest (reference wav/wav.go:23-161).

Port of godsp_tpu/wav/__init__.py: numpy plus the native host decode
(godsp_tpu_torch.native).  Host-side streaming reader that feeds the
device.  Semantics preserved
exactly, including the reference's documented quirks (SURVEY.md appendix):

  * formats: PCM 8/16-bit and IEEE float32 (wav.go:33-36, 90-95) — plus,
    BEYOND the reference's whitelist, PCM 24/32-bit and
    WAVE_FORMAT_EXTENSIBLE (0xFFFE) headers, normalized by the same
    [0, 1] convention extended to the wider widths;
  * unknown chunks (JUNK, bext, ...) are skipped (wav.go:105-106);
  * Samples = data_size / BitsPerSample * 8 — ignores NumChannels
    (wav.go:101); Duration DOES divide by NumChannels (wav.go:102);
  * read_floats normalizes uint8 -> v/255 in [0,1] and
    int16 -> (v + 32768)/65535 in [0,1] — NOT the conventional [-1,1]
    (wav.go:144-159).

Decoding is vectorized numpy (bulk frombuffer, not per-sample unpacking);
`blocks()` streams fixed-size time blocks for the distributed Pwelch
pipeline (the analogue of ReadSamples' LimitReader streaming).
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass
from typing import BinaryIO, Iterator, Union

import numpy as np

__all__ = [
    "Header",
    "Wav",
    "WavFormatError",
    "WavWriter",
    "new",
    "read_wav",
    "write_wav",
]

WAV_FORMAT_PCM = 1
WAV_FORMAT_IEEE_FLOAT = 3
WAV_FORMAT_EXTENSIBLE = 0xFFFE  # real-world 24-bit files usually use this


class WavFormatError(ValueError):
    """Raised for malformed or unsupported WAV data (reference returns
    error values, wav.go:67-99)."""


@dataclass
class Header:
    """fmt-chunk data (wav.go:39-46), little-endian packed order."""

    audio_format: int = 0
    num_channels: int = 0
    sample_rate: int = 0
    byte_rate: int = 0
    block_align: int = 0
    bits_per_sample: int = 0


class Wav:
    """Streaming WAV reader (wav.go:49-57).

    Attributes:
      header:      parsed fmt chunk.
      samples:     total available samples = data_size/bits*8 — note this
                   intentionally ignores num_channels (wav.go:101).
      duration_ns: estimated duration in integer nanoseconds, computed as
                   samples * 1e9 // rate // channels like Go's
                   time.Duration arithmetic (wav.go:102).
    """

    def __init__(self, header: Header, data_size: int, r: BinaryIO):
        self.header = header
        self.samples = data_size // header.bits_per_sample * 8
        self.duration_ns = (
            self.samples * 1_000_000_000 // header.sample_rate // header.num_channels
        )
        self._remaining = data_size  # LimitReader equivalent (wav.go:103)
        self._r = r

    # convenience accessors mirroring the embedded Header
    @property
    def audio_format(self) -> int:
        return self.header.audio_format

    @property
    def num_channels(self) -> int:
        return self.header.num_channels

    @property
    def sample_rate(self) -> int:
        return self.header.sample_rate

    @property
    def bits_per_sample(self) -> int:
        return self.header.bits_per_sample

    @property
    def duration_seconds(self) -> float:
        return self.duration_ns / 1e9

    def _sample_width(self) -> int:
        """Bytes per sample; validates the format/width combination."""
        fmt, bits = self.header.audio_format, self.header.bits_per_sample
        if fmt == WAV_FORMAT_PCM:
            if bits in (8, 16, 24, 32):
                return bits // 8
            raise WavFormatError(f"wav: unknown bits per sample: {bits}")
        if fmt == WAV_FORMAT_IEEE_FLOAT:
            return 4
        raise WavFormatError("wav: unknown audio format")

    def _sample_dtype(self) -> np.dtype:
        if self.header.audio_format == WAV_FORMAT_PCM:
            return {
                8: np.dtype("<u1"),
                16: np.dtype("<i2"),
                24: np.dtype("<i4"),  # decoded/sign-extended to int32
                32: np.dtype("<i4"),
            }[self.header.bits_per_sample]
        return np.dtype("<f4")

    def read_samples(self, n: int) -> np.ndarray:
        """Next n raw samples as uint8 | int16 | int32 | float32
        (wav.go:113-134; 24-bit packs are sign-extended to int32).

        Raises EOFError if fewer than n samples remain (binary.Read
        semantics: all-or-nothing).
        """
        width = self._sample_width()
        nbytes = n * width
        if nbytes > self._remaining:
            raise EOFError("wav: unexpected EOF")
        buf = self._r.read(nbytes)
        if len(buf) < nbytes:
            raise EOFError("wav: unexpected EOF")
        self._remaining -= nbytes
        if (
            self.header.audio_format == WAV_FORMAT_PCM
            and self.header.bits_per_sample == 24
        ):
            b = np.frombuffer(buf, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
            v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
            return ((v ^ 0x800000) - 0x800000).astype(np.int32)  # sign-extend
        return np.frombuffer(buf, dtype=self._sample_dtype())

    def read_floats(self, n: int) -> np.ndarray:
        """Next n samples normalized to float32 (wav.go:138-161).

        Quirk preserved: integer formats map to [0, 1], not [-1, 1]:
        uint8 -> v/255, int16 -> (v + 32768)/65535.  Decoding runs in the
        native C++ op when built (godsp_tpu_torch.native), numpy otherwise.
        """
        from godsp_tpu_torch import native

        d = self.read_samples(n)
        if d.dtype == np.uint8:
            return native.decode_u8(d)
        if d.dtype == np.int16:
            return native.decode_i16(d)
        if d.dtype == np.int32:
            # Beyond-reference widths, same [0,1] convention extended:
            # intN -> (v + 2^(N-1)) / (2^N - 1).
            bits = self.header.bits_per_sample
            lo, span = 1 << (bits - 1), (1 << bits) - 1
            return ((d.astype(np.float64) + lo) / span).astype(np.float32)
        return d  # float32 passthrough

    @property
    def samples_remaining(self) -> int:
        return self._remaining // self._sample_width()

    def read_channels(self, n_frames: int) -> np.ndarray:
        """Next n_frames deinterleaved frames as (num_channels, n_frames)
        normalized float32.

        Convenience beyond the reference (whose ReadFloats returns the
        interleaved stream, wav.go:138-141); pairs with the multichannel
        streaming Pwelch (parallel.StreamingPwelch(channels=C)).
        """
        c = self.header.num_channels
        flat = self.read_floats(n_frames * c)
        return np.ascontiguousarray(flat.reshape(n_frames, c).T)

    def close(self) -> None:
        """Close the underlying stream."""
        self._r.close()

    def blocks(self, block_size: int, pad_final: bool = False) -> Iterator[np.ndarray]:
        """Stream normalized-float time blocks of block_size samples.

        The host-side feeder for the sharded streaming Pwelch pipeline.
        The final partial block is yielded as-is (or zero-padded to
        block_size when pad_final), never dropped.
        """
        while self.samples_remaining > 0:
            n = min(block_size, self.samples_remaining)
            block = self.read_floats(n)
            if pad_final and n < block_size:
                block = np.pad(block, (0, block_size - n))
            yield block


def new(r: Union[BinaryIO, bytes]) -> Wav:
    """Parse the WAV header from a stream (wav.go:60-110).

    Scans RIFF chunks, parsing `fmt ` and stopping at `data`; all other
    chunk types are skipped.  Raises WavFormatError / EOFError where the
    reference returns errors.
    """
    if isinstance(r, (bytes, bytearray)):
        r = io.BytesIO(r)

    def read_full(n: int) -> bytes:
        b = r.read(n)
        if len(b) < n:
            raise EOFError("wav: unexpected EOF")
        return b

    hdr = read_full(12)
    if hdr[0:4] != b"RIFF":
        raise WavFormatError("wav: missing RIFF")
    if hdr[8:12] != b"WAVE":
        raise WavFormatError("wav: missing WAVE")

    header: Header | None = None
    while True:
        chunk = read_full(8)
        typ = chunk[:4]
        sz = struct.unpack("<I", chunk[4:])[0]
        if typ == b"fmt ":
            if sz < 16:
                raise WavFormatError("wav: bad fmt size")
            f = read_full(sz)
            fields = struct.unpack("<HHIIHH", f[:16])
            header = Header(*fields)
            if header.audio_format == WAV_FORMAT_EXTENSIBLE and sz >= 40:
                # fmt extension: cbSize(2) validBits(2) channelMask(4)
                # GUID(16); the GUID's first two bytes are the real
                # format code (beyond the reference's whitelist).
                header.audio_format = struct.unpack("<H", f[24:26])[0]
            if header.audio_format not in (WAV_FORMAT_PCM, WAV_FORMAT_IEEE_FLOAT):
                raise WavFormatError(
                    f"wav: unknown audio format: {header.audio_format:02x}"
                )
        elif typ == b"data":
            if header is None:
                raise WavFormatError("wav: unexpected fmt chunk")
            return Wav(header, sz, r)
        else:
            read_full(sz)  # skip JUNK/bext/... (wav.go:105-106)


def read_wav(src) -> Wav:
    """Open a WAV by filesystem path, byte buffer, or stream."""
    if isinstance(src, str):
        return new(open(src, "rb"))
    return new(src)


def write_wav(path_or_stream, samples: np.ndarray, sample_rate: int) -> None:
    """Write a WAV file (PCM16 for integer input, IEEE float32 for float
    input).  samples: (n,) mono or (channels, n) — channels interleave.
    Test/benchmark fixture generator; the reference has no writer.
    """
    samples = np.asarray(samples)
    channels = 1
    if samples.ndim == 2:
        channels = samples.shape[0]
        samples = samples.T.reshape(-1)  # interleave frames
    if samples.dtype.kind == "f":
        data = samples.astype("<f4").tobytes()
        fmt, bits = WAV_FORMAT_IEEE_FLOAT, 32
    else:
        data = samples.astype("<i2").tobytes()
        fmt, bits = WAV_FORMAT_PCM, 16
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF",
        36 + len(data),
        b"WAVE",
        b"fmt ",
        16,
        fmt,
        channels,
        sample_rate,
        byte_rate,
        block_align,
        bits,
        b"data",
        len(data),
    )
    if hasattr(path_or_stream, "write"):
        path_or_stream.write(hdr + data)
    else:
        with open(path_or_stream, "wb") as f:
            f.write(hdr + data)


class WavWriter:
    """Incremental WAV writer: append sample blocks, patch sizes on close.

    The streaming twin of write_wav for synthesis pipelines whose output
    never fits in memory (e.g. synthesis blocks): RIFF/data
    sizes are written as placeholders and patched on close(), so the
    target must be seekable (a path or a binary file opened r+b/w+b).
    float=True writes IEEE float32, else PCM16.  samples per write():
    (n,) mono or (channels, n) with the writer's channel count.

    The reference has no writer at all; header layout mirrors the fields
    its reader validates (wav.go:78-103).
    """

    def __init__(self, path_or_stream, sample_rate: int, channels: int = 1,
                 float32: bool = True):
        if channels < 1:
            raise ValueError("channels must be >= 1")
        self.sample_rate = int(sample_rate)
        self.channels = channels
        self.float32 = float32
        # anything without a .write method is a filesystem path
        # (str, pathlib.Path, ...) — same rule as write_wav
        self._owns = not hasattr(path_or_stream, "write")
        self._f = (
            open(path_or_stream, "wb") if self._owns else path_or_stream
        )
        if not (self._f.seekable() and self._f.writable()):
            raise ValueError("WavWriter target must be seekable + writable")
        self._data_bytes = 0
        self._closed = False
        # Header may land anywhere in an external stream: size patches
        # in close() are relative to this start offset.
        self._start = self._f.tell()
        bits = 32 if float32 else 16
        fmt = WAV_FORMAT_IEEE_FLOAT if float32 else WAV_FORMAT_PCM
        self._f.write(
            struct.pack(
                "<4sI4s4sIHHIIHH4sI",
                b"RIFF", 0, b"WAVE", b"fmt ", 16, fmt, channels,
                self.sample_rate, self.sample_rate * channels * bits // 8,
                channels * bits // 8, bits, b"data", 0,
            )
        )

    def write(self, samples) -> None:
        """Append one block of samples."""
        if self._closed:
            raise RuntimeError("write() after close()")
        s = np.asarray(samples)
        if self.channels > 1:
            if s.ndim != 2 or s.shape[0] != self.channels:
                raise ValueError(
                    f"expected ({self.channels}, n) block, got {s.shape}"
                )
            s = s.T.reshape(-1)  # interleave frames
        elif s.ndim != 1:
            raise ValueError(f"expected (n,) mono block, got {s.shape}")
        if self.float32:
            data = s.astype("<f4").tobytes()
        elif s.dtype.kind == "f":
            # Float samples scale to full-range PCM16 (write_wav takes
            # PCM16 only from integer input; here synthesis pipelines
            # hand float blocks in [-1, 1]).
            q = np.clip(np.round(s * 32767.0), -32768, 32767)
            data = q.astype("<i2").tobytes()
        else:
            data = s.astype("<i2").tobytes()
        self._f.write(data)
        self._data_bytes += len(data)

    def close(self) -> None:
        """Patch the RIFF/data sizes and close (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._f.seek(self._start + 4)
        self._f.write(struct.pack("<I", 36 + self._data_bytes))
        self._f.seek(self._start + 40)
        self._f.write(struct.pack("<I", self._data_bytes))
        self._f.flush()
        if self._owns:
            self._f.close()
        else:
            self._f.seek(0, 2)  # leave external streams at EOF

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
