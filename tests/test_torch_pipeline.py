"""The port's main path end to end, held to godsp_tpu.

WAV ingest (native decode + reader), one-device streaming Welch
(StreamingPwelch), checkpoint carry-over between the two packages in both
directions, and wav_psd on a synthesized recording.  CPU float64 against
the JAX package (CPU, x64) at go-dsp's 1e-8 abs-or-rel bound.  The path
on the card is in tests/test_torch_cuda.py.
"""

import io
import struct

import numpy as np
import pytest
import torch

from godsp_tpu import native as jnative
from godsp_tpu import spectral as jspec
from godsp_tpu import wav as jwav
from godsp_tpu.models.pipeline import wav_psd as jwav_psd
from godsp_tpu.parallel.mesh import MeshConfig, make_mesh
from godsp_tpu.parallel.streaming import StreamingPwelch as JStreamingPwelch
from godsp_tpu_torch import default_device, dsputils, native, set_default_device, spectral, wav
from godsp_tpu_torch.models import wav_psd
from godsp_tpu_torch.parallel import StreamingPwelch, stream_pwelch

FS = 8000.0
OPTS = dict(nfft=256, noverlap=128)


@pytest.fixture(autouse=True)
def _host_data_on_cpu():
    """Host data goes to the CPU here; the port's default device is the card."""
    old = default_device()
    set_default_device("cpu")
    yield
    set_default_device(old)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(MeshConfig(dp=1, sp=1))


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    return 0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.1 * rng.normal(size=n)


def _ragged_blocks(x, seed=1):
    rng = np.random.default_rng(seed)
    i = 0
    while i < x.shape[-1]:
        n = int(rng.integers(1, 9000))
        yield x[..., i : i + n]
        i += n


# ---------------------------------------------------------------- host ingest


def test_native_decode_matches_jax_and_builds_outside_source():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, size=1001, dtype=np.uint8)
    i16 = rng.integers(-32768, 32768, size=1001, dtype=np.int16)
    np.testing.assert_array_equal(native.decode_u8(u8), jnative.decode_u8(u8))
    np.testing.assert_array_equal(native.decode_i16(i16), jnative.decode_i16(i16))
    if native.available():
        assert list(native._BUILD.glob("libgodsp_native_*.so"))
        assert not list(native._SRC.parent.glob("libgodsp_native_*.so"))


def test_stream_buffer_fifo():
    b = native.StreamBuffer(capacity=4, dtype=np.float32)
    b.push(np.arange(10))
    np.testing.assert_array_equal(b.peek(3), [0, 1, 2])
    b.consume(4)
    b.push(np.arange(3))
    assert len(b) == 9
    np.testing.assert_array_equal(b.peek(100), [4, 5, 6, 7, 8, 9, 0, 1, 2])


@pytest.mark.parametrize("kind", ["pcm16", "float32", "pcm16_writer", "pcm8_junk"])
def test_wav_read_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "x.wav")
    if kind == "pcm16":
        wav.write_wav(path, rng.integers(-32768, 32768, size=(2, 999)).astype(np.int16), 22050)
    elif kind == "float32":
        wav.write_wav(path, rng.normal(size=1234).astype(np.float32), 16000)
    elif kind == "pcm16_writer":
        with wav.WavWriter(path, 44100, float32=False) as w:
            for _ in range(3):
                w.write(np.clip(rng.normal(scale=0.3, size=500), -1, 1))
    else:
        data = rng.integers(0, 256, size=777, dtype=np.uint8).tobytes()
        fmt = struct.pack("<HHIIHH", 1, 1, 8000, 8000, 1, 8)
        body = b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt
        body += b"JUNK" + struct.pack("<I", 4) + b"\0" * 4
        body += b"data" + struct.pack("<I", len(data)) + data
        with open(path, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + body)
    got, want = wav.read_wav(path), jwav.read_wav(path)
    assert (got.samples, got.sample_rate, got.duration_ns) == (want.samples, want.sample_rate,
                                                               want.duration_ns)
    # samples = data_size / bits * 8 truncates (wav.go:101); blocks() reads
    # every remaining sample in both packages.
    np.testing.assert_array_equal(got.read_floats(got.samples), want.read_floats(want.samples))
    np.testing.assert_array_equal(np.concatenate(list(got.blocks(300))),
                                  np.concatenate(list(want.blocks(300))))
    got.close()


def test_wav_errors():
    with pytest.raises(wav.WavFormatError):
        wav.read_wav(io.BytesIO(b"RIFX\0\0\0\0WAVE"))
    with pytest.raises(EOFError):
        wav.read_wav(io.BytesIO(b"RIFF\0\0\0\0WAVE"))


# ---------------------------------------------------------------- streaming


@pytest.mark.parametrize("length", [100, 3000, 40000])
def test_stream_pwelch_matches_one_shot_jax(length):
    x = _signal(length)
    o = spectral.PwelchOptions(**OPTS)
    pxx, freqs = stream_pwelch(_ragged_blocks(x), FS, o, segs_per_chunk_shard=16)
    jpxx, jfreqs = jspec.pwelch(x, FS, jspec.PwelchOptions(**OPTS))
    assert dsputils.pretty_close(pxx, np.asarray(jpxx))
    assert dsputils.pretty_close(freqs, np.asarray(jfreqs))


def test_stream_multichannel_and_pad_lt_nfft(mesh1):
    x = np.stack([_signal(20000, 1), _signal(20000, 2)])
    kw = dict(nfft=256, pad=128, noverlap=200)
    pxx, _ = stream_pwelch(_ragged_blocks(x), FS, spectral.PwelchOptions(**kw),
                           segs_per_chunk_shard=8, channels=2)
    sp = JStreamingPwelch(FS, jspec.PwelchOptions(**kw), mesh1, segs_per_chunk_shard=8,
                          channels=2)
    for b in _ragged_blocks(x):
        sp.update(b)
    assert dsputils.pretty_close(pxx, sp.finalize()[0])


def test_stream_rejects_mesh():
    """A mesh must be a port Mesh (godsp_tpu's jax Mesh is not one)."""
    with pytest.raises(TypeError, match="Mesh"):
        StreamingPwelch(FS, mesh=object())


def test_load_state_requires_every_key():
    sp = StreamingPwelch(FS, spectral.PwelchOptions(**OPTS))
    with pytest.raises(KeyError):
        sp.load_state({"p_sum": np.zeros(129)})


def _feed(sp, blocks):
    for b in blocks:
        sp.update(b)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_carries_across_packages(tmp_path, mesh1, direction):
    x = _signal(30000, 5)
    blocks = list(_ragged_blocks(x, 6))
    half = len(blocks) // 2
    ckpt = str(tmp_path / "psd.npz")
    jo, o = jspec.PwelchOptions(**OPTS), spectral.PwelchOptions(**OPTS)

    def jax_sp():
        return JStreamingPwelch(FS, jo, mesh1, segs_per_chunk_shard=16, checkpoint_path=ckpt,
                                checkpoint_every_chunks=1)

    def port_sp():
        return StreamingPwelch(FS, o, segs_per_chunk_shard=16, checkpoint_path=ckpt,
                               checkpoint_every_chunks=1)

    first, second = (jax_sp, port_sp) if direction == "jax_to_port" else (port_sp, jax_sp)
    sp = first()
    _feed(sp, blocks[:half])
    chunks = sp.metrics.chunks_done
    assert chunks > 0
    resumed = second()  # restores from the other package's snapshot
    assert resumed.metrics.chunks_done == chunks
    # The snapshot was taken after the last full chunk: replay what followed it.
    tail = np.concatenate(blocks[:half])[resumed.metrics.samples_in:]
    _feed(resumed, [tail] + blocks[half:])
    pxx, _ = resumed.finalize()
    want, _ = jspec.pwelch(x, FS, jo)
    assert dsputils.pretty_close(pxx, np.asarray(want))


# ---------------------------------------------------------------- wav_psd


def _write_recording(path, n, fs=44100, seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    x = 0.4 * np.sin(2 * np.pi * 1000.0 * t) + 0.2 * np.sin(2 * np.pi * 3150.0 * t)
    x += 0.05 * rng.normal(size=n)
    with wav.WavWriter(path, fs, float32=False) as w:
        for i in range(0, n, 65536):
            w.write(x[i : i + 65536])


def test_wav_psd_matches_jax(tmp_path, mesh1):
    path = str(tmp_path / "rec.wav")
    _write_recording(path, 150001)
    o = spectral.PwelchOptions(nfft=1024, noverlap=512)
    got = wav_psd(path, o, block_size=40000, segs_per_chunk_shard=32)
    want = jwav_psd(path, jspec.PwelchOptions(nfft=1024, noverlap=512), mesh1,
                    block_size=40000, segs_per_chunk_shard=32)
    assert got.pxx.shape == (513,) and got.sample_rate == 44100
    assert got.samples == want.samples == 150000  # data_size / bits * 8 truncates (wav.go:101)
    assert dsputils.pretty_close(got.pxx, want.pxx)
    assert dsputils.pretty_close(got.freqs, want.freqs)
    assert '"chunks": 10' in got.metrics_json  # 9 full chunks + the remainder
