"""End-to-end pipelines: WAV stream -> Welch PSD, WAV -> spectrogram, and
streamed spectra -> WAV, on one device.

Port of godsp_tpu/models/pipeline.py:

  wav_psd:              wav.Wav.blocks (host I/O, reference ReadSamples
                        streaming semantics) -> parallel.StreamingPwelch
                        (chunk + halo, fused kernel on CUDA, device-resident
                        compensated sum, checkpoint/resume, metrics)
                        -> (Pxx, freqs) + run metrics;
  spectrogram_from_wav: the whole file -> models.spectrogram (K5's power
                        mode on CUDA);
  spectra_to_wav:       spectra chunks -> models.stream_istft (K6 once per
                        chunk on CUDA, the overlap spill carried on the
                        device) -> wav.WavWriter.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from godsp_tpu_torch import wav as wavmod
from godsp_tpu_torch._dtypes import as_tensor
from godsp_tpu_torch.parallel.streaming import StreamingPwelch
from godsp_tpu_torch.spectral._pwelch_impl import PwelchOptions

__all__ = ["WavPsdResult", "spectra_to_wav", "spectrogram_from_wav", "wav_psd"]


@dataclass
class WavPsdResult:
    pxx: np.ndarray
    freqs: np.ndarray
    sample_rate: int
    samples: int
    metrics_json: str


def wav_psd(
    src,
    options: Optional[PwelchOptions] = None,
    mesh=None,
    block_size: int = 1 << 20,
    checkpoint_path: Optional[str] = None,
    checkpoint_every_chunks: int = 0,
    segs_per_chunk_shard: int = 256,
    device=None,
) -> WavPsdResult:
    """Welch PSD of a WAV file/stream, streamed block by block to `device`
    (default: default_device(), the card).

    src: path, bytes, or binary stream.  fs is taken from the WAV header.
    The signal never fully materializes on the host; checkpointing makes
    multi-hour runs resumable.
    """
    w = wavmod.read_wav(src)
    try:
        sp = StreamingPwelch(
            float(w.sample_rate),
            options,
            mesh,
            segs_per_chunk_shard=segs_per_chunk_shard,
            checkpoint_path=checkpoint_path,
            checkpoint_every_chunks=checkpoint_every_chunks,
            device=device,
        )
        for block in w.blocks(block_size):
            sp.update(block)
    finally:
        if isinstance(src, str):
            w.close()  # the reader opened this file
    pxx, freqs = sp.finalize()
    return WavPsdResult(
        pxx=pxx,
        freqs=freqs,
        sample_rate=w.sample_rate,
        samples=w.samples,
        metrics_json=sp.metrics.json_line(),
    )


def spectrogram_from_wav(
    src,
    nfft: int = 1024,
    hop: Optional[int] = None,
    window=None,
    scale: str = "power",
    max_samples: Optional[int] = None,
    device=None,
):
    """(spectrogram, freqs, frame_times) of a WAV file.

    Reads up to max_samples (default: all) into one batch on `device`
    (default: default_device(), the card); for hours-long inputs use
    wav_psd's streaming path instead.  freqs and frame_times are numpy arrays.
    """
    from godsp_tpu_torch.models._stft_impl import spectrogram

    w = wavmod.read_wav(src)
    try:
        n = w.samples if max_samples is None else min(w.samples, max_samples)
        x = w.read_floats(n)
    finally:
        if isinstance(src, str):
            w.close()  # the reader opened this file
    hop = hop or nfft // 2
    x = as_tensor(np.require(x, requirements="W"), device)  # float32 files read-only
    s = spectrogram(x, nfft, hop, window, scale=scale)
    freqs = np.arange(nfft // 2 + 1) * (w.sample_rate / nfft)
    n_frames = (n - nfft) // hop + 1
    times = (np.arange(n_frames) * hop + nfft / 2) / w.sample_rate
    return s, freqs, times


def spectra_to_wav(
    chunks,
    dest,
    sample_rate: int,
    nfft: int,
    hop: Optional[int] = None,
    window=None,
    pad: Optional[int] = None,
    float32: bool = True,
    device=None,
) -> int:
    """Streaming synthesis pipeline: spectra chunks -> WAV on disk.

    The synthesis mirror of wav_psd: chunks of (..., F, bins) STFT
    spectra (an iterable — e.g. frames produced by a vocoder or a
    spectral-edit loop) run through models.stream_istft on `device`
    (host chunks go there; tensors stay on theirs) and each settled time
    block is appended to `dest` via wav.WavWriter, so neither the spectra
    nor the signal ever materialize fully.  Mono blocks (..., = ()) write
    a mono file; a single leading channel axis writes multichannel.
    Returns the number of samples (per channel) written.
    """
    from godsp_tpu_torch.models._stft_impl import stream_istft

    writer = None
    written = 0
    try:
        for block in stream_istft(chunks, nfft, hop=hop, window=window, pad=pad,
                                  device=device):
            b = block.detach().cpu().numpy()
            if b.ndim > 2:
                raise ValueError(
                    "spectra chunks must be (F, bins) or (channels, F, bins)"
                )
            if b.shape[-1] == 0:
                continue
            if writer is None:
                writer = wavmod.WavWriter(
                    dest, sample_rate,
                    channels=b.shape[0] if b.ndim == 2 else 1,
                    float32=float32,
                )
            writer.write(b)
            written += b.shape[-1]
    except BaseException:
        # a failure mid-synthesis must not mask itself behind WAV
        # bookkeeping, and must not leave a fresh empty file pretending
        # the stream was empty — close whatever was opened and re-raise
        if writer is not None:
            writer.close()
        raise
    if writer is None:
        # Genuinely empty chunk stream: leave a valid (zero-sample) WAV
        # at dest so downstream read_wav sees a file, not ENOENT.
        writer = wavmod.WavWriter(dest, sample_rate, float32=float32)
    writer.close()
    return written
