"""Flagship end-to-end pipeline: WAV stream -> Welch PSD on one device.

Port of godsp_tpu/models/pipeline.py (wav_psd, WavPsdResult):

  wav.Wav.blocks (host I/O, reference ReadSamples streaming semantics)
    -> parallel.StreamingPwelch (chunk + halo, fused kernel on CUDA,
       device-resident compensated sum, checkpoint/resume, metrics)
    -> (Pxx, freqs) + run metrics

spectrogram_from_wav and spectra_to_wav wait for the STFT slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from godsp_tpu_torch import wav as wavmod
from godsp_tpu_torch.parallel.streaming import StreamingPwelch
from godsp_tpu_torch.spectral._pwelch_impl import PwelchOptions

__all__ = ["WavPsdResult", "wav_psd"]


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
    """Welch PSD of a WAV file/stream, streamed block by block to `device`.

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
