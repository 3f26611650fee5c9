"""End-to-end pipelines ("model families") built on the port's stack.

  stft     — short-time Fourier transform / inverse / spectrogram, and
             their streaming forms (K5 and K6 on CUDA)
  griffin  — Griffin-Lim phase reconstruction (fast GLA momentum)
  mel      — mel filterbank / log-mel spectrogram (K5's mel mode on CUDA),
             MFCC (the ortho DCT-II of the log-mel rows)
  shorttime — scipy.signal.ShortTimeFFT and closest_STFT_dual_window
             (over the FFT core: K1/K2 on CUDA)
  pipeline — WAV stream -> streaming Welch PSD, WAV -> spectrogram,
             streamed spectra -> WAV

Counterpart of godsp_tpu.models.  Still to port: the filtering, design
and analysis families (ROADMAP.md queue 1 item 4).
"""

from godsp_tpu_torch.dsputils import detrend
from godsp_tpu_torch.models._stft_impl import (
    StreamingISTFT,
    StreamingSTFT,
    check_COLA,
    check_NOLA,
    check_cola,
    check_nola,
    istft,
    spectrogram,
    stft,
    stft_frames,
    stream_istft,
    stream_stft,
)
from godsp_tpu_torch.models.griffin import griffin_lim
from godsp_tpu_torch.models.mel import mel_filterbank, mel_spectrogram, mfcc, stream_mel
from godsp_tpu_torch.models.pipeline import (
    WavPsdResult,
    spectra_to_wav,
    spectrogram_from_wav,
    wav_psd,
)
from godsp_tpu_torch.models.shorttime import ShortTimeFFT, closest_STFT_dual_window

__all__ = [
    "detrend",
    "ShortTimeFFT",
    "StreamingISTFT",
    "StreamingSTFT",
    "WavPsdResult",
    "check_COLA",
    "check_NOLA",
    "check_cola",
    "check_nola",
    "closest_STFT_dual_window",
    "griffin_lim",
    "istft",
    "mel_filterbank",
    "mel_spectrogram",
    "mfcc",
    "spectra_to_wav",
    "spectrogram",
    "spectrogram_from_wav",
    "stft",
    "stft_frames",
    "stream_istft",
    "stream_mel",
    "stream_stft",
    "wav_psd",
]
