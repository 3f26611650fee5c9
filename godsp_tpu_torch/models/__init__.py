"""End-to-end pipelines ("model families") built on the port's stack.

  stft     — short-time Fourier transform / inverse / spectrogram, and
             their streaming forms (K5 and K6 on CUDA)
  griffin  — Griffin-Lim phase reconstruction (fast GLA momentum)
  mel      — mel filterbank / log-mel spectrogram (K5's mel mode on CUDA)
  pipeline — WAV stream -> streaming Welch PSD, WAV -> spectrogram,
             streamed spectra -> WAV

Counterpart of godsp_tpu.models.  Still to port: mfcc (it needs the DCT,
fft/_dct_impl.py), models/shorttime.py (ShortTimeFFT), and the
filtering, design and analysis families (ROADMAP.md queue 1).
"""

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
from godsp_tpu_torch.models.mel import mel_filterbank, mel_spectrogram, stream_mel
from godsp_tpu_torch.models.pipeline import (
    WavPsdResult,
    spectra_to_wav,
    spectrogram_from_wav,
    wav_psd,
)

__all__ = [
    "StreamingISTFT",
    "StreamingSTFT",
    "WavPsdResult",
    "check_COLA",
    "check_NOLA",
    "check_cola",
    "check_nola",
    "griffin_lim",
    "istft",
    "mel_filterbank",
    "mel_spectrogram",
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
