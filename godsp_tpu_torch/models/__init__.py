"""End-to-end pipelines.  This slice ports wav_psd; the STFT, filtering
and design families of godsp_tpu.models wait for later slices."""

from godsp_tpu_torch.models.pipeline import WavPsdResult, wav_psd

__all__ = ["WavPsdResult", "wav_psd"]
