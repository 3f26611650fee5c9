#!/usr/bin/env python3
"""Drive godsp_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero and prints no
final line):

  1. the card: torch.cuda must be available; prints nvidia-smi's name and
     power limit and torch's device name;
  2. builds the CUDA kernels from godsp_tpu_torch/csrc (nvcc, sm_90a);
  3. holds each kernel (K1 fft_pow2, K2 ifft_pow2, K3 rfft_pow2, K4
     pwelch_power_partials, K7 csd_power_partials) against its plain
     PyTorch version run in float64 on the card, at main-path shapes: SNR >= 120 dB, and each
     launch count must rise; times kernel, plain version (float32) and,
     where one PyTorch call computes the same function, that call
     (library_ms, a yardstick the port never calls) with CUDA events,
     beside the bound: the larger of the bytes the function must move
     over 3.35 TB/s and its float32 operations over 67 TFLOP/s (the
     H100 SXM's published peaks).  The STFT kernels (K5 stft_complex /
     stft_power / stft_mel, K6 istft_overlap_add) are held the same way
     at the shapes of phase 5, and at an odd hop with pad > nfft; K8
     outer_dft_split at every shape phase 6 gives it; K7 at phase 7's
     shape (the whole recording at 1024/512), at the speech hop 160
     with nfft 1000 and pad 1024, and at pad 16384; K10 ring_halo at
     phase 8's chunk shape (exactly equal to its plain version) and K11
     pwelch_power_partials_halo at three shapes (one shard of phase 8's
     chunk reading its neighbour's head, the last shard reading an
     injected tail, and hop 160 with nfft 1000 and pad 1024);
  4. the main path at real size: a seeded 10-minute 44.1 kHz 16-bit mono
     recording (26,460,000 samples) written with the port's WavWriter,
     then, after one warm-up call, one session through the public entry
     points with the launch counts zeroed just before it and read just
     after it, and per step:
       - wav_psd(..., device="cuda") at nfft 1024 / noverlap 512 (the
         fused route: K4 once per chunk, nothing else);
       - wav_psd at nfft 1000 / noverlap 500 (the unfused route: frames,
         Bluestein over K1 and K2);
       - fft_real, ifft and rfft_split of the recording's 1024-point
         frames (K1 real input, K2, K3);
     then, outside the counted session, each result is held against a
     float64 oracle of the same decoded samples built on the card from
     the plain transforms (>= 120 dB), and the 129-bin golden goes
     through the public pwelch;
  5. the STFT family on the same recording, after one warm-up pass, as
     one counted session of its own (counts zeroed before, read after):
       - spectrogram_from_wav at nfft 1024 / hop 512 (K5 power once);
       - stft of the decoded samples at nfft 1024 / hop 256 (K5 complex
         once: 103,356 frames x 513 bins);
       - mel_spectrogram, 80 mels at nfft 1024 / hop 256 (K5 mel once);
       - spectra_to_wav of that STFT in chunks of 4096 frames (K6 once a
         chunk);
       - griffin_lim of the first 60 s of its magnitude, 32 iterations,
         momentum 0.99 (K6 33 times, K5 complex 32 times);
     then each result is held against a float64 oracle built on the card
     from the plain functions (>= 120 dB; the written WAV over the whole
     signal and over its interior, see check_synthesis), the
     istft(stft(x)) round trip is held to x over the interior
     [nfft, L - nfft), and Griffin-Lim is held to its float64 plain route
     at n_iter 0 (>= 120 dB) and at n_iter 32 by spectral convergence
     (within 0.5 dB); prints each step's wall and Msamples/s;
  6. the FFT surface at full size, after one warm-up pass, as one counted
     session of its own, every step through the public entry points:
       - fft of 16 x 2^20 complex64 (the reference's 2^20 benchmark
         transform, fft_test.go:262-280, batched to 2^24 points): K8
         once, K1 once;
       - ifft of one 2^24-point signal: K8 once, K2 once;
       - fft of one 2^28-point signal, the top of the large plan (two K8
         calls, K1 once);
       - hilbert of the decoded recording as host data with no device
         (it lands on the card): Bluestein at pad 2^26, twice;
       - fftn of a 256 x 256 x 256 Matrix built from host data (BASELINE
         config 3): K1 once per axis;
     then each result is held against a float64 oracle built on the card
     from the plain functions (>= 120 dB), and each step's wall and
     Msamples/s is printed beside torch.fft's at the same shape;
  7. the scipy-convention spectra and the cross-spectra on a seeded
     10-minute 44.1 kHz PCM16 STEREO recording (channel 0 is phase 4's
     mix, channel 1 is 0.7 x channel 0 delayed by 37 samples plus
     independent noise), decoded with read_wav and split into (L, 2),
     after one warm-up pass, as one counted session:
       - welch of both channels (axis 0) at 1024/512 without detrend (K4
         once), with the default constant detrend and with the median
         (the unfused route: K1 once each);
       - welch_csd and welch_coherence of the two channels (K7 once; K4
         twice and K7 once);
       - csd and coherence in the reference's conventions at nfft 1024,
         noverlap 864, the speech hop 160 (K7 once; K7 once, K4 twice);
       - spectrogram_scipy of channel 0 (K5 power once);
       - stream_welch over read_wav(...).blocks(2^20) of the mono
         recording (K4 once a chunk);
       - lombscargle of 65,536 seeded uneven times x 2,048 frequencies
         (no kernel: float32 trig and row sums);
     then the scipy-convention results are held against scipy.signal in
     float64 on the host on the same decoded samples, csd/coherence
     against a float64 oracle of the reference formula built on the card
     from the plain functions (all >= 120 dB), and lombscargle against
     its own float64 run on the CPU at the bound lomb_bound_db states;
     prints each step's wall and Msamples/s;
  8. the mesh-sharded paths at real size on meshes of eight shards that
     all sit on the card (eight shards on one card measure the overhead
     of sharding, not scaling), after one warm-up pass, as one counted
     session: wav_psd over a (dp=1, sp=8) mesh (the default ppermute
     halo: K4 once a shard a chunk); stream_pwelch over read_wav blocks
     with halo_impl ("pallas", False) (K10 once a chunk, K4 once a shard a
     chunk) and ("fused", False) (K11 once a shard a chunk, nothing
     else); pwelch_sharded of the decoded recording cut to 26,456,064
     samples under the three routes; the stereo recording through
     StreamingPwelch(channels=2) on a (dp=2, sp=4) mesh, fused route;
     spectrogram_sharded at 1024/256 (K5 power once a shard);
     istft_sharded of the port's stft of the cut recording, 103,336
     frames (K6 once a shard); fft_sharded of one 2^24-point complex64
     signal (local 2^21: K8 and K1 once a shard), then its inverse (K8
     and K2 once a shard); each result is then held against a float64
     oracle built on the card from the plain functions (>= 120 dB) and
     against the same entry without a mesh on the card (>= 120 dB, the
     measured agreement printed), and the streams' walls and Msamples/s
     are printed beside the one-device runs;
  9. prints {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

Imports nothing of JAX.  Needs one card; stops nothing it did not start
(nvidia-smi runs to completion).
"""

from __future__ import annotations

import ast
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SNR_DB = 120.0  # every kernel and the main path vs their float64 references
FS = 44100
SECONDS = 600
WELCH = dict(nfft=1024, noverlap=512)
WELCH_UNFUSED = dict(nfft=1000, noverlap=500)
PLANE = 1 << 24  # points per plane in the FFT kernel checks
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peaks (700 W)
FP32_FLOPS = 67e12  # float32 outside the tensor cores
# Steps of the counted main-path session (phase 4).
FUSED = "wav_psd(nfft=1024, noverlap=512)"
UNFUSED = "wav_psd(nfft=1000, noverlap=500)"
FFT_API = "fft_real/ifft/rfft_split(frames)"

# Steps of the counted STFT-family session (phase 5).
NFFT = 1024
SPECGRAM = "spectrogram_from_wav(nfft=1024, hop=512)"
STFT = "stft(nfft=1024, hop=256)"
MEL = "mel_spectrogram(n_mels=80, nfft=1024, hop=256)"
SYNTH = "spectra_to_wav(chunks of 4096 frames)"
GRIFFIN = "griffin_lim(60 s, n_iter=32, momentum=0.99)"
CHUNK = 4096  # frames per spectra_to_wav chunk
GL_ITERS = 32
GL_SECONDS = 60
GL_SC_DB = 0.5  # kernel vs float64 spectral convergence, dB apart at most

# Steps of the counted FFT-surface session (phase 6), and their sizes.
B20, N20, N24, N28, CUBE = 16, 1 << 20, 1 << 24, 1 << 28, 256
FFT20 = "fft(16 x 2^20 complex64)"
IFFT24 = "ifft(2^24)"
FFT28 = "fft(2^28)"
HILBERT = "hilbert(recording, 26,460,000, host data)"
FFTN = "fftn(Matrix 256^3, host data)"

# Steps of the counted scipy-spectra session (phase 7), and their sizes.
W_FUSED = "welch(stereo, 1024/512, detrend=False, axis=0)"
W_CONST = "welch(stereo, 1024/512, detrend='constant', axis=0)"
W_MEDIAN = "welch(stereo, 1024/512, average='median', detrend=False)"
W_CSD = "welch_csd(ch0, ch1, nperseg=1024, detrend=False)"
W_COH = "welch_coherence(ch0, ch1, nperseg=1024, detrend=False)"
CSD160 = "csd(ch0, ch1, nfft=1024, noverlap=864)"
COH160 = "coherence(ch0, ch1, nfft=1024, noverlap=864)"
SPEC_SCIPY = "spectrogram_scipy(ch0, nperseg=1024, detrend=False)"
STREAM_WELCH = "stream_welch(mono, blocks of 2^20, nperseg=1024)"
LOMB = "lombscargle(65,536 uneven times x 2,048 frequencies)"
LOMB_N, LOMB_F, LOMB_FMAX = 1 << 16, 2048, 1000.0  # samples over 1 s, frequencies to 1 kHz
DELAY = 37  # samples between the stereo channels

# Steps of the counted mesh session (phase 8), on meshes of eight shards
# that all sit on the card.
SP, SEGS = 8, 256  # shards on "sp"; StreamingPwelch's default segments a shard a chunk
M_WAV = "mesh: wav_psd(1024/512, sp=8, ppermute)"
M_PALLAS = "mesh: stream_pwelch(blocks of 2^20, sp=8, pallas)"
M_FUSED = "mesh: stream_pwelch(blocks of 2^20, sp=8, fused)"
M_SHARDED = {r: f"mesh: pwelch_sharded(26,456,064, sp=8, {r})"
             for r in ("ppermute", "pallas", "fused")}
M_STEREO = "mesh: StreamingPwelch(stereo, channels=2, dp=2 x sp=4, fused)"
M_SPEC = "mesh: spectrogram_sharded(1024/256, sp=8)"
M_ISTFT = "mesh: istft_sharded(103,336 frames, 1024/256, sp=8)"
M_FFT = "mesh: fft_sharded(2^24 complex64, sp=8)"
M_IFFT = "mesh: fft_sharded(inverse=True) / 2^24"

REPLACES = {
    "fft_pow2": "godsp_tpu/ops/pallas_fft.py:1125",
    "ifft_pow2": "godsp_tpu/ops/pallas_fft.py:1268",
    "rfft_pow2": "godsp_tpu/ops/pallas_fft.py:1466",
    "pwelch_power_partials": "godsp_tpu/ops/pallas_pwelch.py:483",
    "stft_complex": "godsp_tpu/ops/pallas_stft.py:150",
    "stft_power": "godsp_tpu/ops/pallas_stft.py:150",
    "stft_mel": "godsp_tpu/ops/pallas_stft.py:150",
    "istft_overlap_add": "godsp_tpu/ops/pallas_istft.py:167",
    "outer_dft_split": "godsp_tpu/ops/pallas_outer.py:245",
    "csd_power_partials": "godsp_tpu/ops/pallas_csd.py:84",
    "ring_halo": "godsp_tpu/parallel/halo.py:63",
    "pwelch_power_partials_halo": "godsp_tpu/parallel/fused_halo.py:129",
}
SOURCES = {
    "fft_pow2": "godsp_tpu_torch/csrc/fft_kernels.cu",
    "ifft_pow2": "godsp_tpu_torch/csrc/fft_kernels.cu",
    "rfft_pow2": "godsp_tpu_torch/csrc/fft_kernels.cu",
    "pwelch_power_partials": "godsp_tpu_torch/csrc/pwelch_kernel.cu",
    "stft_complex": "godsp_tpu_torch/csrc/stft_kernel.cu",
    "stft_power": "godsp_tpu_torch/csrc/stft_kernel.cu",
    "stft_mel": "godsp_tpu_torch/csrc/stft_kernel.cu",
    "istft_overlap_add": "godsp_tpu_torch/csrc/istft_kernel.cu",
    "outer_dft_split": "godsp_tpu_torch/csrc/outer_kernel.cu",
    "csd_power_partials": "godsp_tpu_torch/csrc/csd_kernel.cu",
    "ring_halo": "godsp_tpu_torch/csrc/halo_kernel.cu",
    "pwelch_power_partials_halo": "godsp_tpu_torch/csrc/pwelch_kernel.cu",
}


def log(*a):
    print(*a, flush=True)


def snr(got, want) -> float:
    from godsp_tpu_torch.dsputils import snr_db

    g, w = (t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t for t in (got, want))
    return snr_db(g, w)


def cplx(planes):
    return planes[0].double() + 1j * planes[1].double()


def golden_pxx() -> np.ndarray:
    """The 129-bin go-dsp golden (pwelch_test.go:39-46), read from
    tests/test_spectral.py without importing it (that module imports jax)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "test_spectral.py")
    tree = ast.parse(open(path).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "GOLDEN_PXX":
            return np.asarray(ast.literal_eval(node.value), dtype=np.float64)
    raise LookupError("GOLDEN_PXX not found in tests/test_spectral.py")


def time_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds of fn over reps launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over HBM bandwidth or
    float32 operations over the peak rate, whichever is larger."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def fft_flops(points: int, n: int) -> float:
    """Radix-2 complex FFT operations over `points` points in rows of n."""
    return 5.0 * points * np.log2(n)


def rfft_flops(points: int, n: int) -> float:
    """FFT operations of real input (or real output) over `points` points
    in rows of n: half a complex transform's."""
    return 2.5 * points * np.log2(n)


class KernelRecord:
    def __init__(self):
        self.err: dict[str, float] = {}
        self.times: dict[str, dict] = {}

    def time(self, name: str, shape: str, kernel, plain, library, nbytes: float,
             flops: float) -> None:
        """Time the kernel, its plain version and (when not None) the one
        PyTorch call computing the same function; the bound comes from
        the bytes and operations of these inputs."""
        b, by = bound_ms(nbytes, flops)
        self.times[name] = dict(ms=time_ms(kernel), plain_ms=time_ms(plain),
                                library_ms=None if library is None else time_ms(library),
                                bound_ms=b, bound_by=by, shape=shape)

    def check(self, name: str, run, want, what: str) -> None:
        """Hold a float32 kernel result, run(), against its float64 plain
        version; run() must launch the kernel."""
        from godsp_tpu_torch.ops import launch_counts

        before = launch_counts()[name]
        got = run()
        if launch_counts()[name] <= before:
            raise AssertionError(f"{name} {what}: the kernel was not launched")
        db = snr(got, want)
        err = float((got.to(want.dtype) - want).abs().max())
        self.err[name] = max(self.err.get(name, 0.0), err)
        log(f"  {name:22s} {what:34s} snr {db:7.2f} dB  max_abs_err {err:.3e}")
        if not db >= SNR_DB:
            raise AssertionError(f"{name} {what}: {db:.2f} dB < {SNR_DB} dB")


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {smi}")
    name = torch.cuda.get_device_name(0)
    log(f"torch: {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from godsp_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)")


@contextlib.contextmanager
def plain_route():
    """Kernels off: the plain versions beneath the public entry points run
    on the card, in the dtype they are given (float64 for the oracles)."""
    from godsp_tpu_torch import fft

    fft.set_kernels_enabled(False)
    try:
        yield
    finally:
        fft.set_kernels_enabled(True)


def c128(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.complex128)


def phase_kernels(rec: KernelRecord, dev) -> None:
    from godsp_tpu_torch import window
    from godsp_tpu_torch.fft import convolve, fft
    from godsp_tpu_torch.fft.bluestein import bluestein_fft
    from godsp_tpu_torch.fft.pow2 import pow2_convolve
    from godsp_tpu_torch.ops import cuda_fft, cuda_pwelch

    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.float32)

    log("kernels vs their float64 plain versions on the card:")
    for n in (1024, 256, 4096, 16384):
        rows = PLANE // n
        xr, xi = rand(rows, n), rand(rows, n)
        xr64, xi64 = xr.double(), xi.double()
        shape = f"N={n} x {rows}"
        rec.check("fft_pow2", lambda: cplx(cuda_fft.fft_pow2(xr, xi)),
                  cplx(cuda_fft.fft_pow2_plain(xr64, xi64)), f"forward {shape}")
        rec.check("fft_pow2", lambda: cplx(cuda_fft.fft_pow2(xr, None)),
                  cplx(cuda_fft.fft_pow2_plain(xr64, None)), f"real input {shape}")
        rec.check("ifft_pow2", lambda: cplx(cuda_fft.ifft_pow2(xr, xi, 1.0 / n)),
                  cplx(cuda_fft.ifft_pow2_plain(xr64, xi64, 1.0 / n)), f"inverse 1/N {shape}")
        if n == 1024:
            z = torch.complex(xr, xi)
            moved = 16.0 * rows * n  # two float32 planes read, two written
            rec.time("fft_pow2", shape, lambda: cuda_fft.fft_pow2(xr, xi),
                     lambda: cuda_fft.fft_pow2_plain(xr, xi), lambda: torch.fft.fft(z),
                     moved, fft_flops(rows * n, n))
            rec.time("ifft_pow2", shape, lambda: cuda_fft.ifft_pow2(xr, xi, 1.0 / n),
                     lambda: cuda_fft.ifft_pow2_plain(xr, xi, 1.0 / n),
                     lambda: torch.fft.ifft(z), moved, fft_flops(rows * n, n) + 2.0 * rows * n)
            del z
        del xr, xi, xr64, xi64
    # K2 in its chains: Bluestein (forward K1, product, inverse K2) and convolve.
    for n in (1000, 1331):
        z = torch.complex(rand(512, n), rand(512, n))
        with plain_route():
            want = bluestein_fft(c128(z))
        rec.check("ifft_pow2", lambda: fft(z), want, f"Bluestein fft N={n} x 512")
    a = torch.complex(rand(256, 4096), rand(256, 4096))
    b = torch.complex(rand(256, 4096), rand(256, 4096))
    with plain_route():
        want = pow2_convolve(c128(a), c128(b), scale=1.0 / 4096)
    rec.check("ifft_pow2", lambda: convolve(a, b), want, "convolve N=4096 x 256")
    for n in (1024, 8192):
        rows = PLANE // n
        xr = rand(rows, n)
        shape = f"N={n} x {rows}"
        rec.check("rfft_pow2", lambda: cplx(cuda_fft.rfft_pow2(xr)),
                  cplx(cuda_fft.rfft_pow2_plain(xr.double())), f"one-sided {shape}")
        if n == 1024:
            rec.time("rfft_pow2", shape, lambda: cuda_fft.rfft_pow2(xr),
                     lambda: cuda_fft.rfft_pow2_plain(xr), lambda: torch.fft.rfft(xr),
                     4.0 * rows * n + 8.0 * rows * (n // 2 + 1), rfft_flops(rows * n, n))
        del xr
    # K4 at the streaming chunk (256 segments + halo), the whole recording,
    # hop 160, pad 2048 > nfft, and a ragged last tile (5001 segments at 10
    # a tile) with a partial mask.
    whole = (FS * SECONDS - 1024) // 512 + 1  # segments of the whole recording
    for nfft, stride, pad, S, keep in (
        (1024, 512, 1024, 256, 256),
        (1024, 512, 1024, whole, whole),
        (1024, 160, 1024, 4096, 4096),
        (1024, 512, 2048, 4096, 4096),
        (1024, 512, 1024, 5001, 4990),
    ):
        L = (S - 1) * stride + nfft
        ext = torch.rand(1, L, generator=g, device=dev) * 2 - 1  # [-1, 1), zero-mean like PCM16
        mask = (torch.arange(S, device=dev) < keep).float()[None]
        w = window.window_table("hann", pad, device=dev, dtype=torch.float32)
        bt = cuda_pwelch.segs_per_tile(S, 1)
        what = f"nfft {nfft} hop {stride} pad {pad} S {S} keep {keep}"
        want = cuda_pwelch.pwelch_power_partials_plain(ext.double(), mask.double(), w.double(),
                                                       nfft, stride, pad, bt)
        rec.check("pwelch_power_partials",
                  lambda: cuda_pwelch.pwelch_power_partials(ext, mask, w, nfft, stride, pad=pad),
                  want, what)
        if S == 256:
            # No one PyTorch call frames, windows, transforms and sums.
            tiles = -(-S // bt)
            rec.time("pwelch_power_partials", what,
                     lambda: cuda_pwelch.pwelch_power_partials(ext, mask, w, nfft, stride,
                                                               pad=pad),
                     lambda: cuda_pwelch.pwelch_power_partials_plain(ext, mask, w, nfft,
                                                                     stride, pad, bt),
                     None, 4.0 * (L + S + pad + tiles * (pad // 2 + 1)),
                     keep * (nfft + rfft_flops(pad, pad) + 3.0 * (pad // 2 + 1)))


def phase_stft_kernels(rec: KernelRecord, dev) -> None:
    """K5 in its three modes and K6 against their float64 plain versions,
    at the shapes of phase 5, plus an odd hop with pad > nfft."""
    from godsp_tpu_torch import window
    from godsp_tpu_torch.models import mel_filterbank
    from godsp_tpu_torch.ops import cuda_istft, cuda_stft

    g = torch.Generator(device=dev).manual_seed(1)
    n = FS * SECONDS
    x = torch.rand(n, generator=g, device=dev) * 2 - 1  # [-1, 1), zero-mean like decoded PCM16
    x64 = x.double()
    fb = mel_filterbank(80, NFFT, FS, device=dev, dtype=torch.float32)
    # The three modes on the whole recording's length, then complex at an
    # odd hop with pad > nfft on its first 2^22 samples.
    for out, hop, pad, L in (("complex", 256, NFFT, n), ("power", 512, NFFT, n),
                             ("mel", 256, NFFT, n), ("complex", 160, 2048, min(n, 1 << 22))):
        w = torch.nn.functional.pad(window.window_table("hann", NFFT, device=dev), (0, pad - NFFT))
        F = (L - NFFT) // hop + 1
        name = f"stft_{out}"
        kernel, mel_fb = getattr(cuda_stft, name), ((fb,) if out == "mel" else ())
        xs, xs64 = x[:L], x64[:L]
        shape = f"nfft {NFFT} hop {hop} pad {pad} x {F} frames"
        want = cuda_stft.stft_pallas_plain(xs64, w, NFFT, hop, F, pad, out, fb.double())
        rec.check(name, lambda: kernel(xs, w.float(), NFFT, hop, F, *mel_fb, pad=pad), want, shape)
        del want
        if name not in rec.times:  # time the first shape of each mode
            lp = pad // 2 + 1
            band = cuda_stft.mel_band(fb)
            band_bins = float((band[:, 1] - band[:, 0] + 1).clamp(min=0).sum())
            out_bytes = {"complex": 8.0 * lp, "power": 4.0 * lp, "mel": 4.0 * fb.shape[0]}[out]
            flops = F * (NFFT + rfft_flops(pad, pad)
                         + {"complex": 0.0, "power": 3.0 * lp, "mel": 3.0 * lp + 2.0 * band_bins}[out])
            wn = w[:NFFT].float()
            # torch.stft computes the complex mode (bins x frames); no one
            # call computes the power or mel spectra.
            library = (lambda: torch.stft(xs, NFFT, hop_length=hop, window=wn, center=False,
                                          return_complex=True)) if out == "complex" else None
            rec.time(name, shape, lambda: kernel(xs, w.float(), NFFT, hop, F, *mel_fb, pad=pad),
                     lambda: cuda_stft.stft_pallas_plain(xs, w.float(), NFFT, hop, F, pad, out,
                                                         fb),
                     library, 4.0 * (L + pad) + F * out_bytes
                     + (4.0 * fb.numel() if out == "mel" else 0.0), flops)
    # K6 at a spectra_to_wav chunk, at the Griffin-Lim shape (60 s), and at
    # an odd hop with pad > nfft.
    w = window.window_table("hann", NFFT, device=dev)
    for F, hop, pad in ((CHUNK, 256, NFFT), ((FS * GL_SECONDS - NFFT) // 256 + 1, 256, NFFT),
                        (CHUNK, 160, 2048)):
        spec = torch.complex(torch.randn(F, pad // 2 + 1, generator=g, device=dev),
                             torch.randn(F, pad // 2 + 1, generator=g, device=dev))
        shape = f"nfft {NFFT} hop {hop} pad {pad} x {F} frames"
        want = cuda_istft.istft_overlap_add_plain(c128(spec), w, NFFT, hop)
        rec.check("istft_overlap_add",
                  lambda: cuda_istft.istft_overlap_add(spec, w.float(), NFFT, hop), want, shape)
        if F == CHUNK and hop == 256:
            # torch.istft also divides by the window-energy sum: not the same function.
            rec.time("istft_overlap_add", shape,
                     lambda: cuda_istft.istft_overlap_add(spec, w.float(), NFFT, hop),
                     lambda: cuda_istft.istft_overlap_add_plain(spec, w.float(), NFFT, hop),
                     None, 8.0 * spec.numel() + 4.0 * NFFT + 4.0 * ((F - 1) * hop + NFFT),
                     F * (rfft_flops(pad, pad) + 2.0 * NFFT))


def k8_shapes(n: int, batch: int = 1) -> list[tuple[int, int, int]]:
    """The (batch, m, n3) views the large plan hands K8 for one N-point
    transform of `batch` rows: one call, or two above m = MAX_ROWS."""
    from godsp_tpu_torch.fft import large

    m, n3 = large._plan(n)
    if m <= large._MAX_ROWS:
        return [(batch, m, n3)]
    g, m2 = large._balanced(m)
    return [(batch, g, m2 * n3), (batch * g, m2, n3)]


def phase_outer_kernel(rec: KernelRecord, dev) -> None:
    """K8 against its float64 plain version at every shape phase 6 gives
    it (the 2^28 plan's two calls whole), timed at 2^24."""
    from godsp_tpu_torch.dsputils import next_power_of_2
    from godsp_tpu_torch.ops import cuda_outer

    pad = next_power_of_2(2 * FS * SECONDS - 1)  # hilbert's Bluestein pad, 2^26
    cases = ([(s, False) for s in k8_shapes(N20, B20)]
             + [(s, True) for s in k8_shapes(N24)]
             + [(s, False) for s in k8_shapes(N28)]
             + [(s, inv) for s in k8_shapes(pad) for inv in (False, True)])
    g = torch.Generator(device=dev).manual_seed(3)
    for (b, m, n3), inverse in cases:
        xr = torch.randn(b, m, n3, generator=g, device=dev)
        xi = torch.randn(b, m, n3, generator=g, device=dev)
        shape = f"{b} x ({m}, {n3}) {'inverse' if inverse else 'forward'}"
        want = cplx(cuda_outer.outer_dft_split_plain(xr.double(), xi.double(), m, 1, inverse))
        rec.check("outer_dft_split",
                  lambda: cplx(cuda_outer.outer_dft_split(xr, xi, m, 1, inverse)), want, shape)
        del want
        if (b, m, n3) == k8_shapes(N24)[0] and "outer_dft_split" not in rec.times:
            # No one PyTorch call computes a twiddled column DFT.
            points = b * m * n3
            rec.time("outer_dft_split", shape,
                     lambda: cuda_outer.outer_dft_split(xr, xi, m, 1, inverse),
                     lambda: cuda_outer.outer_dft_split_plain(xr, xi, m, 1, inverse),
                     None, 16.0 * points, fft_flops(points, m) + 12.0 * points)
        del xr, xi


def phase_csd_kernel(rec: KernelRecord, dev) -> None:
    """K7 against its float64 plain version: at phase 7's shape (the whole
    recording at 1024/512, timed there), the speech hop 160 with nfft 1000
    and pad 1024, and pad 16384 (one shared buffer, the X_k in registers)."""
    from godsp_tpu_torch import window
    from godsp_tpu_torch.ops import cuda_csd, cuda_pwelch

    g = torch.Generator(device=dev).manual_seed(7)
    whole = (FS * SECONDS - 1024) // 512 + 1
    for nfft, stride, pad, S in ((1024, 512, 1024, whole), (1000, 160, 1024, 4096),
                                 (16384, 8192, 16384, 512)):
        L = (S - 1) * stride + nfft
        x = torch.rand(L, generator=g, device=dev) * 2 - 1  # [-1, 1), zero-mean like decoded PCM16
        y = 0.7 * torch.roll(x, DELAY) + 0.1 * torch.randn(L, generator=g, device=dev)
        keep = S - 3
        mask = (torch.arange(S, device=dev) < keep).float()
        w = window.window_table("hann", pad, device=dev, dtype=torch.float32)
        bt = cuda_pwelch.segs_per_tile(S, 1)
        what = f"nfft {nfft} hop {stride} pad {pad} S {S} keep {keep}"
        want = cplx(cuda_csd.csd_power_partials_plain(x.double(), y.double(), mask.double(),
                                                      w.double(), nfft, stride, pad, bt))
        rec.check("csd_power_partials",
                  lambda: cplx(cuda_csd.csd_power_partials(x, y, mask, w, nfft, stride, pad=pad)),
                  want, what)
        del want
        if S == whole:
            # No one PyTorch call frames two signals and sums their cross power.
            lp, tiles = pad // 2 + 1, -(-S // bt)
            rec.time("csd_power_partials", what,
                     lambda: cuda_csd.csd_power_partials(x, y, mask, w, nfft, stride, pad=pad),
                     lambda: cuda_csd.csd_power_partials_plain(x, y, mask, w, nfft, stride,
                                                               pad, bt),
                     None, 4.0 * (2 * L + S + pad + 2 * tiles * lp),
                     keep * (2.0 * (nfft + rfft_flops(pad, pad)) + 8.0 * lp))
        del x, y


def phase_halo_kernels(rec: KernelRecord, dev) -> None:
    """K10 at phase 8's chunk shape, equal to its plain version, and K11
    against its float64 plain version at three shapes, timed at the first."""
    from godsp_tpu_torch import window
    from godsp_tpu_torch.ops import cuda_fused_halo, cuda_halo, cuda_pwelch, launch_counts

    g = torch.Generator(device=dev).manual_seed(10)
    # A StreamingPwelch chunk of phase 8 on the card: 8 blocks of 256 x 512
    # samples, views of the chunk + halo buffer (row stride 8 x 131,072 + 512).
    block, halo = SEGS * 512, 512
    ext = torch.rand(1, SP * block + halo, generator=g, device=dev) * 2 - 1
    blocks = list(ext[:, : SP * block].chunk(SP, dim=-1))
    shape = f"{SP} blocks x 1 row x {block}, halo {halo}"
    before = launch_counts()["ring_halo"]
    got = cuda_halo.ring_halo(blocks, halo)
    if launch_counts()["ring_halo"] != before + 1:
        raise AssertionError("ring_halo: not one launch for the ring")
    want = cuda_halo.ring_halo_plain(blocks, halo)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("ring_halo: differs from its plain version")
    rec.err["ring_halo"] = 0.0
    log(f"  {'ring_halo':22s} {shape:34s} equal to its plain version (torch.equal)")
    stacked = torch.stack([b for b in blocks])
    rec.time("ring_halo", shape, lambda: cuda_halo.ring_halo(blocks, halo),
             lambda: torch.stack(cuda_halo.ring_halo_plain(blocks, halo)),
             lambda: torch.roll(stacked[..., :halo], -1, 0), 8.0 * SP * halo, 0.0)
    del ext, blocks, stacked
    # K11: one shard of phase 8's chunk and its neighbour's head (views of
    # one signal), the last shard with an injected tail, and hop 160 with
    # nfft 1000 and pad 1024 (an 840-sample halo).
    for nfft, stride, pad, last in ((1024, 512, 1024, False), (1024, 512, 1024, True),
                                    (1000, 160, 1024, False)):
        S = SEGS
        L = S * stride
        sig = torch.rand(1, 2 * L, generator=g, device=dev) * 2 - 1
        x, src = sig[:, :L], sig[:, L:]
        if last:
            src = torch.rand(1, nfft - stride, generator=g, device=dev) * 2 - 1
        keep = S - 3 if last else S
        mask = (torch.arange(S, device=dev) < keep).float()
        w = window.window_table("hann", pad, device=dev, dtype=torch.float32)
        bt = cuda_pwelch.segs_per_tile(S, 1)
        what = (f"nfft {nfft} hop {stride} pad {pad} S {S} "
                f"{'tail' if last else 'neighbour'} {nfft - stride}")
        want = cuda_fused_halo.pwelch_power_partials_halo_plain(
            x.double(), src.double(), mask.double(), w.double(), nfft, stride, pad, bt)
        rec.check("pwelch_power_partials_halo",
                  lambda: cuda_fused_halo.pwelch_power_partials_halo(x, src, mask, w, nfft, stride,
                                                                     pad=pad),
                  want, what)
        if "pwelch_power_partials_halo" not in rec.times:
            # No one PyTorch call frames, windows, transforms and sums.
            H, tiles, lp = nfft - stride, -(-S // bt), pad // 2 + 1
            rec.time("pwelch_power_partials_halo", what,
                     lambda: cuda_fused_halo.pwelch_power_partials_halo(x, src, mask, w, nfft,
                                                                        stride, pad=pad),
                     lambda: cuda_fused_halo.pwelch_power_partials_halo_plain(
                         x, src, mask, w, nfft, stride, pad, bt),
                     None, 4.0 * (L + H + S + pad + tiles * lp),
                     keep * (nfft + rfft_flops(pad, pad) + 3.0 * lp))
        del sig, want


def write_recording(path: str, stereo_path: str | None = None) -> int:
    """Seeded sine mix + noise, 10 min of 44.1 kHz PCM16 mono; with
    stereo_path also the stereo twin: channel 0 the same mix, channel 1
    0.7 x channel 0 delayed by DELAY samples plus independent noise."""
    from godsp_tpu_torch import wav

    n = FS * SECONDS
    rng = np.random.default_rng(2024)
    rng1 = np.random.default_rng(2025)
    block = 1 << 20
    prev = np.zeros(DELAY)
    with contextlib.ExitStack() as stack:
        w = stack.enter_context(wav.WavWriter(path, FS, channels=1, float32=False))
        w2 = (stack.enter_context(wav.WavWriter(stereo_path, FS, channels=2, float32=False))
              if stereo_path else None)
        for i in range(0, n, block):
            t = np.arange(i, min(i + block, n)) / FS
            x = (0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(2 * np.pi * 3150.0 * t)
                 + 0.05 * np.sin(2 * np.pi * 11025.0 * t) + 0.1 * rng.normal(size=t.size))
            w.write(x)
            if w2 is not None:
                delayed = np.concatenate([prev, x])[: x.size]
                prev = x[-DELAY:]
                w2.write(np.stack([x, 0.7 * delayed + 0.1 * rng1.normal(size=x.size)]))
    return n


def oracle_pxx(samples: np.ndarray, opts, dev) -> np.ndarray:
    """float64 Pxx of the decoded samples on the card: Welch's frames
    (pwelch.go:104-136) over the plain transforms beneath the public entry
    points."""
    from godsp_tpu_torch import window
    from godsp_tpu_torch.dsputils import is_power_of_2, zero_pad
    from godsp_tpu_torch.fft import four_step_fft
    from godsp_tpu_torch.fft.bluestein import bluestein_fft
    from godsp_tpu_torch.spectral import segment

    nfft, wf, pad, noverlap, scaling = opts.resolved()
    fft_len, lp = max(pad, nfft), pad // 2 + 1
    x = torch.from_numpy(samples).to(dev, torch.float64)
    frames = zero_pad(segment(x, nfft, noverlap), fft_len)
    frames = frames * window.window_table(wf, fft_len, device=dev)
    z = c128(frames)
    del x, frames
    with plain_route():
        spec = (four_step_fft(z) if is_power_of_2(fft_len) else bluestein_fft(z))[..., :lp]
    p = (spec.real * spec.real + spec.imag * spec.imag).mean(dim=-2)
    p[1 : lp - 1] *= 2.0
    w_nfft = window.window_table(wf, nfft, device=dev)
    norm = torch.sum(w_nfft * w_nfft) * (FS if scaling else 1.0)
    return (p / norm).cpu().numpy()


def counted(label: str, run, steps: dict) -> tuple[object, float]:
    """run() as one step of the counted session; its launches go to steps[label]."""
    from godsp_tpu_torch.ops import launch_counts

    before = launch_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = launch_counts()
    steps[label] = {k: after[k] - before[k] for k in after}
    log(f"  step {label}: {wall:.3f} s, launches {steps[label]}")
    return out, wall


def read_decoded(path: str) -> np.ndarray:
    from godsp_tpu_torch import wav

    r = wav.read_wav(path)
    try:
        return r.read_floats(r.samples)
    finally:
        r.close()


def phase_main_path(dev, path: str) -> tuple[dict[str, int], dict[str, dict[str, int]]]:
    from godsp_tpu_torch import fft, spectral
    from godsp_tpu_torch.fft import four_step_fft
    from godsp_tpu_torch.models import wav_psd
    from godsp_tpu_torch.ops import launch_counts, reset_launch_counts

    decoded = read_decoded(path)
    n = decoded.size
    fused_o = spectral.PwelchOptions(**WELCH)
    unfused_o = spectral.PwelchOptions(**WELCH_UNFUSED)
    frames = torch.from_numpy(decoded[: (n // 1024) * 1024].reshape(-1, 1024)).to(dev)

    # A first call pays one-time costs (twiddle tables, allocator);
    # the counted session below is warm.
    t0 = time.perf_counter()
    wav_psd(path, fused_o, device=dev)
    log(f"  wav_psd nfft 1024/512 first call: {time.perf_counter() - t0:.3f} s")

    steps: dict[str, dict[str, int]] = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    res, wall = counted(FUSED, lambda: wav_psd(path, fused_o, device=dev), steps)
    res_u, wall_u = counted(UNFUSED, lambda: wav_psd(path, unfused_o, device=dev), steps)
    def spectra():
        spec = fft.fft_real(frames)
        return spec, fft.ifft(spec), fft.rfft_split(frames)

    (spec, back, (yr, yi)), _ = counted(FFT_API, spectra, steps)
    counts = launch_counts()

    log(f"  wav_psd nfft 1024/512 (fused): {res.metrics_json}")
    log(f"  wav_psd nfft 1024/512 wall {wall:.3f} s, {n / wall / 1e6:.3f} Msamples/s")
    log(f"  wav_psd nfft 1000/500 (unfused): {res_u.metrics_json}")
    log(f"  wav_psd nfft 1000/500 wall {wall_u:.3f} s, {n / wall_u / 1e6:.3f} Msamples/s")
    log(f"  launches in the main path: {counts}")
    chunks = json.loads(res.metrics_json)["chunks"]
    if steps[FUSED] != {**{k: 0 for k in counts}, "pwelch_power_partials": chunks}:
        raise AssertionError(f"fused wav_psd launched {steps[FUSED]} for {chunks} chunks")
    for label, names in ((UNFUSED, ("fft_pow2", "ifft_pow2")),
                         (FFT_API, ("fft_pow2", "ifft_pow2", "rfft_pow2"))):
        for name in names:
            if steps[label][name] <= 0:
                raise AssertionError(f"{label} did not launch {name}")

    for label, r, o in (("fused", res, fused_o), ("unfused", res_u, unfused_o)):
        want = oracle_pxx(decoded, o, dev)
        if r.pxx.shape != want.shape or not np.all(np.isfinite(r.pxx)):
            raise AssertionError(f"wav_psd {label}: bad Pxx {r.pxx.shape}")
        db = snr(r.pxx, want)
        log(f"  wav_psd {label} Pxx vs float64 oracle: {db:.2f} dB over {r.pxx.size} bins")
        if not db >= SNR_DB:
            raise AssertionError(f"wav_psd {label}: {db:.2f} dB < {SNR_DB} dB")

    want_spec = four_step_fft(c128(frames))
    checks = (
        ("fft_real", spec, want_spec),
        ("ifft(fft_real)", back, frames.double()),
        ("rfft_split", torch.complex(yr, yi), want_spec[:, :513]),
    )
    for label, got, want in checks:
        db = snr(got, want)
        log(f"  {label} on {tuple(frames.shape)}: {db:.2f} dB")
        if not db >= SNR_DB:
            raise AssertionError(f"{label}: {db:.2f} dB < {SNR_DB} dB")

    # The golden is a check, run after the session's counts were read.
    golden, _ = spectral.pwelch(torch.arange(100, dtype=torch.float32, device=dev), 2.0)
    db = snr(golden, golden_pxx())
    log(f"  129-bin golden through pwelch on the card: {db:.2f} dB")
    if golden.shape != (129,) or not db >= SNR_DB:
        raise AssertionError(f"golden: {db:.2f} dB < {SNR_DB} dB")
    return counts, steps


def check_db(label: str, got, want) -> float:
    db = snr(got, want)
    log(f"  {label}: {db:.2f} dB")
    if not db >= SNR_DB:
        raise AssertionError(f"{label}: {db:.2f} dB < {SNR_DB} dB")
    return db


def check_synthesis(label: str, got: np.ndarray, want: torch.Tensor) -> None:
    """Hold a float32 synthesis to its float64 oracle over the whole signal
    and over its interior [nfft, L - nfft).  The first and last
    nfft - hop samples divide by a NOLA sum of Hann's near-zero ends
    (w[1]^2 ~ 1e-10 at nfft 1024), which scales float32 rounding by as
    much; the interior shows the synthesis apart from that."""
    want = want.cpu().numpy()
    check_db(f"{label}, whole signal", got, want)
    check_db(f"{label}, interior", got[NFFT:-NFFT], want[NFFT:-NFFT])


def expect_launches(label: str, steps: dict, want: dict[str, int]) -> None:
    got = steps[label]
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{label} launched {got}, expected {full}")


def phase_stft_family(dev, path: str) -> dict[str, dict[str, int]]:
    """The STFT family at real size, as one counted session (phase 5)."""
    from godsp_tpu_torch import window
    from godsp_tpu_torch.models import (griffin_lim, istft, mel_filterbank, mel_spectrogram,
                                        spectra_to_wav, spectrogram_from_wav, stft)
    from godsp_tpu_torch.models._stft_impl import _nola_norm
    from godsp_tpu_torch.models.griffin import _gl_loop
    from godsp_tpu_torch.ops import cuda_istft, cuda_stft, launch_counts, reset_launch_counts

    decoded = read_decoded(path)
    n = decoded.size
    x = torch.from_numpy(decoded).to(dev)
    synth = os.path.join(os.path.dirname(path), "synthesis.wav")
    F = (n - NFFT) // 256 + 1
    L = (F - 1) * 256 + NFFT
    F60 = (FS * GL_SECONDS - NFFT) // 256 + 1
    L60 = (F60 - 1) * 256 + NFFT
    n_chunks = -(-F // CHUNK)

    def session(step):
        """The five steps; step(label, fn) runs each and returns its result."""
        sg, _, _ = step(SPECGRAM, lambda: spectrogram_from_wav(path, nfft=NFFT, hop=512,
                                                               device=dev))
        S = step(STFT, lambda: stft(x, NFFT, hop=256))
        M = step(MEL, lambda: mel_spectrogram(x, FS, nfft=NFFT, hop=256, n_mels=80))
        written = step(SYNTH, lambda: spectra_to_wav(
            (S[i : i + CHUNK] for i in range(0, F, CHUNK)), synth, FS, NFFT, hop=256))
        y_gl = step(GRIFFIN, lambda: griffin_lim(S[:F60].abs(), NFFT, hop=256, n_iter=GL_ITERS,
                                                 momentum=0.99))
        return sg, S, M, written, y_gl

    # A first pass pays one-time costs (filterbank and band tables,
    # allocator); the counted session below is warm.
    t0 = time.perf_counter()
    session(lambda label, fn: fn())
    torch.cuda.synchronize()
    log(f"STFT family: first pass {time.perf_counter() - t0:.3f} s")

    steps: dict[str, dict[str, int]] = {}
    walls: dict[str, float] = {}

    def step(label, fn):
        out, walls[label] = counted(label, fn, steps)
        return out

    reset_launch_counts()
    sg, S, M, written, y_gl = session(step)
    counts = launch_counts()

    log(f"  launches in the STFT-family session: {counts}")
    expect_launches(SPECGRAM, steps, {"stft_power": 1})
    expect_launches(STFT, steps, {"stft_complex": 1})
    expect_launches(MEL, steps, {"stft_mel": 1})
    expect_launches(SYNTH, steps, {"istft_overlap_add": n_chunks})
    expect_launches(GRIFFIN, steps, {"istft_overlap_add": GL_ITERS + 1, "stft_complex": GL_ITERS})
    for label, samples in ((SPECGRAM, n), (STFT, n), (MEL, n), (SYNTH, written),
                           (GRIFFIN, L60)):
        log(f"  {label}: wall {walls[label]:.3f} s, {samples / walls[label] / 1e6:.3f} Msamples/s")
    log(f"  {GRIFFIN}: {walls[GRIFFIN] / GL_ITERS * 1e3:.3f} ms per iteration")

    # Checks, after the counts were read: float64 oracles on the card from
    # the plain functions on the same decoded samples.
    x64 = x.double()
    w64 = window.window_table("hann", NFFT, device=dev)
    shapes = [tuple(t.shape) for t in (sg, S, M, y_gl)]
    if shapes != [((n - NFFT) // 512 + 1, NFFT // 2 + 1), (F, NFFT // 2 + 1), (F, 80), (L60,)]:
        raise AssertionError(f"shapes of spectrogram, stft, mel, griffin_lim: {shapes}")
    check_db("spectrogram_from_wav vs float64 oracle", sg,
             cuda_stft.stft_pallas_plain(x64, w64, NFFT, 512, sg.shape[0], out="power"))
    check_db("stft vs float64 oracle", S, cuda_stft.stft_pallas_plain(x64, w64, NFFT, 256, F))
    fb64 = mel_filterbank(80, NFFT, FS, device=dev, dtype=torch.float64)
    check_db("mel_spectrogram vs float64 oracle", M,
             cuda_stft.stft_pallas_plain(x64, w64, NFFT, 256, F, out="mel", fb=fb64))
    got = read_decoded(synth)
    if written != L or got.shape != (L,) or not np.all(np.isfinite(got)):
        raise AssertionError(f"spectra_to_wav wrote {written} samples, read {got.shape}, want {L}")
    want = cuda_istft.istft_overlap_add_plain(c128(S), w64, NFFT, 256) / _nola_norm(w64, F, 256, L)
    check_synthesis("spectra_to_wav WAV vs float64 istft of the same spectra", got, want)
    del want
    y = istft(S, NFFT, hop=256)
    log(f"  istft(stft(x)) vs x over [{NFFT}, {L - NFFT}):")
    check_db("    round trip, interior", y[NFFT:-NFFT], x64[NFFT : L - NFFT])

    # Griffin-Lim: float32 kernels against the float64 plain route.
    mag = S[:F60].abs()
    mag64 = mag.double()

    def fwd64(s):
        return cuda_stft.stft_pallas_plain(s, w64, NFFT, 256, F60)

    def ola64(s):
        return cuda_istft.istft_overlap_add_plain(s, w64, NFFT, 256)

    def convergence(y):
        return float(torch.linalg.vector_norm(fwd64(y.double()).abs() - mag64)
                     / torch.linalg.vector_norm(mag64))

    y0 = griffin_lim(mag, NFFT, hop=256, n_iter=0)
    want0 = _gl_loop(mag64, w64, 256, L60, 0, 0.99, fwd64, ola64)
    check_db("griffin_lim n_iter 0 vs float64 plain route", y0, want0)
    y64 = _gl_loop(mag64, w64, 256, L60, GL_ITERS, 0.99, fwd64, ola64)
    sc, sc64 = convergence(y_gl), convergence(y64)
    sc_db, sc64_db = 20 * np.log10(sc), 20 * np.log10(sc64)
    log(f"  griffin_lim n_iter {GL_ITERS}: spectral convergence kernel {sc:.6f} ({sc_db:.3f} dB), "
        f"float64 plain route {sc64:.6f} ({sc64_db:.3f} dB)")
    if not (np.isfinite(sc_db) and abs(sc_db - sc64_db) <= GL_SC_DB):
        raise AssertionError(f"griffin_lim: {sc_db:.3f} dB vs {sc64_db:.3f} dB, > {GL_SC_DB} dB")
    return steps


def oracle_hilbert(x64: torch.Tensor) -> torch.Tensor:
    """float64 analytic signal on the card from the plain functions beneath
    the public hilbert: Bluestein forward, the one-sided weights, and the
    index-reversed Bluestein inverse (fft.go:35-52)."""
    from godsp_tpu_torch.fft.bluestein import bluestein_fft

    n = x64.shape[-1]
    h = torch.zeros(n, dtype=torch.float64, device=x64.device)
    h[0] = 1.0
    h[1 : (n + 1) // 2] = 2.0
    if n % 2 == 0:
        h[n // 2] = 1.0
    with plain_route():
        z = bluestein_fft(c128(x64)) * h
        return bluestein_fft(torch.roll(torch.flip(z, dims=(-1,)), 1, dims=-1)) / n


def phase_fft_surface(dev, path: str) -> dict[str, dict[str, int]]:
    """The FFT surface at full size, as one counted session (phase 6)."""
    from godsp_tpu_torch import dsputils, fft
    from godsp_tpu_torch.fft import four_step_fft
    from godsp_tpu_torch.ops import launch_counts, reset_launch_counts

    decoded = read_decoded(path)  # host data: hilbert gets no device
    g = torch.Generator(device=dev).manual_seed(6)

    def crand(*shape):
        return torch.complex(torch.randn(*shape, generator=g, device=dev),
                             torch.randn(*shape, generator=g, device=dev))

    x20, y24, x28 = crand(B20, N20), crand(N24), crand(N28)
    rng = np.random.default_rng(256)
    n3d = CUBE ** 3
    cube = dsputils.make_matrix(rng.normal(size=n3d) + 1j * rng.normal(size=n3d), [CUBE] * 3)

    def session(step):
        """The five steps; step(label, fn) runs each and returns its result."""
        a = step(FFT20, lambda: fft.fft(x20))
        b = step(IFFT24, lambda: fft.ifft(y24))
        c = step(FFT28, lambda: fft.fft(x28))
        h = step(HILBERT, lambda: fft.hilbert(decoded))
        m = step(FFTN, lambda: fft.fftn(cube))
        return a, b, c, h, m

    # A first pass pays one-time costs (twiddle and chirp tables,
    # allocator); the counted session below is warm.
    t0 = time.perf_counter()
    session(lambda label, fn: fn())
    torch.cuda.synchronize()
    log(f"FFT surface: first pass {time.perf_counter() - t0:.3f} s")

    steps: dict[str, dict[str, int]] = {}
    walls: dict[str, float] = {}

    def step(label, fn):
        out, walls[label] = counted(label, fn, steps)
        return out

    reset_launch_counts()
    y20, z24, y28, an, spec3 = session(step)
    counts = launch_counts()

    log(f"  launches in the FFT-surface session: {counts}")
    expect_launches(FFT20, steps, {"outer_dft_split": 1, "fft_pow2": 1})
    expect_launches(IFFT24, steps, {"outer_dft_split": 1, "ifft_pow2": 1})
    expect_launches(FFT28, steps, {"outer_dft_split": 2, "fft_pow2": 1})
    expect_launches(HILBERT, steps, {"outer_dft_split": 8, "fft_pow2": 2, "ifft_pow2": 2})
    expect_launches(FFTN, steps, {"fft_pow2": 3})
    if an.device.type != dev.type:
        raise AssertionError(f"hilbert of host data ran on {an.device}, not the card")
    if not isinstance(spec3, dsputils.Matrix) or spec3.dimensions() != [CUBE] * 3:
        raise AssertionError(f"fftn of a Matrix returned {spec3!r}")

    # Beside torch.fft (cuFFT) at the same shapes: device time, CUDA events.
    xdec = torch.from_numpy(decoded).to(dev)
    cube_dev = torch.from_numpy(cube.array).to(dev, torch.complex64)
    yardsticks = {
        FFT20: (x20.numel(), lambda: fft.fft(x20), lambda: torch.fft.fft(x20)),
        IFFT24: (y24.numel(), lambda: fft.ifft(y24), lambda: torch.fft.ifft(y24)),
        FFT28: (x28.numel(), lambda: fft.fft(x28), lambda: torch.fft.fft(x28)),
        HILBERT: (decoded.size, lambda: fft.hilbert(xdec), lambda: torch.fft.fft(xdec)),
        FFTN: (n3d, lambda: fft.fftn(cube_dev), lambda: torch.fft.fftn(cube_dev)),
    }
    for label, (samples, ours, lib) in yardsticks.items():
        ms, lib_ms = time_ms(ours, reps=5), time_ms(lib, reps=5)
        log(f"  {label}: wall {walls[label]:.4f} s, {samples / walls[label] / 1e6:.1f} "
            f"Msamples/s; device {ms:.3f} ms ({samples / ms / 1e3:.1f} Msamples/s) on a "
            f"device tensor, torch.fft {lib_ms:.3f} ms")
    del xdec, cube_dev

    # Checks, after the counts were read: float64 oracles on the card from
    # the plain functions.
    check_db(f"{FFT20} vs float64 four-step", y20, four_step_fft(c128(x20)))
    check_db(f"{IFFT24} vs float64 four-step", z24,
             four_step_fft(c128(y24), inverse=True) / N24)
    del y20, z24
    want = four_step_fft(c128(x28))
    check_db(f"{FFT28} vs float64 four-step", y28, want)
    del want, y28
    check_db(f"{HILBERT} vs float64 Bluestein oracle", an,
             oracle_hilbert(torch.from_numpy(decoded).to(dev, torch.float64)))
    want = torch.from_numpy(cube.array).to(dev)
    for axis in range(3):
        want = four_step_fft(want.movedim(axis, -1)).movedim(-1, axis)
    check_db(f"{FFTN} vs float64 four-step per axis", spec3.array, want)
    return steps


def oracle_csd(x64: torch.Tensor, y64: torch.Tensor, opts) -> torch.Tensor:
    """float64 Pxy of the reference's csd on the card: frames, zero pad to
    pad, the symmetric pad-length window, the plain transforms, the mean
    of conj(X) Y, doubling of [1:lp-1] and the NFFT-window norm
    (pwelch.go:104-136 over two signals)."""
    from godsp_tpu_torch import window
    from godsp_tpu_torch.dsputils import zero_pad
    from godsp_tpu_torch.fft import four_step_fft
    from godsp_tpu_torch.spectral import segment

    nfft, wf, pad, noverlap, scaling = opts.resolved()
    dev = x64.device
    lp = pad // 2 + 1
    w = window.window_table(wf, pad, device=dev)
    acc = torch.zeros(lp, dtype=torch.complex128, device=dev)
    frames_x, frames_y = segment(x64, nfft, noverlap), segment(y64, nfft, noverlap)
    nsegs = frames_x.shape[-2]
    with plain_route():
        for i in range(0, nsegs, 1 << 15):  # blocks of segments: bounded memory
            X = four_step_fft(c128(zero_pad(frames_x[i : i + (1 << 15)], pad) * w))[..., :lp]
            Y = four_step_fft(c128(zero_pad(frames_y[i : i + (1 << 15)], pad) * w))[..., :lp]
            acc += (torch.conj(X) * Y).sum(dim=-2)
    acc = acc / nsegs
    acc[1 : lp - 1] *= 2.0
    w_nfft = window.window_table(wf, nfft, device=dev)
    return acc / (torch.sum(w_nfft * w_nfft) * (FS if scaling else 1.0))


def lomb_bound_db(t: np.ndarray, freqs: np.ndarray) -> float:
    """The SNR lombscargle's float32 run must reach against float64.

    Each float32 phase w*t carries at most four roundings of relative size
    u = 2^-24 (t, w, their product, and the subtraction of tau), so its
    error is at most 4 u max|w t| radians; sin and cos pass it on
    unscaled, and the power, a ratio of quadratic forms in them, moves by
    about that relative amount.  The row sums add log2(n) u, far below.
    So 20 log10(1 / (4 u max|w t|))."""
    return float(-20.0 * np.log10(4.0 * 2.0 ** -24 * np.max(np.abs(freqs)) * np.max(np.abs(t))))


def phase_scipy_spectra(dev, mono_path: str, stereo_path: str) -> dict[str, dict[str, int]]:
    """The scipy-convention spectra and the cross-spectra at real size, as
    one counted session (phase 7)."""
    import scipy.signal as ss

    from godsp_tpu_torch import parallel, spectral, wav
    from godsp_tpu_torch.ops import launch_counts, reset_launch_counts

    decoded = read_decoded(stereo_path).reshape(-1, 2)  # interleaved frames -> (L, 2)
    n = decoded.shape[0]
    x = torch.from_numpy(decoded).to(dev)
    ch0, ch1 = x[:, 0], x[:, 1]
    o160 = spectral.PwelchOptions(nfft=1024, noverlap=864)
    rng = np.random.default_rng(65536)
    t_l = np.sort(rng.uniform(0.0, 1.0, LOMB_N))
    y_l = 0.5 + np.sin(2 * np.pi * 97.0 * t_l) + 0.3 * rng.normal(size=LOMB_N)
    f_l = np.linspace(2 * np.pi, 2 * np.pi * LOMB_FMAX, LOMB_F)
    t_d, y_d, f_d = (torch.from_numpy(a).to(dev) for a in (t_l, y_l, f_l))
    kw = dict(fs=FS, nperseg=1024, detrend=False)

    def session(step):
        """The ten steps; step(label, fn) runs each and returns its result."""
        r = {}
        r[W_FUSED] = step(W_FUSED, lambda: spectral.welch(x, FS, nperseg=1024, noverlap=512,
                                                          detrend=False, axis=0)[1])
        r[W_CONST] = step(W_CONST, lambda: spectral.welch(x, FS, nperseg=1024, noverlap=512,
                                                          axis=0)[1])
        r[W_MEDIAN] = step(W_MEDIAN, lambda: spectral.welch(x, FS, nperseg=1024, noverlap=512,
                                                            average="median", detrend=False,
                                                            axis=0)[1])
        r[W_CSD] = step(W_CSD, lambda: spectral.welch_csd(ch0, ch1, **kw)[1])
        r[W_COH] = step(W_COH, lambda: spectral.welch_coherence(ch0, ch1, **kw)[1])
        r[CSD160] = step(CSD160, lambda: spectral.csd(ch0, ch1, FS, o160)[0])
        r[COH160] = step(COH160, lambda: spectral.coherence(ch0, ch1, FS, o160)[0])
        r[SPEC_SCIPY] = step(SPEC_SCIPY, lambda: spectral.spectrogram_scipy(ch0, **kw)[2])
        r[STREAM_WELCH] = step(STREAM_WELCH, lambda: parallel.stream_welch(
            wav.read_wav(mono_path).blocks(1 << 20), FS, nperseg=1024, device=dev)[1])
        r[LOMB] = step(LOMB, lambda: spectral.lombscargle(t_d, y_d, f_d))
        return r

    # A first pass pays one-time costs (twiddle tables, allocator); the
    # counted session below is warm.
    t0 = time.perf_counter()
    session(lambda label, fn: fn())
    torch.cuda.synchronize()
    log(f"scipy spectra: first pass {time.perf_counter() - t0:.3f} s")

    steps: dict[str, dict[str, int]] = {}
    walls: dict[str, float] = {}

    def step(label, fn):
        out, walls[label] = counted(label, fn, steps)
        return out

    reset_launch_counts()
    r = session(step)
    counts = launch_counts()

    log(f"  launches in the scipy-spectra session: {counts}")
    chunk, halo = 256 * 512, 512  # StreamingPwelch's default chunk at hop 512
    full = (n - halo) // chunk
    chunks = full + (1 if n - full * chunk >= 1024 else 0)
    expect_launches(W_FUSED, steps, {"pwelch_power_partials": 1})
    expect_launches(W_CONST, steps, {"fft_pow2": 1})
    expect_launches(W_MEDIAN, steps, {"fft_pow2": 1})
    expect_launches(W_CSD, steps, {"csd_power_partials": 1})
    expect_launches(W_COH, steps, {"pwelch_power_partials": 2, "csd_power_partials": 1})
    expect_launches(CSD160, steps, {"csd_power_partials": 1})
    expect_launches(COH160, steps, {"csd_power_partials": 1, "pwelch_power_partials": 2})
    expect_launches(SPEC_SCIPY, steps, {"stft_power": 1})
    expect_launches(STREAM_WELCH, steps, {"pwelch_power_partials": chunks})
    expect_launches(LOMB, steps, {})
    for label in walls:
        samples = {W_FUSED: 2 * n, W_CONST: 2 * n, W_MEDIAN: 2 * n, W_CSD: 2 * n, W_COH: 2 * n,
                   CSD160: 2 * n, COH160: 2 * n, SPEC_SCIPY: n, STREAM_WELCH: n,
                   LOMB: LOMB_N}[label]
        log(f"  {label}: wall {walls[label]:.4f} s, {samples / walls[label] / 1e6:.3f} "
            f"Msamples/s")
    log(f"  {LOMB}: {LOMB_N * LOMB_F / walls[LOMB] / 1e9:.3f} G(time, frequency) pairs/s")

    # Checks, after the counts were read.  scipy.signal in float64 on the
    # host, on the same decoded samples.
    x64 = decoded.astype(np.float64)
    a64, b64 = x64[:, 0], x64[:, 1]
    mono = read_decoded(mono_path).astype(np.float64)
    want = {
        W_FUSED: ss.welch(x64, FS, nperseg=1024, noverlap=512, detrend=False, axis=0)[1],
        W_CONST: ss.welch(x64, FS, nperseg=1024, noverlap=512, axis=0)[1],
        W_MEDIAN: ss.welch(x64, FS, nperseg=1024, noverlap=512, average="median",
                           detrend=False, axis=0)[1],
        W_CSD: ss.csd(a64, b64, **kw)[1],
        W_COH: ss.coherence(a64, b64, **kw)[1],
        SPEC_SCIPY: ss.spectrogram(a64, **kw)[2],
        STREAM_WELCH: ss.welch(mono, FS, nperseg=1024, detrend=False)[1],
    }
    for label, ref in want.items():
        got = r[label]
        if tuple(got.shape) != ref.shape:
            raise AssertionError(f"{label}: shape {tuple(got.shape)}, scipy {ref.shape}")
        check_db(f"{label} vs scipy.signal float64", got, ref)
    del want
    # The reference-convention cross-spectra: float64 on the card.
    c0, c1 = ch0.double(), ch1.double()
    pxy = oracle_csd(c0, c1, o160)
    pxx, pyy = oracle_csd(c0, c0, o160).real, oracle_csd(c1, c1, o160).real
    check_db(f"{CSD160} vs float64 oracle", r[CSD160], pxy)
    check_db(f"{COH160} vs float64 oracle", r[COH160], (pxy.real**2 + pxy.imag**2) / (pxx * pyy))
    # lombscargle: float32 on the card against its own float64 run on the CPU.
    want_l = spectral.lombscargle(torch.from_numpy(t_l), torch.from_numpy(y_l),
                                  torch.from_numpy(f_l))
    bound = lomb_bound_db(t_l, f_l)
    db = snr(r[LOMB], want_l)
    log(f"  {LOMB} vs its float64 CPU run: {db:.2f} dB (bound {bound:.2f} dB, max|w t| "
        f"{np.max(f_l) * np.max(t_l):.1f} rad)")
    if r[LOMB].shape != (LOMB_F,) or not db >= bound:
        raise AssertionError(f"lombscargle: {db:.2f} dB < {bound:.2f} dB")
    return steps


def stream_chunks(n: int, chunk: int, halo: int, nfft: int) -> int:
    """Chunks StreamingPwelch runs over n samples: the full ones (each
    with its halo buffered) and the zero-padded remainder."""
    full = (n - halo) // chunk
    return full + (1 if n - full * chunk >= nfft else 0)


def phase_mesh(dev, path: str, stereo_path: str) -> dict[str, dict[str, int]]:
    """The mesh-sharded paths at real size, as one counted session (phase 8)."""
    from godsp_tpu_torch import fft, models, parallel, spectral, wav, window
    from godsp_tpu_torch.fft import four_step_fft
    from godsp_tpu_torch.models._stft_impl import _nola_norm
    from godsp_tpu_torch.ops import cuda_istft, cuda_stft, launch_counts, reset_launch_counts

    mesh8 = parallel.make_mesh(parallel.MeshConfig(dp=1, sp=SP), devices=[dev] * SP)
    mesh24 = parallel.make_mesh(parallel.MeshConfig(dp=2, sp=4), devices=[dev] * 8)
    if not (mesh8.one_device and mesh24.one_device):
        raise AssertionError("phase 8 meshes must sit on the one card")
    o = spectral.PwelchOptions(**WELCH)
    decoded = read_decoded(path)
    n = decoded.size
    cut = n // (SP * 512) * (SP * 512)
    x = torch.from_numpy(decoded[:cut]).to(dev)
    spec = models.stft(x, NFFT, hop=256)  # the input of the istft step, outside the session
    F8 = spec.shape[0] // SP * SP
    spec = spec[:F8]
    g = torch.Generator(device=dev).manual_seed(8)
    z = torch.complex(torch.randn(N24, generator=g, device=dev),
                      torch.randn(N24, generator=g, device=dev))

    def stereo_stream(mesh):
        sp = parallel.StreamingPwelch(FS, o, mesh, channels=2, halo_impl=("fused", False),
                                      device=None if mesh is not None else dev)
        for b in wav.read_wav(stereo_path).blocks(1 << 20):
            sp.update(b.reshape(-1, 2).T)
        return sp.finalize()[0]

    def stream(route, mesh):
        blocks = wav.read_wav(path).blocks(1 << 20)
        if mesh is None:
            return parallel.stream_pwelch(blocks, FS, o, device=dev)[0]
        return parallel.stream_pwelch(blocks, FS, o, mesh, halo_impl=(route, False))[0]

    def session(step):
        """The twelve steps; step(label, fn) runs each and returns its result."""
        r = {M_WAV: step(M_WAV, lambda: models.wav_psd(path, o, mesh8).pxx),
             M_PALLAS: step(M_PALLAS, lambda: stream("pallas", mesh8)),
             M_FUSED: step(M_FUSED, lambda: stream("fused", mesh8))}
        for route, label in M_SHARDED.items():
            r[label] = step(label, lambda: parallel.pwelch_sharded(
                x, FS, o, mesh8, halo_impl=(route, False))[0])
        r[M_STEREO] = step(M_STEREO, lambda: stereo_stream(mesh24))
        r[M_SPEC] = step(M_SPEC, lambda: parallel.spectrogram_sharded(x, mesh8, NFFT, 256))
        r[M_ISTFT] = step(M_ISTFT, lambda: parallel.istft_sharded(spec, mesh8, NFFT, 256))
        r[M_FFT] = step(M_FFT, lambda: parallel.fft_sharded(z, mesh8))
        r[M_IFFT] = step(M_IFFT, lambda: parallel.fft_sharded(r[M_FFT], mesh8, inverse=True)
                         / N24)
        return r

    # A first pass pays one-time costs (twiddle tables, allocator); the
    # counted session below is warm.
    t0 = time.perf_counter()
    session(lambda label, fn: fn())
    torch.cuda.synchronize()
    log(f"mesh paths: first pass {time.perf_counter() - t0:.3f} s")

    steps: dict[str, dict[str, int]] = {}
    walls: dict[str, float] = {}

    def step(label, fn):
        out, walls[label] = counted(label, fn, steps)
        return out

    reset_launch_counts()
    r = session(step)
    counts = launch_counts()
    log(f"  launches in the mesh session: {counts}")

    mono = stream_chunks(n, SP * SEGS * 512, 512, 1024)
    two = stream_chunks(n, 4 * SEGS * 512, 512, 1024)
    k4, k10, k11 = "pwelch_power_partials", "ring_halo", "pwelch_power_partials_halo"
    expect_launches(M_WAV, steps, {k4: SP * mono})
    expect_launches(M_PALLAS, steps, {k10: mono, k4: SP * mono})
    expect_launches(M_FUSED, steps, {k11: SP * mono})
    expect_launches(M_SHARDED["ppermute"], steps, {k4: SP})
    expect_launches(M_SHARDED["pallas"], steps, {k10: 1, k4: SP})
    expect_launches(M_SHARDED["fused"], steps, {k11: SP})
    expect_launches(M_STEREO, steps, {k11: 8 * two})
    expect_launches(M_SPEC, steps, {"stft_power": SP})
    expect_launches(M_ISTFT, steps, {"istft_overlap_add": SP})
    expect_launches(M_FFT, steps, {"outer_dft_split": SP, "fft_pow2": SP})
    expect_launches(M_IFFT, steps, {"outer_dft_split": SP, "ifft_pow2": SP})
    log(f"  chunks: {mono} of {SP * SEGS * 512} samples (sp=8), {two} of {4 * SEGS * 512} "
        "(dp=2 x sp=4)")

    # The same entries without a mesh on the card: walls beside the
    # sharded ones, and the results the sharded ones must agree with.
    one = {}
    one_walls = {}
    for label, fn in ((M_WAV, lambda: models.wav_psd(path, o, device=dev).pxx),
                      (M_PALLAS, lambda: stream(None, None)),
                      (M_STEREO, lambda: stereo_stream(None)),
                      (M_SHARDED["ppermute"], lambda: spectral.pwelch(x, FS, o)[0]),
                      (M_SPEC, lambda: models.spectrogram(x, NFFT, 256)),
                      (M_ISTFT, lambda: models.istft(spec, NFFT, 256)[: F8 * 256]),
                      (M_FFT, lambda: fft.fft(z)),
                      (M_IFFT, lambda: fft.ifft(r[M_FFT]))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one[label] = fn()
        torch.cuda.synchronize()
        one_walls[label] = time.perf_counter() - t0
    one[M_FUSED] = one[M_PALLAS]
    one_walls[M_FUSED] = one_walls[M_PALLAS]
    for route in ("pallas", "fused"):
        one[M_SHARDED[route]] = one[M_SHARDED["ppermute"]]
        one_walls[M_SHARDED[route]] = one_walls[M_SHARDED["ppermute"]]
    samples = {M_WAV: n, M_PALLAS: n, M_FUSED: n, M_STEREO: 2 * n, M_SPEC: cut,
               M_ISTFT: F8 * 256, M_FFT: N24, M_IFFT: N24, **{v: cut for v in M_SHARDED.values()}}
    log("  eight shards on one card measure the overhead of sharding, not scaling:")
    for label in r:
        log(f"  {label}: wall {walls[label]:.4f} s, {samples[label] / walls[label] / 1e6:.3f} "
            f"Msamples/s; one device {one_walls[label]:.4f} s, "
            f"{samples[label] / one_walls[label] / 1e6:.3f} Msamples/s")

    # Checks, after the counts were read: float64 oracles on the card from
    # the plain functions, then the one-device results.
    st = read_decoded(stereo_path).reshape(-1, 2)
    pxx_mono, pxx_cut = oracle_pxx(decoded, o, dev), oracle_pxx(decoded[:cut], o, dev)
    pxx_st = np.stack([oracle_pxx(np.ascontiguousarray(st[:, c]), o, dev) for c in range(2)])
    x64 = x.double()
    w64 = window.window_table("hann", NFFT, device=dev)
    with plain_route():
        z64 = c128(z)
        Z64 = four_step_fft(z64)
    oracles = {M_WAV: pxx_mono, M_PALLAS: pxx_mono, M_FUSED: pxx_mono, M_STEREO: pxx_st,
               **{v: pxx_cut for v in M_SHARDED.values()},
               M_SPEC: cuda_stft.stft_pallas_plain(x64, w64, NFFT, 256, (cut - NFFT) // 256 + 1,
                                                   out="power"),
               M_FFT: Z64, M_IFFT: z64}
    for label, want in oracles.items():
        got = r[label]
        if tuple(got.shape) != tuple(want.shape):
            raise AssertionError(f"{label}: shape {tuple(got.shape)}, want {tuple(want.shape)}")
        check_db(f"{label} vs float64 oracle", got, want)
    del oracles
    want = (cuda_istft.istft_overlap_add_plain(c128(spec), w64, NFFT, 256)
            / _nola_norm(w64, F8, 256, (F8 - 1) * 256 + NFFT))[: F8 * 256]
    check_synthesis(f"{M_ISTFT} vs float64 istft", r[M_ISTFT].cpu().numpy(), want)
    del want
    worst = min(check_db(f"{label} vs one device", r[label], one[label]) for label in r)
    log(f"  sharded vs one device on the card: >= {worst:.2f} dB over every step")
    return steps


def main() -> int:
    smi = phase_card()
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import godsp_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = torch.device("cuda", 0)
    phase_build()
    rec = KernelRecord()
    phase_kernels(rec, dev)
    phase_stft_kernels(rec, dev)
    phase_outer_kernel(rec, dev)
    phase_csd_kernel(rec, dev)
    phase_halo_kernels(rec, dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "recording.wav")
        stereo = os.path.join(tmp, "stereo.wav")
        t0 = time.perf_counter()
        n = write_recording(path, stereo)
        log(f"main path: wrote {n} samples ({os.path.getsize(path)} bytes) and their stereo "
            f"twin ({os.path.getsize(stereo)} bytes) in {time.perf_counter() - t0:.2f} s")
        _, steps = phase_main_path(dev, path)
        stft_steps = phase_stft_family(dev, path)
        fft_steps = phase_fft_surface(dev, path)
        welch_steps = phase_scipy_spectra(dev, path, stereo)
        mesh_steps = phase_mesh(dev, path, stereo)
    # Each wrapper's launches come from the counted sessions, each read
    # right after it ran.
    steps.update(stft_steps)
    steps.update(fft_steps)
    steps.update(welch_steps)
    steps.update(mesh_steps)

    kernels = []
    for name in REPLACES:
        t = rec.times[name]
        launched_by = {label: c[name] for label, c in steps.items() if c[name]}
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=sum(launched_by.values()), max_abs_err=rec.err[name], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=t["shape"], launched_by=launched_by,
        ))
        if not launched_by:
            raise AssertionError(f"{name} was not launched by the main path")
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        log(f"time {name:22s} {t['shape']:40s} kernel {t['ms']:.4f} ms  plain(f32) "
            f"{t['plain_ms']:.4f} ms  bound {t['bound_ms']:.4f} ms ({t['bound_by']})  "
            f"library {lib}  [{smi}]")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
