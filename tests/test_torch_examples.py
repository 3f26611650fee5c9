"""The godsp_tpu_torch twins of the examples (examples/torch/*.py) on the CPU.

One child interpreter (this process has imported jax through
tests/conftest.py) imports every twin, checks after each import that no
jax module is loaded, then runs each twin's main() on the CPU
(set_default_device("cpu"); long_stream_benchmark at 2^22 samples, still
past its first checkpoint) and hands back what each printed.  The cases
below read those lines, the quantities the JAX examples print: where a
twin feeds float64 host data the CPU run is float64 and its SNRs must
reach 200 dB; synthesis_tour casts its signal to float32, so its SNRs are
float32 ones, held to 60 dB (round trip, whose ends divide by Hann's
near-zero overlap sum) and 100 dB (streaming against one-shot), bars
between float32 rounding (~140 dB) and a wrong synthesis (< 20 dB).
"""

import json
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
TWINS = sorted((REPO / "examples" / "torch").glob("*.py"))
ARGV = {"long_stream_benchmark": ["1<<22"]}

CHILD = r"""
import contextlib, importlib.util, io, json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from godsp_tpu_torch import set_default_device
set_default_device("cpu")
out = {{}}
for path, argv in {twins!r}:
    name = path.rsplit("/", 1)[-1][:-3]
    spec = importlib.util.spec_from_file_location("twin_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax_loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "godsp_tpu"))
    sys.argv = [path] + [str(eval(a)) for a in argv]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    out[name] = {{"jax": jax_loaded, "stdout": buf.getvalue()}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs():
    twins = [(str(p), ARGV.get(p.stem, [])) for p in TWINS]
    proc = subprocess.run([sys.executable, "-c", CHILD.format(repo=str(REPO), twins=twins)],
                          capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _num(text, pattern):
    m = re.search(pattern, text)
    assert m, (pattern, text)
    return float(m.group(1))


def test_every_example_has_a_twin():
    names = {p.stem for p in TWINS}
    assert names == {"fft_basics", "pwelch_wav", "distributed_pwelch", "long_stream_benchmark",
                     "large_fft_and_hilbert", "synthesis_tour", "audio_frontend",
                     "filtering_tour", "signal_toolkit_tour"}
    for name in names:
        assert (REPO / "examples" / f"{name}.py").is_file()


@pytest.mark.parametrize("name", sorted(p.stem for p in TWINS))
def test_twin_imports_no_jax_and_runs(runs, name):
    assert runs[name]["jax"] == []
    assert runs[name]["stdout"].strip()


def test_fft_basics(runs):
    out = runs["fft_basics"]["stdout"]
    assert "X[1] mag=4.0000" in out and "X[2] mag=2.0000" in out  # Lyons's two tones
    assert _num(out, r"round-trip SNR: ([\d.]+) dB") >= 200.0
    assert _num(out, r"bluestein N=1000 vs numpy SNR: ([\d.]+) dB") >= 200.0
    assert "convolve: (500,)" in out and "fft2: (64, 128)" in out


def test_pwelch_wav(runs):
    out = runs["pwelch_wav"]["stdout"]
    assert "samples=40000 fs=8000" in out
    assert abs(_num(out, r"peak at ([\d.]+) Hz") - 440.0) < 8000 / 1024


def test_distributed_pwelch(runs):
    out = runs["distributed_pwelch"]["stdout"]
    assert "mesh: dp=1 sp=1 over cpu" in out
    assert abs(_num(out, r"peak at ([\d.]+) Hz") - 5000.0) < 44100 / 1024


def test_long_stream_benchmark_resumes_exactly(runs):
    out = runs["long_stream_benchmark"]["stdout"]
    assert _num(out, r"run A crashed after \d+ samples, (\d+) chunks") >= 4  # past a checkpoint
    assert _num(out, r"rel err ([\d.e+-]+)") < 1e-12
    assert abs(_num(out, r"peak: ([\d.]+) Hz") - 5000.0) < 44100 / 1024


def test_large_fft_and_hilbert(runs):
    out = runs["large_fft_and_hilbert"]["stdout"]
    assert "2^20 FFT: bins (1048576,)" in out
    assert abs(_num(out, r"peak at ([\d.]+) Hz") - 440.0) < 16000 / 1024
    assert "mel spectrogram: (1633, 40)" in out
    lo = _num(out, r"AM envelope range: \[([\d.]+),")
    hi = _num(out, r"AM envelope range: \[[\d.]+, ([\d.]+)\]")
    assert abs(lo - 0.5) < 0.01 and abs(hi - 1.5) < 0.01


def test_synthesis_tour(runs):
    out = runs["synthesis_tour"]["stdout"]
    assert _num(out, r"istft round-trip SNR: ([\d.]+) dB") >= 60.0
    assert _num(out, r"streaming == one-shot: ([\d.inf]+) dB") >= 100.0
    assert _num(out, r"mismatch after 32 iters: ([\d.]+)%") < 20.0


def test_audio_frontend(runs):
    out = runs["audio_frontend"]["stdout"]
    assert "48000 samples @ 16000 Hz" in out
    assert "log-mel: (184, 80)" in out and "mfcc:    (184, 13)" in out


def test_filtering_tour(runs):
    """The tour's float32 signal runs in float32 on the CPU: the figures of
    examples/filtering_tour.py under godsp_tpu."""
    out = runs["filtering_tour"]["stdout"]
    assert abs(_num(out, r"FIR-101:\s+440 Hz\s+([+-][\d.]+) dB")) < 0.5
    assert _num(out, r"FIR-101:.*1800 Hz ([+-][\d.]+) dB") < -50.0
    assert _num(out, r"butter-6:.*1800 Hz ([+-][\d.]+) dB") < -30.0
    assert "group delay 0 samples" in out
    assert _num(out, r"chunked == one-shot: ([\d.e+-]+)") < 1e-5
    assert "8000 -> 44100 -> 8000 samples" in out
    assert _num(out, r"round-trip err ([\d.]+)") < 0.1
    assert _num(out, r"440 Hz tone correlation ([\d.]+)") > 0.99


def test_signal_toolkit_tour(runs):
    """The tour's float64 host data runs in float64 on the CPU: the figures
    of examples/signal_toolkit_tour.py under godsp_tpu (the 2-D and
    Savitzky-Golay steps are the twin's own)."""
    out = runs["signal_toolkit_tour"]["stdout"]
    assert "elliptic bandpass: order 4 at wn = [350. 550.] Hz" in out
    assert _num(out, r"PSD @1800 Hz: [\d.e+-]+ -> ([\d.e+-]+)") < 1e-10
    assert "remez lowpass: 101 taps -> minimum-phase 51 taps" in out
    assert abs(_num(out, r"settles to ([\d.]+)") - 1.0) < 1e-3
    assert abs(_num(out, r"residual rms: ([\d.]+)") - 0.262) < 1e-3
    assert "chirp ridge: 125 Hz -> 1969 Hz across 253 slices" in out
    assert "maxima at samples [63, 312]" in out
    assert "savgol + find_peaks: 10 pulses, first at 201, last at 3800" in out
    noisy, blur, wien, med = (float(v) for v in re.search(
        r"noisy / blur / wiener / median: ([\d.]+) / ([\d.]+) / ([\d.]+) / ([\d.]+)",
        out).groups())
    assert max(blur, wien, med) < noisy / 2
    assert _num(out, r"fft parity vs numpy at n=4096: ([\d.e+-]+)") < 1e-10
