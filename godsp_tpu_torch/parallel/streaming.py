"""Streaming Welch PSD, sharded over a device mesh, with checkpoint/resume.

Port of godsp_tpu/parallel/streaming.py: time blocks stream from the host
(e.g. wav.Wav.blocks), each full chunk plus its halo goes to the mesh's
first device as one buffer, sharded_partial_step reduces it to a
periodogram sum (halo exchange by the chosen route, one kernel per shard
on CUDA, psum over "sp" in shard order), and a Neumaier-compensated
accumulator on that device folds the chunks together.  Without a mesh
the stream runs on one device (a 1 x 1 mesh).  A chunk is n_sp *
segs_per_chunk_shard * stride samples; the last shard's halo is the head
of the next chunk (the tail).  Channels split over the mesh's "dp" axis.
The state is snapshotted under godsp_tpu's npz keys, so a stream
checkpointed by either package resumes in the other.

Exactness: a chunk's halo is the head of the next chunk, so the union of
per-chunk segments is the reference's global segmentation
((L-nfft)/stride+1, spectral.go:26-33); the remainder is zero-padded to
one chunk with its incomplete segments masked.

stream_welch drives the same accumulator with scipy.signal.welch's
conventions (periodic window, nperseg/noverlap/nfft, density or spectrum
scaling).
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import torch

from godsp_tpu_torch import window as win
from godsp_tpu_torch._dtypes import np_float_for, resolve_device, working_float
from godsp_tpu_torch.native import StreamBuffer
from godsp_tpu_torch.parallel._pwelch_sharded_impl import resolve_geometry, sharded_partial_step
from godsp_tpu_torch.parallel.mesh import Mesh, canonical_device
from godsp_tpu_torch.spectral._pwelch_impl import PwelchOptions
from godsp_tpu_torch.spectral._welch_impl import _periodic_table_np

__all__ = ["StreamingMetrics", "StreamingPwelch", "stream_pwelch", "stream_welch"]

log = logging.getLogger("godsp_tpu_torch.streaming")

_STATE_KEYS = ("p_sum", "count", "consumed", "buf", "chunks", "segments", "samples_in")


def _neumaier_add(s: torch.Tensor, c: torch.Tensor, x: torch.Tensor):
    """Compensated (Neumaier) accumulation: (s', c') with s' + c' ~= s + c + x
    at about twice the working precision."""
    t = s + x
    c = c + torch.where(s.abs() >= x.abs(), (s - t) + x, (x - t) + s)
    return t, c


@dataclass
class StreamingMetrics:
    """Per-run observability (the reference has none)."""

    samples_in: int = 0
    segments_done: int = 0
    chunks_done: int = 0
    wall_s: float = 0.0

    @property
    def samples_per_s(self) -> float:
        return self.samples_in / self.wall_s if self.wall_s else 0.0

    def json_line(self) -> str:
        return json.dumps(
            dict(
                samples_in=self.samples_in,
                segments=self.segments_done,
                chunks=self.chunks_done,
                wall_s=self.wall_s,
                msamples_per_s=self.samples_per_s / 1e6,
            )
        )


class StreamingPwelch:
    """Accumulates a Welch PSD over a sample stream, sharded over a mesh.

    Usage:
        sp = StreamingPwelch(fs, options, mesh, segs_per_chunk_shard=256)
        for block in wav.blocks(1 << 20):
            sp.update(block)
        pxx, freqs = sp.finalize()

    update() buffers on the host and runs one sharded step per full chunk
    (n_sp * segs_per_chunk_shard * stride samples, plus the
    noverlap-sample halo that update() peeks from the following data).
    mesh None runs on `device` alone (default: default_device()); with a
    mesh, device is None or the mesh's first device.  halo_impl picks the
    halo route ("ppermute", "pallas" or "fused"; see
    _pwelch_sharded_impl).  channels > 1 takes (channels, n) blocks,
    returns (channels, lp) Pxx, and splits the channels over "dp".
    """

    def __init__(
        self,
        fs: float,
        options: Optional[PwelchOptions] = None,
        mesh=None,
        segs_per_chunk_shard: int = 256,
        checkpoint_path: Optional[str] = None,
        checkpoint_every_chunks: int = 0,
        channels: int = 1,
        halo_impl: tuple = ("ppermute", False),
        device=None,
    ):
        self.fs = float(fs)
        self.options = options or PwelchOptions()
        if mesh is None:
            mesh = Mesh([[resolve_device(device)]])
        elif not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a godsp_tpu_torch.parallel.Mesh, got {type(mesh)}")
        elif device is not None and canonical_device(device) != mesh.first:
            raise ValueError(f"device {device} is not the mesh's first device {mesh.first}")
        self.mesh = mesh
        self.device = mesh.first
        (
            self.nfft,
            self._wf,
            self.pad,
            self.fft_len,
            self.noverlap,
            self._scaling,
            self.stride,
            self.lp,
        ) = resolve_geometry(self.options)
        self.n_sp = self.mesh.shape["sp"]
        self.channels = int(channels)
        if self.channels < 1:
            raise ValueError("channels must be >= 1")
        n_dp = self.mesh.shape["dp"]
        if n_dp > 1 and self.channels % n_dp != 0:
            raise ValueError(
                f"channels ({self.channels}) must divide over the dp axis ({n_dp})"
            )
        self.segs_per_shard = int(segs_per_chunk_shard)
        self.chunk_len = self.n_sp * self.segs_per_shard * self.stride
        self.halo = max(self.nfft - self.stride, 0)
        if self.halo > self.segs_per_shard * self.stride:
            raise ValueError(
                f"per-shard block ({self.segs_per_shard * self.stride}) must hold "
                f"the {self.halo}-sample overlap halo; raise segs_per_chunk_shard"
            )
        self._halo_impl = tuple(halo_impl)

        self._fdt = working_float(self.device)
        self._np_float = np_float_for(self.device)
        self._w_pad = win.window_table(self._wf, self.fft_len, device=self.device,
                                       dtype=self._fdt)
        w_nfft = win.window_table_np(self._wf, self.nfft)
        self._w_norm = float(np.sum(w_nfft * w_nfft)) * (self.fs if self._scaling else 1.0)

        self._bufs = [
            StreamBuffer(capacity=2 * (self.chunk_len + self.halo), dtype=self._np_float)
            for _ in range(self.channels)
        ]
        # Device-resident compensated accumulator: no per-chunk readback.
        self._acc_s: Optional[torch.Tensor] = None  # (C, lp) running sum
        self._acc_c: Optional[torch.Tensor] = None  # (C, lp) compensation
        self._count = 0.0
        self._consumed = 0  # global samples fully folded into the state
        self._t_first: Optional[float] = None
        self.metrics = StreamingMetrics()

        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every_chunks)
        if checkpoint_path and os.path.exists(checkpoint_path):
            self._restore(checkpoint_path)

    def _acc_read(self) -> np.ndarray:
        """The accumulator as float64 numpy (waits for the device)."""
        if self._acc_s is None:
            return np.zeros((self.channels, self.lp), dtype=np.float64)
        return (self._acc_s.double() + self._acc_c.double()).cpu().numpy()

    # -- checkpoint / resume --------------------------------------------
    def state(self) -> dict:
        """The stream state under godsp_tpu's snapshot keys."""
        return dict(
            p_sum=self._acc_read(),
            count=self._count,
            consumed=self._consumed,
            buf=np.stack([b.peek(len(b)) for b in self._bufs]),
            chunks=self.metrics.chunks_done,
            segments=self.metrics.segments_done,
            samples_in=self.metrics.samples_in,
        )

    def _snapshot(self) -> None:
        tmp = self.checkpoint_path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **self.state())
        os.replace(tmp, self.checkpoint_path)
        log.info("checkpoint @ chunk %d -> %s", self.metrics.chunks_done, self.checkpoint_path)

    def load_state(self, z) -> None:
        """Resume from a mapping of numpy arrays under godsp_tpu's keys
        (p_sum, count, consumed, buf, chunks, segments, samples_in)."""
        missing = [k for k in _STATE_KEYS if k not in z]
        if missing:
            raise KeyError(f"stream state lacks {missing}")
        p_sum = np.asarray(z["p_sum"], dtype=np.float64)
        if p_sum.ndim == 1:  # pre-multichannel snapshot
            p_sum = p_sum[None, :]
        s = p_sum.astype(self._np_float)
        self._acc_s = torch.from_numpy(s).to(self.device)
        self._acc_c = torch.from_numpy(
            (p_sum - s.astype(np.float64)).astype(self._np_float)
        ).to(self.device)
        self._count = float(z["count"])
        self._consumed = int(z["consumed"])
        buf = np.asarray(z["buf"])
        if buf.ndim == 1:
            buf = buf[None, :]
        for b, row in zip(self._bufs, buf):
            b.consume(len(b))
            b.push(row)
        self.metrics.chunks_done = int(z["chunks"])
        self.metrics.segments_done = int(z["segments"])
        self.metrics.samples_in = int(z["samples_in"])

    def _restore(self, path: str) -> None:
        with np.load(path) as z:
            self.load_state(z)
        log.info("resumed from %s at chunk %d", path, self.metrics.chunks_done)

    # -- streaming ------------------------------------------------------
    def update(self, samples: np.ndarray) -> None:
        """Fold a new block of samples into the running PSD.

        samples: (n,) for single-channel, (channels, n) otherwise.
        """
        if self._t_first is None:
            self._t_first = time.perf_counter()
        samples = np.asarray(samples, dtype=self._np_float)
        if self.channels == 1:
            samples = samples.reshape(1, -1)
        elif samples.ndim != 2 or samples.shape[0] != self.channels:
            raise ValueError(f"expected ({self.channels}, n) samples, got {samples.shape}")
        for b, row in zip(self._bufs, samples):
            b.push(row)
        self.metrics.samples_in += samples.shape[-1]
        # A chunk is processable once its tail halo is also buffered.
        while len(self._bufs[0]) >= self.chunk_len + self.halo:
            ext = np.stack([b.peek(self.chunk_len + self.halo) for b in self._bufs])
            self._process(ext, total_segs=self.n_sp * self.segs_per_shard)
            for b in self._bufs:
                b.consume(self.chunk_len)
            self._consumed += self.chunk_len
            # Snapshot only after the buffer is trimmed, so a resume
            # replays nothing and skips nothing.
            if (
                self.checkpoint_path
                and self.checkpoint_every
                and self.metrics.chunks_done % self.checkpoint_every == 0
            ):
                self._snapshot()

    def _process(self, ext: np.ndarray, total_segs: int) -> None:
        """ext: (C, chunk_len + halo) — chunk plus its tail halo."""
        ext_dev = torch.from_numpy(ext).to(self.device)
        if self._acc_s is None:
            self._acc_s = torch.zeros(self.channels, self.lp, dtype=self._fdt, device=self.device)
            self._acc_c = torch.zeros_like(self._acc_s)
        p, _count = sharded_partial_step(
            ext_dev[..., : self.chunk_len], ext_dev[..., self.chunk_len:], self._w_pad,
            self.mesh, self.nfft, self.fft_len, self.stride, self.segs_per_shard, self.lp,
            total_segs, halo_impl=self._halo_impl,
        )
        self._acc_s, self._acc_c = _neumaier_add(self._acc_s, self._acc_c, p)
        # The masked count is deterministic (== total_segs): no readback.
        self._count += float(total_segs)
        self.metrics.chunks_done += 1
        self.metrics.segments_done += int(total_segs)

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """Flush the remainder and return (Pxx, freqs) as float64 numpy.

        The remainder is zero-padded to one chunk and its incomplete
        segments masked, so the final count equals the reference's
        (L-nfft)/stride+1 over the whole stream.
        """
        rem = np.stack([b.peek(len(b)) for b in self._bufs])
        if 0 < rem.shape[-1] < self.nfft and self._count == 0 and self.metrics.chunks_done == 0:
            # Whole stream shorter than nfft: the reference zero-pads to
            # one full segment (pwelch.go:97-99).
            rem = np.pad(rem, ((0, 0), (0, self.nfft - rem.shape[-1])))
        if rem.shape[-1] >= self.nfft:
            rem_segs = (rem.shape[-1] - self.nfft) // self.stride + 1
            padded = np.zeros((self.channels, self.chunk_len + self.halo), dtype=self._np_float)
            padded[:, : rem.shape[-1]] = rem
            self._process(padded, total_segs=rem_segs)
            for b in self._bufs:
                b.consume(len(b))
        acc = self._acc_read()  # waits for the device: wall_s covers the work
        if self._t_first is not None:
            self.metrics.wall_s = time.perf_counter() - self._t_first
        pxx = acc / (self._count * self._w_norm) if self._count else acc
        freqs = np.arange(self.lp) * (self.fs / self.pad)
        log.info("finalize: %s", self.metrics.json_line())
        if self.channels == 1:
            pxx = pxx[0]
        return pxx, freqs


def stream_pwelch(
    blocks: Iterable[np.ndarray],
    fs: float,
    options: Optional[PwelchOptions] = None,
    mesh=None,
    device=None,
    **kwargs,
) -> tuple[np.ndarray, np.ndarray]:
    """One-call streaming Pwelch over an iterable of sample blocks, sharded
    over mesh (or on `device` alone when mesh is None)."""
    sp = StreamingPwelch(fs, options, mesh, device=device, **kwargs)
    for b in blocks:
        sp.update(b)
    return sp.finalize()


def stream_welch(
    blocks: Iterable[np.ndarray],
    fs: float = 1.0,
    window="hann",
    nperseg: int = 256,
    noverlap: int | None = None,
    nfft: int | None = None,
    scaling: str = "density",
    mesh=None,
    **kwargs,
) -> tuple[np.ndarray, np.ndarray]:
    """Streaming Welch PSD with scipy.signal.welch conventions (periodic
    windows, nperseg/noverlap/nfft vocabulary, density or spectrum
    scaling, mean average, no detrend): returns (freqs, Pxx) as float64
    numpy after consuming an iterable of sample blocks through
    StreamingPwelch (the fused kernel once per chunk on CUDA).

    The nperseg-length PERIODIC window is zero-extended on demand, so
    the driver's pad-length-window slot reproduces scipy's
    window-then-zero-pad semantics for nfft > nperseg while the
    sum(w^2) normalization keeps the nperseg table — exactly scipy's
    scaling.  The reference's doubling stops short of the last bin; for
    odd nfft scipy doubles it too, and that bin is doubled here."""
    if scaling not in ("density", "spectrum"):
        raise ValueError("scaling must be 'density' or 'spectrum'")
    nperseg = int(nperseg)
    noverlap = nperseg // 2 if noverlap is None else int(noverlap)
    nfft = nperseg if nfft is None else int(nfft)
    if nfft < nperseg:
        raise ValueError("nfft must be >= nperseg")
    wt = _periodic_table_np(window, nperseg)

    def wf(L: int) -> np.ndarray:
        out = np.zeros(L)
        out[: min(L, nperseg)] = wt[: min(L, nperseg)]
        return out

    opts = PwelchOptions(nfft=nperseg, window=wf, pad=nfft, noverlap=noverlap)
    pxx, freqs = stream_pwelch(blocks, fs, opts, mesh, **kwargs)
    pxx = np.asarray(pxx).copy()
    if nfft % 2:  # scipy doubles every non-DC bin for odd lengths
        pxx[..., -1] *= 2.0
    if scaling == "spectrum":
        pxx *= float(fs) * float(np.sum(wt * wt)) / float(np.sum(wt)) ** 2
    return np.asarray(freqs), pxx
