"""ShortTimeFFT: scipy.signal's sliding-window STFT class.

Port of godsp_tpu/models/shorttime.py, a faithful core of
scipy.signal.ShortTimeFFT (the p-indexed sliding frames with
window-centred slices, canonical dual windows, four FFT modes, border
padding, magnitude/psd scaling) over the port's FFT core: the frame
gather, window multiply, batched FFT and overlap-add inverse are torch
on the signal's device (on the card the FFT and its inverse run K1/K2,
fft/core.py; this class runs the FFT, not the STFT kernel); the slice
geometry is host arithmetic.

Supported surface: from_window, stft, stft_detrend, spectrogram, istft,
dual_win/invertible, scale_to/fac_magnitude/fac_psd, the slice-geometry
properties (p_min/p_max/p_num/k_min/k_max, lower_border_end,
upper_border_begin, t, f, delta_t, delta_f, extent), and
closest_STFT_dual_window (per-residue-class affine projection onto the
valid-dual set, scipy parity).  Host input goes to default_device(); CUDA
float64 is cast to float32.
"""

from __future__ import annotations

import numpy as np
import torch

from godsp_tpu_torch._dtypes import as_complex_array, as_real_array, as_tensor
from godsp_tpu_torch.dsputils.utils import detrend as _detrend
from godsp_tpu_torch.fft.core import fft, ifft

__all__ = ["ShortTimeFFT", "closest_STFT_dual_window"]

_FFT_MODES = ("twosided", "centered", "onesided", "onesided2X")
_PAD_MODES = ("edge", "even", "odd", "zeros")


def _signal(x) -> torch.Tensor:
    """A real or complex tensor at the policy precision."""
    x = as_tensor(x)
    return as_complex_array(x) if x.dtype.is_complex else as_real_array(x)


def _pad(x: torch.Tensor, lo: int, hi: int, padding: str) -> torch.Tensor:
    """numpy.pad of the trailing axis: "zeros" (constant), "edge", "even"
    (reflect) and "odd" (reflect, reflect_type="odd"), with numpy's
    iterative reflection for pads longer than the signal."""
    if not (lo or hi):
        return x
    if padding == "zeros":
        return torch.nn.functional.pad(x, (lo, hi))
    n0 = x.shape[-1]
    if padding == "edge" or n0 == 1:
        return torch.cat([x[..., :1].expand(*x.shape[:-1], lo), x,
                          x[..., -1:].expand(*x.shape[:-1], hi)], dim=-1)
    while lo or hi:
        n = x.shape[-1]
        period = (n - 1) // (n0 - 1) * (n0 - 1)  # whole periods of the original
        a, b = min(lo, period), min(hi, period)
        left, right = x[..., 1 : a + 1].flip(-1), x[..., n - 1 - b : n - 1].flip(-1)
        if padding == "odd":
            left, right = 2 * x[..., :1] - left, 2 * x[..., -1:] - right
        x = torch.cat([left, x, right], dim=-1)
        lo, hi = lo - a, hi - b
    return x


def _frames(x: torch.Tensor, hop: int, m_num: int, p_num: int) -> torch.Tensor:
    """(..., p_num, m_num): the hop-strided slices of x."""
    return x.unfold(-1, m_num, hop)[..., :p_num, :]


def _phase(p_s, mfft: int, like: torch.Tensor):
    """The slices' spectral phase factor e^{2 pi i p_s k / mfft}, or None
    where phase_shift is None or the factor is 1."""
    if p_s is None:
        return None
    ph = np.exp(2j * np.pi * p_s * np.arange(mfft) / mfft)
    if np.allclose(ph, 1.0):
        return None
    return torch.from_numpy(ph).to(device=like.device, dtype=like.dtype)


def _twice(f_pts: int, mfft: int, psd_scaled: bool, like: torch.Tensor) -> torch.Tensor:
    """onesided2X's factors: sqrt(2) (psd) or 2 on every bin but DC and
    Nyquist."""
    fac = np.ones(f_pts)
    hi = f_pts - 1 if mfft % 2 == 0 else f_pts
    fac[1:hi] = np.sqrt(2) if psd_scaled else 2.0
    return torch.from_numpy(fac).to(device=like.device, dtype=like.real.dtype)


def _spectra(frames: torch.Tensor, win: torch.Tensor, mfft: int, fft_mode: str, f_pts: int,
             p_s, psd_scaled: bool) -> torch.Tensor:
    """Window, zero-pad to mfft, FFT, phase factor and fft-mode shaping of
    (..., p, m_num) frames: (..., f, p)."""
    frames = frames * win
    if mfft > frames.shape[-1]:
        frames = torch.nn.functional.pad(frames, (0, mfft - frames.shape[-1]))
    S = fft(frames)
    ph = _phase(p_s, mfft, S)
    if ph is not None:
        S = S * ph
    if fft_mode == "centered":
        S = torch.roll(S, mfft // 2, dims=-1)
    elif fft_mode in ("onesided", "onesided2X"):
        S = S[..., :f_pts]
        if fft_mode == "onesided2X":
            S = S * _twice(f_pts, mfft, psd_scaled, S)
    return S.transpose(-1, -2)


class ShortTimeFFT:
    """scipy.signal.ShortTimeFFT-compatible sliding STFT (see module
    docstring; scipy conventions: slice p covers samples
    p*hop - m_num_mid + [0, m_num))."""

    def __init__(self, win, hop: int, fs: float, *, fft_mode: str = "onesided",
                 mfft: int | None = None, dual_win=None, scale_to=None,
                 phase_shift: int | None = 0):
        win = np.asarray(win)
        if win.ndim != 1 or win.size == 0 or not np.all(np.isfinite(win)):
            raise ValueError("win must be a finite 1-D array")
        if not (isinstance(hop, (int, np.integer)) and hop >= 1):
            raise ValueError("hop must be a positive integer")
        self._win = win.astype(np.float64)
        self._hop = int(hop)
        self._fs = float(fs)
        self._mfft = len(win) if mfft is None else int(mfft)
        if self._mfft < len(win):
            raise ValueError("mfft must be at least the window length")
        if fft_mode not in _FFT_MODES:
            raise ValueError(f"fft_mode must be one of {_FFT_MODES}")
        if fft_mode in ("onesided", "onesided2X") and np.iscomplexobj(win):
            raise ValueError("onesided modes need a real window")
        self._fft_mode = fft_mode
        self._dual_win = None if dual_win is None else np.asarray(
            dual_win, np.float64)
        if self._dual_win is not None and self._dual_win.shape != win.shape:
            raise ValueError("dual_win must have the window's shape")
        self._scaling = None
        if phase_shift is not None and not (
            -self._mfft < int(phase_shift) < self._mfft
        ):
            raise ValueError("phase_shift must be None or within (-mfft, mfft)")
        self._phase_shift = None if phase_shift is None else int(phase_shift)
        if scale_to is not None:
            self.scale_to(scale_to)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_window(cls, win_param, fs: float, nperseg: int, noverlap: int,
                    *, symmetric_win: bool = False, fft_mode: str = "onesided",
                    mfft: int | None = None, scale_to=None,
                    phase_shift: int | None = 0):
        """Build from a get_window spec + (nperseg, noverlap) like the
        legacy stft API (scipy.signal.ShortTimeFFT.from_window)."""
        from godsp_tpu_torch.window.extended import get_window

        if not 0 <= noverlap < nperseg:
            raise ValueError("need 0 <= noverlap < nperseg")
        win = get_window(win_param, nperseg, fftbins=not symmetric_win)
        return cls(win, nperseg - int(noverlap), fs, fft_mode=fft_mode,
                   mfft=mfft, scale_to=scale_to, phase_shift=phase_shift)

    # -- basic properties --------------------------------------------------
    @property
    def win(self) -> np.ndarray:
        return self._win

    @property
    def hop(self) -> int:
        return self._hop

    @property
    def fs(self) -> float:
        return self._fs

    @property
    def T(self) -> float:
        return 1.0 / self._fs

    @property
    def fft_mode(self) -> str:
        return self._fft_mode

    @fft_mode.setter
    def fft_mode(self, mode: str):
        if mode not in _FFT_MODES:
            raise ValueError(f"fft_mode must be one of {_FFT_MODES}")
        if mode == "onesided2X" and self._scaling is None:
            raise ValueError("onesided2X needs a scaled instance "
                             "(call scale_to first)")
        self._fft_mode = mode

    @property
    def mfft(self) -> int:
        return self._mfft

    @property
    def scaling(self):
        return self._scaling

    @property
    def phase_shift(self):
        return self._phase_shift

    @property
    def m_num(self) -> int:
        return len(self._win)

    @property
    def m_num_mid(self) -> int:
        return self.m_num // 2

    # -- slice geometry ----------------------------------------------------
    # scipy convention: geometry is defined by the NONZERO support of
    # the window (a hann window's zero first sample does not count as
    # overlap), hence the w^2-masked scans below.

    @property
    def _w2(self) -> np.ndarray:
        return self._win.real**2 + self._win.imag**2

    @property
    def _pre_padding(self) -> tuple[int, int]:
        """(k_min, p_min): shift the window left by hops until no
        nonzero sample overlaps t >= 0."""
        w2 = self._w2
        n0 = -self.m_num_mid
        for p_, n_ in enumerate(range(n0, n0 - self.m_num - 1, -self._hop)):
            n_next = n_ - self._hop
            if n_next + self.m_num <= 0 or not np.any(w2[n_next:]):
                return n_, -p_
        raise RuntimeError("unreachable: window has no nonzero samples")

    @property
    def p_min(self) -> int:
        return self._pre_padding[1]

    @property
    def k_min(self) -> int:
        return self._pre_padding[0]

    def _post_padding(self, n: int) -> tuple[int, int]:
        """(k_max, p_max): shift right until no nonzero window sample
        overlaps t < t[n]."""
        if n < self.m_num - self.m_num_mid:
            raise ValueError("n must be >= ceil(m_num/2)")
        w2 = self._w2
        q1 = n // self._hop
        k1 = q1 * self._hop - self.m_num_mid
        for q_, k_ in enumerate(range(k1, n + self.m_num, self._hop),
                                start=q1):
            n_next = k_ + self._hop
            if n_next >= n or not np.any(w2[: n - n_next]):
                return k_ + self.m_num, q_ + 1
        raise RuntimeError("unreachable: window has no nonzero samples")

    def p_max(self, n: int) -> int:
        return self._post_padding(n)[1]

    def k_max(self, n: int) -> int:
        return self._post_padding(n)[0]

    def p_num(self, n: int) -> int:
        return self.p_max(n) - self.p_min

    @property
    def lower_border_end(self) -> tuple[int, int]:
        """(end sample, slice index) where pre-padding effects end: the
        first slice whose nonzero support starts inside the signal."""
        m0 = int(np.flatnonzero(self._w2)[0])
        k0 = -self.m_num_mid + m0
        for q_, k_ in enumerate(range(k0, self._hop + 1, self._hop)):
            if k_ + self._hop >= 0:
                return k_ + self.m_num, q_ + 1
        return 0, max(self.p_min, 0)

    def upper_border_begin(self, n: int) -> tuple[int, int]:
        """(start sample, slice index) where post-padding effects begin:
        the first slice whose nonzero support reaches past the end."""
        if n < self.m_num - self.m_num_mid:
            raise ValueError("n must be >= ceil(m_num/2)")
        w2 = self._w2
        q2 = n // self._hop + 1
        q1 = max((n - self.m_num) // self._hop - 1, -1)
        for q_ in range(q2, q1, -1):
            k_ = q_ * self._hop + (self.m_num - self.m_num_mid)
            if k_ <= n or not np.any(w2[n - k_ :]):
                return (q_ + 1) * self._hop - self.m_num_mid, q_ + 1
        raise RuntimeError("unreachable: window has no nonzero samples")

    @property
    def delta_t(self) -> float:
        return self._hop * self.T

    @property
    def delta_f(self) -> float:
        return self._fs / self._mfft

    @property
    def f_pts(self) -> int:
        if self.onesided_fft:
            return self._mfft // 2 + 1
        return self._mfft

    @property
    def onesided_fft(self) -> bool:
        return self._fft_mode in ("onesided", "onesided2X")

    @property
    def f(self) -> np.ndarray:
        if self.onesided_fft:
            return np.arange(self.f_pts) * self.delta_f
        freqs = np.fft.fftfreq(self._mfft, self.T)
        return np.fft.fftshift(freqs) if self._fft_mode == "centered" else freqs

    def t(self, n: int, p0: int | None = None, p1: int | None = None,
          k_offset: int = 0) -> np.ndarray:
        p0 = self.p_min if p0 is None else p0
        p1 = self.p_max(n) if p1 is None else p1
        return (np.arange(p0, p1) * self._hop + k_offset) * self.T

    def extent(self, n: int, axes_seq: str = "tf", center_bins: bool = False):
        """Axis limits (t0, t1, f0, f1) for imshow-style plots."""
        if axes_seq not in ("tf", "ft"):
            raise ValueError("axes_seq must be 'tf' or 'ft'")
        p0, p1 = self.p_min, self.p_max(n)
        if center_bins:
            t0, t1 = ((p0 - 0.5) * self.delta_t, (p1 - 0.5) * self.delta_t)
        else:
            t0, t1 = p0 * self.delta_t, p1 * self.delta_t
        if self.onesided_fft:
            f0, f1 = 0.0, self.f_pts * self.delta_f
        else:
            f0 = -self._mfft / 2 * self.delta_f if self._fft_mode == "centered" else 0.0
            f1 = f0 + self._mfft * self.delta_f
        if center_bins:
            f0, f1 = f0 - self.delta_f / 2, f1 - self.delta_f / 2
        return (t0, t1, f0, f1) if axes_seq == "tf" else (f0, f1, t0, t1)

    # -- scaling -----------------------------------------------------------
    @property
    def fac_magnitude(self) -> float:
        return 1.0 / abs(self._win.sum())

    @property
    def fac_psd(self) -> float:
        return 1.0 / np.sqrt(self._fs * np.sum(self._win**2))

    def scale_to(self, scaling: str):
        """Rescale the window (and dual) so stft magnitudes ('magnitude')
        or |.|^2 ('psd') are physically calibrated."""
        if scaling not in ("magnitude", "psd"):
            raise ValueError("scaling must be 'magnitude' or 'psd'")
        if self._scaling == scaling:
            return
        fac = self.fac_magnitude if scaling == "magnitude" else self.fac_psd
        self._win = self._win * fac
        if self._dual_win is not None:
            self._dual_win = self._dual_win / fac
        self._scaling = scaling

    # -- dual window / invertibility --------------------------------------
    @property
    def dual_win(self) -> np.ndarray:
        if self._dual_win is None:
            w = self._win
            m = self.m_num
            if self._hop > m:
                raise ValueError("hop > window length leaves unobserved "
                                 "samples — STFT not invertible")
            dd = np.zeros(m)
            for j in range(-(m // self._hop) - 1, m // self._hop + 2):
                sh = j * self._hop
                lo, hi = max(0, sh), min(m, m + sh)
                if lo < hi:
                    dd[lo:hi] += np.abs(w[lo - sh : hi - sh]) ** 2
            if np.any(dd <= 0):
                raise ValueError("window/hop has gaps — STFT not invertible")
            self._dual_win = w / dd
        return self._dual_win

    @property
    def invertible(self) -> bool:
        try:
            self.dual_win
            return True
        except ValueError:
            return False

    # -- transforms --------------------------------------------------------
    def _phase_factor(self, p0: int, p_num: int) -> np.ndarray | None:
        """Per-slice spectral phase factor implementing phase_shift:
        the FFT is taken of the slice rolled so sample k = p*hop lands
        at index phase_shift (scipy's convention)."""
        if self._phase_shift is None:
            return None
        mfft = self._mfft
        # scipy rolls the zero-padded slice left by p_s; in frequency
        # that is a factor e^{+2j pi p_s k / mfft}
        p_s = (self._phase_shift + self.m_num_mid) % self.m_num
        k = np.arange(mfft)
        return np.exp(2j * np.pi * p_s * k / mfft)

    def _slice_geometry(self, n: int, p0, p1, k_offset: int):
        p0 = self.p_min if p0 is None else p0
        p1 = self.p_max(n) if p1 is None else p1
        k0 = p0 * self._hop - self.m_num_mid + k_offset
        k1 = (p1 - 1) * self._hop - self.m_num_mid + self.m_num + k_offset
        return p0, p1, k0, k1

    def _p_s(self):
        return (None if self._phase_shift is None
                else (self._phase_shift + self.m_num_mid) % self.m_num)

    def _prepare(self, x, padding: str, axis: int):
        """(x as a tensor with the signal axis last, that axis), after the
        checks of padding and of a complex signal in a onesided mode."""
        if padding not in _PAD_MODES:
            raise ValueError(f"padding must be one of {sorted(_PAD_MODES)}")
        x = _signal(x)
        if self.onesided_fft and x.dtype.is_complex:
            raise ValueError("onesided fft_mode requires a real signal "
                             "(use 'twosided' or 'centered')")
        ax = axis % x.dim()
        x = x.movedim(axis, -1)
        return x, ax

    def stft(self, x, p0: int | None = None, p1: int | None = None, *,
             k_offset: int = 0, padding: str = "zeros", axis: int = -1):
        """Sliding STFT of x (scipy.signal.ShortTimeFFT.stft): slices
        p0..p1-1, border handling per `padding`
        ('zeros'/'edge'/'even'/'odd')."""
        x, ax = self._prepare(x, padding, axis)
        n = x.shape[-1]
        if n < max(self.m_num, self._hop):
            raise ValueError("signal too short for one slice")
        p0, p1, k0, k1 = self._slice_geometry(n, p0, p1, k_offset)
        if not p0 < p1:
            raise ValueError("need p0 < p1")
        pad_lo, pad_hi = max(0, -k0), max(0, k1 - n)
        start = k0 + pad_lo
        xs = _pad(x, pad_lo, pad_hi, padding)[..., start : start + (k1 - k0)]
        win = torch.from_numpy(self._win).to(device=x.device, dtype=x.real.dtype)
        S = _spectra(_frames(xs, self._hop, self.m_num, p1 - p0), win, self._mfft,
                     self._fft_mode, self.f_pts, self._p_s(), self._scaling == "psd")
        # scipy layout: f takes the signal axis's position, p goes last
        return S.movedim(-2, ax) if S.dim() > 2 else S

    def stft_detrend(self, x, detr, p0=None, p1=None, *, k_offset: int = 0,
                     padding: str = "zeros", axis: int = -1):
        """STFT with per-slice detrending: detr is 'constant'/'linear' or a
        callable applied along the last axis of each slice."""
        x, ax = self._prepare(x, padding, axis)
        n = x.shape[-1]
        p0, p1, k0, k1 = self._slice_geometry(n, p0, p1, k_offset)
        # frame first (same geometry), detrend each slice, then window + FFT
        pad_lo, pad_hi = max(0, -k0), max(0, k1 - n)
        start = k0 + pad_lo
        xs = _pad(x, pad_lo, pad_hi, padding)[..., start : start + (k1 - k0)]
        frames = _frames(xs, self._hop, self.m_num, p1 - p0)
        if callable(detr):
            frames = detr(frames)
        elif detr in ("constant", "linear"):
            frames = _detrend(frames, type=detr)
        else:
            raise ValueError("detr must be 'constant', 'linear', or callable")
        win = torch.from_numpy(self._win).to(device=frames.device, dtype=frames.real.dtype)
        S = _spectra(frames, win, self._mfft, self._fft_mode, self.f_pts, self._p_s(),
                     self._scaling == "psd")
        return S.movedim(-2, ax) if S.dim() > 2 else S

    def spectrogram(self, x, detr=None, **kw):
        """|STFT|^2 (scipy.signal.ShortTimeFFT.spectrogram)."""
        S = self.stft(x, **kw) if detr is None else self.stft_detrend(x, detr, **kw)
        return S.real**2 + S.imag**2

    def istft(self, S, k0: int = 0, k1: int | None = None, *,
              f_axis: int = -2, t_axis: int = -1):
        """Inverse STFT by canonical-dual overlap-add
        (scipy.signal.ShortTimeFFT.istft): reconstructs samples [k0, k1)
        assuming S covers the slices from p_min on.  The onesided modes
        give a real signal; twosided and centered stay complex, as in
        scipy."""
        S = as_complex_array(S).movedim((f_axis, t_axis), (-2, -1))
        if S.shape[-2] != self.f_pts:
            raise ValueError(f"S must have {self.f_pts} frequency rows")
        p_num = S.shape[-1]
        q_num = (p_num - 1) * self._hop + self.m_num
        if k1 is None:
            k1 = self.k_min + q_num - (self.m_num - self.m_num_mid - 1) - 1
            k1 = max(k1, k0 + 1)
        lo, hi = k0 - self.k_min, k1 - self.k_min
        if lo < 0 or hi > q_num:
            raise ValueError("requested sample range exceeds the slices in S")
        mfft = self._mfft
        S = S.transpose(-1, -2)  # (..., p, f)
        if self._fft_mode == "centered":
            S = torch.roll(S, -(mfft // 2), dims=-1)
        elif self.onesided_fft:
            if self._fft_mode == "onesided2X":
                S = S / _twice(self.f_pts, mfft, self._scaling == "psd", S)
            S = torch.cat([S, torch.conj(S[..., 1 : (mfft + 1) // 2].flip(-1))], dim=-1)
        ph = _phase(self._p_s(), mfft, S)
        if ph is not None:
            S = S / ph
        segs = ifft(S)[..., : self.m_num]
        if self.onesided_fft:
            segs = segs.real
        dual = torch.from_numpy(self.dual_win).to(device=segs.device, dtype=segs.real.dtype)
        vals = segs * dual
        idx = (torch.arange(p_num, device=vals.device)[:, None] * self._hop
               + torch.arange(self.m_num, device=vals.device)[None, :]).reshape(-1)
        out = torch.zeros(*vals.shape[:-2], q_num, dtype=vals.dtype, device=vals.device)
        out.index_add_(-1, idx, vals.reshape(*vals.shape[:-2], -1))
        return out[..., lo:hi]


def closest_STFT_dual_window(win, hop: int, desired_dual=None, *,
                             scaled: bool = True):
    """The valid STFT dual window closest to `desired_dual`
    (scipy.signal.closest_STFT_dual_window): duals of (win, hop) form
    an affine set — one biorthogonality constraint
    sum_j win[m+j*hop] conj(d[m+j*hop]) = 1 per residue class m — so
    the closest point is a per-class orthogonal projection.  With
    scaled=True the returned pair is (d, alpha) minimizing
    ||d - alpha*desired_dual|| jointly over valid d and the scalar."""
    w = np.atleast_1d(np.asarray(win))
    n = w.shape[0]
    hop = int(hop)
    if w.ndim != 1 or n == 0:
        raise ValueError("win must be a nonempty 1-D array")
    if not 1 <= hop <= n:
        raise ValueError("hop must lie in [1, len(win)]")
    d_des = (np.ones(n) if desired_dual is None
             else np.atleast_1d(np.asarray(desired_dual)))
    if d_des.shape != w.shape:
        raise ValueError("desired_dual must have the window's shape")
    cplx = np.iscomplexobj(w) or np.iscomplexobj(d_des)
    dt = complex if cplx else float
    w = w.astype(dt)
    d_des = d_des.astype(dt)
    q = np.zeros(hop, dt)
    nrm = np.zeros(hop)
    for m in range(hop):
        q[m] = np.dot(w[m::hop], np.conj(d_des[m::hop]))
        nrm[m] = np.real(np.dot(w[m::hop], np.conj(w[m::hop])))
    if np.any(nrm == 0):
        raise ValueError("window/hop leaves an all-zero residue class "
                         "(gap) — no dual exists")
    if scaled:
        alpha = np.sum(q / nrm) / np.sum(np.abs(q) ** 2 / nrm)
        alpha = complex(alpha) if cplx else float(np.real(alpha))
    else:
        alpha = 1.0
    d = alpha * d_des
    # the alpha*d_des term contributes conj(alpha)*q[m] to the class
    # constraint sum w conj(d); the projection must close the remainder
    for m in range(hop):
        d[m::hop] = d[m::hop] + w[m::hop] * (
            np.conj(1.0 - np.conj(alpha) * q[m]) / nrm[m])
    return d, alpha
