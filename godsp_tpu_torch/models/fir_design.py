"""Optimal FIR design: least-squares (firls), equiripple Parks-McClellan
(remez), and minimum-phase conversion.

Like models.design, all of this is trace-time host float64 — it produces
tap constants for the device-side FFT-convolution filters (models.filter
fir_filter/fftconvolve/overlap_save and models.resample upfirdn).  The
reference library has no FIR design surface (go-dsp consumes windows
only, window.go:25-152); scipy.signal is the cross-oracle.

Both designers are implemented from the textbook formulations, not
ported: firls solves the closed-form normal equations (Toeplitz+Hankel
Gram matrix of band-limited cosine inner products), and remez runs the
barycentric multiple-exchange on the classic Parks-McClellan dense grid.
remez's tap values can differ from scipy's in the 5th decimal (the
dense-grid quantization is not bit-identical) while its equiripple
level on the continuum measures equal or slightly better — see
tests/test_fir_design.py's ripple-ratio assertions.
"""

from __future__ import annotations

import numpy as np

__all__ = ["firls", "firwin_2d", "minimum_phase", "remez"]


def firls(numtaps: int, bands, desired, weight=None, fs: float = 2.0) -> np.ndarray:
    """Least-squares linear-phase FIR (scipy.signal.firls semantics):
    minimize the weighted integrated squared error of the amplitude
    A(f) = a0 + sum a_k cos(pi k f) against the piecewise-linear desired
    response over the listed bands.  numtaps must be odd (type I).

    The Gram matrix of {cos(pi k f)} over a union of bands is
    0.5*(Toeplitz + Hankel) of q[n] = sum_b w_b I_b(n) with
    I_b(n) = [sin(pi n f)/(pi n)]_{f1}^{f2}; the right-hand side uses
    the closed forms of int f cos(pi k f) df — all exact, so the solve
    is a single (M+1)x(M+1) dense system.
    """
    numtaps = int(numtaps)
    if numtaps % 2 == 0 or numtaps < 1:
        raise ValueError("numtaps must be odd and >= 1")
    bands = np.asarray(bands, np.float64).reshape(-1, 2) * (2.0 / float(fs))
    desired = np.asarray(desired, np.float64).reshape(-1, 2)
    if len(desired) != len(bands):
        raise ValueError("desired must give one value per band edge")
    if np.any(bands < 0) or np.any(bands > 1) or np.any(np.diff(bands.ravel()) < 0):
        raise ValueError("bands must be non-decreasing within [0, fs/2]")
    if weight is None:
        weight = np.ones(len(bands))
    weight = np.asarray(weight, np.float64)
    if weight.shape != (len(bands),):
        raise ValueError("weight must give one value per band")
    M = (numtaps - 1) // 2

    f = bands[None, :, :]  # (1, nbands, 2)
    n = np.arange(2 * M + 1, dtype=np.float64)[:, None, None]
    with np.errstate(invalid="ignore", divide="ignore"):
        nn = np.where(n == 0, 1.0, n)
        I = np.where(n == 0, f, np.sin(np.pi * n * f) / (np.pi * nn))
    q = np.sum(weight[None, :] * (I[:, :, 1] - I[:, :, 0]), axis=1)
    i, j = np.indices((M + 1, M + 1))
    Q = 0.5 * (q[np.abs(i - j)] + q[i + j])

    k = np.arange(M + 1, dtype=np.float64)[:, None, None]
    m = (desired[:, 1] - desired[:, 0]) / (bands[:, 1] - bands[:, 0])
    c0 = desired[:, 0] - m * bands[:, 0]
    with np.errstate(invalid="ignore", divide="ignore"):
        kk = np.where(k == 0, 1.0, k)
        Jf = np.where(
            k == 0,
            f * f / 2.0,
            f * np.sin(np.pi * k * f) / (np.pi * kk)
            + np.cos(np.pi * k * f) / (np.pi * kk) ** 2,
        )
        J1 = np.where(k == 0, f, np.sin(np.pi * k * f) / (np.pi * kk))
    integ = (m[None, :] * (Jf[:, :, 1] - Jf[:, :, 0])
             + c0[None, :] * (J1[:, :, 1] - J1[:, :, 0]))
    c = np.sum(weight[None, :] * integ, axis=1)

    a = np.linalg.solve(Q, c)
    return np.concatenate([a[:0:-1] / 2.0, [a[0]], a[1:] / 2.0])


def _pm_exchange(grid, D, W, r: int, band_id, maxiter: int):
    """Remez multiple-exchange: the best weighted-Chebyshev fit of an
    (r-1)-degree polynomial in x = cos(pi f) to D on the dense grid.

    Candidates each round are the per-band local maxima of |E| plus
    every band edge (the classic Parks-McClellan rule; filtering by the
    current delta instead can strand the exchange at a false
    equilibrium).  |delta| is non-decreasing across exchanges, so a
    stalled |delta| with max|E| == |delta| is convergence — this also
    terminates the period-2 limit cycle a degenerate problem with r+2
    equal-height extremals produces (e.g. odd-length Hilbert on a
    symmetric band).  Returns a consistent (extremal indices, delta).
    """
    ngrid = len(grid)
    x = np.cos(np.pi * grid)
    ext = np.round(np.linspace(0, ngrid - 1, r + 1)).astype(int)
    edges = np.flatnonzero(np.diff(band_id) != 0)
    edge_idx = np.unique(np.concatenate([[0], edges, edges + 1, [ngrid - 1]]))
    sgn = (-1.0) ** np.arange(r + 1)

    def solve(ext):
        xe = x[ext]
        diff = xe[:, None] - xe[None, :]
        np.fill_diagonal(diff, 1.0)
        gamma = 1.0 / np.prod(diff, axis=1)
        delta = np.sum(gamma * D[ext]) / np.sum(gamma * sgn / W[ext])
        return gamma, delta

    last_delta = 0.0
    for _ in range(maxiter):
        gamma, delta = solve(ext)
        stalled = abs(delta) <= abs(last_delta) * (1.0 + 1e-12)
        last_delta = delta
        ce = D[ext] - sgn * delta / W[ext]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = gamma[None, :] / (x[:, None] - x[ext][None, :])
            A = (t @ ce) / np.sum(t, axis=1)
        A[ext] = ce
        E = (D - A) * W
        absE = np.abs(E)
        if stalled and absE.max() - abs(delta) <= 1e-9 * max(abs(delta), 1e-30):
            break
        left = np.empty(ngrid)
        right = np.empty(ngrid)
        left[1:] = absE[:-1]
        left[0] = -1.0
        right[:-1] = absE[1:]
        right[-1] = -1.0
        left[edges + 1] = -1.0  # don't compare across band boundaries
        right[edges] = -1.0
        cand = np.flatnonzero((absE >= left) & (absE >= right))
        cand = np.unique(np.concatenate([cand, edge_idx]))
        keep = []
        for i in cand:  # alternation: largest |E| per same-sign run
            if keep and (E[i] >= 0) == (E[keep[-1]] >= 0):
                if absE[i] > absE[keep[-1]]:
                    keep[-1] = i
            else:
                keep.append(i)
        while len(keep) > r + 1:  # drop the smaller-|E| endpoint
            if absE[keep[0]] < absE[keep[-1]]:
                keep.pop(0)
            else:
                keep.pop()
        if len(keep) < r + 1:
            break  # defective problem; keep the current extremals
        new_ext = np.asarray(keep)
        if np.array_equal(new_ext, ext):
            break
        ext = new_ext
    _, delta = solve(ext)  # returned pair must be consistent
    return ext, delta


def remez(numtaps: int, bands, desired, weight=None, type: str = "bandpass",
          fs: float = 1.0, grid_density: int = 16,
          maxiter: int = 250) -> np.ndarray:
    """Parks-McClellan equiripple FIR design (scipy.signal.remez
    semantics; bands in Hz against fs, desired one value per band).

    type: 'bandpass' (symmetric, types I/II), 'differentiator'
    (antisymmetric, amplitude desired*f with 1/f relative-error
    weighting), or 'hilbert' (antisymmetric flat).  The four linear-
    phase types reduce to one cosine-polynomial Chebyshev problem via
    the standard trig prefactor q(f) in {1, cos(pi f/2), sin(pi f),
    sin(pi f/2)}: fit G = D/q with weight W*q, then resample
    A = q*G at the numtaps DFT bins and inverse-transform.
    """
    numtaps = int(numtaps)
    if numtaps < 3:
        raise ValueError("numtaps must be >= 3")
    bands = np.asarray(bands, np.float64).reshape(-1, 2) / float(fs) * 2.0
    desired = np.asarray(desired, np.float64)
    nb = len(bands)
    if desired.shape != (nb,):
        raise ValueError("desired must give one value per band")
    if np.any(bands < 0) or np.any(bands > 1) or np.any(np.diff(bands.ravel()) < 0):
        raise ValueError("bands must be non-decreasing within [0, fs/2]")
    if weight is None:
        weight = np.ones(nb)
    weight = np.asarray(weight, np.float64)
    if weight.shape != (nb,):
        raise ValueError("weight must give one value per band")
    odd = numtaps % 2 == 1
    if type == "bandpass":
        neg = False
    elif type in ("differentiator", "hilbert"):
        neg = True
    else:
        raise ValueError("type must be 'bandpass', 'differentiator', or 'hilbert'")
    r = numtaps // 2
    if odd and not neg:
        r += 1

    # classic dense grid: fixed step, last point snapped to the band edge
    delf = 0.5 / (grid_density * r)
    gl, bl = [], []
    for i, (f1, f2) in enumerate(bands):
        pts = f1 + delf * np.arange(max(int(np.floor((f2 - f1) / delf)) + 1, 1))
        pts[-1] = f2
        gl.append(pts)
        bl.append(np.full(len(pts), i))
    grid = np.concatenate(gl)
    band_id = np.concatenate(bl)
    D = desired[band_id].astype(np.float64)
    Wg = weight[band_id].astype(np.float64)
    if type == "differentiator":
        D = D * grid / 2.0 * float(fs)
        big = desired[band_id] > 1e-4
        Wg = np.where(big, Wg / np.maximum(D, 1e-30), Wg)
    if not neg:
        q = np.ones(len(grid)) if odd else np.cos(np.pi * grid / 2.0)
    else:
        q = np.sin(np.pi * grid) if odd else np.sin(np.pi * grid / 2.0)
    good = q > 1e-9  # drop points where the type's amplitude must vanish
    grid_w, bw_id = grid[good], band_id[good]
    Dw, Ww = D[good] / q[good], Wg[good] * q[good]
    if len(grid_w) <= r + 1:
        raise ValueError("grid too small for the requested order; "
                         "widen the bands or lower numtaps")
    ext, delta = _pm_exchange(grid_w, Dw, Ww, r, bw_id, maxiter)

    # resample the barycentric optimum at the numtaps DFT bins
    xe = np.cos(np.pi * grid_w[ext])
    diffm = xe[:, None] - xe[None, :]
    np.fill_diagonal(diffm, 1.0)
    gamma = 1.0 / np.prod(diffm, axis=1)
    sgn = (-1.0) ** np.arange(r + 1)
    ce = Dw[ext] - sgn * delta / Ww[ext]
    fj = np.arange(numtaps) / numtaps * 2.0
    xq = np.cos(np.pi * np.where(fj > 1.0, 2.0 - fj, fj))
    with np.errstate(divide="ignore", invalid="ignore"):
        t = gamma[None, :] / (xq[:, None] - xe[None, :])
        G = (t @ ce) / np.sum(t, axis=1)
    for k in range(r + 1):  # exact values at interpolation-node hits
        hit = np.isclose(xq, xe[k], rtol=0.0, atol=1e-13)
        G[hit] = ce[k]
    # the trig prefactor is evaluated UNFOLDED so its sign past Nyquist
    # is correct (cos(pi f/2) is negative on (1,2); cos(pi f) folds evenly)
    shift = np.exp(-1j * np.pi * fj * (numtaps - 1) / 2.0)
    if not neg:
        qf = np.ones(numtaps) if odd else np.cos(np.pi * fj / 2.0)
        Hf = qf * G * shift
    else:
        qf = np.sin(np.pi * fj) if odd else np.sin(np.pi * fj / 2.0)
        Hf = qf * G * 1j * shift
    return np.fft.ifft(Hf).real


def minimum_phase(h, n_fft: int | None = None, half: bool = True) -> np.ndarray:
    """Minimum-phase reconstruction by the homomorphic (real-cepstrum)
    method (scipy.signal.minimum_phase): log-magnitude -> cepstrum ->
    causal fold -> exp.  half=True (default) halves the log-magnitude so
    the result approximates the square root of the original magnitude
    response with (len(h)+1)//2 taps; half=False keeps the full
    magnitude and length.  Accuracy is bounded by the log-spectrum
    regularization (~1e-7 of the peak), matching scipy to that level.
    """
    h = np.asarray(h, np.float64)
    n = len(h)
    if h.ndim != 1 or n < 2:
        raise ValueError("h must be a 1-D filter with at least 2 taps")
    if n_fft is None:
        n_fft = 2 ** int(np.ceil(np.log2(2 * (n - 1) / 0.01)))
    n_fft = int(n_fft)
    if n_fft < n:
        raise ValueError("n_fft must be at least len(h)")
    H = np.abs(np.fft.fft(h, n_fft))
    H += 1e-7 * H[H > 0].min()  # keep the log finite at true zeros
    log_h = np.log(H)
    if half:
        log_h *= 0.5
    cep = np.fft.ifft(log_h).real
    # minimum-phase (causal-cepstrum) fold: double positive quefrencies,
    # keep the origin, and for odd n_fft keep the middle sample once
    # (even n_fft zeroes it — Oppenheim & Schafer eq. 13.42b)
    win = np.zeros(n_fft)
    win[0] = 1.0
    stop = n_fft // 2
    win[1:stop] = 2.0
    if n_fft % 2:
        win[stop] = 1.0
    h_min = np.fft.ifft(np.exp(np.fft.fft(cep * win))).real
    n_out = (n // 2) + (n % 2) if half else n
    return h_min[:n_out]


def firwin_2d(hsize, window, *, fc=None, fs: float = 2.0,
              circular: bool = False) -> np.ndarray:
    """2-D window-method FIR design (scipy.signal.firwin_2d):
    separable (outer product of two 1-D firwin designs, window a
    2-tuple of specs) or circularly symmetric (radial linear
    interpolation of an 8x-oversampled 1-D design)."""
    from godsp_tpu_torch.models._resample_impl import firwin

    if len(hsize) != 2:
        raise ValueError("hsize must be a 2-element tuple or list")
    if fc is None:
        raise ValueError("fc must be provided")
    fc_n = 2.0 * float(fc) / float(fs)
    if circular:
        n_r = max(int(hsize[0]), int(hsize[1])) * 8
        win_r = firwin(n_r, fc_n, window=window)
        f1, f2 = np.meshgrid(np.linspace(-1, 1, int(hsize[0])),
                             np.linspace(-1, 1, int(hsize[1])))
        r = np.sqrt(f1 * f1 + f2 * f2)
        return np.interp(r, np.linspace(0, 1, n_r), win_r)
    if len(window) != 2:
        raise ValueError("window must be a 2-element tuple or list")
    row = firwin(int(hsize[0]), fc_n, window=window[0])
    col = firwin(int(hsize[1]), fc_n, window=window[1])
    return np.outer(row, col)
