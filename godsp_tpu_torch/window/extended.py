"""Extended window family (scipy.signal.windows surface) + get_window.

Port of godsp_tpu/window/extended.py: host float64 numpy, the same
formulas and names; the core tables come from godsp_tpu_torch.window.

The reference ships six tapers (window/window.go:25-152, in
godsp_tpu_torch.window); production spectral analysis expects the full scipy
catalogue and the `get_window` name/tuple dispatcher that pwelch-style
estimators consume.  API surface and conventions (names, parameters,
the periodic/symmetric `sym` flag, normalization choices) follow
scipy.signal.windows so tables are drop-in interchangeable — verified
against scipy in tests/test_window_extended.py — but every generator
here is written from the window's defining formula: Tukey from the
edge-distance closed form, Dolph-Chebyshev from its frequency-domain
definition via one centered inverse-DFT cosine sum (no parity-split FFT
tricks), Taylor from the F_m product coefficients computed as one
vectorized Vandermonde-style table, DPSS from the symmetric tridiagonal
commuting eigenproblem.  All tables are host float64; a caller moves a
table to the device and dtype it computes in.

`sym=True` returns symmetric (filter-design) windows; `sym=False` the
DFT-periodic form (the M+1-point symmetric window minus its last
sample), scipy's `fftbins` convention — implemented once in
`_sym_window` below.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = [
    "barthann",
    "bohman",
    "chebwin",
    "cosine",
    "dpss",
    "exponential",
    "gaussian",
    "general_gaussian",
    "get_window",
    "lanczos",
    "parzen",
    "taylor",
    "triang",
    "tukey",
]


def _sym_window(M: int, sym: bool, build) -> np.ndarray:
    """Shared scaffolding for every generator in this module.

    Validates the length, returns ones for the degenerate M <= 1 cases,
    and implements the periodic (sym=False) convention: build the
    (M+1)-point symmetric window and drop its final sample.  `build(L)`
    receives the symmetric length and returns that window.
    """
    if int(M) != M or M < 0:
        raise ValueError("window length must be a non-negative integer")
    if M <= 1:
        return np.ones(M)
    if sym:
        return build(M)
    return build(M + 1)[:-1]


def _centered(L: int) -> np.ndarray:
    """Sample positions relative to the window center, n - (L-1)/2."""
    return np.arange(L, dtype=np.float64) - (L - 1) / 2.0


def triang(M: int, sym: bool = True) -> np.ndarray:
    """Triangular window (nonzero endpoints, unlike bartlett): the
    linear taper 1 - |n_c| / h with h = L/2 (even L) or (L+1)/2 (odd)."""

    def build(L):
        h = L / 2.0 if L % 2 == 0 else (L + 1) / 2.0
        return 1.0 - np.abs(_centered(L)) / h

    return _sym_window(M, sym, build)


def parzen(M: int, sym: bool = True) -> np.ndarray:
    """Parzen piecewise-cubic window: with u = |n_c| / (L/2),
    1 - 6u^2 + 6u^3 for u <= 1/2, else 2(1-u)^3."""

    def build(L):
        u = np.abs(_centered(L)) / (L / 2.0)
        return np.where(
            u <= 0.5,
            1.0 - 6.0 * u * u * (1.0 - u),
            2.0 * (1.0 - u) ** 3,
        )

    return _sym_window(M, sym, build)


def bohman(M: int, sym: bool = True) -> np.ndarray:
    """Bohman window: (1-u)cos(pi u) + sin(pi u)/pi, u = |n_c|/((L-1)/2),
    with exactly-zero endpoints."""

    def build(L):
        u = np.abs(_centered(L)) / ((L - 1) / 2.0)
        w = (1.0 - u) * np.cos(np.pi * u) + np.sin(np.pi * u) / np.pi
        w[0] = w[-1] = 0.0
        return w

    return _sym_window(M, sym, build)


def barthann(M: int, sym: bool = True) -> np.ndarray:
    """Modified Bartlett-Hann: 0.62 - 0.48u + 0.38 cos(2 pi u) with
    u = |n/(L-1) - 1/2|."""

    def build(L):
        u = np.abs(_centered(L)) / (L - 1.0)
        return 0.62 - 0.48 * u + 0.38 * np.cos(2.0 * np.pi * u)

    return _sym_window(M, sym, build)


def cosine(M: int, sym: bool = True) -> np.ndarray:
    """Half-cycle sine window sin(pi (n + 1/2) / L)."""
    return _sym_window(
        M, sym, lambda L: np.sin(np.pi * (np.arange(L) + 0.5) / L)
    )


def lanczos(M: int, sym: bool = True) -> np.ndarray:
    """Lanczos window: sinc(2 n_c / (L-1))."""
    return _sym_window(
        M, sym, lambda L: np.sinc(2.0 * _centered(L) / (L - 1.0))
    )


def exponential(M: int, center: float | None = None, tau: float = 1.0,
                sym: bool = True) -> np.ndarray:
    """Exponential (Poisson) window exp(-|n - center|/tau)."""
    if sym and center is not None:
        raise ValueError("center must be None for symmetric windows")

    def build(L):
        c = (L - 1) / 2.0 if center is None else center
        return np.exp(-np.abs(np.arange(L, dtype=np.float64) - c) / tau)

    return _sym_window(M, sym, build)


def gaussian(M: int, std: float, sym: bool = True) -> np.ndarray:
    """Gaussian window exp(-n_c^2 / (2 std^2))."""
    return _sym_window(
        M, sym, lambda L: np.exp(-0.5 * (_centered(L) / std) ** 2)
    )


def general_gaussian(M: int, p: float, sig: float,
                     sym: bool = True) -> np.ndarray:
    """Generalized Gaussian exp(-0.5 |n_c/sig|^(2p))."""
    return _sym_window(
        M, sym,
        lambda L: np.exp(-0.5 * np.abs(_centered(L) / sig) ** (2 * p)),
    )


def tukey(M: int, alpha: float = 0.5, sym: bool = True) -> np.ndarray:
    """Tukey (tapered cosine): flat center, raised-cosine tapers over a
    fraction alpha of the span.

    Closed form: with e = (distance to the nearer edge) / (alpha (L-1)/2)
    the window is the raised cosine (1 - cos(pi e))/2 inside the taper
    (e < 1) and 1 elsewhere.  alpha <= 0 degenerates to rectangular and
    alpha >= 1 to the symmetric Hann — both limits of the same formula,
    no special-case branches.
    """
    if alpha <= 0:
        if int(M) != M or M < 0:
            raise ValueError("window length must be a non-negative integer")
        return np.ones(M)
    a = min(float(alpha), 1.0)

    def build(L):
        n = np.arange(L, dtype=np.float64)
        e = np.minimum(n, (L - 1.0) - n) / (0.5 * a * (L - 1.0))
        return np.where(
            e >= 1.0, 1.0, 0.5 * (1.0 - np.cos(np.pi * np.minimum(e, 1.0)))
        )

    return _sym_window(M, sym, build)


def _cheb_poly(order: float, x: np.ndarray) -> np.ndarray:
    """Chebyshev polynomial T_order on all of R: the cos form inside
    [-1, 1], the cosh continuation outside, with T(-x) = (-1)^order T(x)
    handling the negative branch."""
    inside = np.cos(order * np.arccos(np.clip(x, -1.0, 1.0)))
    outside = np.cosh(order * np.arccosh(np.maximum(np.abs(x), 1.0)))
    parity = -1.0 if int(order) % 2 else 1.0
    return np.where(
        np.abs(x) <= 1.0, inside, np.where(x > 0, outside, parity * outside)
    )


def chebwin(M: int, at: float = 100.0, sym: bool = True) -> np.ndarray:
    """Dolph-Chebyshev window with `at` dB equiripple sidelobes.

    Defined in the frequency domain: the DFT samples are
    W(k) = T_{L-1}(beta cos(pi k / L)) with beta chosen so the mainlobe
    peak is 10^(at/20) times the ripple.  The time-domain window is the
    inverse DFT centered on (L-1)/2; because W is real and even that is
    a single cosine sum valid for BOTH parities (the half-sample phase
    for even L is just the centering), normalized to unit peak.
    """

    def build(L):
        order = L - 1.0
        beta = np.cosh(np.arccosh(10.0 ** (abs(at) / 20.0)) / order)
        k = np.arange(L, dtype=np.float64)
        W = _cheb_poly(order, beta * np.cos(np.pi * k / L))
        # centered inverse DFT: w[n] = sum_k W(k) cos(2 pi k n_c / L)
        w = np.cos((2.0 * np.pi / L) * np.outer(_centered(L), k)) @ W
        return w / w.max()

    return _sym_window(M, sym, build)


def taylor(M: int, nbar: int = 4, sll: float = 30.0, norm: bool = True,
           sym: bool = True) -> np.ndarray:
    """Taylor window (radar/antenna taper): `nbar` nearly-constant
    sidelobes at -sll dB.

    The window is the cosine series 1 + 2 sum_m F_m cos(2 pi m n_c / L)
    over m = 1..nbar-1, where the F_m place the pattern's inner zeros at
    the dilated Chebyshev positions.  Standard coefficient formula
    (e.g. Doerry, "Catalog of Window Taper Functions", SAND2017-4042):

        F_m = (-1)^(m+1) / 2 * prod_j (1 - m^2 / z_j^2)
                             / prod_{j != m} (1 - m^2 / j^2)

    with zero positions z_j^2 = sigma^2 (A^2 + (j - 1/2)^2),
    A = arccosh(10^(sll/20)) / pi, and the dilation sigma^2 chosen so
    z_nbar = nbar.  Computed here as one vectorized (nbar-1)^2 table.
    """

    def build(L):
        a2 = (np.arccosh(10.0 ** (sll / 20.0)) / np.pi) ** 2
        sigma2 = nbar**2 / (a2 + (nbar - 0.5) ** 2)
        m = np.arange(1, nbar, dtype=np.float64)
        zeros2 = sigma2 * (a2 + (m - 0.5) ** 2)
        num = np.prod(1.0 - m[:, None] ** 2 / zeros2[None, :], axis=1)
        ratio = 1.0 - m[:, None] ** 2 / m[None, :] ** 2
        ratio[np.diag_indices_from(ratio)] = 1.0
        F = (-1.0) ** (m + 1) * num / (2.0 * np.prod(ratio, axis=1))
        phase = (2.0 * np.pi / L) * np.outer(_centered(L), m)
        w = 1.0 + 2.0 * (np.cos(phase) @ F)
        # center-of-window normalization: phase 0 => value 1 + 2 sum F
        return w / (1.0 + 2.0 * F.sum()) if norm else w

    return _sym_window(M, sym, build)


@lru_cache(maxsize=None)
def _dpss_tables(M: int, NW: float, Kmax: int) -> np.ndarray:
    """First Kmax Slepian sequences: eigenvectors of the classic
    symmetric tridiagonal commuting matrix (diag ((M-1-2n)/2)^2 cos(2
    pi W), offdiag n(M-n)/2), ordered by concentration."""
    W = NW / M
    n = np.arange(M, dtype=np.float64)
    T = np.zeros((M, M))
    d = ((M - 1 - 2 * n) / 2.0) ** 2 * np.cos(2 * np.pi * W)
    e = n[1:] * (M - n[1:]) / 2.0
    T[np.arange(M), np.arange(M)] = d
    T[np.arange(M - 1), np.arange(1, M)] = e
    T[np.arange(1, M), np.arange(M - 1)] = e
    vals, vecs = np.linalg.eigh(T)
    wins = vecs[:, ::-1][:, :Kmax].T  # largest eigenvalue first
    # sign convention (matches scipy so tables interchange): symmetric
    # windows positive mean; antisymmetric start with a positive lobe
    fix = np.ones(Kmax)
    for i in range(Kmax):
        if i % 2 == 0:
            if wins[i].sum() < 0:
                fix[i] = -1.0
        else:
            if wins[i][: M // 2].sum() < 0:
                fix[i] = -1.0
    return wins * fix[:, None]


def dpss(M: int, NW: float, Kmax: int | None = None,
         sym: bool = True, norm=None, return_ratios: bool = False):
    """Discrete prolate spheroidal (Slepian) sequences
    (scipy.signal.windows.dpss semantics): the Kmax most spectrally
    concentrated sequences at half-bandwidth NW/M.  Kmax=None returns
    the single leading window normalized to peak 1 (norm=2: unit
    energy; 'approximate'/'subsample' peak corrections follow scipy's
    defaults only for norm=None)."""
    if Kmax is None:
        single = True
        Kmax = 1
    else:
        single = False
        Kmax = int(Kmax)
    if Kmax < 1 or Kmax > M:
        raise ValueError("Kmax must be in [1, M]")
    if NW <= 0 or NW >= M / 2.0:
        raise ValueError("NW must lie in (0, M/2)")
    if int(M) != M or M < 0:
        raise ValueError("window length must be a non-negative integer")
    if M <= 1:
        w = np.ones((Kmax, max(M, 0)))
        return w[0] if single else w
    M2 = M if sym else M + 1
    wins = _dpss_tables(M2, float(NW), Kmax).copy()
    if norm is None:
        norm = "approximate" if single else 2
    if norm == 2:
        wins = wins / np.linalg.norm(wins, axis=-1, keepdims=True)
    elif norm in ("approximate", "subsample"):
        wins = wins / np.max(np.abs(wins), axis=-1, keepdims=True)
        if M2 % 2 == 0:
            # the true (inter-sample) peak exceeds the sampled max for
            # even lengths; scale so IT is 1 (scipy's corrections)
            if norm == "approximate":
                correction = M2 * M2 / float(M2 * M2 + NW)
            else:
                from numpy.fft import irfft, rfft

                spec = rfft(wins[0])
                f = np.arange(len(spec))
                shifted = irfft(spec * np.exp(-1j * np.pi * f / M2), n=M2)
                correction = 1.0 / np.max(np.abs(shifted))
            wins = wins * correction
    else:
        raise ValueError("norm must be 2, 'approximate', or 'subsample'")
    if not sym:
        wins = wins[:, :-1]
    return wins[0] if single else wins


_PLAIN = {
    "barthann": barthann,
    "brthan": barthann,
    "bth": barthann,
    "bohman": bohman,
    "bman": bohman,
    "bmn": bohman,
    "cosine": cosine,
    "halfcosine": cosine,
    "lanczos": lanczos,
    "sinc": lanczos,
    "parzen": parzen,
    "parz": parzen,
    "par": parzen,
    "triang": triang,
    "triangle": triang,
    "tri": triang,
}

_PARAM = {
    "chebwin": (chebwin, 1),
    "cheb": (chebwin, 1),
    "dpss": (dpss, None),
    "exponential": (exponential, None),
    "poisson": (exponential, None),
    "gaussian": (gaussian, 1),
    "gauss": (gaussian, 1),
    "gss": (gaussian, 1),
    "general gaussian": (general_gaussian, 2),
    "general_gaussian": (general_gaussian, 2),
    "ggs": (general_gaussian, 2),
    "kaiser": (None, 1),  # handled via the core kaiser table
    "ksr": (None, 1),
    "taylor": (taylor, None),
    "taylor_win": (taylor, None),
    "tukey": (tukey, 1),
    "tuk": (tukey, 1),
}

_CORE = {  # names resolved by godsp_tpu_torch.window's reference-parity tables
    "boxcar": "rectangular",
    "box": "rectangular",
    "ones": "rectangular",
    "rect": "rectangular",
    "rectangular": "rectangular",
    "hamming": "hamming",
    "hamm": "hamming",
    "ham": "hamming",
    "hann": "hann",
    "han": "hann",
    "hanning": "hann",
    "bartlett": "bartlett",
    "bart": "bartlett",
    "brt": "bartlett",
    "flattop": "flat_top",
    "flat": "flat_top",
    "flt": "flat_top",
    "flat_top": "flat_top",
    "blackman": "blackman",
    "black": "blackman",
    "blk": "blackman",
    "blackmanharris": "blackman_harris",
    "blackharr": "blackman_harris",
    "bkh": "blackman_harris",
    "blackman_harris": "blackman_harris",
    "nuttall": "nuttall",
    "nutl": "nuttall",
    "nut": "nuttall",
}


def get_window(window, Nx: int, fftbins: bool = True) -> np.ndarray:
    """Resolve a scipy-style window spec to a float64 table
    (scipy.signal.get_window): a plain name, a (name, *params) tuple for
    parametrized windows, or a bare float (kaiser beta).  fftbins=True
    returns the DFT-periodic form."""
    sym = not fftbins
    if isinstance(window, (float, int)) and not isinstance(window, bool):
        window = ("kaiser", float(window))
    if isinstance(window, (str, bytes)):
        name = (window.decode() if isinstance(window, bytes) else window).lower()
        args = ()
    elif isinstance(window, tuple):
        if not window or not isinstance(window[0], str):
            raise ValueError("tuple windows must start with the name")
        name = window[0].lower()
        args = tuple(window[1:])
    else:
        raise ValueError("window must be a string, tuple, or float")
    if name in _CORE:
        from godsp_tpu_torch.window import window_table_np

        core = _CORE[name]
        if core == "rectangular":
            return np.ones(Nx)
        if sym:
            return window_table_np(core, Nx)
        return window_table_np(core, Nx + 1)[:-1]
    if name in ("kaiser", "ksr"):
        from godsp_tpu_torch.window import _kaiser_table

        if len(args) != 1:
            raise ValueError("kaiser needs one parameter (beta)")
        if sym:
            return _kaiser_table(float(args[0]), Nx)
        return _kaiser_table(float(args[0]), Nx + 1)[:-1]
    if name in _PLAIN:
        if args:
            raise ValueError(f"window '{name}' takes no parameters")
        return _PLAIN[name](Nx, sym=sym)
    if name in _PARAM:
        fn, nargs = _PARAM[name]
        if nargs is not None and len(args) != nargs:
            raise ValueError(f"window '{name}' needs {nargs} parameter(s)")
        return np.asarray(fn(Nx, *args, sym=sym), np.float64)
    raise ValueError(f"unknown window: {window!r}")
