"""Classical IIR filter design (butter/cheby1/cheby2/bessel) + analysis.

The reference library has no filter-design surface (go-dsp's spectral
stack consumes externally designed windows only, window.go:25-152);
production DSP needs to design the filters that models.iir runs.  All
design math is trace-time float64 numpy — the same discipline as the
FFT twiddle caches (fft/stockham.py) — producing (b, a) / zpk / sos
coefficient constants for the device-side parallel-scan filters.

Design pipeline (the standard analog-prototype route).  Semantics and
API follow scipy.signal so coefficients interchange; the implementations
are this repo's own (e.g. zpk2sos uses a different pairing algorithm,
cont2discrete a self-contained Pade-13 expm), EXCEPT where behavioral
compatibility forces scipy's exact choices — those spots (findfreqs'
decade-bracketing constants, bessel norm conventions) say so in their
docstrings:

  analog lowpass prototype (buttap/cheb1ap/cheb2ap/besselap)
    -> frequency transform (lp2lp/lp2hp/lp2bp/lp2bs on zpk)
    -> bilinear transform (analog s -> digital z)
    -> output form (zpk2tf / zpk2sos)

Analysis helpers (freqz, sosfreqz, group_delay) evaluate responses in
float64 on host — they are diagnostics, not compute paths.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "BadCoefficients",
    "band_stop_obj",
    "bessel",
    "besselap",
    "bilinear",
    "bilinear_zpk",
    "buttap",
    "butter",
    "buttord",
    "cheb1ap",
    "cheb1ord",
    "cheb2ap",
    "cheb2ord",
    "cheby1",
    "cheby2",
    "ellip",
    "ellipap",
    "ellipord",
    "findfreqs",
    "freqz",
    "freqz_sos",
    "freqz_zpk",
    "gammatone",
    "group_delay",
    "iircomb",
    "iirdesign",
    "iirfilter",
    "iirnotch",
    "iirpeak",
    "lp2bp",
    "lp2bp_zpk",
    "lp2bs",
    "lp2bs_zpk",
    "lp2hp",
    "lp2hp_zpk",
    "lp2lp",
    "lp2lp_zpk",
    "normalize",
    "sos2tf",
    "sos2zpk",
    "sosfreqz",
    "tf2sos",
    "tf2zpk",
    "zpk2sos",
    "zpk2tf",
]


# ---------------------------------------------------------------------------
# Analog lowpass prototypes (unit cutoff, zpk form)
# ---------------------------------------------------------------------------


def _check_order(N: int) -> int:
    N = int(N)
    if N < 1:
        raise ValueError("filter order must be >= 1")
    return N


def buttap(N: int):
    """Butterworth analog lowpass prototype: N poles equally spaced on
    the left-half unit circle, no zeros, unit DC gain."""
    N = _check_order(N)
    theta = np.pi * (2 * np.arange(1, N + 1) + N - 1) / (2 * N)
    p = np.exp(1j * theta)
    return np.array([], complex), p, 1.0


def cheb1ap(N: int, rp: float):
    """Chebyshev type-I prototype: rp dB passband ripple, poles on an
    ellipse (sinh/cosh-scaled Butterworth angles), no zeros."""
    N = _check_order(N)
    if rp <= 0:
        raise ValueError("rp must be > 0 dB")
    eps = math.sqrt(10.0 ** (0.1 * rp) - 1.0)
    mu = math.asinh(1.0 / eps) / N
    theta = np.pi * np.arange(-N + 1, N, 2) / (2 * N)
    p = -np.sinh(mu + 1j * theta)
    k = np.prod(-p).real
    if N % 2 == 0:
        k /= math.sqrt(1.0 + eps * eps)
    return np.array([], complex), p, float(k)


def cheb2ap(N: int, rs: float):
    """Chebyshev type-II (inverse Chebyshev) prototype: rs dB stopband
    attenuation, zeros on the imaginary axis at the inverted Chebyshev
    nodes, poles the inverted type-I poles."""
    N = _check_order(N)
    if rs <= 0:
        raise ValueError("rs must be > 0 dB")
    de = 1.0 / math.sqrt(10.0 ** (0.1 * rs) - 1.0)
    mu = math.asinh(1.0 / de) / N
    if N % 2:
        m = np.concatenate([np.arange(-N + 1, 0, 2), np.arange(2, N, 2)])
    else:
        m = np.arange(-N + 1, N, 2)
    z = -np.conjugate(1j / np.sin(m * np.pi / (2 * N)))
    p = -np.exp(1j * np.pi * np.arange(-N + 1, N, 2) / (2 * N))
    p = np.sinh(mu) * p.real + 1j * np.cosh(mu) * p.imag
    p = 1.0 / p
    k = (np.prod(-p) / np.prod(-z)).real
    return z, p, float(k)


def _reverse_bessel_coeffs(N: int) -> np.ndarray:
    """Coefficients (highest power first) of the degree-N reverse Bessel
    polynomial theta_N(s): a_k = (2N-k)! / (2^(N-k) k! (N-k)!)."""
    k = np.arange(N + 1)
    c = [
        math.factorial(2 * N - i)
        // (2 ** (N - i) * math.factorial(i) * math.factorial(N - i))
        for i in k
    ]
    return np.array(c[::-1], float)  # highest power of s first


def besselap(N: int, norm: str = "phase"):
    """Bessel/Thomson analog prototype (maximally flat group delay).

    norm='phase' (default): poles scaled so the asymptotic magnitude
    matches a Butterworth of the same order (phase crosses -N*pi/4 near
    w=1); norm='delay': unit group delay at DC (raw polynomial roots).
    Root-finding is np.roots — accurate to f64 parity for N <= ~25.
    """
    N = _check_order(N)
    if norm not in ("phase", "delay"):
        raise ValueError("norm must be 'phase' or 'delay'")
    coeffs = _reverse_bessel_coeffs(N)
    p = np.roots(coeffs)
    a0 = coeffs[-1]  # constant term = theta_N(0)
    if norm == "phase":
        p = p * a0 ** (-1.0 / N)
        k = 1.0
    else:
        k = float(a0)
    return np.array([], complex), p, k


# ---------------------------------------------------------------------------
# Elliptic (Cauer) prototype — Jacobi elliptic functions via Landen
# transformations (host float64; the textbook degree-equation route,
# solved through the nome for full precision at extreme attenuations)
# ---------------------------------------------------------------------------


def _agm(a: float, b: float) -> float:
    """Arithmetic-geometric mean (quadratic convergence; the capped
    tolerance avoids the 1-ulp oscillation an exact test can enter)."""
    for _ in range(64):
        if abs(a - b) <= 4e-16 * a:
            break
        a, b = 0.5 * (a + b), math.sqrt(a * b)
    return 0.5 * (a + b)


def _ellipk_m(m: float) -> float:
    """Complete elliptic integral K with parameter m = k^2:
    K = pi / (2 AGM(1, sqrt(1-m)))."""
    if not 0.0 <= m < 1.0:
        raise ValueError("parameter m must lie in [0, 1)")
    return math.pi / (2.0 * _agm(1.0, math.sqrt(1.0 - m)))


def _landen(k: float, kp: float | None = None) -> np.ndarray:
    """Descending Landen sequence k -> 0.  Passing the complement kp
    keeps the first step accurate when k is within ulps of 1."""
    ks = []
    k = float(k)
    if kp is None:
        kp = math.sqrt(max(0.0, (1.0 - k) * (1.0 + k)))
    for _ in range(64):
        if k < 1e-16:
            break
        k = (k / (1.0 + kp)) ** 2
        kp = math.sqrt(max(0.0, (1.0 - k) * (1.0 + k)))
        ks.append(k)
    return np.array(ks)


def _cde(u, k: float, kp: float | None = None):
    """Jacobi cd(u*K(k), k) — u in units of the quarter period, possibly
    complex; ascending Gauss/Landen recursion from the degenerate cos."""
    v = _landen(k, kp)
    w = np.cos(np.asarray(u) * (np.pi / 2))
    for kn in v[::-1]:
        w = (1 + kn) * w / (1 + kn * w * w)
    return w


def _sne(u, k: float, kp: float | None = None):
    """Jacobi sn(u*K(k), k), u in units of K (complex ok)."""
    v = _landen(k, kp)
    w = np.sin(np.asarray(u) * (np.pi / 2))
    for kn in v[::-1]:
        w = (1 + kn) * w / (1 + kn * w * w)
    return w


def _asne(w, k: float):
    """Inverse sn: u (in units of K) with sn(u*K, k) = w (complex ok) —
    descending Landen on the value, then the degenerate arcsine."""
    v = _landen(k)
    w = np.asarray(w, complex)
    kprev = k
    for kn in v:
        w = 2.0 * w / ((1 + kn) * (1 + np.sqrt(1 - kprev * kprev * w * w)))
        kprev = kn
    return 2.0 / np.pi * np.arcsin(w)


def _ellipdeg(N: int, k1: float) -> tuple[float, float]:
    """Solve the elliptic degree equation N K'(k1)/K(k1) = K'(k)/K(k)
    for k via the nome (q = q1^(1/N), k = (theta2/theta3)^2).  Returns
    (k, k'): the complement comes from theta4/theta3 so callers keep
    full precision when k is within ulps of 1 (high-attenuation
    designs, where forming sqrt(1-k^2) would be catastrophic)."""
    k1p = math.sqrt(max(0.0, (1.0 - k1) * (1.0 + k1)))
    # K(k') = pi/(2 AGM(1, k)) — so both quarter periods come straight
    # from AGMs of k1 and its complement, no 1-k1^2 cancellation.
    q1 = math.exp(-math.pi * _agm(1.0, k1p) / _agm(1.0, k1))
    q = q1 ** (1.0 / N)
    m = np.arange(1, 9, dtype=np.float64)
    th2 = 2.0 * q**0.25 * (1.0 + np.sum(q ** (m * (m + 1))))
    th3 = 1.0 + 2.0 * np.sum(q ** (m * m))
    th4 = 1.0 + 2.0 * np.sum((-1.0) ** m * q ** (m * m))
    return float((th2 / th3) ** 2), float((th4 / th3) ** 2)


def ellipap(N: int, rp: float, rs: float):
    """Elliptic (Cauer) analog lowpass prototype: rp dB passband ripple,
    rs dB stopband attenuation, equiripple in both bands — the minimum-
    order classical prototype.  Zeros at j/(k*cd(u_i K, k)), poles at
    j*cd((u_i - j v0) K, k) with v0 from the inverse-sn of the ripple
    ratio (the standard Jacobi-elliptic parameterization; scipy.signal
    ellipap conventions for ordering-insensitive zpk)."""
    N = _check_order(N)
    if rp <= 0:
        raise ValueError("rp must be > 0 dB")
    if rs <= rp:
        raise ValueError("rs must exceed rp (stopband below passband ripple)")
    eps = math.sqrt(10.0 ** (0.1 * rp) - 1.0)
    k1 = eps / math.sqrt(10.0 ** (0.1 * rs) - 1.0)
    k, kc = _ellipdeg(N, k1)
    L, r = N // 2, N % 2
    ui = (2.0 * np.arange(1, L + 1) - 1.0) / N
    z = 1j / (k * _cde(ui, k, kc))
    zeros = np.concatenate([z, np.conj(z)])
    v0 = float((-1j * _asne(1j / eps, k1) / N).real)
    p = 1j * _cde(ui - 1j * v0, k, kc)
    poles = np.concatenate([p, np.conj(p)])
    if r:
        p0 = 1j * _sne(np.array(1j * v0), k, kc)
        poles = np.concatenate([poles, np.atleast_1d(p0)])
    gain = float((np.prod(-poles) / np.prod(-zeros)).real)
    if N % 2 == 0:
        gain /= math.sqrt(1.0 + eps * eps)
    return zeros, poles, gain


# ---------------------------------------------------------------------------
# zpk frequency transforms + bilinear (all trace-time float64)
# ---------------------------------------------------------------------------


def _relative_degree(z, p) -> int:
    d = len(p) - len(z)
    if d < 0:
        raise ValueError("improper transfer function (more zeros than poles)")
    return d


def lp2lp_zpk(z, p, k, wo: float = 1.0):
    """Lowpass prototype -> lowpass at cutoff wo (rad/s)."""
    z, p = np.asarray(z, complex), np.asarray(p, complex)
    d = _relative_degree(z, p)
    return z * wo, p * wo, k * wo**d


def lp2hp_zpk(z, p, k, wo: float = 1.0):
    """Lowpass prototype -> highpass with cutoff wo: s -> wo/s."""
    z, p = np.asarray(z, complex), np.asarray(p, complex)
    d = _relative_degree(z, p)
    zh = wo / z if len(z) else np.array([], complex)
    ph = wo / p
    zh = np.append(zh, np.zeros(d))
    k_hp = k * np.real(np.prod(-z) / np.prod(-p))
    return zh, ph, float(k_hp)


def _bp_pair(roots, wo, bw):
    """s -> (s^2 + wo^2)/(bw*s) root images: each lowpass root r maps to
    the quadratic pair r*bw/2 +/- sqrt((r*bw/2)^2 - wo^2)."""
    s = roots * bw / 2.0
    disc = np.sqrt(s * s - wo * wo + 0j)
    return np.concatenate([s + disc, s - disc])


def lp2bp_zpk(z, p, k, wo: float = 1.0, bw: float = 1.0):
    """Lowpass prototype -> bandpass centered at wo with bandwidth bw."""
    z, p = np.asarray(z, complex), np.asarray(p, complex)
    d = _relative_degree(z, p)
    zb = _bp_pair(z, wo, bw) if len(z) else np.array([], complex)
    pb = _bp_pair(p, wo, bw)
    zb = np.append(zb, np.zeros(d))
    return zb, pb, k * bw**d


def lp2bs_zpk(z, p, k, wo: float = 1.0, bw: float = 1.0):
    """Lowpass prototype -> bandstop: s -> bw*s/(s^2 + wo^2)."""
    z, p = np.asarray(z, complex), np.asarray(p, complex)
    d = _relative_degree(z, p)
    zi = bw / 2.0 / z if len(z) else np.array([], complex)
    pi_ = bw / 2.0 / p
    zb = (
        np.concatenate(
            [zi + np.sqrt(zi * zi - wo * wo + 0j), zi - np.sqrt(zi * zi - wo * wo + 0j)]
        )
        if len(z)
        else np.array([], complex)
    )
    pb = np.concatenate(
        [pi_ + np.sqrt(pi_ * pi_ - wo * wo + 0j), pi_ - np.sqrt(pi_ * pi_ - wo * wo + 0j)]
    )
    zb = np.append(zb, np.full(d, 1j * wo))
    zb = np.append(zb, np.full(d, -1j * wo))
    k_bs = k * np.real(np.prod(-z) / np.prod(-p))
    return zb, pb, float(k_bs)


def bilinear_zpk(z, p, k, fs: float):
    """Bilinear transform s -> 2*fs*(z-1)/(z+1) on zpk (analog -> digital;
    pre-warp cutoffs with 2*fs*tan(w/(2*fs)) before calling)."""
    z, p = np.asarray(z, complex), np.asarray(p, complex)
    d = _relative_degree(z, p)
    fs2 = 2.0 * fs
    zd = (fs2 + z) / (fs2 - z)
    pd = (fs2 + p) / (fs2 - p)
    zd = np.append(zd, -np.ones(d))
    kd = k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))
    return zd, pd, float(kd)


# ---------------------------------------------------------------------------
# Output forms
# ---------------------------------------------------------------------------


def zpk2tf(z, p, k):
    """(zeros, poles, gain) -> (b, a) polynomial coefficients (float64;
    imaginary residue of conjugate-pair products is dropped)."""
    b = k * np.atleast_1d(np.poly(np.asarray(z, complex)))
    a = np.atleast_1d(np.poly(np.asarray(p, complex)))
    return np.real(b).astype(np.float64), np.real(a).astype(np.float64)


def tf2zpk(b, a):
    """(b, a) -> (zeros, poles, gain) via np.roots."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a[0] == 0.0:
        raise ValueError("a[0] must be nonzero")
    # strip leading zeros of b so roots() sees the true degree
    nz = np.flatnonzero(b)
    if nz.size == 0:
        return np.array([], complex), np.roots(a), 0.0
    if nz[0] > 0:
        import warnings

        # scipy parity: tf2zpk routes through normalize() and warns on
        # a badly conditioned (leading-zero) numerator.
        warnings.warn("Badly conditioned filter coefficients (numerator): "
                      "the results may be meaningless", BadCoefficients,
                      stacklevel=2)
    b = b[nz[0] :]
    return np.roots(b / b[0]), np.roots(a / a[0]), float(b[0] / a[0])


def _cplx_real_split(r, tol: float = 1e-12):
    """Split roots into (conjugate-pair representatives, reals).

    Pairs are matched by sorted position of the positive-imag members
    against the negative-imag members; raises if conjugates don't pair
    up (inputs here always come from real-coefficient designs).
    """
    r = np.asarray(r, complex)
    scale = np.abs(r).max() if r.size else 1.0
    real_mask = np.abs(r.imag) <= tol * max(scale, 1.0)
    reals = np.sort(r[real_mask].real)
    cplx = r[~real_mask]
    pos = np.sort_complex(cplx[cplx.imag > 0])
    neg = np.sort_complex(np.conj(cplx[cplx.imag < 0]))
    if len(pos) != len(neg) or not np.allclose(pos, neg, rtol=1e-8, atol=1e-10):
        raise ValueError("roots do not come in conjugate pairs")
    return pos, reals.astype(float)


def _section(zs, ps) -> np.ndarray:
    """One biquad row [b0 b1 b2 1 a1 a2] from <=2 zeros and <=2 poles."""
    b = np.real(np.poly(np.asarray(zs, complex))) if len(zs) else np.array([1.0])
    a = np.real(np.poly(np.asarray(ps, complex))) if len(ps) else np.array([1.0])
    row = np.zeros(6)
    row[: len(b)] = b
    row[3 : 3 + len(a)] = a
    return row


def zpk2sos(z, p, k):
    """(z, p, k) -> second-order sections (n_sections, 6).

    Pairing: poles sorted by closeness to the unit circle (worst first
    fills the LAST section, as scipy does); each complex pole takes its
    conjugate, each real pole the nearest remaining real pole; each pole
    pair takes the nearest remaining zero (plus its conjugate or the
    nearest remaining real co-zero).  The overall cascade equals the zpk
    transfer function to float64 round-off regardless of pairing; the
    ordering minimizes intermediate peaking like scipy's 'nearest'.
    """
    z = np.asarray(z, complex)
    p = np.asarray(p, complex)
    if len(z) > len(p):
        raise ValueError("improper system: more zeros than poles")
    if len(p) == 0:
        return np.array([[float(k), 0.0, 0.0, 1.0, 0.0, 0.0]])
    n_sections = (len(p) + 1) // 2

    zc, zr = _cplx_real_split(z)
    pc, pr = _cplx_real_split(p)
    zc, zr, pc, pr = list(zc), list(zr), list(pc), list(pr)

    def take_nearest(pool, ref):
        i = int(np.argmin(np.abs(np.asarray(pool) - ref)))
        return pool.pop(i)

    sections = []
    for _ in range(n_sections):
        # worst remaining pole = closest to the unit circle
        cand = [(abs(1.0 - abs(x)), 0, j) for j, x in enumerate(pc)] + [
            (abs(1.0 - abs(x)), 1, j) for j, x in enumerate(pr)
        ]
        _, kind, j = min(cand)
        if kind == 0:
            p1 = pc.pop(j)
            ps = [p1, np.conj(p1)]
        else:
            p1 = pr.pop(j)
            ps = [p1]
            if pr and not pc:
                ps.append(take_nearest(pr, p1))
            elif pr and len(pr) + 2 * len(pc) + 1 > 2 * (n_sections - len(sections) - 1):
                # pair two reals when the remaining slots demand it
                ps.append(take_nearest(pr, p1))
        # zeros: nearest to the section's first pole
        zs = []
        if zc or zr:
            candz = [(abs(x - ps[0]), 0, j) for j, x in enumerate(zc)] + [
                (abs(x - ps[0]), 1, j) for j, x in enumerate(zr)
            ]
            _, zkind, j = min(candz)
            if zkind == 0:
                z1 = zc.pop(j)
                zs = [z1, np.conj(z1)]
            else:
                zs = [zr.pop(j)]
                if zr and len(zr) + 2 * len(zc) > 2 * (n_sections - len(sections) - 1):
                    zs.append(take_nearest(zr, zs[0]))
        sections.append(_section(zs, ps))
    # remaining zeros/poles must all be consumed
    if zc or zr or pc or pr:
        raise ValueError("pairing failed to consume all roots")
    sos = np.stack(sections[::-1])  # worst pole last
    sos[0, :3] *= k
    return sos


def sos2tf(sos):
    """Second-order sections -> (b, a) by polynomial multiplication."""
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos must have shape (n_sections, 6)")
    b = np.array([1.0])
    a = np.array([1.0])
    for sec in sos:
        b = np.polymul(b, sec[:3])
        a = np.polymul(a, sec[3:])
    return b, a


def sos2zpk(sos):
    """Second-order sections -> (z, p, k): per-section quadratic roots
    concatenated (sections with fewer than two zeros/poles contribute
    roots at the origin, matching scipy's 2*n_sections convention)."""
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos must have shape (n_sections, 6)")
    zs, ps = [], []
    k = 1.0
    for sec in sos:
        z_i, p_i, k_i = tf2zpk(sec[:3], sec[3:])
        zs.append(np.concatenate([z_i, np.zeros(2 - len(z_i))]))
        ps.append(np.concatenate([p_i, np.zeros(2 - len(p_i))]))
        k *= k_i
    return np.concatenate(zs), np.concatenate(ps), k


def tf2sos(b, a):
    """(b, a) -> second-order sections via tf2zpk + zpk2sos."""
    return zpk2sos(*tf2zpk(b, a))


def normalize(b, a):
    """Normalize (b, a) so a[0] == 1, trimming leading numerator zeros
    (scipy.signal.normalize)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a.ndim != 1 or b.ndim != 1:
        raise ValueError("b and a must be 1-D")
    if a[0] == 0.0:
        raise ValueError("a[0] must be nonzero")
    b = b / a[0]
    a = a / a[0]
    nz = np.flatnonzero(b)
    if nz.size and nz[0] > 0:
        import warnings

        warnings.warn("Badly conditioned filter coefficients (numerator): "
                      "the results may be meaningless", BadCoefficients,
                      stacklevel=2)
        b = b[nz[0] :]
    elif nz.size == 0:
        b = b[-1:]
    return b, a


# ---------------------------------------------------------------------------
# Order selection (buttord / cheb1ord / cheb2ord)
# ---------------------------------------------------------------------------


def _bounded_min(f, lo: float, hi: float, xatol: float = 1e-5) -> float:
    """Golden-section scalar minimization on [lo, hi] (the bounded
    minimizer the bandstop order objective needs; smooth unimodal)."""
    invphi = (math.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c = b - invphi * (b - a)
    d = a + invphi * (b - a)
    fc, fd = f(c), f(d)
    while abs(b - a) > xatol:
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - invphi * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + invphi * (b - a)
            fd = f(d)
    return (a + b) / 2.0


def _ord_filter_type(wp, ws, analog: bool, fs) -> tuple[np.ndarray, np.ndarray, int]:
    wp = np.atleast_1d(np.asarray(wp, np.float64))
    ws = np.atleast_1d(np.asarray(ws, np.float64))
    if wp.shape != ws.shape or wp.shape[0] not in (1, 2):
        raise ValueError("wp and ws must both be scalars or 2-sequences")
    if fs is not None:
        if analog:
            raise ValueError("fs cannot be specified for an analog filter")
        wp = 2.0 * wp / fs
        ws = 2.0 * ws / fs
    # 1: lowpass, 2: highpass, 3: bandstop, 4: bandpass
    ftype = 2 * (wp.shape[0] - 1) + 1
    if wp[0] >= ws[0]:
        ftype += 1
    return wp, ws, ftype


def _ord_prototype_selectivity(wp, ws, gpass, gstop, ftype: int,
                               analog: bool, kind: str):
    """Pre-warp, adjust bandstop passband edges (minimizing the
    continuous order), and return (nat, passb): the lowpass-prototype
    selectivity and the (possibly adjusted) analog passband edges."""
    if not analog:
        passb = np.tan(np.pi * wp / 2.0)
        stopb = np.tan(np.pi * ws / 2.0)
    else:
        passb, stopb = wp.copy(), ws.copy()
    gs = 10.0 ** (0.1 * abs(gstop))
    gp = 10.0 ** (0.1 * abs(gpass))

    def cont_order(nat: float) -> float:
        if kind == "butter":
            return math.log10((gs - 1.0) / (gp - 1.0)) / (2 * math.log10(nat))
        if kind == "ellip":
            m1 = (gp - 1.0) / (gs - 1.0)  # ripple-ratio modulus squared
            m2 = 1.0 / (nat * nat)  # selectivity modulus squared
            return (_ellipk_m(m2) * _ellipk_m(1.0 - m1)) / (
                _ellipk_m(1.0 - m2) * _ellipk_m(m1)
            )
        return math.acosh(math.sqrt((gs - 1.0) / (gp - 1.0))) / math.acosh(nat)

    if ftype == 1:
        nat = stopb / passb
    elif ftype == 2:
        nat = passb / stopb
    elif ftype == 3:
        def obj(ind):
            def f(w):
                pb = passb.copy()
                pb[ind] = w
                nat = stopb * (pb[0] - pb[1]) / (stopb**2 - pb[0] * pb[1])
                return cont_order(float(np.min(np.abs(nat))))

            return f

        passb[0] = _bounded_min(obj(0), passb[0], stopb[0] - 1e-12)
        passb[1] = _bounded_min(obj(1), stopb[1] + 1e-12, passb[1])
        nat = stopb * (passb[0] - passb[1]) / (stopb**2 - passb[0] * passb[1])
    else:  # 4: bandpass
        nat = (stopb**2 - passb[0] * passb[1]) / (stopb * (passb[0] - passb[1]))
    return float(np.min(np.abs(nat))), passb


def _ord_unwarp(WN, analog: bool, fs):
    WN = np.atleast_1d(np.asarray(WN, np.float64))
    wn = WN if analog else np.arctan(WN) * 2.0 / np.pi
    if fs is not None:
        wn = wn * fs / 2.0
    return float(wn[0]) if wn.shape[0] == 1 else wn


def buttord(wp, ws, gpass: float, gstop: float, analog: bool = False, fs=None):
    """Minimum Butterworth order meeting gpass dB passband loss at wp
    and gstop dB stopband attenuation at ws (scipy.signal.buttord).
    Returns (ord, wn) with wn the -gpass natural frequency for butter()."""
    wp, ws, ftype = _ord_filter_type(wp, ws, analog, fs)
    nat, passb = _ord_prototype_selectivity(wp, ws, gpass, gstop, ftype,
                                            analog, "butter")
    gs = 10.0 ** (0.1 * abs(gstop))
    gp = 10.0 ** (0.1 * abs(gpass))
    N = int(math.ceil(math.log10((gs - 1.0) / (gp - 1.0)) / (2 * math.log10(nat))))
    W0 = (gp - 1.0) ** (-1.0 / (2.0 * N)) if N > 0 else 1.0
    if ftype == 1:
        WN = W0 * passb
    elif ftype == 2:
        WN = passb / W0
    elif ftype == 3:
        discr = math.sqrt((passb[1] - passb[0]) ** 2
                          + 4 * W0**2 * passb[0] * passb[1])
        WN = np.sort(np.abs([((passb[1] - passb[0]) + discr) / (2 * W0),
                             ((passb[1] - passb[0]) - discr) / (2 * W0)]))
    else:
        W0v = np.array([-W0, W0])
        WN = np.sort(np.abs(
            -W0v * (passb[1] - passb[0]) / 2.0
            + np.sqrt(W0v**2 / 4.0 * (passb[1] - passb[0]) ** 2
                      + passb[0] * passb[1])
        ))
    return N, _ord_unwarp(WN, analog, fs)


def cheb1ord(wp, ws, gpass: float, gstop: float, analog: bool = False, fs=None):
    """Minimum Chebyshev-I order for the given band spec
    (scipy.signal.cheb1ord); wn is the passband edge for cheby1()."""
    wp, ws, ftype = _ord_filter_type(wp, ws, analog, fs)
    nat, passb = _ord_prototype_selectivity(wp, ws, gpass, gstop, ftype,
                                            analog, "cheby")
    gs = 10.0 ** (0.1 * abs(gstop))
    gp = 10.0 ** (0.1 * abs(gpass))
    N = int(math.ceil(math.acosh(math.sqrt((gs - 1.0) / (gp - 1.0)))
                      / math.acosh(nat)))
    return N, _ord_unwarp(passb, analog, fs)


def cheb2ord(wp, ws, gpass: float, gstop: float, analog: bool = False, fs=None):
    """Minimum Chebyshev-II order for the given band spec
    (scipy.signal.cheb2ord); wn is the frequency where the response
    first hits -gpass dB, converted for cheby2()."""
    wp, ws, ftype = _ord_filter_type(wp, ws, analog, fs)
    nat, passb = _ord_prototype_selectivity(wp, ws, gpass, gstop, ftype,
                                            analog, "cheby")
    gs = 10.0 ** (0.1 * abs(gstop))
    gp = 10.0 ** (0.1 * abs(gpass))
    v = math.acosh(math.sqrt((gs - 1.0) / (gp - 1.0)))
    N = int(math.ceil(v / math.acosh(nat)))
    new_freq = 1.0 / math.cosh(v / N)
    if ftype == 1:
        WN = passb / new_freq
    elif ftype == 2:
        WN = passb * new_freq
    elif ftype == 3:
        nat0 = (new_freq / 2.0 * (passb[0] - passb[1])
                + math.sqrt(new_freq**2 * (passb[1] - passb[0]) ** 2 / 4.0
                            + passb[1] * passb[0]))
        WN = np.array([nat0, passb[0] * passb[1] / nat0])
    else:
        nat0 = (1.0 / (2.0 * new_freq) * (passb[0] - passb[1])
                + math.sqrt((passb[1] - passb[0]) ** 2 / (4.0 * new_freq**2)
                            + passb[1] * passb[0]))
        WN = np.array([nat0, passb[0] * passb[1] / nat0])
    return N, _ord_unwarp(WN, analog, fs)


def ellipord(wp, ws, gpass: float, gstop: float, analog: bool = False, fs=None):
    """Minimum elliptic order for the given band spec
    (scipy.signal.ellipord): the elliptic degree equation evaluated with
    complete elliptic integrals of the selectivity and ripple-ratio
    moduli; wn is the passband edge for ellip()."""
    wp, ws, ftype = _ord_filter_type(wp, ws, analog, fs)
    nat, passb = _ord_prototype_selectivity(wp, ws, gpass, gstop, ftype,
                                            analog, "ellip")
    gs = 10.0 ** (0.1 * abs(gstop))
    gp = 10.0 ** (0.1 * abs(gpass))
    m1 = (gp - 1.0) / (gs - 1.0)
    m2 = 1.0 / (nat * nat)
    N = int(math.ceil((_ellipk_m(m2) * _ellipk_m(1.0 - m1))
                      / (_ellipk_m(1.0 - m2) * _ellipk_m(m1))))
    return N, _ord_unwarp(passb, analog, fs)


# ---------------------------------------------------------------------------
# Top-level designers
# ---------------------------------------------------------------------------

_PROTOTYPES = {
    "butter": lambda N, rp, rs: buttap(N),
    "cheby1": lambda N, rp, rs: cheb1ap(N, rp),
    "cheby2": lambda N, rp, rs: cheb2ap(N, rs),
    "ellip": lambda N, rp, rs: ellipap(N, rp, rs),
    "bessel": lambda N, rp, rs: besselap(N),
}


def iirfilter(
    N: int,
    Wn,
    rp: float | None = None,
    rs: float | None = None,
    btype: str = "lowpass",
    analog: bool = False,
    ftype: str = "butter",
    output: str = "ba",
    fs: float | None = None,
    _prototype=None,
):
    """Design an Nth-order IIR filter (scipy.signal.iirfilter semantics).

    Wn: critical frequency/frequencies — normalized to Nyquist == 1 when
    fs is None (digital), else in the same units as fs; rad/s if analog.
    btype: lowpass/highpass/bandpass/bandstop.  ftype: butter/cheby1/
    cheby2/bessel.  output: 'ba', 'zpk', or 'sos'.
    """
    N = _check_order(N)
    btype = {
        "low": "lowpass",
        "lowpass": "lowpass",
        "high": "highpass",
        "highpass": "highpass",
        "band": "bandpass",
        "bandpass": "bandpass",
        "stop": "bandstop",
        "bandstop": "bandstop",
    }.get(str(btype).lower())
    if btype is None:
        raise ValueError("btype must be lowpass/highpass/bandpass/bandstop")
    if ftype not in _PROTOTYPES:
        raise ValueError(f"ftype must be one of {sorted(_PROTOTYPES)}")
    if ftype in ("cheby1", "ellip") and rp is None:
        raise ValueError(f"{ftype} needs passband ripple rp (dB)")
    if ftype in ("cheby2", "ellip") and rs is None:
        raise ValueError(f"{ftype} needs stopband attenuation rs (dB)")
    if output not in ("ba", "zpk", "sos"):
        raise ValueError("output must be 'ba', 'zpk', or 'sos'")

    Wn = np.atleast_1d(np.asarray(Wn, np.float64))
    if btype in ("lowpass", "highpass"):
        if Wn.shape != (1,):
            raise ValueError(f"{btype} needs a single critical frequency")
    else:
        if Wn.shape != (2,) or not Wn[0] < Wn[1]:
            raise ValueError(f"{btype} needs two increasing critical frequencies")

    if not analog:
        if fs is not None:
            Wn = 2.0 * Wn / fs
        if np.any(Wn <= 0) or np.any(Wn >= 1):
            raise ValueError("digital critical frequencies must lie in (0, 1)")
        fs_design = 2.0
        warped = 2.0 * fs_design * np.tan(np.pi * Wn / fs_design)
    else:
        if np.any(Wn <= 0):
            raise ValueError("analog critical frequencies must be > 0")
        warped = Wn

    proto_fn = _prototype if _prototype is not None else _PROTOTYPES[ftype]
    z, p, k = proto_fn(N, rp, rs)
    if btype == "lowpass":
        z, p, k = lp2lp_zpk(z, p, k, wo=warped[0])
    elif btype == "highpass":
        z, p, k = lp2hp_zpk(z, p, k, wo=warped[0])
    else:
        bw = warped[1] - warped[0]
        wo = math.sqrt(warped[0] * warped[1])
        if btype == "bandpass":
            z, p, k = lp2bp_zpk(z, p, k, wo=wo, bw=bw)
        else:
            z, p, k = lp2bs_zpk(z, p, k, wo=wo, bw=bw)
    if not analog:
        z, p, k = bilinear_zpk(z, p, k, fs=fs_design)

    if output == "zpk":
        return z, p, k
    if output == "sos":
        return zpk2sos(z, p, k)
    return zpk2tf(z, p, k)


def butter(N, Wn, btype="lowpass", analog=False, output="ba", fs=None):
    """Butterworth design (scipy.signal.butter semantics)."""
    return iirfilter(N, Wn, None, None, btype, analog, "butter", output, fs)


def cheby1(N, rp, Wn, btype="lowpass", analog=False, output="ba", fs=None):
    """Chebyshev type-I design (rp dB passband ripple)."""
    return iirfilter(N, Wn, rp, None, btype, analog, "cheby1", output, fs)


def cheby2(N, rs, Wn, btype="lowpass", analog=False, output="ba", fs=None):
    """Chebyshev type-II design (rs dB stopband attenuation)."""
    return iirfilter(N, Wn, None, rs, btype, analog, "cheby2", output, fs)


def ellip(N, rp, rs, Wn, btype="lowpass", analog=False, output="ba", fs=None):
    """Elliptic (Cauer) design: rp dB passband ripple AND rs dB stopband
    attenuation — the minimum order for a given transition band
    (scipy.signal.ellip semantics)."""
    return iirfilter(N, Wn, rp, rs, btype, analog, "ellip", output, fs)


_ORD_SELECTORS = {
    "butter": buttord,
    "cheby1": cheb1ord,
    "cheby2": cheb2ord,
    "ellip": ellipord,
}


def iirdesign(wp, ws, gpass: float, gstop: float, analog: bool = False,
              ftype: str = "ellip", output: str = "ba", fs=None):
    """Complete band-spec design (scipy.signal.iirdesign): pick the
    minimum order meeting (gpass, gstop) at the (wp, ws) edges via the
    family's order selector, then design at that (N, wn).  The band
    type is inferred from the edge layout: scalar wp<ws lowpass,
    wp>ws highpass; 2-vectors with the passband inside the stopband
    edges bandpass, outside bandstop."""
    if ftype not in _ORD_SELECTORS:
        raise ValueError(f"ftype must be one of {sorted(_ORD_SELECTORS)}"
                         " (bessel has no equiripple band spec)")
    wpa = np.atleast_1d(np.asarray(wp, np.float64))
    wsa = np.atleast_1d(np.asarray(ws, np.float64))
    if wpa.shape != wsa.shape or wpa.shape[0] not in (1, 2):
        raise ValueError("wp and ws must both be scalars or 2-sequences")
    if wpa.shape[0] == 1:
        btype = "lowpass" if wpa[0] < wsa[0] else "highpass"
    elif wsa[0] < wpa[0] < wpa[1] < wsa[1]:
        btype = "bandpass"
    elif wpa[0] < wsa[0] < wsa[1] < wpa[1]:
        btype = "bandstop"
    else:
        raise ValueError("passband and stopband edges must nest")
    N, wn = _ORD_SELECTORS[ftype](wp, ws, gpass, gstop, analog=analog, fs=fs)
    return iirfilter(N, wn, rp=gpass, rs=gstop, btype=btype, analog=analog,
                     ftype=ftype, output=output, fs=fs)


def bessel(N, Wn, btype="lowpass", analog=False, output="ba", fs=None, norm="phase"):
    """Bessel/Thomson design (maximally flat group delay)."""
    proto = None
    if norm != "phase":
        # delay-normed prototype passes through the private override —
        # never mutate the module registry (not reentrancy-safe)
        z, p, k = besselap(_check_order(N), norm=norm)
        proto = lambda n, rp, rs: (z, p, k)
    return iirfilter(N, Wn, None, None, btype, analog, "bessel", output, fs,
                     _prototype=proto)


# ---------------------------------------------------------------------------
# Narrow-band biquad / comb designers (closed-form second-order sections)
# ---------------------------------------------------------------------------


def _notch_peak(w0, Q: float, kind: str, fs: float):
    """Shared closed-form biquad: -3 dB bandwidth w0/Q around w0; the
    notch zeros sit ON the unit circle at +-w0, the peak numerator is
    the bandpass differentiator (1 - z^-2) (scipy iirnotch/iirpeak
    conventions)."""
    w0 = 2.0 * float(w0) / float(fs)
    if not 0.0 < w0 < 1.0:
        raise ValueError("w0 must lie in (0, fs/2)")
    bw = w0 / float(Q) * math.pi
    w0 = w0 * math.pi
    gb = 1.0 / math.sqrt(2.0)  # -3 dB edge gain
    if kind == "notch":
        beta = (math.sqrt(1.0 - gb * gb) / gb) * math.tan(bw / 2.0)
    else:
        beta = (gb / math.sqrt(1.0 - gb * gb)) * math.tan(bw / 2.0)
    gain = 1.0 / (1.0 + beta)
    if kind == "notch":
        b = gain * np.array([1.0, -2.0 * math.cos(w0), 1.0])
    else:
        b = (1.0 - gain) * np.array([1.0, 0.0, -1.0])
    a = np.array([1.0, -2.0 * gain * math.cos(w0), 2.0 * gain - 1.0])
    return b, a


def iirnotch(w0, Q: float, fs: float = 2.0):
    """Second-order notch: unit gain away from w0, zero at w0, -3 dB
    bandwidth w0/Q (scipy.signal.iirnotch)."""
    return _notch_peak(w0, Q, "notch", fs)


def iirpeak(w0, Q: float, fs: float = 2.0):
    """Second-order resonator: unit gain at w0, zero at DC and Nyquist,
    -3 dB bandwidth w0/Q (scipy.signal.iirpeak)."""
    return _notch_peak(w0, Q, "peak", fs)


def iircomb(w0, Q: float, ftype: str = "notch", fs: float = 2.0,
            *, pass_zero: bool = False):
    """Comb filter with N = fs/w0 teeth: H(z) = g (1 ± z^-N)/(1 ∓ a z^-N).
    ftype='notch' rejects (pass_zero=False: the harmonics of w0;
    pass_zero=True: the half-harmonics), 'peak' resonates there instead;
    -3 dB tooth bandwidth w0/Q (scipy.signal.iircomb conventions)."""
    if ftype not in ("notch", "peak"):
        raise ValueError("ftype must be 'notch' or 'peak'")
    w0 = float(w0)
    fs = float(fs)
    if w0 <= 0 or w0 > fs / 2.0:
        raise ValueError("w0 must lie in (0, fs/2]")
    N = fs / w0
    Ni = int(round(N))
    if abs(N - Ni) > 1e-9 * max(1.0, N):
        raise ValueError("w0 must divide fs evenly")
    N = Ni
    bw = (2.0 * w0 / fs) / float(Q) * math.pi
    beta = math.tan(N * bw / 4.0)
    a = (1.0 - beta) / (1.0 + beta)
    sign = 1.0 if pass_zero else -1.0
    b_c = np.zeros(N + 1)
    a_c = np.zeros(N + 1)
    a_c[0] = 1.0
    if ftype == "notch":
        g = (1.0 + a) / 2.0
        b_c[0], b_c[N] = g, sign * g
        a_c[N] = sign * a
    else:
        g = (1.0 - a) / 2.0
        b_c[0], b_c[N] = g, sign * g
        a_c[N] = -sign * a
    return b_c, a_c


# ---------------------------------------------------------------------------
# Response analysis (host float64 diagnostics)
# ---------------------------------------------------------------------------


def _freq_grid(worN, whole: bool, fs: float) -> np.ndarray:
    if np.ndim(worN) == 0:
        n = int(worN)
        span = fs if whole else fs / 2.0
        return np.linspace(0.0, span, n, endpoint=False)
    return np.asarray(worN, np.float64)


def freqz(b, a=1.0, worN: int = 512, whole: bool = False, fs: float = 2 * np.pi):
    """Digital filter frequency response H(e^{jw}) (scipy.signal.freqz).

    Returns (w, h): w in the units of fs (default rad/sample), h complex
    float64.  worN may be a count (linspace over [0, fs/2) or [0, fs))
    or an explicit frequency grid.
    """
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    w = _freq_grid(worN, whole, fs)
    zm1 = np.exp(-2j * np.pi * w / fs)
    h = np.polynomial.polynomial.polyval(zm1, b) / np.polynomial.polynomial.polyval(
        zm1, a
    )
    return w, h


def sosfreqz(sos, worN: int = 512, whole: bool = False, fs: float = 2 * np.pi):
    """Cascaded frequency response of second-order sections."""
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos must have shape (n_sections, 6)")
    w = _freq_grid(worN, whole, fs)
    h = np.ones_like(w, complex)
    for sec in sos:
        _, hi = freqz(sec[:3], sec[3:], worN=w, fs=fs)
        h *= hi
    return w, h


def group_delay(system, w: int = 512, whole: bool = False, fs: float = 2 * np.pi):
    """Group delay -d(angle(H))/dw in samples (scipy.signal.group_delay).

    system: (b, a).  Uses the exact derivative formula
    gd = Re[(sum k b_k z^-k)/B] - Re[(sum k a_k z^-k)/A], which is
    analytic (no phase unwrapping).
    """
    b, a = system
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    wgrid = _freq_grid(w, whole, fs)
    zm1 = np.exp(-2j * np.pi * wgrid / fs)
    pv = np.polynomial.polynomial.polyval
    B = pv(zm1, b)
    A = pv(zm1, a)
    dB = pv(zm1, b * np.arange(len(b)))
    dA = pv(zm1, a * np.arange(len(a)))
    sing = (np.abs(B) < 1e-300) | (np.abs(A) < 1e-300)
    gd = np.where(
        sing, 0.0, np.real(dB / np.where(sing, 1.0, B)) - np.real(dA / np.where(sing, 1.0, A))
    )
    return wgrid, gd


def bilinear(b, a, fs: float = 1.0):
    """Bilinear transform of an analog (b, a) transfer function
    (scipy.signal.bilinear): s = 2 fs (z-1)/(z+1), via the zpk pipeline
    (tf2zpk -> bilinear_zpk -> zpk2tf)."""
    z, p, k = tf2zpk(b, a)
    return zpk2tf(*bilinear_zpk(z, p, k, fs=float(fs)))


class BadCoefficients(UserWarning):
    """Warning for badly conditioned filter coefficients
    (scipy.signal.BadCoefficients)."""


def _tf_transform(b, a, fn, **kw):
    z, p, k = tf2zpk(b, a)
    return zpk2tf(*fn(z, p, k, **kw))


def lp2lp(b, a, wo: float = 1.0):
    """Lowpass prototype -> lowpass at wo, tf form (scipy.signal.lp2lp)."""
    return _tf_transform(b, a, lp2lp_zpk, wo=wo)


def lp2hp(b, a, wo: float = 1.0):
    """Lowpass prototype -> highpass at wo, tf form (scipy.signal.lp2hp)."""
    return _tf_transform(b, a, lp2hp_zpk, wo=wo)


def lp2bp(b, a, wo: float = 1.0, bw: float = 1.0):
    """Lowpass prototype -> bandpass, tf form (scipy.signal.lp2bp)."""
    return _tf_transform(b, a, lp2bp_zpk, wo=wo, bw=bw)


def lp2bs(b, a, wo: float = 1.0, bw: float = 1.0):
    """Lowpass prototype -> bandstop, tf form (scipy.signal.lp2bs)."""
    return _tf_transform(b, a, lp2bs_zpk, wo=wo, bw=bw)


def freqz_zpk(z, p, k, worN: int = 512, whole: bool = False,
              fs: float = 2 * np.pi):
    """Digital frequency response from zpk (scipy.signal.freqz_zpk)."""
    w = _freq_grid(worN, whole, fs)
    zm = np.exp(1j * w * (2 * np.pi / fs if fs != 2 * np.pi else 1.0))
    z = np.atleast_1d(np.asarray(z, complex))
    p = np.atleast_1d(np.asarray(p, complex))
    h = k * np.prod(zm[:, None] - z[None, :], axis=1) / np.prod(
        zm[:, None] - p[None, :], axis=1)
    return w, h


# scipy >= 1.15 name for sosfreqz
freqz_sos = sosfreqz


def findfreqs(num, den, N: int, kind: str = "ba") -> np.ndarray:
    """Log-spaced frequency grid bracketing an analog system's
    interesting range, from its pole/zero positions.

    Grid-compatible with scipy.signal.findfreqs (BSD-3): the decade
    bracketing heuristic — 3x|real| + 1.5x imag for the top edge,
    |real| + 2x imag over 10 for the bottom, half-decade rounding, the
    1e-10 origin snap and 1e5 far-zero cutoff — follows scipy's
    constants verbatim, because freqs()/freqs_zpk() callers with an
    integer worN expect the exact same default grids.
    """
    if kind == "ba":
        poles = np.atleast_1d(np.roots(np.asarray(den, np.float64)) + 0j)
        zeros = np.atleast_1d(np.roots(np.asarray(num, np.float64)) + 0j)
    elif kind == "zp":
        poles = np.atleast_1d(np.asarray(den, complex))
        zeros = np.atleast_1d(np.asarray(num, complex))
    else:
        raise ValueError("kind must be 'ba' or 'zp'")
    if poles.size == 0:
        poles = np.array([-1000.0 + 0j])
    # Upper-half-plane features only (conjugate symmetry), ignoring
    # far-away zeros that would inflate the range.
    feats = np.concatenate([
        poles[poles.imag >= 0],
        zeros[(zeros.imag >= 0) & (np.abs(zeros) < 1e5)],
    ])
    # A feature at the origin (pure integrator) contributes unit |real|
    # so the log-edges stay finite.
    origin = (np.abs(feats) < 1e-10).astype(np.float64)
    top = np.max(3.0 * np.abs(feats.real + origin) + 1.5 * feats.imag)
    bot = np.min(np.abs(feats.real + origin) + 2.0 * feats.imag) / 10.0
    return np.logspace(np.round(np.log10(bot) - 0.5),
                       np.round(np.log10(top) + 0.5), int(N))


def _hz_to_erb(hz: float) -> float:
    """Equivalent rectangular bandwidth of the auditory filter at hz
    (Glasberg-Moore: ERB = f/EarQ + minBW, EarQ=9.26449, minBW=24.7)."""
    return hz / 9.26449 + 24.7


def gammatone(freq: float, ftype: str, order: int | None = None,
              numtaps: int | None = None, fs: float | None = None):
    """Gammatone auditory filter at center frequency `freq`
    (scipy.signal.gammatone semantics; Slaney 1993 design).

    ftype='fir': sampled impulse response t^(order-1) e^{-2 pi b t}
    cos(2 pi f t), scaled to unit gain at freq.  ftype='iir': the
    4th-order gammatone as an (order-8 denominator) digital filter from
    the 4x-repeated complex pole u = e^{-bT + j 2 pi f T}; numerator
    T^4 Re[(1 - u z^-1)^4] with Slaney's center-frequency gain."""
    import cmath

    freq = float(freq)
    fs = 2.0 if fs is None else float(fs)
    if not 0 < freq < fs / 2:
        raise ValueError(f"freq must lie in (0, fs/2) = (0, {fs / 2})")
    ftype = str(ftype).lower()
    if ftype == "fir":
        order = 4 if order is None else int(order)
        if not 0 < order <= 24:
            raise ValueError("order must be in (0, 24]")
        if numtaps is None:
            numtaps = max(int(fs * 0.015), 15)
        t = np.arange(int(numtaps), dtype=np.float64) / fs
        bw = 1.019 * _hz_to_erb(freq)
        b = t ** (order - 1) * np.exp(-2 * np.pi * bw * t) * np.cos(
            2 * np.pi * freq * t)
        scale = 2 * (2 * np.pi * bw) ** order / math.factorial(order - 1) / fs
        return b * scale, np.array([1.0])
    if ftype != "iir":
        raise ValueError("ftype must be 'fir' or 'iir'")
    T = 1.0 / fs
    bw = 2 * np.pi * 1.019 * _hz_to_erb(freq)
    fr = 2 * np.pi * freq * T
    bwT = bw * T
    # Slaney's unit-gain normalization at the center frequency
    g1 = -2 * cmath.exp(2j * fr) * T
    g2 = 2 * cmath.exp(-bwT + 1j * fr) * T
    g3 = math.sqrt(3 + 2**1.5) * math.sin(fr)
    g4 = math.sqrt(3 - 2**1.5) * math.sin(fr)
    g5 = cmath.exp(2j * fr)
    g = ((g1 + g2 * (math.cos(fr) - g4)) * (g1 + g2 * (math.cos(fr) + g4))
         * (g1 + g2 * (math.cos(fr) - g3)) * (g1 + g2 * (math.cos(fr) + g3)))
    g /= (-2 / math.exp(2 * bwT) - 2 * g5
          + 2 * (1 + g5) / math.exp(bwT)) ** 4
    g = abs(g)
    u = cmath.exp(-bwT + 1j * fr)  # the 4x-repeated complex pole
    p4 = np.array([1.0])
    for _ in range(4):
        p4 = np.convolve(p4, np.array([1.0, -u]))
    b = (T**4) * np.real(p4) / g
    a = np.real(np.convolve(p4, np.conj(p4)))
    return b, a


def band_stop_obj(wp, ind: int, passb, stopb, gpass: float, gstop: float,
                  type: str):
    """Continuous filter-order objective for bandstop edge optimization
    (scipy.signal.band_stop_obj): the analog order of the given family
    when passband edge `ind` is moved to wp."""
    kind = {"butter": "butter", "cheby": "cheby", "ellip": "ellip"}.get(type)
    if kind is None:
        raise ValueError("type must be 'butter', 'cheby', or 'ellip'")
    passb = np.asarray(passb, np.float64).copy()
    stopb = np.asarray(stopb, np.float64)
    passb[int(ind)] = float(wp)
    nat = stopb * (passb[0] - passb[1]) / (stopb**2 - passb[0] * passb[1])
    nat = float(np.min(np.abs(nat)))
    gs = 10.0 ** (0.1 * abs(gstop))
    gp = 10.0 ** (0.1 * abs(gpass))
    if kind == "butter":
        return math.log10((gs - 1.0) / (gp - 1.0)) / (2 * math.log10(nat))
    if kind == "ellip":
        m1 = (gp - 1.0) / (gs - 1.0)
        m2 = 1.0 / (nat * nat)
        return (_ellipk_m(m2) * _ellipk_m(1.0 - m1)) / (
            _ellipk_m(1.0 - m2) * _ellipk_m(m1))
    return math.acosh(math.sqrt((gs - 1.0) / (gp - 1.0))) / math.acosh(nat)
