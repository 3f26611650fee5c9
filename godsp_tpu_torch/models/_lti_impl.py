"""LTI systems toolkit: state-space forms, discretization, simulation,
analog responses, and partial-fraction expansion.

Port of godsp_tpu/models/_lti_impl.py.  The reference library has no
system-simulation surface (go-dsp is a spectral/IO library);
scipy.signal is the semantic oracle (tf2ss/ss2tf, cont2discrete,
lsim/dlsim, impulse/step, freqs/bode, residue family), implemented from
the textbook formulations:

- conversions and discretization are host float64 numpy (like the
  design kit, models/design.py) — coefficient math, not compute;
- simulation runs on default_device(): the linear recurrence
  x_{k+1} = M x_k + v_k is ONE log-depth scan over (matrix, offset)
  pairs (models/_scan.py), in residual form (the transition carried as
  E = M - I), with TF32 off on the card (ROADMAP fault class a).

The matrix exponential is a self-contained Pade-13
scaling-and-squaring (Higham 2005's constants — the standard
algorithm), keeping the framework scipy-free.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from godsp_tpu_torch._dtypes import resolve_device, working_float
from godsp_tpu_torch.fft.four_step import _tf32_off
from godsp_tpu_torch.models._scan import associative_scan

__all__ = [
    "StateSpace",
    "TransferFunction",
    "ZerosPolesGain",
    "abcd_normalize",
    "dlti",
    "lti",
    "cont2discrete",
    "dbode",
    "dfreqresp",
    "dimpulse",
    "dlsim",
    "dstep",
    "freqs",
    "freqs_zpk",
    "freqresp",
    "bode",
    "impulse",
    "invres",
    "invresz",
    "lsim",
    "place_poles",
    "residue",
    "residuez",
    "ss2tf",
    "ss2zpk",
    "step",
    "tf2ss",
    "unique_roots",
    "zpk2ss",
]


# ---------------------------------------------------------------------------
# State-space conversions (host float64)
# ---------------------------------------------------------------------------


def tf2ss(num, den):
    """Transfer function -> controllable canonical state space
    (scipy.signal.tf2ss layout: A's first row carries -den[1:])."""
    num = np.atleast_1d(np.asarray(num, np.float64))
    den = np.atleast_1d(np.asarray(den, np.float64))
    if den[0] == 0:
        raise ValueError("den[0] must be nonzero")
    num = num / den[0]
    den = den / den[0]
    if len(num) > len(den):
        raise ValueError("improper transfer function (num longer than den)")
    n = len(den) - 1
    if n == 0:
        return (np.zeros((0, 0)), np.zeros((0, 1)), np.zeros((1, 0)),
                np.atleast_2d(num[-1] if len(num) else 0.0))
    if len(num) < len(den):
        num = np.concatenate([np.zeros(len(den) - len(num)), num])
    D = np.atleast_2d(num[0])
    A = np.zeros((n, n))
    A[0, :] = -den[1:]
    A[1:, :-1] = np.eye(n - 1)
    B = np.zeros((n, 1))
    B[0, 0] = 1.0
    C = (num[1:] - num[0] * den[1:])[None, :]
    return A, B, C, D


def ss2tf(A, B, C, D, input: int = 0):
    """State space -> transfer function for the chosen input column
    (scipy.signal.ss2tf): den = poly(A), num rows via the classic
    poly(A - B C_i) identity."""
    A, B, C, D = (np.atleast_2d(np.asarray(m, np.float64)) for m in (A, B, C, D))
    B = B[:, input : input + 1]
    D = D[:, input : input + 1]
    den = np.poly(A) if A.size else np.ones(1)
    nout = C.shape[0]
    num = np.empty((nout, len(den)))
    for i in range(nout):
        num[i] = np.poly(A - B @ C[i : i + 1]) + (D[i, 0] - 1.0) * den
    return num, den


def zpk2ss(z, p, k):
    """zpk -> state space via the transfer function (scipy.signal)."""
    from godsp_tpu_torch.models.design import zpk2tf

    return tf2ss(*zpk2tf(z, p, k))


def ss2zpk(A, B, C, D, input: int = 0):
    """State space -> zpk via the transfer function (scipy.signal)."""
    from godsp_tpu_torch.models.design import tf2zpk

    num, den = ss2tf(A, B, C, D, input=input)
    return tf2zpk(num[0], den)


def _as_ss(system):
    """Accept (b, a) / (z, p, k) / (A, B, C, D) like scipy's lti entry
    points; returns 2-D float64 A, B, C, D."""
    if len(system) == 2:
        system = tf2ss(*system)
    elif len(system) == 3:
        system = zpk2ss(*system)
    elif len(system) != 4:
        raise ValueError("system must be (b,a), (z,p,k), or (A,B,C,D)")
    return tuple(np.atleast_2d(np.asarray(m, np.float64)) for m in system)


# ---------------------------------------------------------------------------
# Matrix exponential + discretization (host float64)
# ---------------------------------------------------------------------------

_PADE13 = (
    64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
    1187353796428800.0, 129060195264000.0, 10559470521600.0, 670442572800.0,
    33522128640.0, 1323241920.0, 40840800.0, 960960.0, 16380.0, 182.0, 1.0,
)


def _expm(A: np.ndarray) -> np.ndarray:
    """Pade-13 scaling-and-squaring matrix exponential (f64 host;
    theta_13 = 5.372 from Higham's analysis)."""
    A = np.asarray(A, np.float64)
    n = A.shape[0]
    if n == 0:
        return np.zeros((0, 0))
    b = _PADE13
    nrm = np.linalg.norm(A, 1)
    s = int(np.ceil(np.log2(nrm / 5.371920351148152))) if nrm > 5.37 else 0
    A = A / (2.0**s)
    A2 = A @ A
    A4 = A2 @ A2
    A6 = A4 @ A2
    eye = np.eye(n)
    U = A @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2)
             + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye)
    V = (A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2)
         + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye)
    F = np.linalg.solve(V - U, V + U)
    for _ in range(s):
        F = F @ F
    return F


_GBT_ALPHA = {"bilinear": 0.5, "tustin": 0.5, "euler": 0.0,
              "forward_diff": 0.0, "backward_diff": 1.0}


def cont2discrete(system, dt: float, method: str = "zoh", alpha=None):
    """Continuous -> discrete state space (scipy.signal.cont2discrete):
    methods 'zoh' (block matrix exponential), 'foh' (triangle-hold block
    exponential), 'impulse', 'gbt' (generalized bilinear with alpha;
    'bilinear'/'tustin'/'euler'/'backward_diff' are fixed alphas).
    Returns the representation it was given (scipy convention): tf in ->
    (numd, dend, dt); zpk in -> (zd, pd, kd, dt); ss in ->
    (Ad, Bd, Cd, Dd, dt)."""
    if len(system) == 2:
        Ad, Bd, Cd, Dd, dt = cont2discrete(tf2ss(*system), dt, method, alpha)
        num, den = ss2tf(Ad, Bd, Cd, Dd)
        return np.squeeze(num), den, dt
    if len(system) == 3:
        Ad, Bd, Cd, Dd, dt = cont2discrete(zpk2ss(*system), dt, method, alpha)
        return (*ss2zpk(Ad, Bd, Cd, Dd), dt)
    A, B, C, D = _as_ss(system)
    n, m = A.shape[0], B.shape[1]
    dt = float(dt)
    if method == "gbt" or method in _GBT_ALPHA:
        al = _GBT_ALPHA.get(method, alpha)
        if al is None:
            raise ValueError("gbt needs alpha in [0, 1]")
        eye = np.eye(n)
        ima = eye - al * dt * A
        Ad = np.linalg.solve(ima, eye + (1.0 - al) * dt * A)
        Bd = np.linalg.solve(ima, dt * B)
        Cd = np.linalg.solve(ima.T, C.T).T
        Dd = D + al * (C @ Bd)
        return Ad, Bd, Cd, Dd, dt
    if method == "zoh":
        em = np.zeros((n + m, n + m))
        em[:n, :n] = A * dt
        em[:n, n:] = B * dt
        ms = _expm(em)
        return ms[:n, :n], ms[:n, n:], C.copy(), D.copy(), dt
    if method == "foh":
        em = np.zeros((n + 2 * m, n + 2 * m))
        em[:n, :n] = A * dt
        em[:n, n : n + m] = B * dt
        em[n : n + m, n + m :] = np.eye(m)
        ms = _expm(em)
        phi, g1, g2 = ms[:n, :n], ms[:n, n : n + m], ms[:n, n + m :]
        return phi, g1 + phi @ g2 - g2, C.copy(), D + C @ g2, dt
    if method == "impulse":
        Ad = _expm(A * dt)
        return Ad, Ad @ B * dt, C.copy(), C @ B * dt + D, dt
    raise ValueError(f"unknown method: {method}")


def _foh_gammas(A, B, dt):
    """(phi, gamma1, gamma2) for exact linear-interpolation stepping:
    x_{k+1} = phi x_k + (g1 - g2) u_k + g2 u_{k+1}."""
    n, m = A.shape[0], B.shape[1]
    em = np.zeros((n + 2 * m, n + 2 * m))
    em[:n, :n] = A * dt
    em[:n, n : n + m] = B * dt
    em[n : n + m, n + m :] = np.eye(m)
    ms = _expm(em)
    return ms[:n, :n], ms[:n, n : n + m], ms[:n, n + m :]


# ---------------------------------------------------------------------------
# Simulation — ONE log-depth scan on the device
# ---------------------------------------------------------------------------


def _residual_combine(c1, c2):
    """(I + E2)(I + E1) = I + (E1 + E2 + E2 E1); offsets b1 then b2."""
    E1, b1 = c1
    E2, b2 = c2
    return E1 + E2 + torch.matmul(E2, E1), b1 + b2 + torch.matmul(E2, b1[..., None])[..., 0]


def _affine_scan(E, V, x0):
    """States of x_{k+1} = (I + E) x_k + V[k] for k = 0..K-1, incl. x0:
    log-depth via associative_scan over affine maps in RESIDUAL form —
    the transition matrix is carried as its deviation E from the
    identity.

    Why (godsp_tpu's chip measurement): for small dt the discretized
    Ad ~ I, and storing Ad directly throws away the increment's relative
    precision in float32 — the direct form measured 102 dB (CPU float32)
    and 14 dB (with reduced-precision matmuls) against scipy float64 over
    2001 steps; the residual form with full-precision float32 matmuls
    ~132 dB.  On the card TF32 stays off for the same reason."""
    K = V.shape[0]
    with _tf32_off():
        Es, bs = associative_scan(_residual_combine, (E.expand(K, *E.shape), V))
        xs = x0 + torch.matmul(Es, x0[:, None])[..., 0] + bs
    return torch.cat([x0[None], xs], dim=0)


def _simulate(Ad, Bd1, Bd2, u, x0) -> np.ndarray:
    """Run x_{k+1} = Ad x_k + Bd1 u_k + Bd2 u_{k+1} on default_device()
    in its working float from float64 host inputs; returns all states
    (T, n) as float64 numpy."""
    K = u.shape[0] - 1
    v = u[:-1] @ np.asarray(Bd1).T
    if Bd2 is not None:
        v = v + u[1:] @ np.asarray(Bd2).T
    if K == 0:
        return np.asarray(x0, np.float64)[None, :]
    dev = resolve_device()
    fdt = working_float(dev)
    # Residual form: subtract the identity IN float64, so the float32 cast
    # carries E = Ad - I at full relative precision (see _affine_scan).
    Ad64 = np.asarray(Ad, np.float64)
    E, V, x0t = (torch.from_numpy(np.ascontiguousarray(t, np.float64)).to(device=dev, dtype=fdt)
                 for t in (Ad64 - np.eye(Ad64.shape[0]), v, x0))
    return _affine_scan(E, V, x0t).cpu().numpy().astype(np.float64)


def dlsim(system, u, t=None, x0=None):
    """Simulate a discrete system (A, B, C, D, dt) — or a (b, a, dt) /
    (z, p, k, dt) tuple — over input u (scipy.signal.dlsim).  Returns
    (tout, yout, xout).  The state recurrence is one associative scan
    (log-depth) instead of a sequential loop."""
    if len(system) < 3:
        raise ValueError("discrete system tuple must end with dt")
    dt = float(system[-1])
    A, B, C, D = _as_ss(system[:-1])
    u = np.atleast_1d(np.asarray(u, np.float64))
    if u.ndim == 1:
        u = u[:, None]
    if u.shape[1] != B.shape[1]:
        raise ValueError("u must have one column per input")
    if t is None:
        steps = u.shape[0]
        tout = np.arange(steps) * dt
    else:
        # scipy semantics: resample u onto the system's dt grid spanning
        # [0, t[-1]] by linear interpolation
        t = np.asarray(t, np.float64)
        tout = np.arange(int(np.floor(t[-1] / dt)) + 1) * dt
        u = np.stack([np.interp(tout, t, u[:, i])
                      for i in range(u.shape[1])], axis=1)
        steps = u.shape[0]
    n = A.shape[0]
    x0v = np.zeros(n) if x0 is None else np.asarray(x0, np.float64).reshape(n)
    xs = _simulate(A, B, None, u, x0v)
    xs_np = xs[:steps]
    yout = xs_np @ C.T + u @ D.T
    return tout, yout, xs_np


def lsim(system, U, T, X0=None, interp: bool = True):
    """Simulate a continuous system over a uniform time grid
    (scipy.signal.lsim): discretize exactly with the triangle hold
    (interp=True, input linearly interpolated between samples) or the
    zero-order hold, then run the one-scan recurrence.  Returns
    (T, yout, xout)."""
    A, B, C, D = _as_ss(system)
    T = np.asarray(T, np.float64)
    if T.ndim != 1 or len(T) < 2:
        raise ValueError("T must be a 1-D array with at least 2 points")
    dt = T[1] - T[0]
    if not np.allclose(np.diff(T), dt, rtol=1e-10, atol=0):
        raise ValueError("T must be uniformly spaced")
    if U is None:
        U = np.zeros((len(T), B.shape[1]))
    U = np.atleast_1d(np.asarray(U, np.float64))
    if U.ndim == 1:
        U = U[:, None]
    if U.shape[0] != len(T):
        raise ValueError("U must have len(T) rows")
    n = A.shape[0]
    x0 = np.zeros(n) if X0 is None else np.asarray(X0, np.float64).reshape(n)
    if interp:
        phi, g1, g2 = _foh_gammas(A, B, dt)
        xs = _simulate(phi, g1 - g2, g2, U, x0)
    else:
        Ad, Bd, _, _, _ = cont2discrete((A, B, C, D), dt, "zoh")
        xs = _simulate(Ad, Bd, None, U, x0)
    xs_np = xs[: len(T)]
    yout = xs_np @ C.T + U @ D.T
    if yout.shape[1] == 1:
        yout = yout[:, 0]
    return T, yout, xs_np


def _default_times(A, N):
    """Response horizon from the slowest pole (scipy's heuristic:
    7 time constants, 100 points)."""
    N = 100 if N is None else int(N)
    vals = np.linalg.eigvals(A) if A.size else np.array([-1.0])
    r = np.min(np.abs(np.real(vals)))
    if r == 0.0 or not np.isfinite(r):
        r = 1.0
    return np.linspace(0.0, 7.0 / r, N)


def impulse(system, X0=None, T=None, N=None):
    """Continuous impulse response (scipy.signal.impulse): simulate the
    autonomous system from x0 + B.  Returns (T, yout)."""
    A, B, C, D = _as_ss(system)
    if T is None:
        T = _default_times(A, N)
    T = np.asarray(T, np.float64)
    x0 = B[:, 0] + (0 if X0 is None else np.asarray(X0, np.float64).reshape(-1))
    _, y, _ = lsim((A, B, C, D), np.zeros((len(T), B.shape[1])), T, X0=x0)
    return T, y


def step(system, X0=None, T=None, N=None):
    """Continuous step response (scipy.signal.step).  Returns (T, yout)."""
    A, B, C, D = _as_ss(system)
    if T is None:
        T = _default_times(A, N)
    T = np.asarray(T, np.float64)
    _, y, _ = lsim((A, B, C, D), np.ones((len(T), B.shape[1])), T, X0=X0)
    return T, y


def dimpulse(system, x0=None, t=None, n=None):
    """Discrete impulse response (scipy.signal.dimpulse conventions):
    one response per INPUT — input i alone receives the unit impulse —
    each an (n, n_outputs) array in the returned tuple."""
    dt = float(system[-1])
    A, B, C, D = _as_ss(system[:-1])
    steps = 100 if n is None else int(n)
    if t is not None:
        steps = len(np.atleast_1d(t))
    tout = np.arange(steps) * dt
    outs = []
    for i in range(B.shape[1]):
        u = np.zeros((steps, B.shape[1]))
        u[0, i] = 1.0
        _, y, _ = dlsim((A, B, C, D, dt), u, x0=x0)
        outs.append(y)
    return tout, tuple(outs)


def dstep(system, x0=None, t=None, n=None):
    """Discrete step response (scipy.signal.dstep conventions): one
    response per INPUT, like dimpulse)."""
    dt = float(system[-1])
    A, B, C, D = _as_ss(system[:-1])
    steps = 100 if n is None else int(n)
    if t is not None:
        steps = len(np.atleast_1d(t))
    tout = np.arange(steps) * dt
    outs = []
    for i in range(B.shape[1]):
        u = np.zeros((steps, B.shape[1]))
        u[:, i] = 1.0
        _, y, _ = dlsim((A, B, C, D, dt), u, x0=x0)
        outs.append(y)
    return tout, tuple(outs)


# ---------------------------------------------------------------------------
# Analog frequency responses (host float64 diagnostics)
# ---------------------------------------------------------------------------


def _freq_grid_analog(b, a, N: int) -> np.ndarray:
    """Log grid bracketing the system's pole/zero decades (the role of
    scipy's findfreqs; explicit worN grids match scipy exactly, this
    default differs only in grid placement)."""
    roots = np.concatenate([np.atleast_1d(np.roots(a)),
                            np.atleast_1d(np.roots(b))]) if len(b) > 1 or len(a) > 1 else np.array([])
    mags = np.abs(roots[np.abs(roots) > 1e-10]) if roots.size else np.array([])
    if mags.size == 0:
        lo, hi = -1.0, 2.0
    else:
        lo = math.floor(math.log10(mags.min())) - 1.0
        hi = math.ceil(math.log10(mags.max())) + 1.0
    return np.logspace(lo, hi, N)


def freqs(b, a, worN=200):
    """Analog frequency response H(jw) of b(s)/a(s)
    (scipy.signal.freqs).  worN: int for an auto log grid, or an
    explicit array of angular frequencies."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if np.ndim(worN) == 0:
        w = _freq_grid_analog(b, a, int(worN))
    else:
        w = np.asarray(worN, np.float64)
    s = 1j * w
    h = np.polyval(b, s) / np.polyval(a, s)
    return w, h


def freqs_zpk(z, p, k, worN=200):
    """Analog response from zpk (scipy.signal.freqs_zpk)."""
    z = np.atleast_1d(np.asarray(z, complex))
    p = np.atleast_1d(np.asarray(p, complex))
    if np.ndim(worN) == 0:
        from godsp_tpu_torch.models.design import zpk2tf

        b, a = zpk2tf(z, p, k)
        w = _freq_grid_analog(np.atleast_1d(b), np.atleast_1d(a), int(worN))
    else:
        w = np.asarray(worN, np.float64)
    s = 1j * w
    h = k * np.prod(s[:, None] - z[None, :], axis=1) / np.prod(
        s[:, None] - p[None, :], axis=1)
    return w, h


def bode(system, w=None, n: int = 100):
    """Continuous Bode data (scipy.signal.bode): (w, magnitude dB,
    unwrapped phase degrees)."""
    if len(system) == 4:
        num, den = ss2tf(*system)
        num = num[0]
    elif len(system) == 3:
        from godsp_tpu_torch.models.design import zpk2tf

        num, den = zpk2tf(*system)
    else:
        num, den = system
    w, h = freqs(np.atleast_1d(num), np.atleast_1d(den),
                 worN=(w if w is not None else n))
    mag = 20.0 * np.log10(np.maximum(np.abs(h), 1e-300))
    phase = np.degrees(np.unwrap(np.angle(h)))
    return w, mag, phase


# ---------------------------------------------------------------------------
# Partial-fraction expansion (host float64/complex128)
# ---------------------------------------------------------------------------


def unique_roots(p, tol: float = 1e-3, rtype: str = "min"):
    """Group close roots (scipy.signal.unique_roots): greedy clustering
    within tol; the representative is the min/max-magnitude member or
    the cluster mean ('avg')."""
    p = np.atleast_1d(np.asarray(p))
    if rtype not in ("max", "maximum", "min", "minimum", "avg", "mean"):
        raise ValueError("rtype must be max/min/avg (or synonyms)")
    pool = list(p)
    uniq, mult = [], []
    while pool:
        r = pool.pop(0)
        grp = [r]
        rest = []
        for q in pool:
            if abs(q - r) < tol:
                grp.append(q)
            else:
                rest.append(q)
        pool = rest
        if rtype in ("avg", "mean"):
            val = np.mean(grp)
        elif rtype in ("min", "minimum"):
            val = grp[int(np.argmin(np.abs(grp)))]
        else:
            val = grp[int(np.argmax(np.abs(grp)))]
        uniq.append(val)
        mult.append(len(grp))
    return np.asarray(uniq), np.asarray(mult, int)


def _taylor_at(c: np.ndarray, p: complex, terms: int) -> np.ndarray:
    """First `terms` Taylor coefficients of the polynomial c (descending
    powers) around s = p, by repeated synthetic division."""
    c = np.asarray(c, complex).copy()
    out = np.zeros(terms, complex)
    for k in range(min(terms, len(c))):
        m = len(c)
        r = c[0]
        for i in range(1, m):
            r = r * p + c[i]
        out[k] = r
        q = np.empty(m - 1, complex)
        acc = 0.0
        for i in range(m - 1):
            acc = acc * p + c[i]
            q[i] = acc
        c = q
        if len(c) == 0:
            break
    return out


def _residues_grouped(b, a, uniq, mult):
    """Residues for grouped poles via local Taylor-series division:
    around each pole p of multiplicity m, expand f = b/q (q = a without
    the (s-p)^m factor) to m terms; term j is the residue of
    (s-p)^-(m-j).  Returned per pole in scipy's increasing-power order
    ((s-p)^-1 first)."""
    r_all, p_all = [], []
    lead = a[0]
    for idx, (p, m) in enumerate(zip(uniq, mult)):
        q = np.array([lead], complex)
        for j2, (p2, m2) in enumerate(zip(uniq, mult)):
            if j2 == idx:
                continue
            for _ in range(m2):
                q = np.convolve(q, [1.0, -p2])
        bt = _taylor_at(b, p, m) if len(b) else np.zeros(m, complex)
        qt = _taylor_at(q, p, m)
        f = np.empty(m, complex)
        for j in range(m):
            f[j] = (bt[j] - sum(f[i] * qt[j - i] for i in range(j))) / qt[0]
        r_all.extend(f[::-1])
        p_all.extend([p] * m)
    return np.asarray(r_all), np.asarray(p_all)


def residue(b, a, tol: float = 1e-3, rtype: str = "avg"):
    """Partial-fraction expansion of b(s)/a(s) (scipy.signal.residue):
    returns (r, p, k) with sum_i r_i/(s-p_i)^j + polyval(k, s); repeated
    poles list residues in increasing power order."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a[0] == 0:
        raise ValueError("a[0] must be nonzero")
    k = np.array([])
    if len(b) >= len(a):
        k, b = np.polydiv(b, a)
    poles = np.roots(a)
    uniq, mult = unique_roots(poles, tol=tol, rtype=rtype)
    r, p = _residues_grouped(b, a, uniq, mult)
    return r, p, np.atleast_1d(k).astype(np.float64)


def invres(r, p, k, tol: float = 1e-3, rtype: str = "avg"):
    """Inverse of residue (scipy.signal.invres): rebuild (b, a) from
    residues/poles/direct terms."""
    r = np.atleast_1d(np.asarray(r, complex))
    p = np.atleast_1d(np.asarray(p, complex))
    k = np.atleast_1d(np.asarray(k, np.float64)) if np.size(k) else np.array([])
    uniq, mult = unique_roots(p, tol=tol, rtype=rtype)
    a = np.array([1.0], complex)
    for pu, m in zip(uniq, mult):
        for _ in range(m):
            a = np.convolve(a, [1.0, -pu])
    b = np.zeros(1, complex)
    ri = 0
    for idx, (pu, m) in enumerate(zip(uniq, mult)):
        # a / (s-pu)^j for j = 1..m, times the residue of (s-pu)^-j
        base = np.array([1.0], complex)
        for j2, (p2, m2) in enumerate(zip(uniq, mult)):
            if j2 == idx:
                continue
            for _ in range(m2):
                base = np.convolve(base, [1.0, -p2])
        tail = np.array([1.0], complex)
        terms = []
        for j in range(m, 0, -1):  # (s-pu)^(m-j) factors, j = m..1
            terms.append(np.convolve(base, tail))
            tail = np.convolve(tail, [1.0, -pu])
        # terms[0] pairs with (s-pu)^-m ... terms[m-1] with ^-1;
        # residues arrive in increasing power order (^-1 first)
        for j in range(m):
            t = terms[m - 1 - j] * r[ri + j]
            b = np.polyadd(b, t)
        ri += m
    if k.size:
        b = np.polyadd(b, np.convolve(k, a))
    return (np.atleast_1d(np.real_if_close(b)),
            np.atleast_1d(np.real_if_close(a)))


def residuez(b, a, tol: float = 1e-3, rtype: str = "avg"):
    """z-domain partial fractions (scipy.signal.residuez):
    b(z)/a(z) in z^-1 = sum r_i/(1 - p_i z^-1)^j + sum k_j z^-j.
    Solved by substituting w = z^-1 and mapping the w-plane expansion
    back: 1/(w - 1/p)^j = (-p)^j / (1 - p w)^j."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a[0] == 0:
        raise ValueError("a[0] (constant z^0 term) must be nonzero")
    # as polynomials in w = z^-1 (ascending in z^-1 == given order),
    # convert to descending-power form by reversal
    bw = b[::-1].copy()
    aw = a[::-1].copy()
    kw = np.array([])
    if len(bw) >= len(aw):
        kw, bw = np.polydiv(bw, aw)
    wroots = np.roots(aw)
    uniq_w, mult = unique_roots(wroots, tol=tol, rtype=rtype)
    rw, pw = _residues_grouped(bw, aw, uniq_w, mult)
    # map each residue: r_w/(w - w0)^j -> r_w (-p)^j / (1 - p w)^j,
    # with p = 1/w0
    r, p = [], []
    ri = 0
    for w0, m in zip(uniq_w, mult):
        pz = 1.0 / w0
        for j in range(1, m + 1):  # increasing power order
            r.append(rw[ri + j - 1] * (-pz) ** j)
            p.append(pz)
        ri += m
    # direct polynomial in w (descending) -> ascending z^-1 order
    k = kw[::-1] if np.size(kw) else np.array([])
    return np.asarray(r), np.asarray(p), np.atleast_1d(k).astype(np.float64) if np.size(k) else np.array([])


def invresz(r, p, k, tol: float = 1e-3, rtype: str = "avg"):
    """Inverse of residuez (scipy.signal.invresz)."""
    r = np.atleast_1d(np.asarray(r, complex))
    p = np.atleast_1d(np.asarray(p, complex))
    k = np.atleast_1d(np.asarray(k, np.float64)) if np.size(k) else np.array([])
    uniq, mult = unique_roots(p, tol=tol, rtype=rtype)
    # invert the residuez mapping back into w-space, reuse invres there
    rw, pw = [], []
    ri = 0
    for pu, m in zip(uniq, mult):
        w0 = 1.0 / pu
        for j in range(1, m + 1):
            rw.append(r[ri + j - 1] / ((-pu) ** j))
            pw.append(w0)
        ri += m
    kw = k[::-1] if k.size else np.array([])
    bw, aw = invres(np.asarray(rw), np.asarray(pw), kw, tol=tol, rtype=rtype)
    bw = np.atleast_1d(bw)
    aw = np.atleast_1d(aw)
    # back to ascending z^-1 (reverse), normalize a[0] = aw's z^0 term
    b = np.asarray(bw)[::-1]
    a = np.asarray(aw)[::-1]
    scale = a[0]
    return np.real_if_close(b / scale), np.real_if_close(a / scale)


def freqresp(system, w=None, n: int = 10000):
    """Continuous frequency response H(jw) (scipy.signal.freqresp):
    returns (w, h); explicit w grids match scipy exactly, the default
    grid uses this module's decade-bracketing heuristic."""
    if len(system) == 4:
        num, den = ss2tf(*system)
        num = num[0]
    elif len(system) == 3:
        from godsp_tpu_torch.models.design import zpk2tf

        num, den = zpk2tf(*system)
    else:
        num, den = system
    return freqs(np.atleast_1d(num), np.atleast_1d(den),
                 worN=(w if w is not None else n))


def _dsys_tf(system):
    """(b, a, dt) / (z, p, k, dt) / (A, B, C, D, dt) -> (b, a, dt)."""
    dt = float(system[-1])
    body = system[:-1]
    if len(body) == 2:
        b, a = body
    elif len(body) == 3:
        from godsp_tpu_torch.models.design import zpk2tf

        b, a = zpk2tf(*body)
    else:
        num, den = ss2tf(*body)
        b, a = num[0], den
    return np.atleast_1d(np.asarray(b, np.float64)), np.atleast_1d(
        np.asarray(a, np.float64)), dt


def dfreqresp(system, w=None, n: int = 100, whole: bool = False):
    """Discrete frequency response H(e^{jw}) over w in rad/sample
    (scipy.signal.dfreqresp)."""
    b, a, _ = _dsys_tf(system)
    from godsp_tpu_torch.models.design import freqz

    if w is None:
        span = 2 * np.pi if whole else np.pi
        w = np.linspace(0, span, int(n), endpoint=False)
    else:
        w = np.asarray(w, np.float64)
    _, h = freqz(b, a, worN=w)
    return w, np.asarray(h)


def dbode(system, w=None, n: int = 100):
    """Discrete Bode data (scipy.signal.dbode): w is interpreted in
    rad/SAMPLE like dfreqresp, and the returned frequency grid is w/dt
    (rad/s); magnitude dB, unwrapped phase degrees."""
    b, a, dt = _dsys_tf(system)
    wn, h = dfreqresp((b, a, dt), w=w, n=n)
    mag = 20.0 * np.log10(np.maximum(np.abs(h), 1e-300))
    phase = np.degrees(np.unwrap(np.angle(h)))
    return wn / dt, mag, phase


def abcd_normalize(A=None, B=None, C=None, D=None):
    """Fill in compatible zero matrices for missing state-space parts
    and check shape consistency (scipy.signal.abcd_normalize)."""
    given = {k: (np.atleast_2d(np.asarray(v, np.float64)) if v is not None
                 else None) for k, v in zip("ABCD", (A, B, C, D))}
    n = p = q = None
    if given["A"] is not None:
        n = given["A"].shape[0]
    if given["B"] is not None:
        n = n or given["B"].shape[0]
        p = given["B"].shape[1]
    if given["C"] is not None:
        n = n or given["C"].shape[1]
        q = given["C"].shape[0]
    if given["D"] is not None:
        q = q or given["D"].shape[0]
        p = p or given["D"].shape[1]
    if n is None or p is None or q is None:
        raise ValueError("not enough information to deduce state-space "
                         "shapes")
    out = {
        "A": given["A"] if given["A"] is not None else np.zeros((n, n)),
        "B": given["B"] if given["B"] is not None else np.zeros((n, p)),
        "C": given["C"] if given["C"] is not None else np.zeros((q, n)),
        "D": given["D"] if given["D"] is not None else np.zeros((q, p)),
    }
    if (out["A"].shape != (n, n) or out["B"].shape != (n, p)
            or out["C"].shape != (q, n) or out["D"].shape != (q, p)):
        raise ValueError("inconsistent state-space shapes")
    return out["A"], out["B"], out["C"], out["D"]


# ---------------------------------------------------------------------------
# Class layer (scipy.signal lti/dlti surface over the functional API)
# ---------------------------------------------------------------------------


class _SystemBase:
    """Shared representation holder: keeps one of tf/zpk/ss plus dt
    (None = continuous), converts lazily."""

    def __init__(self, *system, dt=None):
        self.dt = dt
        if len(system) == 2:
            self._form = "tf"
            self.num = np.atleast_1d(np.asarray(system[0], np.float64))
            self.den = np.atleast_1d(np.asarray(system[1], np.float64))
        elif len(system) == 3:
            self._form = "zpk"
            self.zeros = np.atleast_1d(np.asarray(system[0], complex))
            self.poles = np.atleast_1d(np.asarray(system[1], complex))
            self.gain = float(system[2])
        elif len(system) == 4:
            self._form = "ss"
            self.A, self.B, self.C, self.D = (
                np.atleast_2d(np.asarray(m, np.float64)) for m in system)
        else:
            raise ValueError("system must have 2 (tf), 3 (zpk), or 4 (ss) "
                             "elements")

    # --- conversions -----------------------------------------------------
    def _tf(self):
        if self._form == "tf":
            return self.num, self.den
        if self._form == "zpk":
            from godsp_tpu_torch.models.design import zpk2tf

            return zpk2tf(self.zeros, self.poles, self.gain)
        num, den = ss2tf(self.A, self.B, self.C, self.D)
        return num[0], den

    def _zpk(self):
        if self._form == "zpk":
            return self.zeros, self.poles, self.gain
        from godsp_tpu_torch.models.design import tf2zpk

        return tf2zpk(*self._tf())

    def _ss(self):
        if self._form == "ss":
            return self.A, self.B, self.C, self.D
        return tf2ss(*self._tf())

    def _tuple(self):
        if self._form == "tf":
            return self._tf()
        if self._form == "zpk":
            return self._zpk()
        return self._ss()

    def to_tf(self):
        cls = TransferFunction
        return cls(*self._tf(), dt=self.dt)

    def to_zpk(self):
        cls = ZerosPolesGain
        return cls(*self._zpk(), dt=self.dt)

    def to_ss(self):
        cls = StateSpace
        return cls(*self._ss(), dt=self.dt)

    def __repr__(self):
        kind = "dlti" if self.dt is not None else "lti"
        return f"{type(self).__name__}({kind}, form={self._form}, dt={self.dt})"

    # --- responses -------------------------------------------------------
    def impulse(self, X0=None, T=None, N=None):
        if self.dt is not None:
            t, y = dimpulse((*self._tuple(), self.dt), x0=X0, t=T, n=N)
            return t, y
        return impulse(self._tuple(), X0=X0, T=T, N=N)

    def step(self, X0=None, T=None, N=None):
        if self.dt is not None:
            return dstep((*self._tuple(), self.dt), x0=X0, t=T, n=N)
        return step(self._tuple(), X0=X0, T=T, N=N)

    def output(self, U, T, X0=None):
        if self.dt is not None:
            return dlsim((*self._tuple(), self.dt), U, t=T, x0=X0)
        return lsim(self._tuple(), U, T, X0=X0)

    def freqresp(self, w=None, n=10000):
        if self.dt is not None:
            return dfreqresp((*self._tuple(), self.dt), w=w, n=n)
        return freqresp(self._tuple(), w=w, n=n)

    def bode(self, w=None, n=100):
        if self.dt is not None:
            return dbode((*self._tuple(), self.dt), w=w, n=n)
        return bode(self._tuple(), w=w, n=n)

    def to_discrete(self, dt, method="zoh", alpha=None):
        if self.dt is not None:
            raise ValueError("system is already discrete")
        out = cont2discrete(self._tuple(), dt, method=method, alpha=alpha)
        return _wrap_like(self, out[:-1], out[-1])


def _wrap_like(sys_obj, body, dt):
    cls = type(sys_obj)
    if cls in (lti, dlti):
        cls = {2: TransferFunction, 3: ZerosPolesGain, 4: StateSpace}[len(body)]
    return cls(*body, dt=dt)


class TransferFunction(_SystemBase):
    """Transfer-function system (scipy.signal.TransferFunction surface):
    continuous when dt is None, discrete otherwise."""

    def __init__(self, num, den, dt=None):
        super().__init__(num, den, dt=dt)


class ZerosPolesGain(_SystemBase):
    """zpk-form system (scipy.signal.ZerosPolesGain surface)."""

    def __init__(self, z, p, k, dt=None):
        super().__init__(z, p, k, dt=dt)


class StateSpace(_SystemBase):
    """State-space system (scipy.signal.StateSpace surface)."""

    def __init__(self, A, B, C, D, dt=None):
        super().__init__(A, B, C, D, dt=dt)


class lti(_SystemBase):
    """Continuous-time system from 2/3/4-element data
    (scipy.signal.lti)."""

    def __init__(self, *system):
        super().__init__(*system, dt=None)


class dlti(_SystemBase):
    """Discrete-time system from 2/3/4-element data + dt
    (scipy.signal.dlti; dt defaults to 1.0 like scipy's True)."""

    def __init__(self, *system, dt=1.0):
        super().__init__(*system, dt=float(dt))


class _PlacedPoles:
    """Result container mirroring scipy.signal.place_poles' Bunch:
    gain_matrix, computed_poles, requested_poles, X, rtol, nb_iter."""

    def __init__(self, gain_matrix, computed_poles, requested_poles, X,
                 rtol, nb_iter):
        self.gain_matrix = gain_matrix
        self.computed_poles = computed_poles
        self.requested_poles = requested_poles
        self.X = X
        self.rtol = rtol
        self.nb_iter = nb_iter


def place_poles(A, B, poles, method: str = "YT", rtol: float = 1e-3,
                maxiter: int = 30):
    """Full-state-feedback pole placement: K with
    eig(A - B K) = poles (scipy.signal.place_poles surface).

    Single-input systems use the Ackermann formula — there the gain is
    UNIQUE, so the result matches scipy exactly.  Multi-input systems
    place each eigenvector inside its allowable subspace
    ker(Q1^T (A - lambda I)) (the same subspaces scipy's KNV0/YT
    optimizers search); candidates are drawn over `maxiter`
    deterministic trials and the best-conditioned eigenvector matrix is
    kept, so the placement is exact while the gain may differ from
    scipy's robustness-optimized one (any K with the requested spectrum
    is a valid placement).  method is accepted for API compatibility.
    """
    if method not in ("YT", "KNV0"):
        raise ValueError("method must be 'YT' or 'KNV0'")
    A = np.atleast_2d(np.asarray(A, np.float64))
    B = np.atleast_2d(np.asarray(B, np.float64))
    n = A.shape[0]
    if A.shape != (n, n) or B.shape[0] != n:
        raise ValueError("A must be square and B must have matching rows")
    poles = np.atleast_1d(np.asarray(poles, complex))
    if poles.shape != (n,):
        raise ValueError("exactly one pole per state is required")
    # complex poles must come in conjugate pairs for a real gain
    if not np.allclose(np.sort_complex(poles),
                       np.sort_complex(np.conj(poles))):
        raise ValueError("complex poles must come in conjugate pairs")
    m = B.shape[1]
    ctrb = np.hstack([np.linalg.matrix_power(A, k) @ B for k in range(n)])
    if np.linalg.matrix_rank(ctrb) < n:
        raise ValueError("the pair (A, B) is not controllable")

    if m == 1:
        # Ackermann: K = e_n^T C^-1 phi(A) — the unique SISO gain
        b = B.reshape(-1, 1)
        C = np.hstack([np.linalg.matrix_power(A, k) @ b for k in range(n)])
        phi = np.real(np.poly(poles))
        phiA = np.zeros_like(A)
        for c in phi:
            phiA = phiA @ A + c * np.eye(n)
        e = np.zeros((1, n))
        e[0, -1] = 1.0
        K = e @ np.linalg.solve(C, phiA)
        X = None
        nb_iter = 0
    else:
        Q, _ = np.linalg.qr(B, mode="complete")
        Q1 = Q[:, m:]
        eye = np.eye(n)
        bases = {}
        order = []
        pair_of = {}
        seen = {}
        for i, lam in enumerate(poles):
            key = complex(np.conj(lam))
            if key in seen and seen[key] is not None:
                pair_of[i] = seen[key]
                seen[key] = None  # each conjugate partner used once
                continue
            Mn = Q1.T @ (A - lam * eye)
            _, _, Vh = np.linalg.svd(Mn)
            bases[i] = Vh[n - m :, :].conj().T  # (n, m) allowed subspace
            order.append(i)
            seen[complex(lam)] = i
        rng_local = np.random.default_rng(0)
        best = None
        nb_iter = 0
        for _ in range(max(int(maxiter), 1)):
            nb_iter += 1
            X = np.zeros((n, n), complex)
            for i in order:
                v = bases[i] @ rng_local.normal(size=m)
                X[:, i] = v / np.linalg.norm(v)
            for i, j in pair_of.items():
                X[:, i] = np.conj(X[:, j])
            cond = np.linalg.cond(X)
            if best is None or cond < best[0]:
                best = (cond, X)
            if best[0] < 1.0 / rtol:
                break
        cond, X = best
        Lam = np.diag(poles)
        K = np.linalg.lstsq(
            B, np.real(A - X @ Lam @ np.linalg.inv(X)), rcond=None)[0]
    computed = np.linalg.eigvals(A - B @ K)
    return _PlacedPoles(K, computed, poles, X, rtol, nb_iter)
