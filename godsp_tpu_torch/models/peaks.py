"""Peak detection and measurement (scipy.signal semantics).

Port of godsp_tpu/models/peaks.py, which is host float64 numpy: peak
finding has data-dependent output shapes, so it is a host analysis path
by design (like freqz/group_delay).  A tensor given here (a spectrum on
the card, say) is brought to the host once (_host: .cpu().numpy()), as
godsp_tpu's np.asarray does; find_peaks_cwt builds its scalogram with
the port's models.wavelets.cwt (on the card for host data by default)
and reads it back once.  All math is float64 numpy; local-maxima detection is
vectorized via run-length encoding, and the per-peak prominence/width
scans follow scipy.signal's C reference behavior exactly (strictly-
decreasing min updates, interpolated half-height crossings).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["argrelextrema", "argrelmax", "argrelmin", "find_peaks", "find_peaks_cwt",
           "peak_prominences", "peak_widths", "vectorstrength"]


def _host(x):
    """A tensor as a numpy array on the host (one copy); anything else as is."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _as_1d_f64(x) -> np.ndarray:
    x = np.asarray(_host(x), np.float64)
    if x.ndim != 1:
        raise ValueError("x must be 1-D")
    return x


def _local_maxima(x: np.ndarray):
    """All interior local maxima with plateau handling: returns
    (midpoints, left_edges, right_edges), each plateau reported once at
    its (floor) midpoint — scipy.signal._local_maxima_1d semantics."""
    n = x.shape[0]
    if n < 3:
        e = np.array([], np.intp)
        return e, e, e
    change = np.flatnonzero(np.diff(x)) + 1  # start of each new run
    starts = np.concatenate([[0], change]).astype(np.intp)
    ends = np.concatenate([change, [n]]).astype(np.intp) - 1  # inclusive
    vals = x[starts]
    if vals.shape[0] < 3:
        e = np.array([], np.intp)
        return e, e, e
    is_max = (vals[1:-1] > vals[:-2]) & (vals[1:-1] > vals[2:])
    runs = np.flatnonzero(is_max) + 1
    left = starts[runs]
    right = ends[runs]
    mid = (left + right) // 2
    return mid.astype(np.intp), left, right


def _prom_one(x: np.ndarray, peak: int, i_min: int, i_max: int):
    """Prominence and bases of one peak inside the window [i_min, i_max]
    (scipy's scan: walk out to the next higher sample or the window
    edge, tracking the running min with strictly-less updates)."""
    h = x[peak]
    left_base = peak
    left_min = h
    i = peak
    while i > i_min and x[i] <= h:
        i -= 1
        if x[i] < left_min:
            left_min = x[i]
            left_base = i
        if x[i] > h:
            break
    right_base = peak
    right_min = h
    i = peak
    while i < i_max and x[i] <= h:
        i += 1
        if x[i] < right_min:
            right_min = x[i]
            right_base = i
        if x[i] > h:
            break
    return h - max(left_min, right_min), left_base, right_base


def peak_prominences(x, peaks, wlen: int | None = None):
    """Prominence of each peak (scipy.signal.peak_prominences): the
    drop from the peak to the higher of the two bases — the minima
    between the peak and its nearest higher samples (or the wlen-window
    / signal edges).  Returns (prominences, left_bases, right_bases)."""
    x = _as_1d_f64(x)
    peaks = np.asarray(_host(peaks), np.intp)
    if peaks.ndim != 1:
        raise ValueError("peaks must be 1-D")
    if peaks.size and (peaks.min() < 0 or peaks.max() >= x.shape[0]):
        raise ValueError("a peak index is out of range")
    if wlen is not None:
        wlen = int(np.ceil(wlen))
        if wlen < 3:
            raise ValueError("wlen must be at least 3")
    prom = np.empty(peaks.shape[0])
    lb = np.empty(peaks.shape[0], np.intp)
    rb = np.empty(peaks.shape[0], np.intp)
    n = x.shape[0]
    for j, p in enumerate(peaks):
        if wlen is None:
            i_min, i_max = 0, n - 1
        else:
            half = wlen // 2
            i_min, i_max = max(0, p - half), min(n - 1, p + half)
        prom[j], lb[j], rb[j] = _prom_one(x, int(p), i_min, i_max)
    return prom, lb, rb


def peak_widths(x, peaks, rel_height: float = 0.5, prominence_data=None,
                wlen: int | None = None):
    """Width of each peak at `rel_height` of its prominence
    (scipy.signal.peak_widths): interpolated crossings of the
    evaluation height on both flanks, bounded by the prominence bases.
    Returns (widths, width_heights, left_ips, right_ips)."""
    x = _as_1d_f64(x)
    peaks = np.asarray(_host(peaks), np.intp)
    if rel_height < 0:
        raise ValueError("rel_height must be >= 0")
    if prominence_data is None:
        prominence_data = peak_prominences(x, peaks, wlen)
    prom, lb, rb = prominence_data
    widths = np.empty(peaks.shape[0])
    heights = np.empty(peaks.shape[0])
    lips = np.empty(peaks.shape[0])
    rips = np.empty(peaks.shape[0])
    for j, p in enumerate(peaks):
        height = x[p] - prom[j] * rel_height
        heights[j] = height
        i = int(p)
        while lb[j] < i and height < x[i]:
            i -= 1
        lip = float(i)
        if x[i] < height:  # interpolate the crossing
            lip += (height - x[i]) / (x[i + 1] - x[i])
        i = int(p)
        while i < rb[j] and height < x[i]:
            i += 1
        rip = float(i)
        if x[i] < height:
            rip -= (height - x[i]) / (x[i - 1] - x[i])
        lips[j], rips[j] = lip, rip
        widths[j] = rip - lip
    return widths, heights, lips, rips


def _select_by_distance(peaks: np.ndarray, priority: np.ndarray,
                        distance: float) -> np.ndarray:
    """Greedy keep-highest-first thinning: drop any peak within
    `distance` of an already-kept higher-priority peak (scipy's
    _select_by_peak_distance)."""
    n = peaks.shape[0]
    keep = np.ones(n, bool)
    # iterate from highest priority down; peaks is sorted ascending
    for j in np.argsort(priority)[::-1]:
        if not keep[j]:
            continue
        k = j - 1
        while k >= 0 and peaks[j] - peaks[k] < distance:
            keep[k] = False
            k -= 1
        k = j + 1
        while k < n and peaks[k] - peaks[j] < distance:
            keep[k] = False
            k += 1
    return keep


def _unpack_minmax(interval, x_size: int, peaks: np.ndarray):
    """(min, max) per-peak arrays from a scalar / (min, max) pair /
    full-signal array spec (scipy's _unpack_condition_args: a border
    array must match x's size and is reduced to the peaks)."""

    def one(v):
        if v is None:
            return None
        v = np.asarray(_host(v), float)
        if v.ndim == 0:
            return np.broadcast_to(v, peaks.shape)
        if v.shape[0] != x_size:
            raise ValueError(
                "array borders must match the size of x"
            )
        return v[peaks]

    # scipy's unpack rule: anything that unpacks into exactly two
    # elements (tuple, list, OR 2-element ndarray) is a (min, max)
    # interval; everything else is a bare minimum
    try:
        lo, hi = interval
    except (TypeError, ValueError):
        lo, hi = interval, None
    return one(lo), one(hi)


def find_peaks(
    x,
    height=None,
    threshold=None,
    distance: float | None = None,
    prominence=None,
    width=None,
    wlen: int | None = None,
    rel_height: float = 0.5,
    plateau_size=None,
):
    """Find local maxima satisfying the given conditions
    (scipy.signal.find_peaks): conditions are evaluated in scipy's
    order (plateau_size, height, threshold, distance, prominence,
    width), each as a scalar minimum, (min, max) pair, or per-sample
    arrays.  Returns (peaks, properties)."""
    x = _as_1d_f64(x)
    if distance is not None and distance < 1:
        raise ValueError("distance must be >= 1")
    peaks, left_edges, right_edges = _local_maxima(x)
    props: dict[str, np.ndarray] = {}

    def _keep(mask):
        nonlocal peaks
        peaks = peaks[mask]
        for k in props:
            props[k] = props[k][mask]

    if plateau_size is not None:
        lo, hi = _unpack_minmax(plateau_size, x.shape[0], peaks)
        sizes = right_edges - left_edges + 1
        props["plateau_sizes"] = sizes
        props["left_edges"] = left_edges
        props["right_edges"] = right_edges
        mask = np.ones(peaks.size, bool)
        if lo is not None:
            mask &= sizes >= lo
        if hi is not None:
            mask &= sizes <= hi
        _keep(mask)
    if height is not None:
        lo, hi = _unpack_minmax(height, x.shape[0], peaks)
        hts = x[peaks]
        props["peak_heights"] = hts
        mask = np.ones(peaks.size, bool)
        if lo is not None:
            mask &= hts >= lo
        if hi is not None:
            mask &= hts <= hi
        _keep(mask)
    if threshold is not None:
        lo, hi = _unpack_minmax(threshold, x.shape[0], peaks)
        tl = x[peaks] - x[peaks - 1]
        tr = x[peaks] - x[peaks + 1]
        props["left_thresholds"] = tl
        props["right_thresholds"] = tr
        mask = np.ones(peaks.size, bool)
        if lo is not None:
            mask &= np.minimum(tl, tr) >= lo
        if hi is not None:
            mask &= np.maximum(tl, tr) <= hi
        _keep(mask)
    if distance is not None:
        _keep(_select_by_distance(peaks, x[peaks], distance))
    if prominence is not None or width is not None:
        prom, lb, rb = peak_prominences(x, peaks, wlen)
        props["prominences"] = prom
        props["left_bases"] = lb
        props["right_bases"] = rb
    if prominence is not None:
        lo, hi = _unpack_minmax(prominence, x.shape[0], peaks)
        mask = np.ones(peaks.size, bool)
        if lo is not None:
            mask &= props["prominences"] >= lo
        if hi is not None:
            mask &= props["prominences"] <= hi
        _keep(mask)
    if width is not None:
        w, wh, lip, rip = peak_widths(
            x, peaks, rel_height,
            (props["prominences"], props["left_bases"], props["right_bases"]),
        )
        props["widths"] = w
        props["width_heights"] = wh
        props["left_ips"] = lip
        props["right_ips"] = rip
        lo, hi = _unpack_minmax(width, x.shape[0], peaks)
        mask = np.ones(peaks.size, bool)
        if lo is not None:
            mask &= w >= lo
        if hi is not None:
            mask &= w <= hi
        _keep(mask)
    return peaks, props


def _boolrel(data: np.ndarray, comparator, axis: int, order: int,
             mode: str) -> np.ndarray:
    """True where data compares favorably to every neighbor within
    `order` along axis (scipy.signal._boolrelextrema semantics:
    mode 'clip' repeats the edge value, 'wrap' wraps)."""
    data = np.asarray(_host(data))
    if order < 1:
        raise ValueError("order must be >= 1")
    if mode not in ("clip", "wrap"):
        raise ValueError("mode must be 'clip' or 'wrap'")
    locs = np.arange(data.shape[axis])
    results = np.ones(data.shape, dtype=bool)
    main = data.take(locs, axis=axis)
    for shift in range(1, order + 1):
        if mode == "clip":
            plus = np.clip(locs + shift, 0, locs[-1])
            minus = np.clip(locs - shift, 0, locs[-1])
        else:
            plus = (locs + shift) % data.shape[axis]
            minus = (locs - shift) % data.shape[axis]
        results &= comparator(main, data.take(plus, axis=axis))
        results &= comparator(main, data.take(minus, axis=axis))
        if ~results.any():
            return results
    return results


def argrelextrema(data, comparator, axis: int = 0, order: int = 1,
                  mode: str = "clip"):
    """Indices of the relative extrema of data under `comparator`
    (scipy.signal.argrelextrema; host numpy — the output is a
    data-dependent index tuple)."""
    return np.nonzero(_boolrel(data, comparator, axis, order, mode))


def argrelmax(data, axis: int = 0, order: int = 1, mode: str = "clip"):
    """Relative maxima indices (scipy.signal.argrelmax: strict >)."""
    return argrelextrema(data, np.greater, axis, order, mode)


def argrelmin(data, axis: int = 0, order: int = 1, mode: str = "clip"):
    """Relative minima indices (scipy.signal.argrelmin: strict <)."""
    return argrelextrema(data, np.less, axis, order, mode)


def vectorstrength(events, period):
    """Vector strength (phase locking) of event times to one or more
    periods (scipy.signal.vectorstrength): the resultant length and
    angle of the unit phasors e^{2 pi i t/T}.  Returns (strength,
    phase) shaped like `period`."""
    events = np.asarray(_host(events), np.float64)
    period = np.asarray(_host(period), np.float64)
    if events.ndim != 1:
        raise ValueError("events must be 1-D")
    if period.ndim > 1:
        raise ValueError("period must be a scalar or 1-D")
    if np.any(period <= 0):
        raise ValueError("periods must be positive")
    scalar = period.ndim == 0
    p = np.atleast_1d(period)
    ang = 2.0 * np.pi * events[None, :] / p[:, None]
    vec = np.exp(1j * ang).mean(axis=1)
    strength, phase = np.abs(vec), np.angle(vec)
    if scalar:
        return float(strength[0]), float(phase[0])
    return strength, phase


def _link_ridge_lines(mat: np.ndarray, max_distances, gap_thresh):
    """Connect per-row relative maxima of a scalogram into ridge lines
    (the Du et al. 2006 linking rule, scipy.signal semantics): walk from
    the widest scale down, attach each maximum to the nearest active
    line within max_distances[row], and retire lines whose gap count
    exceeds gap_thresh.  Returns [rows, cols] arrays per line."""
    is_max = _boolrel(mat, np.greater, axis=1, order=1, mode="clip")
    rows_with = np.nonzero(is_max.any(axis=1))[0]
    if len(rows_with) == 0:
        return []
    top = rows_with[-1]
    active = [{"rows": [top], "cols": [c], "gap": 0}
              for c in np.nonzero(is_max[top])[0]]
    retired = []
    for row in range(top - 1, -1, -1):
        for line in active:
            line["gap"] += 1
        prev_cols = np.array([line["cols"][-1] for line in active])
        for col in np.nonzero(is_max[row])[0]:
            line = None
            if len(prev_cols):
                nearest = int(np.argmin(np.abs(col - prev_cols)))
                if abs(col - prev_cols[nearest]) <= max_distances[row]:
                    line = active[nearest]
            if line is not None:
                line["rows"].append(row)
                line["cols"].append(col)
                line["gap"] = 0
            else:
                active.append({"rows": [row], "cols": [col], "gap": 0})
        for i in range(len(active) - 1, -1, -1):
            if active[i]["gap"] > gap_thresh:
                retired.append(active.pop(i))
    out = []
    for line in retired + active:
        order = np.argsort(line["rows"])
        out.append([np.asarray(line["rows"])[order],
                    np.asarray(line["cols"])[order]])
    return out


def find_peaks_cwt(vector, widths, wavelet=None, max_distances=None,
                   gap_thresh=None, min_length=None, min_snr: float = 1.0,
                   noise_perc: float = 10.0, window_size=None) -> np.ndarray:
    """Wavelet-based peak finding (scipy.signal.find_peaks_cwt): build a
    CWT scalogram (ricker by default, one batched FFT convolution via
    models.wavelets.cwt), link per-scale maxima into ridge lines, and
    keep lines long enough and with sufficient smallest-scale SNR."""
    vector = np.asarray(_host(vector), np.float64)
    widths = np.atleast_1d(np.asarray(widths, np.float64))
    if gap_thresh is None:
        gap_thresh = np.ceil(widths[0])
    if max_distances is None:
        max_distances = widths / 4.0
    max_distances = np.asarray(max_distances)
    if len(max_distances) < len(widths):
        raise ValueError("max_distances must cover every width")
    from godsp_tpu_torch.models.wavelets import cwt, ricker

    mat = np.asarray(_host(cwt(vector, wavelet or ricker, widths)), np.float64)
    lines = _link_ridge_lines(mat, max_distances, gap_thresh)

    n = mat.shape[1]
    if min_length is None:
        min_length = np.ceil(mat.shape[0] / 4)
    if window_size is None:
        window_size = np.ceil(n / 20)
    half, odd = divmod(int(window_size), 2)
    row0 = mat[0]
    noises = np.array([
        np.percentile(row0[max(i - half, 0) : min(i + half + odd, n)],
                      noise_perc)
        for i in range(n)
    ])
    locs = []
    for rows, cols in lines:
        if len(rows) < min_length:
            continue
        denom = noises[cols[0]]
        snr = abs(mat[rows[0], cols[0]] / denom) if denom != 0 else np.inf
        if snr >= min_snr:
            locs.append(cols[0])
    return np.asarray(sorted(locs))
