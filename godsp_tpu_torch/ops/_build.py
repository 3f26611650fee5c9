"""Build and load the hand-written CUDA kernels (godsp_tpu_torch/csrc).

The sources compile with nvcc into one shared library with a plain C
interface, loaded with ctypes: one nvcc per source, all started
together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c csrc/<name>.cu -o <tmp>/<name>.o   (each)
    nvcc -shared -o _build/libgodsp_cuda_<hash>.so <tmp>/*.o

The build runs at first use, never at import, so the package imports on
a machine without nvcc.  The library lands in the package's git-ignored
_build/ directory, keyed by a hash of every .cu/.cuh source, so a
changed source builds anew and an unchanged one loads at once.  Any
build or load failure raises: there is no fallback route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

__all__ = ["build_seconds", "check", "library"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_lock = threading.Lock()
_lib = None
build_seconds = 0.0  # wall seconds of the last nvcc run in this process


def _sources() -> list[pathlib.Path]:
    """Every CUDA source of the library, in a stable order."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _declare(lib) -> None:
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.gdsp_fft_pow2.argtypes = [p, p, p, p, p, i, i64, f, i, p]
    lib.gdsp_fft_pow2.restype = i
    lib.gdsp_rfft_pow2.argtypes = [p, p, p, p, i, i64, p]
    lib.gdsp_rfft_pow2.restype = i
    lib.gdsp_fft_pow2_geometry.argtypes = [i, p]
    lib.gdsp_fft_pow2_geometry.restype = i
    lib.gdsp_fft_pow2_radix2.argtypes = [p, p, p, p, p, i, i, i64, f, p]
    lib.gdsp_fft_pow2_radix2.restype = i
    for name in ("gdsp_pwelch_partials", "gdsp_pwelch_radix2"):
        getattr(lib, name).argtypes = [p, p, p, p, p, i64, i64, i64, i, i, i, i, i, p]
        getattr(lib, name).restype = i
    lib.gdsp_pwelch_partials_halo.argtypes = [
        p, i64, i64, p, i64, i64, p, i64, p, p, p, i64, i64, i, i, i, i, i, p,
    ]
    lib.gdsp_pwelch_partials_halo.restype = i
    lib.gdsp_ring_halo.argtypes = [p, p, i, i, i, p, i64, i, i, p]
    lib.gdsp_ring_halo.restype = i
    lib.gdsp_ring_halo_view.argtypes = [p, i64, i64, i, p, i64, i, i, p]
    lib.gdsp_ring_halo_view.restype = i
    lib.gdsp_enable_peer.argtypes = [i, i]
    lib.gdsp_enable_peer.restype = i
    for name in ("gdsp_csd_partials", "gdsp_csd_radix2"):
        getattr(lib, name).argtypes = [p, p, p, p, p, p, p, i64, i64, i64, i, i, i, i, i, p]
        getattr(lib, name).restype = i
    for name in ("gdsp_pwelch_geometry", "gdsp_csd_geometry"):
        getattr(lib, name).argtypes = [i, i, p]
        getattr(lib, name).restype = i
    for name in ("gdsp_stft", "gdsp_stft_radix2"):
        getattr(lib, name).argtypes = [p, p, p, p, p, p, i64, i64, i64, i, i64, i, i, i, p]
        getattr(lib, name).restype = i
    lib.gdsp_istft_ola.argtypes = [p, p, p, p, p, i64, i64, i, i, i, i, i, i, i64, i, f, p]
    lib.gdsp_istft_ola.restype = i
    lib.gdsp_istft_radix2.argtypes = [p, p, p, p, i64, i64, i, i, i, i, i, i, i64, f, p]
    lib.gdsp_istft_radix2.restype = i
    lib.gdsp_istft_geometry.argtypes = [i, i, p]
    lib.gdsp_istft_geometry.restype = i
    lib.gdsp_outer_dft.argtypes = [p, p, p, p, p, p, p, p, i, i, i64, i64, i, i, p]
    lib.gdsp_outer_dft.restype = i
    lib.gdsp_outer_dft_geometry.argtypes = [i, p]
    lib.gdsp_outer_dft_geometry.restype = i
    lib.gdsp_outer_dft_radix2.argtypes = [p, p, p, p, p, p, p, i, i, i64, i64, i, p]
    lib.gdsp_outer_dft_radix2.restype = i
    lib.gdsp_peel_rows.argtypes = [p, p, p, p, p, p, p, p, p, i, i64, i, i, f, p]
    lib.gdsp_peel_rows.restype = i
    lib.gdsp_peel_rows_radix2.argtypes = [p, p, p, p, p, p, p, p, i, i64, i, f, p]
    lib.gdsp_peel_rows_radix2.restype = i
    lib.gdsp_peel_rows_geometry.argtypes = [i, p]
    lib.gdsp_peel_rows_geometry.restype = i
    lib.gdsp_copy_split.argtypes = [p, p, p, p, i64, p]
    lib.gdsp_copy_split.restype = i
    for name in ("gdsp_gmm_floor", "gdsp_gmm_floor_sync"):
        getattr(lib, name).argtypes = [p, p, p, p, p, i64, i, i, p]
        getattr(lib, name).restype = i
    lib.gdsp_gmm_floor_resident.argtypes = [i]
    lib.gdsp_gmm_floor_resident.restype = i
    lib.gdsp_gmm_floor_geometry.argtypes = [i64, i, i, p]
    lib.gdsp_gmm_floor_geometry.restype = i
    lib.gdsp_pwfloor_loadonly.argtypes = [p, p, p, p, i64, i64, i64, i, i, i, i, i, p]
    lib.gdsp_pwfloor_loadonly.restype = i
    for name in ("gdsp_pwfloor_frameonly", "gdsp_pwfloor_frameonly_shared"):
        getattr(lib, name).argtypes = [p, p, p, p, i64, i64, i64, i, i, i, i, i, p]
        getattr(lib, name).restype = i
    for name in ("gdsp_pwfloor_noframe", "gdsp_pwfloor_noframe_radix2"):
        getattr(lib, name).argtypes = [p, p, p, p, p, i64, i64, i, i, i, p]
        getattr(lib, name).restype = i
    for name in ("gdsp_pwfloor_staged", "gdsp_pwfloor_staged_radix2"):
        getattr(lib, name).argtypes = [p, p, p, p, p, i64, i64, i64, i, i, i, i, i, p]
        getattr(lib, name).restype = i
    lib.gdsp_pwfloor_staged_geometry.argtypes = [i, i, i, i, p]
    lib.gdsp_pwfloor_staged_geometry.restype = i
    lib.gdsp_fac_dft.argtypes = [p, p, p, p, p, i64, i, p]
    lib.gdsp_fac_dft.restype = i
    for name in ("gdsp_slicestore", "gdsp_slicestore_sync"):
        getattr(lib, name).argtypes = [p, p, p, p, i64, i, p]
        getattr(lib, name).restype = i
    lib.gdsp_concatstore.argtypes = [p, p, p, p, i64, i, p]
    lib.gdsp_concatstore.restype = i
    lib.gdsp_gmm_concat.argtypes = [p, p, p, p, p, i64, i, i, p]
    lib.gdsp_gmm_concat.restype = i
    lib.gdsp_gmm_concat_stream.argtypes = [p, p, p, p, p, i64, i, p]
    lib.gdsp_gmm_concat_stream.restype = i
    for name in ("gdsp_gmm_concat_resident", "gdsp_ls_full_resident"):
        getattr(lib, name).argtypes = [i, i]
        getattr(lib, name).restype = i
    lib.gdsp_lane_cluster_geometry.argtypes = [i, i64, i, i, i, i, i, p]
    lib.gdsp_lane_cluster_geometry.restype = i
    for name in ("gdsp_half3", "gdsp_slice8_add", "gdsp_slice8_add_sync", "gdsp_reshape_add"):
        getattr(lib, name).argtypes = [p, p, p, p, i64, i, p]
        getattr(lib, name).restype = i
    for name in ("gdsp_bd_tf32_sync", "gdsp_bd_hi_sync", "gdsp_vdif", "gdsp_vdif_sync"):
        getattr(lib, name).argtypes = [p, p, p, p, p, i64, i, p]
        getattr(lib, name).restype = i
    lib.gdsp_bd_tf32.argtypes = [p, p, p, p, p, i64, i, i, p]
    lib.gdsp_bd_tf32.restype = i
    lib.gdsp_bd_tf32_resident.argtypes = [i]
    lib.gdsp_bd_tf32_resident.restype = i
    lib.gdsp_bd_tf32_geometry.argtypes = [i64, i, i, p]
    lib.gdsp_bd_tf32_geometry.restype = i
    lib.gdsp_vdif_geometry.argtypes = [i64, i, p]
    lib.gdsp_vdif_geometry.restype = i
    lib.gdsp_bd_hi.argtypes = [p, p, p, p, p, i64, i, i, p]
    lib.gdsp_bd_hi.restype = i
    lib.gdsp_bd_hi_resident.argtypes = [i]
    lib.gdsp_bd_hi_resident.restype = i
    lib.gdsp_bd_hi_geometry.argtypes = [i64, i, i, p]
    lib.gdsp_bd_hi_geometry.restype = i
    lib.gdsp_anat_full.argtypes = [p, p, p, p, p, p, i64, i, i, p]
    lib.gdsp_anat_full.restype = i
    lib.gdsp_anat_full_sync.argtypes = [p, p, p, p, p, p, i64, i, p]
    lib.gdsp_anat_full_sync.restype = i
    lib.gdsp_anat_full_resident.argtypes = [i]
    lib.gdsp_anat_full_resident.restype = i
    lib.gdsp_anat_full_geometry.argtypes = [i64, i, i, p]
    lib.gdsp_anat_full_geometry.restype = i
    lib.gdsp_sdif_peel.argtypes = [p, p, p, p, p, p, p, p, i64, i64, i, p]
    lib.gdsp_sdif_peel.restype = i
    lib.gdsp_sdif_peel_sync.argtypes = [p, p, p, p, p, p, p, i64, i64, i, p]
    lib.gdsp_sdif_peel_sync.restype = i
    lib.gdsp_sdif_geometry.argtypes = [i64, i64, p]
    lib.gdsp_sdif_geometry.restype = i
    lib.gdsp_fft_pow2_rows.argtypes = [p, p, p, p, p, i, i64, f, i, i, p]
    lib.gdsp_fft_pow2_rows.restype = i
    lib.gdsp_ls_network.argtypes = [p, p, p, p, i64, i, p]
    lib.gdsp_ls_network.restype = i
    lib.gdsp_gmm_tf32.argtypes = [p, p, p, p, p, i64, i, i, p]
    lib.gdsp_gmm_tf32.restype = i
    lib.gdsp_gmm_tf32_sync.argtypes = [p, p, p, p, p, i64, i, i, p]
    lib.gdsp_gmm_tf32_sync.restype = i
    lib.gdsp_gmm_tf32_resident.argtypes = [i]
    lib.gdsp_gmm_tf32_resident.restype = i
    lib.gdsp_gmm_tf32_geometry.argtypes = [i64, i, i, p]
    lib.gdsp_gmm_tf32_geometry.restype = i
    lib.gdsp_ls_full.argtypes = [p, p, p, p, p, i64, i, i, i, i, i, p]
    lib.gdsp_ls_full.restype = i
    lib.gdsp_ls_full_stream.argtypes = [p, p, p, p, p, i64, i, i, i, i, p]
    lib.gdsp_ls_full_stream.restype = i
    lib.gdsp_lane_flip.argtypes = [p, p, i64, p]
    lib.gdsp_lane_flip.restype = i
    for name in ("gdsp_i8_dot", "gdsp_i8_dot_bytes"):
        getattr(lib, name).argtypes = [p, p, p, i64, i, i, p]
        getattr(lib, name).restype = i
    lib.gdsp_i8_dot_geometry.argtypes = [i64, i, i, i, p]
    lib.gdsp_i8_dot_geometry.restype = i
    for name in ("gdsp_i8mm", "gdsp_i8dec"):
        getattr(lib, name).argtypes = [p, p, p, p, p, i64, i, p]
        getattr(lib, name).restype = i
    lib.gdsp_i8full.argtypes = [p, p, p, p, p, i64, i, i, i, p]
    lib.gdsp_i8full.restype = i
    for name in ("gdsp_i8_concat_stream", "gdsp_i8full_sync"):
        getattr(lib, name).argtypes = [p, p, p, p, p, i64, i, p]
        getattr(lib, name).restype = i
    lib.gdsp_i8_concat_resident.argtypes = [i, i]
    lib.gdsp_i8_concat_resident.restype = i
    lib.gdsp_i8full_resident.argtypes = []
    lib.gdsp_i8full_resident.restype = i
    lib.gdsp_i8full_geometry.argtypes = [i64, i, i, p]
    lib.gdsp_i8full_geometry.restype = i


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of any that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failed = []
    for c, p in zip(cmds, procs):
        out, err = p.communicate()
        if p.returncode != 0:
            failed.append(f"{' '.join(c)} ({p.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _compile(srcs: list[pathlib.Path], so: pathlib.Path) -> None:
    """One nvcc per .cu source, all started together, then one link into so.
    Objects and the unlinked library live in a temporary directory beside
    so, removed whether the build succeeds or fails."""
    cus = [s for s in srcs if s.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=so.parent) as objdir:
        objs = [os.path.join(objdir, f"{s.stem}.o") for s in cus]
        _run_all([
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-I", str(CSRC), "-c", str(s), "-o", o]
            for s, o in zip(cus, objs)
        ])
        tmp = os.path.join(objdir, so.name)
        _run_all([[_nvcc(), "-shared", "-o", tmp, *objs]])
        os.replace(tmp, so)


def library():
    """The loaded kernel library, built from the sources on first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        h = hashlib.sha256()
        for s in srcs:
            h.update(s.name.encode())
            h.update(s.read_bytes())
        so = BUILD_DIR / f"libgodsp_cuda_{h.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            _compile(srcs, so)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error (its cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
