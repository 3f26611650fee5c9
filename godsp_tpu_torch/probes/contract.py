"""What bounds K13's contraction from shared memory on the card: the
register tile, timed without device-memory traffic.

    python3 -m godsp_tpu_torch.probes.contract

gmm_floor, gmm_concat and ls_full run K13's Karatsuba chain (m1 = a G_r,
m2 = b G_i, m3 = (a + b) G_s, fmaf over i2 in order) on the CUDA cores with
G[k1] (192 KB) and a row tile in shared memory.  This probe times that
inner loop alone at several register tiles: each of 132 CTAs stages a
G-sized table and one tile once, then runs the chain over the tile many
times, reading both from shared memory, with nothing read from or written
to device memory in the loop.  Each variant does the same work, 64 x 16
16-row steps an SM; a line gives ns a 16-row x 128-bin i2 step (6
float32 operations a row, bin and i2) and the TFLOP/s that makes on the
card.  The variants (threads a CTA, rows x bins a thread, tile rows):

  128, 4 x 4, 16   gmm_concat's and ls_full's (csrc/lane_contract.cuh)
  256, 2 x 4, 16   the same tile on twice the threads
  256, 4 x 4, 32   twice the tile (no room beside G for two buffers)
  128, 8 x 4, 32   twice the tile on the same threads
  64,  8 x 4, 16   gmm_concat's tile on half the threads

The source is built with nvcc into a temporary directory (the
port's kernel library is not touched); it needs one GPU.  The last line
is {"contract": {variant: ns a step}}.

    python3 -m godsp_tpu_torch.probes.contract --breakdown

times gmm_concat's cluster kernel at 16384 x 1024 (zero planes; CUDA
events over 20 back-to-back launches) as it is and with parts of its tile
loop taken out of a copy of csrc/lane_probe_kernels.cu (BREAKDOWN: the
whole-row gather of the last tile, the next tile's load, both), built with
a small C++ main program: what each part costs beside the contraction.  The
copies compute wrong results on purpose; the last line is
{"breakdown": {variant: ms}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile

__all__ = ["BREAKDOWN", "HARNESS", "SOURCE", "VARIANTS", "breakdown_source", "main", "source"]

# (threads, rows a thread, bins a thread, tile rows)
VARIANTS = ((128, 4, 4, 16), (256, 2, 4, 16), (256, 4, 4, 32), (128, 8, 4, 32), (64, 8, 4, 16))

SOURCE = r'''
#include <cuda_runtime.h>
#include <cstdio>
constexpr int L = 128, PL = L * L, PITCH = 132;
__device__ __forceinline__ float lo(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <int T, int R, int C, int ROWS>
__global__ void __launch_bounds__(T, 1) kern(const float* g, float* out, int reps) {
  extern __shared__ float4 sm4[];
  float* sg = (float*)sm4;
  float* sx = sg + 3 * PL;  // ROWS x PITCH x 2 planes
  for (int e = threadIdx.x; e < 3 * PL; e += T) sg[e] = g[e];
  for (int e = threadIdx.x; e < 2 * ROWS * PITCH; e += T) sx[e] = g[e % 4096] * 0.5f;
  __syncthreads();
  constexpr int BG = L / C;           // bin groups
  const int bg = threadIdx.x % BG, rg = threadIdx.x / BG;
  const int bin = bg * C, row = rg * R;
  float acc_sum = 0.f;
  for (int rep = 0; rep < reps; ++rep) {
    float m1[R][C], m2[R][C], m3[R][C];
#pragma unroll
    for (int e = 0; e < R; ++e)
#pragma unroll
      for (int q = 0; q < C; ++q) m1[e][q] = m2[e][q] = m3[e][q] = 0.f;
#pragma unroll 2
    for (int i = 0; i < L; i += 4) {
      float4 a[R], b[R];
#pragma unroll
      for (int e = 0; e < R; ++e) {
        a[e] = *(const float4*)(sx + (row + e) * PITCH + i);
        b[e] = *(const float4*)(sx + ROWS * PITCH + (row + e) * PITCH + i);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float* gp = sg + (i + ii) * L + bin;
        float gr[C], gi[C], gs[C];
#pragma unroll
        for (int q = 0; q < C; q += 4) {
          const float4 x = *(const float4*)(gp + q), y = *(const float4*)(gp + PL + q);
          const float4 z = *(const float4*)(gp + 2 * PL + q);
          gr[q] = x.x; gr[q+1] = x.y; gr[q+2] = x.z; gr[q+3] = x.w;
          gi[q] = y.x; gi[q+1] = y.y; gi[q+2] = y.z; gi[q+3] = y.w;
          gs[q] = z.x; gs[q+1] = z.y; gs[q+2] = z.z; gs[q+3] = z.w;
        }
#pragma unroll
        for (int e = 0; e < R; ++e) {
          const float ar = lo(a[e], ii), ai = lo(b[e], ii), as = ar + ai;
#pragma unroll
          for (int q = 0; q < C; ++q) {
            m1[e][q] = fmaf(ar, gr[q], m1[e][q]);
            m2[e][q] = fmaf(ai, gi[q], m2[e][q]);
            m3[e][q] = fmaf(as, gs[q], m3[e][q]);
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < R; ++e)
#pragma unroll
      for (int q = 0; q < C; ++q) acc_sum += m1[e][q] - m2[e][q] + m3[e][q];
  }
  out[blockIdx.x * T + threadIdx.x] = acc_sum;
}


template <int T, int R, int C, int ROWS>
void run(const float* g, float* out) {
  static_assert((L / C) * (ROWS / R) == T, "tile");
  const int smem = (3 * PL + 2 * ROWS * PITCH) * 4;
  cudaFuncSetAttribute(kern<T, R, C, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int reps = 64 * 16 / ROWS;
  kern<T, R, C, ROWS><<<132, T, smem>>>(g, out, reps);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int k = 0; k < 5; ++k) kern<T, R, C, ROWS><<<132, T, smem>>>(g, out, reps);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double steps = 5.0 * 64 * 128;  // 16-row i2 steps an SM
  const double flops = 5.0 * 132 * 64 * 16 * 128 * 128 * 6.0;
  printf("%d %d %d %d %.4f %.4f %s\n", T, R, C, ROWS, ms * 1e6 / steps, flops / (ms * 1e-3) / 1e12,
         cudaGetErrorString(cudaGetLastError()));
}

int main() {
  float *g, *out;
  cudaMalloc(&g, 3 * PL * 4);
  cudaMalloc(&out, 132 * 256 * 4);
  cudaMemset(g, 0, 3 * PL * 4);
@RUNS@
  return 0;
}
'''


# gmm_concat_kernel's lines each variant takes out (each occurs once in
# csrc/lane_probe_kernels.cu; tests/test_torch_lane_plan.py checks).
GATHER_LINE = "      ln::gather_rows(other, yr, yi, b, n, tile - per_chunk, c0, cols, rank, cs);\n"
LOAD_LINE = ("    if (live && i + 1 < steps) load_slice(other, xr, xi, b, n, tile + per_chunk, "
             "cr);\n")
BREAKDOWN = {"as built": (), "no gather": (GATHER_LINE,), "no next-tile load": (LOAD_LINE,),
             "neither": (GATHER_LINE, LOAD_LINE)}

HARNESS = r'''
#include "lane_probe_kernels.cu"
#include <cstdio>
int main() {
  const long long b = 16384;
  const int n = 1024;
  float *xr, *xi, *yr, *yi, *g;
  cudaMalloc(&xr, b * n * 4);
  cudaMalloc(&xi, b * n * 4);
  cudaMalloc(&yr, b * n * 4);
  cudaMalloc(&yi, b * n * 4);
  cudaMalloc(&g, 8 * 3 * 128 * 128 * 4);
  cudaMemset(xr, 0, b * n * 4);
  cudaMemset(xi, 0, b * n * 4);
  cudaMemset(g, 0, 8 * 3 * 128 * 128 * 4);
  const int resident = gdsp_gmm_concat_resident(n, 0);
  const int rc = gdsp_gmm_concat(xr, xi, yr, yi, g, b, n, resident, 0);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  for (int k = 0; k < 20; ++k) gdsp_gmm_concat(xr, xi, yr, yi, g, b, n, resident, 0);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  printf("%d %d %.4f %s\n", rc, resident, ms / 20, cudaGetErrorString(cudaGetLastError()));
  return 0;
}
'''


def breakdown_source(csrc: str, variant: str) -> str:
    """lane_probe_kernels.cu's text with BREAKDOWN[variant]'s lines taken out."""
    for line in BREAKDOWN[variant]:
        if csrc.count(line) != 1:
            raise ValueError(f"contract probe: {line.strip()!r} is not in the source once")
        csrc = csrc.replace(line, "")
    return csrc


def breakdown() -> dict[str, float]:
    """gmm_concat's ms at 16384 x 1024 for each BREAKDOWN variant."""
    import pathlib
    import shutil

    from godsp_tpu_torch.ops import _build

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, variant in enumerate(BREAKDOWN):
            d = pathlib.Path(tmp) / str(i)
            shutil.copytree(_build.CSRC, d)
            src = (d / "lane_probe_kernels.cu").read_text()
            (d / "lane_probe_kernels.cu").write_text(breakdown_source(src, variant))
            (d / "harness.cu").write_text(HARNESS)
            subprocess.run([_build._nvcc(), "-O3", "-std=c++17", "-gencode",
                            "arch=compute_90a,code=sm_90a", "-I", str(d), "-o", str(d / "run"),
                            str(d / "harness.cu")], check=True, capture_output=True)
            rc, resident, ms, err = subprocess.run(
                [str(d / "run")], capture_output=True, text=True, check=True).stdout.split(" ", 3)
            if rc != "0" or err.strip() != "no error":
                raise RuntimeError(f"contract probe, {variant}: rc {rc}, {err.strip()}")
            out[variant] = float(ms)
            print(f"  gmm_concat 16384 x 1024, {variant:18s} {float(ms):.4f} ms "
                  f"({resident} clusters)", flush=True)
    return out


def source() -> str:
    """The probe's CUDA source with one run a variant."""
    runs = "\n".join(f"  run<{t}, {r}, {c}, {rows}>(g, out);" for t, r, c, rows in VARIANTS)
    return SOURCE.replace("@RUNS@", runs)


def main() -> int:
    from godsp_tpu_torch.ops import _build
    from godsp_tpu_torch.probes._common import card

    print(f"card: {card()}", flush=True)
    if "--breakdown" in sys.argv[1:]:
        print(json.dumps({"breakdown": breakdown()}), flush=True)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        with open(f"{tmp}/contract.cu", "w") as f:
            f.write(source())
        subprocess.run([_build._nvcc(), "-O3", "-std=c++17", "-gencode",
                        "arch=compute_90a,code=sm_90a", "-o", f"{tmp}/contract",
                        f"{tmp}/contract.cu"], check=True)
        lines = subprocess.run([f"{tmp}/contract"], capture_output=True, text=True,
                               check=True).stdout.split("\n")
    out = {}
    for line in filter(None, lines):
        t, r, c, rows, ns, tflops, err = line.split(" ", 6)
        if err != "no error":
            raise RuntimeError(f"contract probe {t}/{r}x{c}/{rows}: {err}")
        key = f"{t} threads, {r} x {c} a thread, {rows}-row tile"
        out[key] = float(ns)
        print(f"  {key:40s} {float(ns):8.2f} ns a 16-row i2 step  {float(tflops):6.2f} TFLOP/s",
              flush=True)
    print(json.dumps({"contract": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
