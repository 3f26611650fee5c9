// Ring halo exchange for Hopper (sm_90a): K10.
//
// Replaces godsp_tpu/parallel/halo.py: ring_halo_pallas (inner kernel
// _halo_kernel), where each TPU shard sent the first `halo` samples of
// its time block into its LEFT neighbour's buffer by remote DMA: shard i
// receives the head of shard (i+1) % n_sp, the ppermute contract
// [(i, (i-1) % n)].  On Hopper the remote copy becomes a direct load:
// one launch serves every destination shard on one device, and its
// threads read each source block through a pointer from the table below
// (a block on the same card, or on a peer card over NVLink once peer
// access is on, gdsp_enable_peer).
//
// Bound on the H100: bytes, 2 x 4 B x n_sp x rows x halo (each head read
// once, written once).  At the mesh paths' shapes that is tens of KB, so
// the kernel is launch-latency-bound; the design keeps it to one launch
// per ring and 16-byte loads and stores where every block allows them.
// The pointer table travels in the kernel's parameter block, so a launch
// copies nothing to the device before it runs.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxShards = 64;

// The n_sp source blocks of one ring: row r of block i starts at
// block[i] + r * stride[i].
struct Ring {
  const float* block[kMaxShards];
  long long stride[kMaxShards];
};

// out[d, r, c] = ring.block[s][r * ring.stride[s] + c] with
// s = (first + d + 1) % n_sp, for destinations d < n_dst; T is float
// (one sample) or float4 (four, when every row start is 16-byte aligned).
template <typename T>
__global__ void ring_halo_kernel(Ring ring, T* __restrict__ out, int n_sp, int first, int n_dst,
                                 long long rows, int width) {
  const long long total = static_cast<long long>(n_dst) * rows * width;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(e % width);
    const long long dr = e / width;
    const long long r = dr % rows;
    const int s = (first + static_cast<int>(dr / rows) + 1) % n_sp;
    const T* src = reinterpret_cast<const T*>(ring.block[s] + r * ring.stride[s]);
    out[e] = src[c];
  }
}

}  // namespace

extern "C" {

// Heads of the right neighbours of destinations first .. first+n_dst-1:
// out (n_dst, rows, halo) float32.  blocks/strides: the n_sp block
// pointers and row strides (in floats), host arrays.  vec: every row
// start 16-byte aligned and halo % 4 == 0.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for more than kMaxShards shards.
int gdsp_ring_halo(const long long* blocks, const long long* strides, int n_sp, int first,
                   int n_dst, float* out, long long rows, int halo, int vec, void* stream) {
  if (n_sp < 1 || n_sp > kMaxShards) return static_cast<int>(cudaErrorInvalidValue);
  Ring ring;
  for (int i = 0; i < n_sp; ++i) {
    ring.block[i] = reinterpret_cast<const float*>(blocks[i]);
    ring.stride[i] = strides[i];
  }
  const int width = vec ? halo / 4 : halo;
  const long long total = static_cast<long long>(n_dst) * rows * width;
  const int threads = 256;
  long long grid = (total + threads - 1) / threads;
  if (grid > 8 * 132) grid = 8 * 132;
  if (grid < 1) grid = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    ring_halo_kernel<float4><<<static_cast<unsigned>(grid), threads, 0, s>>>(
        ring, reinterpret_cast<float4*>(out), n_sp, first, n_dst, rows, width);
  } else {
    ring_halo_kernel<float><<<static_cast<unsigned>(grid), threads, 0, s>>>(
        ring, out, n_sp, first, n_dst, rows, width);
  }
  return static_cast<int>(cudaGetLastError());
}

// Let `device` read `peer`'s memory (cudaDeviceEnablePeerAccess), an
// access already on counting as success.  Restores the current device.
// Returns the CUDA error, 0 on success.
int gdsp_enable_peer(int device, int peer) {
  int cur = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear the sticky-free "already enabled" status
      e = cudaSuccess;
    }
  }
  cudaSetDevice(cur);
  return static_cast<int>(e);
}

}  // extern "C"
