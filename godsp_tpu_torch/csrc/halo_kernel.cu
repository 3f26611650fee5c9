// Ring halo exchange for Hopper (sm_90a): K10.
//
// Replaces godsp_tpu/parallel/halo.py: ring_halo_pallas (inner kernel
// _halo_kernel), where each TPU shard sent the first `halo` samples of
// its time block into its LEFT neighbour's buffer by remote DMA: shard i
// receives the head of shard (i+1) % n_sp, the ppermute contract
// [(i, (i-1) % n)].  On Hopper the remote copy becomes a direct load: one
// launch serves every destination shard on one device.
//
// Bound on the H100: bytes, 2 x 4 B x n_sp x rows x halo (each head read
// once, written once).  At the mesh paths' shapes that is tens of KB, so
// the kernel alone is launch-latency-bound (1.6 us for 32 KB), and the
// call is bound by the host work of its wrapper (ops/cuda_halo.py).  Two
// forms, one body:
//
// - the view ring (ring_halo_view_kernel, gdsp_ring_halo_view): every block
//   on one device, at a uniform element spacing in one storage, with one
//   row stride, as coll.shard_time gives a mesh's blocks on one card.  The
//   kernel takes one base pointer, the spacing and the row stride, and
//   computes source s's address itself, so the wrapper builds no table;
// - the pointer table (ring_halo_table_kernel, gdsp_ring_halo): any other
//   ring (distinct storages, ragged spacing, mixed row strides, blocks on
//   distinct cards).  Its threads read each source block through a
//   pointer from the table below, which travels in the kernel's parameter
//   block, so a launch copies nothing to the device before it runs.  A
//   block on a peer card is read over NVLink once peer access is on
//   (gdsp_enable_peer).  That distinct-card branch needs two cards and has
//   not run: every measurement so far is of one card.
//
// Both use 16-byte loads and stores where every row start allows them.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8 * 132;

// The n_sp source blocks of one ring: row r of block i starts at
// block[i] + r * stride[i].
struct Ring {
  const float* block[kMaxShards];
  long long stride[kMaxShards];
};

// Row r of source s: the table's pointer, or base + s * spacing + r * stride.
struct TableSource {
  Ring ring;
  __device__ const float* row(int s, long long r) const {
    return ring.block[s] + r * ring.stride[s];
  }
};

struct ViewSource {
  const float* base;
  long long spacing, stride;
  __device__ const float* row(int s, long long r) const {
    return base + s * spacing + r * stride;
  }
};

// out[d, r, c] = row(s, r)[c] with s = (first + d + 1) % n_sp, for
// destinations d < n_dst; T is float (one sample) or float4 (four, when
// every row start is 16-byte aligned).
template <typename T, typename Source>
__device__ __forceinline__ void copy_heads(const Source& src, T* __restrict__ out, int n_sp,
                                           int first, int n_dst, long long rows, int width) {
  const long long total = static_cast<long long>(n_dst) * rows * width;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(e % width);
    const long long dr = e / width;
    const long long r = dr % rows;
    const int s = (first + static_cast<int>(dr / rows) + 1) % n_sp;
    out[e] = reinterpret_cast<const T*>(src.row(s, r))[c];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_halo_table_kernel(TableSource src, T* __restrict__ out, int n_sp, int first, int n_dst,
                       long long rows, int width) {
  copy_heads(src, out, n_sp, first, n_dst, rows, width);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_halo_view_kernel(ViewSource src, T* __restrict__ out, int n_sp, long long rows, int width) {
  copy_heads(src, out, n_sp, 0, n_sp, rows, width);
}

unsigned grid_for(long long total) {
  long long grid = (total + kThreads - 1) / kThreads;
  if (grid > kMaxBlocks) grid = kMaxBlocks;
  return static_cast<unsigned>(grid < 1 ? 1 : grid);
}

}  // namespace

extern "C" {

// The pointer table.  Heads of the right neighbours of destinations
// first .. first+n_dst-1: out (n_dst, rows, halo) float32.  blocks/strides:
// the n_sp block pointers and row strides (in floats), host arrays.  vec:
// every row start 16-byte aligned and halo % 4 == 0.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for more than kMaxShards
// shards.
int gdsp_ring_halo(const long long* blocks, const long long* strides, int n_sp, int first,
                   int n_dst, float* out, long long rows, int halo, int vec, void* stream) {
  if (n_sp < 1 || n_sp > kMaxShards) return static_cast<int>(cudaErrorInvalidValue);
  TableSource src;
  for (int i = 0; i < n_sp; ++i) {
    src.ring.block[i] = reinterpret_cast<const float*>(blocks[i]);
    src.ring.stride[i] = strides[i];
  }
  const int width = vec ? halo / 4 : halo;
  const unsigned grid = grid_for(static_cast<long long>(n_dst) * rows * width);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    ring_halo_table_kernel<float4><<<grid, kThreads, 0, s>>>(
        src, reinterpret_cast<float4*>(out), n_sp, first, n_dst, rows, width);
  } else {
    ring_halo_table_kernel<float><<<grid, kThreads, 0, s>>>(src, out, n_sp, first, n_dst, rows,
                                                            width);
  }
  return static_cast<int>(cudaGetLastError());
}

// The view ring: block i's row r starts at base + i * spacing + r * stride
// (floats).  out (n_sp, rows, halo) float32, out[i] the head of block
// (i + 1) % n_sp.  vec as above (base, spacing and stride all allow it).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for n_sp < 1.
int gdsp_ring_halo_view(const float* base, long long spacing, long long stride, int n_sp,
                        float* out, long long rows, int halo, int vec, void* stream) {
  if (n_sp < 1) return static_cast<int>(cudaErrorInvalidValue);
  const ViewSource src{base, spacing, stride};
  const int width = vec ? halo / 4 : halo;
  const unsigned grid = grid_for(static_cast<long long>(n_sp) * rows * width);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    ring_halo_view_kernel<float4><<<grid, kThreads, 0, s>>>(
        src, reinterpret_cast<float4*>(out), n_sp, rows, width);
  } else {
    ring_halo_view_kernel<float><<<grid, kThreads, 0, s>>>(src, out, n_sp, rows, width);
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
