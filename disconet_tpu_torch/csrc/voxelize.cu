// Point cloud -> binary BEV occupancy, for Hopper (sm_90a).
//
// Replaces disconet_tpu/ops/pallas/voxelize_pallas.py::voxelize_occupy_pallas.
// The TPU has no vector scatter, so its kernel ran a serial loop over points
// on the scalar core, one read-modify-write of a (1, W) row per point. Here
// every point gets its own thread and sets its voxel's bit with atomicOr in a
// bit-packed (frames, H, W) word grid (bit z <=> voxel (x, y, z), Z <= 32).
// OR is order-free, so the result is deterministic. A second kernel unpacks
// the words to the (frames, H, W, Z) float32 occupancy the convs read.
//
// What bounds it: bytes. The scatter reads 12 bytes a point; the unpack
// writes the float32 grid (82 MB for 24 frames at 256x256x13), which is
// almost all of the traffic. The unpack writes it once, coalesced.
//
// Index arithmetic is float32 floor((p - lo) / vs) with IEEE division
// (no fast-math), bit for bit the plain version's. Non-finite, masked and
// out-of-extent points are dropped before any index is formed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Geometry {
  float lo[3], hi[3], vs[3];
  int dims[3];
};

__global__ void scatter_kernel(const float* __restrict__ pts,
                               const uint8_t* __restrict__ mask,
                               unsigned int* __restrict__ packed,
                               long long total, int n, Geometry g) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;
  if (mask != nullptr && mask[p] == 0) return;
  const float* q = pts + 3 * p;
  int idx[3];
  for (int a = 0; a < 3; ++a) {
    float v = q[a];
    if (!isfinite(v)) return;
    if (!(v >= g.lo[a] && v < g.hi[a])) return;
    float f = floorf((v - g.lo[a]) / g.vs[a]);
    int i = (int)f;
    if (i < 0 || i >= g.dims[a]) return;
    idx[a] = i;
  }
  long long frame = p / n;
  long long word = (frame * g.dims[0] + idx[0]) * g.dims[1] + idx[1];
  atomicOr(packed + word, 1u << idx[2]);
}

__global__ void unpack_kernel(const unsigned int* __restrict__ packed,
                              float* __restrict__ out, long long total, int zdim) {
  long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  long long word = o / zdim;
  int z = (int)(o - word * zdim);
  out[o] = (float)((packed[word] >> z) & 1u);
}

}  // namespace

// pts (frames*n, 3) float32; mask (frames*n) uint8 or null; packed
// (frames, H, W) zeroed int32; out (frames, H, W, Z) float32.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int voxelize_occupy_launch(const float* pts, const uint8_t* mask,
                                      unsigned int* packed, float* out,
                                      int frames, int n, const float* lo,
                                      const float* hi, const float* vs,
                                      const int* dims, void* stream) {
  Geometry g;
  for (int a = 0; a < 3; ++a) {
    g.lo[a] = lo[a];
    g.hi[a] = hi[a];
    g.vs[a] = vs[a];
    g.dims[a] = dims[a];
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  long long npts = (long long)frames * n;
  if (npts > 0) {
    unsigned int blocks = (unsigned int)((npts + threads - 1) / threads);
    scatter_kernel<<<blocks, threads, 0, s>>>(pts, mask, packed, npts, n, g);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  long long nout = (long long)frames * dims[0] * dims[1] * dims[2];
  if (nout > 0) {
    unsigned int blocks = (unsigned int)((nout + threads - 1) / threads);
    unpack_kernel<<<blocks, threads, 0, s>>>(packed, out, nout, dims[2]);
  }
  return (int)cudaGetLastError();
}
