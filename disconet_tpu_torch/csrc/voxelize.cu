// Point cloud -> binary BEV occupancy, for Hopper (sm_90a).
//
// Replaces disconet_tpu/ops/pallas/voxelize_pallas.py::voxelize_occupy_pallas.
// The TPU has no vector scatter, so its kernel ran a serial loop over points
// on the scalar core, one read-modify-write of a (1, W) row per point.
//
// Here one launch does all of it. A block owns one band of x rows of one
// frame. The band's bit-packed (rows, W) words (bit z <=> voxel (x, y, z),
// Z <= 32) live in shared memory and are zeroed there. The block streams all
// of its frame's points with 16-byte loads (a frame's points, 196 KB at the
// main path's 16384, stay in L2 across the frame's bands) and sets the bit of
// each point whose x cell falls in its band with a shared-memory atomicOr.
// OR is order-free, so the result is deterministic. Then the block writes its
// band, one contiguous slab of the (frames, H, W, Z) float32 output, once,
// with 16-byte stores.
//
// What bounds it: bytes. The float32 grid (82 MB for 24 frames at
// 256x256x13) is almost all of the traffic; the points are read from device
// memory once and from L2 once per band.
//
// Index arithmetic is float32 floor((p - lo) / vs) with IEEE division (no
// fast-math), bit for bit the plain version's. Non-finite, masked and
// out-of-extent points are dropped before any index is formed. Offsets
// inside a band are 32-bit, and the write-out divides by Z with a multiply-high
// by a magic number the launch precomputes (see `bit`).

#include <cuda_runtime.h>
#include <stdint.h>

// Laid out as ops/voxelize.py's _KernelGeometry.
struct Geometry {
  float lo[3], hi[3], vs[3];
  int dims[3];
};

namespace {

constexpr int kThreads = 512;
// Words of a band: 16 KB of shared memory, 16 rows of a 256-wide grid.
constexpr int kBandWords = 4096;
constexpr int kMaxShared = 48 * 1024;

// The cell of v on axis a, or -1 if v is dropped.
__device__ __forceinline__ int cell(float v, const Geometry& g, int a) {
  if (!isfinite(v) || !(v >= g.lo[a] && v < g.hi[a])) return -1;
  const int i = (int)floorf((v - g.lo[a]) / g.vs[a]);
  return (i >= 0 && i < g.dims[a]) ? i : -1;
}

__device__ __forceinline__ void add_point(unsigned int* words, float x, float y, float z,
                                          const Geometry& g, int row0, int rows) {
  const int ix = cell(x, g, 0);
  if (ix < row0 || ix >= row0 + rows) return;  // another band's, or dropped (-1)
  const int iy = cell(y, g, 1);
  const int iz = cell(z, g, 2);
  if (iy < 0 || iz < 0) return;
  atomicOr(words + (ix - row0) * g.dims[1] + iy, 1u << iz);
}

// The magic number of Z: i / Z == __umulhi(2 * i, magic) for 1 <= Z <= 32
// and every i < 2^26: magic exceeds 2^31 / Z by at most 1, so 2 * i * magic
// / 2^32 exceeds i / Z by at most i / 2^31 < 1 / Z. A band holds at most
// 12288 words of 32 bits, so i < 2^19.
inline unsigned int z_magic(int Z) { return (1u << 31) / (unsigned int)Z + 1u; }

// Element i of a band is bit i % Z of the band's word i / Z.
__device__ __forceinline__ float bit(const unsigned int* words, unsigned int i, unsigned int Z,
                                     unsigned int magic) {
  const unsigned int w = __umulhi(2u * i, magic);
  return (float)((words[w] >> (i - w * Z)) & 1u);
}

__global__ void __launch_bounds__(kThreads)
voxelize_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                float* __restrict__ out, int n, int bands, int band_rows, Geometry g,
                unsigned int magic, bool vec) {
  const unsigned int Z = (unsigned int)g.dims[2];
  extern __shared__ unsigned int words[];
  const int f = blockIdx.x / bands;
  const int row0 = (blockIdx.x - f * bands) * band_rows;
  const int rows = min(band_rows, g.dims[0] - row0);
  const int nwords = rows * g.dims[1];
  for (int i = threadIdx.x; i < nwords; i += kThreads) words[i] = 0u;
  __syncthreads();

  const float* fp = pts + (size_t)f * n * 3;
  const uint8_t* fm = mask == nullptr ? nullptr : mask + (size_t)f * n;
  int p = threadIdx.x;
  if (vec) {  // 4 points in three 16-byte loads (n % 4 == 0, aligned frames)
    const float4* p4 = reinterpret_cast<const float4*>(fp);
    for (int q = threadIdx.x; q < n / 4; q += kThreads) {
      const float4 a = p4[3 * q], b = p4[3 * q + 1], c = p4[3 * q + 2];
      uchar4 m = make_uchar4(1, 1, 1, 1);
      if (fm != nullptr) m = reinterpret_cast<const uchar4*>(fm)[q];
      if (m.x) add_point(words, a.x, a.y, a.z, g, row0, rows);
      if (m.y) add_point(words, a.w, b.x, b.y, g, row0, rows);
      if (m.z) add_point(words, b.z, b.w, c.x, g, row0, rows);
      if (m.w) add_point(words, c.y, c.z, c.w, g, row0, rows);
    }
    p = n;
  }
  for (; p < n; p += kThreads) {
    if (fm != nullptr && fm[p] == 0) continue;
    add_point(words, fp[3 * p], fp[3 * p + 1], fp[3 * p + 2], g, row0, rows);
  }
  __syncthreads();

  // The band: a scalar head up to the first 16-byte boundary, float4 stores,
  // a scalar tail.
  float* band = out + ((size_t)f * g.dims[0] + row0) * g.dims[1] * Z;
  const unsigned int count = (unsigned int)nwords * Z;
  const unsigned int head = min(count, (4u - (unsigned int)(((uintptr_t)band >> 2) & 3u)) & 3u);
  if (threadIdx.x < head) band[threadIdx.x] = bit(words, threadIdx.x, Z, magic);
  const unsigned int nvec = (count - head) / 4;
  float4* band4 = reinterpret_cast<float4*>(band + head);
  for (unsigned int v = threadIdx.x; v < nvec; v += kThreads) {
    const unsigned int i = head + 4 * v;
    band4[v] = make_float4(bit(words, i, Z, magic), bit(words, i + 1, Z, magic),
                           bit(words, i + 2, Z, magic), bit(words, i + 3, Z, magic));
  }
  for (unsigned int i = head + 4 * nvec + threadIdx.x; i < count; i += kThreads) {
    band[i] = bit(words, i, Z, magic);
  }
}

}  // namespace

// pts (frames*n, 3) float32; mask (frames*n) uint8 or null; out
// (frames, H, W, Z) float32, 16-byte aligned; g the grid, 1 <= Z <= 32.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int voxelize_occupy_launch(const float* pts, const uint8_t* mask, float* out,
                                      int frames, int n, const Geometry* g, void* stream) {
  const int H = g->dims[0], W = g->dims[1], Z = g->dims[2];
  if (frames == 0 || H == 0 || W == 0 || Z == 0) return 0;
  if (Z < 0 || Z > 32 || ((uintptr_t)out & 15) != 0) return (int)cudaErrorInvalidValue;
  const int band_rows = W >= kBandWords ? 1 : kBandWords / W;
  const int bands = (H + band_rows - 1) / band_rows;
  const size_t shared = (size_t)band_rows * W * sizeof(unsigned int);
  const long long blocks = (long long)frames * bands;
  if (shared > kMaxShared || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && ((uintptr_t)pts & 15) == 0 && ((uintptr_t)mask & 3) == 0;
  voxelize_kernel<<<(unsigned int)blocks, kThreads, shared, (cudaStream_t)stream>>>(
      pts, mask, out, n, bands, band_rows, *g, z_magic(Z), vec);
  return (int)cudaGetLastError();
}
