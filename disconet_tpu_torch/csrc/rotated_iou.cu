// Batched rotated-box IoU (B, N, 5) x (B, M, 5) -> (B, N, M), for Hopper (sm_90a).
//
// Replaces disconet_tpu/ops/pallas/rotated_iou_pallas.py::rotated_iou_matrix_pallas.
// Same algorithm: the intersection's boundary is the pieces of A's edges
// inside B plus the pieces of B's edges inside A, so its shoelace area is the
// sum of the Liang-Barsky-clipped edge pieces of each quad against the
// other's four half-planes; no vertex sorting. The boundary tolerance
// tol*|n| is +tol for the A-in-B pass and -tol for the B-in-A pass, so
// coincident edges count once. The parallel test is scale-aware,
// |den| < 1e-5*|n|*|d| + 1e-9: for exactly parallel edges den is a rounding
// residue whose value depends on FMA contraction.
//
// Layout: one thread per (f, i, j) pair. A 16x16 block first computes the
// corners and areas of its 16 A boxes and 16 B boxes into shared memory, then
// each thread runs both clip passes (4 edges x 4 planes each) in registers and
// writes one float. The ragged edge is masked; N and M need no padding.
// Boxes with zero area give IoU 0.
//
// What bounds it: fp32 arithmetic, about 800 operations a pair, against
// 20 bytes per box read and 4 bytes per pair written (6.3 MB for 24 frames
// of 256x256 pairs).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr float kTol = 1e-4f;

__device__ __forceinline__ float pieces_area(const float* px, const float* py,
                                             const float* cx, const float* cy,
                                             float tol) {
  float total = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float e1x = px[e], e1y = py[e];
    const float dx = px[(e + 1) & 3] - e1x, dy = py[(e + 1) & 3] - e1y;
    const float dlen = sqrtf(dx * dx + dy * dy);
    float t_lo = 0.f, t_hi = 1.f;
    bool par_ok = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float c1x = cx[k], c1y = cy[k];
      const float nx = -(cy[(k + 1) & 3] - c1y);  // inward normal (CCW)
      const float ny = cx[(k + 1) & 3] - c1x;
      const float num = nx * (e1x - c1x) + ny * (e1y - c1y);
      const float den = nx * dx + ny * dy;
      const float nlen = sqrtf(nx * nx + ny * ny);
      const float ntol = tol * nlen;
      const bool is_par = fabsf(den) < 1e-5f * nlen * dlen + 1e-9f;
      if (is_par) {
        if (!(num >= -ntol)) par_ok = false;
      } else {
        const float t_cross = -(num + ntol) / den;
        if (den > 0.f) t_lo = fmaxf(t_lo, t_cross);
        if (den < 0.f) t_hi = fminf(t_hi, t_cross);
      }
    }
    if (t_hi > t_lo && par_ok) {
      const float q1x = e1x + t_lo * dx, q1y = e1y + t_lo * dy;
      const float q2x = e1x + t_hi * dx, q2y = e1y + t_hi * dy;
      total += 0.5f * (q1x * q2y - q1y * q2x);
    }
  }
  return total;
}

__device__ __forceinline__ void corners(const float* b, float* x, float* y, float* area) {
  const float cx = b[0], cy = b[1], w = b[2], l = b[3], th = b[4];
  const float c = cosf(th), s = sinf(th);
  const float hw = 0.5f * w, hl = 0.5f * l;
  const float ox[4] = {hw, -hw, -hw, hw};  // CCW from (+w/2, +l/2)
  const float oy[4] = {hl, hl, -hl, -hl};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k] = cx + c * ox[k] - s * oy[k];
    y[k] = cy + s * ox[k] + c * oy[k];
  }
  *area = w * l;
}

__global__ void rotated_iou_kernel(const float* __restrict__ a,
                                   const float* __restrict__ b,
                                   float* __restrict__ out, int n, int m) {
  __shared__ float ax[kTile][4], ay[kTile][4], aarea[kTile];
  __shared__ float bx[kTile][4], by[kTile][4], barea[kTile];
  const int f = blockIdx.z;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int t = threadIdx.y * kTile + threadIdx.x;
  if (t < kTile) {
    if (i0 + t < n) corners(a + ((long long)f * n + i0 + t) * 5, ax[t], ay[t], &aarea[t]);
  } else if (t < 2 * kTile) {
    const int u = t - kTile;
    if (j0 + u < m) corners(b + ((long long)f * m + j0 + u) * 5, bx[u], by[u], &barea[u]);
  }
  __syncthreads();
  const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
  if (i >= n || j >= m) return;
  float px[4], py[4], qx[4], qy[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    px[k] = ax[threadIdx.y][k];
    py[k] = ay[threadIdx.y][k];
    qx[k] = bx[threadIdx.x][k];
    qy[k] = by[threadIdx.x][k];
  }
  const float area_a = aarea[threadIdx.y], area_b = barea[threadIdx.x];
  float inter = pieces_area(px, py, qx, qy, kTol) + pieces_area(qx, qy, px, py, -kTol);
  inter = fmaxf(inter, 0.f);
  const float uni = area_a + area_b - inter;
  const bool ok = area_a > 0.f && area_b > 0.f && uni > 1e-8f;
  out[((long long)f * n + i) * m + j] = ok ? inter / uni : 0.f;
}

}  // namespace

// a (batch, n, 5), b (batch, m, 5), out (batch, n, m), all float32 contiguous.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int rotated_iou_launch(const float* a, const float* b, float* out,
                                  int batch, int n, int m, void* stream) {
  if (batch == 0 || n == 0 || m == 0) return 0;
  dim3 block(kTile, kTile);
  dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile, batch);
  rotated_iou_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a, b, out, n, m);
  return (int)cudaGetLastError();
}
