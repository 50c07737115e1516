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
// residue. Boxes with zero area give IoU 0.
//
// What bounds it: a pair that is clipped costs 32 IEEE divisions and ~650
// other fp32 operations, against 20 bytes per box read and 4 bytes per pair
// written (6.3 MB for 24 frames of 256x256 pairs). Where ~1% of pairs are
// clipped, as on the main path's candidates, bytes bound it; on boxes packed
// closely, arithmetic.
//
// Layout: a block of 4 warps takes 32 A boxes x 32 B boxes of one frame.
// 1. It computes what depends on one box alone, once per box, into shared
//    memory: corners, edge vectors, edge lengths (the only square roots), the
//    tolerance terms tol*len and 1e-5*len, the area, and the box's reach
//    (below). Boxes are 29 words apart, an odd stride, so 32 lanes reading 32
//    boxes hit 32 banks.
// 2. Each warp owns 8 rows of A. Lane l tests pair (row, B box l): if either
//    box has no area (the NMS zeroes its dead slots), or the two boxes'
//    circumscribed circles, each widened by a slack, do not meet (every edge
//    piece of both passes is then clipped away, see `reach`), the plain
//    version's IoU is exactly 0 and the pair is skipped. The warp queues the
//    pairs that remain with a ballot.
// 3. The warp computes the queued pairs, one a lane, so no lane idles on a
//    skipped pair while its neighbours clip. On the main path's candidates
//    most pairs are far apart or dead; on boxes packed closely most are
//    queued.
// 4. Results go through shared memory, and each row is written as 32
//    adjacent floats. The ragged edge is masked; N and M need no padding.
//
// Per clipped pair only what depends on the pair is left: for each of A's
// edges e and B's edges k, one corner difference, one denominator, and for
// each pass a numerator, the parallel test, one IEEE division and a min or
// max; per edge the piece's shoelace term. Both passes share the corner
// differences and the denominators. The results are bit for bit those of
// computing everything per pair (the build has -fmad=false):
// - plane k's inward normal (-ey_k, ex_k) has length sqrt(ey*ey + ex*ex),
//   which is the edge length sqrt(ex*ex + ey*ey): negation is exact and
//   addition commutes;
// - the B-in-A pass's tolerance (-tol)*len is -(tol*len);
// - that pass's corner differences are the A-in-B pass's negated
//   (b - a == -(a - b)), and so is its denominator ((-q) + p == -((-p) + q));
//   -(x + -t) / -d == (x - t) / d.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // B boxes of a tile
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // A boxes of a tile
constexpr float kTol = 1e-4f;

struct Box {
  float x[4], y[4];    // corners, counter-clockwise from (+w/2, +l/2)
  float ex[4], ey[4];  // edge k, corner k -> corner k+1
  float len[4];        // |edge k|, also |inward normal of plane k|
  float tl[4];         // kTol * len[k]
  float sl[4];         // 1e-5f * len[k]
  float area;
};

// A box's centre and reach: the radius of its circumscribed circle plus a
// slack of 1e-3 * (1 m + |cx| + |cy| + radius). Two boxes whose reaches do
// not meet are farther apart than the slack, which is over ten times what the
// clipping can move a boundary: the 1e-4 m tolerance, the 1e-5*|d| of the
// parallel test, and float32 rounding of coordinates of that size (~1e-6 of
// them). So every edge piece of both passes is empty, the plain version sums
// only zeros, and its IoU is exactly 0. chip_smoke.py::skipped_pairs is the
// kernel's skip test in PyTorch, for the bound's count of clipped pairs.
__device__ __forceinline__ float3 reach(const float* p) {
  const float cx = p[0], cy = p[1], w = p[2], l = p[3];
  const float r = 0.5f * sqrtf(w * w + l * l);
  return make_float3(cx, cy, r + 1e-3f * (1.f + fabsf(cx) + fabsf(cy) + r));
}

__device__ __forceinline__ void box_data(const float* p, Box& b) {
  const float cx = p[0], cy = p[1], w = p[2], l = p[3], th = p[4];
  const float c = cosf(th), s = sinf(th);
  const float hw = 0.5f * w, hl = 0.5f * l;
  const float ox[4] = {hw, -hw, -hw, hw};
  const float oy[4] = {hl, hl, -hl, -hl};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    b.x[k] = cx + c * ox[k] - s * oy[k];
    b.y[k] = cy + s * ox[k] + c * oy[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float ex = b.x[(k + 1) & 3] - b.x[k], ey = b.y[(k + 1) & 3] - b.y[k];
    const float len = sqrtf(ex * ex + ey * ey);
    b.ex[k] = ex;
    b.ey[k] = ey;
    b.len[k] = len;
    b.tl[k] = kTol * len;
    b.sl[k] = 1e-5f * len;
  }
  b.area = w * l;
}

// Sum of the shoelace terms of the pieces [lo, hi] of P's edges that survived.
__device__ __forceinline__ float pieces_area(const Box& P, const float* lo, const float* hi,
                                             const bool* ok) {
  float total = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (hi[e] > lo[e] && ok[e]) {
      const float q1x = P.x[e] + lo[e] * P.ex[e], q1y = P.y[e] + lo[e] * P.ey[e];
      const float q2x = P.x[e] + hi[e] * P.ex[e], q2y = P.y[e] + hi[e] * P.ey[e];
      total += 0.5f * (q1x * q2y - q1y * q2x);
    }
  }
  return total;
}

__device__ __forceinline__ float pair_iou(const Box& a, const Box& b) {
  // [lo, hi] and the parallel-edge verdict of A's edges inside B (1) and of
  // B's edges inside A (2).
  float lo1[4], hi1[4], lo2[4], hi2[4];
  bool ok1[4], ok2[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    lo1[e] = lo2[e] = 0.f;
    hi1[e] = hi2[e] = 1.f;
    ok1[e] = ok2[e] = true;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float dx = a.x[e] - b.x[k], dy = a.y[e] - b.y[k];
      // A's edge e against B's plane k, inward normal (-b.ey[k], b.ex[k]);
      // B's edge k against A's plane e has the denominator -den.
      const float den = -b.ey[k] * a.ex[e] + b.ex[k] * a.ey[e];
      const float num1 = -b.ey[k] * dx + b.ex[k] * dy;
      if (fabsf(den) < b.sl[k] * a.len[e] + 1e-9f) {
        if (!(num1 >= -b.tl[k])) ok1[e] = false;
      } else {
        const float t = -(num1 + b.tl[k]) / den;
        if (den > 0.f) lo1[e] = fmaxf(lo1[e], t);
        if (den < 0.f) hi1[e] = fminf(hi1[e], t);
      }
      const float num2 = a.ey[e] * dx - a.ex[e] * dy;
      if (fabsf(den) < a.sl[e] * b.len[k] + 1e-9f) {
        if (!(num2 >= a.tl[e])) ok2[k] = false;
      } else {
        const float t = (num2 - a.tl[e]) / den;
        if (den < 0.f) lo2[k] = fmaxf(lo2[k], t);
        if (den > 0.f) hi2[k] = fminf(hi2[k], t);
      }
    }
  }
  const float inter = fmaxf(pieces_area(a, lo1, hi1, ok1) + pieces_area(b, lo2, hi2, ok2), 0.f);
  const float uni = a.area + b.area - inter;
  return (a.area > 0.f && b.area > 0.f && uni > 1e-8f) ? inter / uni : 0.f;
}

// 6 blocks an SM caps the registers a thread holds: more warps hide the
// divisions' latency, without the spills of a tighter cap.
__global__ void __launch_bounds__(kLanes * kWarps, 6)
rotated_iou_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out, int n, int m) {
  __shared__ Box sa[kRows], sb[kLanes];
  __shared__ float3 ra[kRows], rb[kLanes];
  __shared__ float result[kWarps][kRowsPerWarp][kLanes];
  __shared__ unsigned short queue[kWarps][kRowsPerWarp * kLanes];
  const int f = blockIdx.z;
  const int i0 = blockIdx.y * kRows, j0 = blockIdx.x * kLanes;
  const int lane = threadIdx.x, warp = threadIdx.y;
  if (warp == 0 && lane < kRows && i0 + lane < n) {
    const float* p = a + ((size_t)f * n + i0 + lane) * 5;
    box_data(p, sa[lane]);
    ra[lane] = reach(p);
  }
  if (warp == 1 && j0 + lane < m) {
    const float* p = b + ((size_t)f * m + j0 + lane) * 5;
    box_data(p, sb[lane]);
    rb[lane] = reach(p);
  }
  __syncthreads();

  const int row0 = warp * kRowsPerWarp;
  const int j = j0 + lane;
  const float3 rj = rb[lane];
  const bool live_j = j < m && sb[lane].area > 0.f;  // pair_iou gives 0 without area
  int queued = 0;
  for (int q = 0; q < kRowsPerWarp; ++q) {
    bool clip = false;
    if (i0 + row0 + q < n && live_j && sa[row0 + q].area > 0.f) {
      const float3 ri = ra[row0 + q];
      const float dx = ri.x - rj.x, dy = ri.y - rj.y, r = ri.z + rj.z;
      clip = !(dx * dx + dy * dy > r * r);  // NaN: clip
    }
    result[warp][q][lane] = 0.f;
    const unsigned int vote = __ballot_sync(0xffffffffu, clip);
    if (clip) queue[warp][queued + __popc(vote & ((1u << lane) - 1u))] = (q << 5) | lane;
    queued += __popc(vote);
  }
  __syncwarp();
  for (int t = lane; t < queued; t += kLanes) {
    const int q = queue[warp][t] >> 5, l = queue[warp][t] & 31;
    result[warp][q][l] = pair_iou(sa[row0 + q], sb[l]);
  }
  __syncwarp();
  if (j < m) {
    for (int q = 0; q < kRowsPerWarp && i0 + row0 + q < n; ++q) {
      out[((size_t)f * n + i0 + row0 + q) * m + j] = result[warp][q][lane];
    }
  }
}

}  // namespace

// a (batch, n, 5), b (batch, m, 5), out (batch, n, m), all float32 contiguous.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int rotated_iou_launch(const float* a, const float* b, float* out,
                                  int batch, int n, int m, void* stream) {
  if (batch == 0 || n == 0 || m == 0) return 0;
  dim3 block(kLanes, kWarps);
  dim3 grid((m + kLanes - 1) / kLanes, (n + kRows - 1) / kRows, batch);
  rotated_iou_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a, b, out, n, m);
  return (int)cudaGetLastError();
}
