// 3x3 stride-1 convolution in float32 on the tensor cores (3xTF32), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves V2VNet's float32 convs (the
// ConvGRU's update, reset and candidate, the message conv) to XLA. The port
// left them to cuDNN, whose float32 kernels run on the FFMA units, and those
// top out at 67 TFLOP/s on an H100. This kernel runs the same float32
// product on the tensor cores in 3xTF32: each float32 operand x is carried
// as hi = rna_tf32(x) plus lo = rna_tf32(x - hi) (x - hi is exact), and the
// product as hi*hi + hi*lo + lo*hi with float32 sums. The representation
// error is below 2^-22 of |x| and the dropped lo*lo term below 2^-22 of the
// product: float32's accuracy, not TF32's three digits.
//
// What bounds it: operations, three TF32 passes at 495 TFLOP/s, so 2 * 9 *
// Cin * Cout * pixels * 3 / 495e12 s. Bytes are far below that: at C = 256
// a pixel's 1 KB in and 1 KB out carry 9.4 MFLOP of passes.
//
// Design. An implicit GEMM: M = output pixels, N = Cout, K = (input channel
// chunk of 32, tap). A block is persistent and walks over tiles of 128
// pixels (a rectangle of rows of one image, as wide as the image up to 128)
// by BN output channels: 32 when Cout is 32, 64 when it is 64, else 128, so
// narrow layers do not multiply zeros past Cout.
//  * One producer thread issues TMA loads. Per chunk of 32 input channels,
//    one box of the NHWC input covers the tile with its one-pixel halo; the
//    box's coordinates start at (x0 - 1, y0 - pad_h), and what lies outside
//    the image arrives as zeros: SAME padding, and the halo strip's rows,
//    for free. Per tap, the BN x 32 weight tile comes pre-split as hi and
//    lo. Both land 128-byte swizzled in rings of shared memory (2 input
//    slots, up to 4 weight slots) guarded by mbarriers.
//  * Two consumer warpgroups own 64 pixels each. Per tap and step of 8
//    channels a thread reads its two pixels' values from the input slot
//    (the tap is an offset into the halo box), splits them into hi and lo in
//    registers, and issues three wgmma m64nBNk8 with A from registers and
//    the weights' hi or lo from shared memory. No hi/lo copy of an
//    activation exists outside registers.
//  * Each tap's three passes sum into a partial accumulator that starts at
//    zero, and the partial is added to the tile's float32 accumulator with
//    an IEEE add (round to nearest) once the tap's wgmmas have completed.
//    The tensor cores' own float32 sums are not rounded to nearest, so the
//    partials stay short: 96 products (32 channels, 3 passes) a partial.
//  * The epilogue adds the bias and stores the NHWC float32 output.
// The reduction order is fixed by the shapes alone (no atomics, no split-K),
// so a result repeats bit for bit. Channels are taken in pairs (2t, 2t + 1)
// by a thread whose wgmma fragment wants columns (t, t + 4); the weight
// preparation permutes each group of 8 input channels to match.
//
// The weights are prepared once per call by conv3x3_f32x3_prep_weights: (2,
// 9, Cout, Cin) float32, hi then lo, tap-major, permuted as above; with
// flip set it prepares the flipped, transposed weights of the input
// gradient. The caller allocates every buffer; nothing here allocates or
// synchronises, so a CUDA graph can capture both launches.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;             // output pixels a tile: two consumer warpgroups of 64
constexpr int kKC = 32;              // input channels a chunk: one 128-byte swizzle row
constexpr int kThreads = 384;        // the producer warpgroup and two consumer warpgroups
constexpr int kAStages = 2;
constexpr int kMaxBStages = 4;
constexpr int kBarrierBytes = 8 * 2 * (kAStages + kMaxBStages);
constexpr int kSmemLimit = 232448;   // a block's shared memory on sm_90
constexpr int kMaxDevices = 64;
constexpr int kErrNoEncoder = 1000;  // launch error codes beyond CUDA's
constexpr int kErrEncode = 1001;

struct Params {
  float* y;
  const float* bias;
  int hout, w, cin, cout, pad_h;
  int bw_log2, bh;                   // a tile: bh rows of (1 << bw_log2) pixels
  int tiles_x, tiles_y, tiles_n, tiles;
  int a_slot_bytes, a_bytes, b_stages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The wgmma descriptor of a K-major operand tile in shared memory, 128-byte
// swizzled: rows of 128 bytes, groups of 8 rows 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Orders the compiler's reads of the accumulators after a wgmma_wait.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N of the warpgroup) = [d +] A (64 x 8, tf32 in registers) * B
// (8 x N, tf32 in shared memory, K-major), for N = 128, 64 and 32.
__device__ __forceinline__ void mma_64x128x8(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate), "l"(desc_b));
}

__device__ __forceinline__ void mma_64x64x8(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %37, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate), "l"(desc_b));
}

__device__ __forceinline__ void mma_64x32x8(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %20, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %21, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate), "l"(desc_b));
}

template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  if constexpr (BN == 128) {
    mma_64x128x8(d, a, desc_b, accumulate);
  } else if constexpr (BN == 64) {
    mma_64x64x8(d, a, desc_b, accumulate);
  } else {
    mma_64x32x8(d, a, desc_b, accumulate);
  }
}

__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// A thread's A fragment of step ks (channels 8 ks .. 8 ks + 7 of the chunk)
// for its pixels at halo positions p0 (row g) and p1 (row g + 8): columns
// t and t + 4 are the channels 2t and 2t + 1, one 8-byte load a pixel. The
// slot is TMA's 128-byte swizzle: the 16-byte chunk c of pixel p lies at
// c ^ (p % 8).
__device__ __forceinline__ void load_a(uint32_t slot, int p0, int p1, int ks, int t4, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int chunk = 2 * ks + (t4 >> 1);
  const uint32_t in_chunk = (t4 & 1) << 3;
  const uint32_t s0 = slot + p0 * 128 + (((chunk ^ (p0 & 7)) << 4) | in_chunk);
  const uint32_t s1 = slot + p1 * 128 + (((chunk ^ (p1 & 7)) << 4) | in_chunk);
  float v0x, v0y, v1x, v1y;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v0x), "=f"(v0y) : "r"(s0));
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v1x), "=f"(v1y) : "r"(s1));
  split(v0x, hi[0], lo[0]);
  split(v1x, hi[1], lo[1]);
  split(v0y, hi[2], lo[2]);
  split(v1y, hi[3], lo[3]);
}

struct Tile {
  int img, y0, x0, co0;
};

template <int BN>
__device__ __forceinline__ Tile tile_of(const Params& p, int t) {
  Tile r;
  const int n_tile = t % p.tiles_n;
  const int m = t / p.tiles_n;
  r.co0 = n_tile * BN;
  r.x0 = (m % p.tiles_x) << p.bw_log2;
  r.y0 = ((m / p.tiles_x) % p.tiles_y) * p.bh;
  r.img = m / (p.tiles_x * p.tiles_y);
  return r;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
               const Params p) {
  constexpr int kHalfSlot = BN * kKC * 4;  // one weight tile, hi or lo
  constexpr int kBSlotBytes = 2 * kHalfSlot;
  constexpr int kAcc = BN / 2;  // accumulators a thread: 64 x BN over 128 threads
  extern __shared__ unsigned char smem_raw[];
  // slots start 1024-aligned in the shared window: the swizzle is a function of the address
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t a_slots = base;
  const uint32_t b_slots = a_slots + kAStages * p.a_slot_bytes;
  const uint32_t bars = b_slots + p.b_stages * kBSlotBytes;
  const uint32_t full_a = bars, empty_a = full_a + 8 * kAStages;
  const uint32_t full_b = empty_a + 8 * kAStages, empty_b = full_b + 8 * kMaxBStages;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kAStages; ++i) {
      mbar_init(full_a + 8 * i, 1);
      mbar_init(empty_a + 8 * i, 8);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < p.b_stages; ++i) {
      mbar_init(full_b + 8 * i, 1);
      mbar_init(empty_b + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != 0) return;
    int as = 0, bs = 0;
    uint32_t a_phase = 0, b_phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const Tile tl = tile_of<BN>(p, t);
      for (int c = 0; c < p.cin; c += kKC) {
        mbar_wait(empty_a + 8 * as, a_phase ^ 1);
        mbar_expect_tx(full_a + 8 * as, p.a_bytes);
        tma_load_4d(a_slots + as * p.a_slot_bytes, &map_x, full_a + 8 * as, c, tl.x0 - 1, tl.y0 - p.pad_h, tl.img);
        if (++as == kAStages) {
          as = 0;
          a_phase ^= 1;
        }
        for (int tap = 0; tap < 9; ++tap) {
          mbar_wait(empty_b + 8 * bs, b_phase ^ 1);
          mbar_expect_tx(full_b + 8 * bs, kBSlotBytes);
          const uint32_t slot = b_slots + bs * kBSlotBytes;
          tma_load_4d(slot, &map_w, full_b + 8 * bs, c, tl.co0, tap, 0);
          tma_load_4d(slot + kHalfSlot, &map_w, full_b + 8 * bs, c, tl.co0, tap, 1);
          if (++bs == p.b_stages) {
            bs = 0;
            b_phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns the tile's pixels 64 cw .. 64 cw + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int bw = 1 << p.bw_log2, hw = bw + 2;
  const int r0 = 64 * (wg - 1) + 16 * warp + g, r1 = r0 + 8;
  const int q0 = (r0 >> p.bw_log2) * hw + (r0 & (bw - 1));
  const int q1 = (r1 >> p.bw_log2) * hw + (r1 & (bw - 1));
  int as = 0, bs = 0;
  uint32_t a_phase = 0, b_phase = 0;
  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) part[i] = 0.0f;

  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const Tile tl = tile_of<BN>(p, t);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
    for (int c = 0; c < p.cin; c += kKC) {
      mbar_wait(full_a + 8 * as, a_phase);
      const uint32_t a_slot = a_slots + as * p.a_slot_bytes;
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * hw + tap % 3;
        const int p0 = q0 + off, p1 = q1 + off;
        mbar_wait(full_b + 8 * bs, b_phase);
        const uint32_t b_hi = b_slots + bs * kBSlotBytes, b_lo = b_hi + kHalfSlot;
        uint32_t hi[2][4], lo[2][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int buf = ks & 1;
          load_a(a_slot, p0, p1, ks, t4, hi[buf], lo[buf]);
          wgmma_fence();
          // the small terms first; B advances 8 tf32 = 32 bytes a step
          mma<BN>(part, lo[buf], sw128_desc(b_hi + 32 * ks), ks > 0);
          mma<BN>(part, hi[buf], sw128_desc(b_lo + 32 * ks), 1);
          mma<BN>(part, hi[buf], sw128_desc(b_hi + 32 * ks), 1);
          wgmma_commit();
          if (ks == 1 || ks == 2) wgmma_wait<1>();  // step ks - 1 done: its registers are free
        }
        wgmma_wait<0>();
        fence_operands(part);
        if (lane == 0) mbar_arrive(empty_b + 8 * bs);
        if (++bs == p.b_stages) {
          bs = 0;
          b_phase ^= 1;
        }
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
      }
      if (lane == 0) mbar_arrive(empty_a + 8 * as);
      if (++as == kAStages) {
        as = 0;
        a_phase ^= 1;
      }
    }

    // epilogue: rows r0 and r1, columns co0 + 8j + 2 t4 and the next
    const int ya = tl.y0 + (r0 >> p.bw_log2), xa = tl.x0 + (r0 & (bw - 1));
    const int yb = tl.y0 + (r1 >> p.bw_log2), xb = tl.x0 + (r1 & (bw - 1));
    const bool ok0 = ya < p.hout && xa < p.w, ok1 = yb < p.hout && xb < p.w;
    float* out0 = p.y + ((static_cast<size_t>(tl.img) * p.hout + ya) * p.w + xa) * p.cout;
    float* out1 = p.y + ((static_cast<size_t>(tl.img) * p.hout + yb) * p.w + xb) * p.cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int co = tl.co0 + 8 * j + 2 * t4;
      if (co < p.cout) {
        float b0 = 0.0f, b1 = 0.0f;
        if (p.bias != nullptr) {
          b0 = p.bias[co];
          b1 = p.bias[co + 1];
        }
        if (ok0) *reinterpret_cast<float2*>(out0 + co) = make_float2(acc[4 * j] + b0, acc[4 * j + 1] + b1);
        if (ok1) *reinterpret_cast<float2*>(out1 + co) = make_float2(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
      }
    }
  }
}

// out[h][tap][o][i'] (h = 0 hi, 1 lo; i' the permuted input channel) from a
// weight element (o, i, ky, kx) at w + o s_o + i s_i + ky s_y + kx s_x, the
// taps flipped when `flip` is set.
__global__ void prep_weights_kernel(const float* __restrict__ w, float* __restrict__ out, int cout, int cin,
                                    long long s_o, long long s_i, long long s_y, long long s_x, int flip) {
  const long long total = 9LL * cout * cin;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int il = static_cast<int>(e % cin);
    const long long r = e / cin;
    const int o = static_cast<int>(r % cout);
    const int tap = static_cast<int>(r / cout);
    const int kk = il & 7;
    const int i = (il & ~7) | (kk < 4 ? 2 * kk : 2 * kk - 7);  // columns t, t + 4 <- channels 2t, 2t + 1
    int ky = tap / 3, kx = tap % 3;
    if (flip) {
      ky = 2 - ky;
      kx = 2 - kx;
    }
    const float v = w[o * s_o + i * s_i + ky * s_y + kx * s_x];
    uint32_t hi, lo;
    split(v, hi, lo);
    out[e] = __uint_as_float(hi);
    out[total + e] = __uint_as_float(lo);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no link to libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

int encode(EncodeTiled enc, CUtensorMap* map, const float* ptr, const cuuint64_t (&dims)[4],
           const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4]) {
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

}  // namespace

// Prepares the weights for conv3x3_f32x3_launch: `out` holds 2 * 9 * cout *
// cin floats. Element (o, i, ky, kx) of the weights lies at w + o s_o + i s_i
// + ky s_y + kx s_x (strides in elements). Returns the CUDA error code of the
// launch (0 on success).
extern "C" int conv3x3_f32x3_prep_weights(const float* w, float* out, int cout, int cin, long long s_o,
                                          long long s_i, long long s_y, long long s_x, int flip, void* stream) {
  const long long total = 9LL * cout * cin;
  const int threads = 256;
  const int blocks = static_cast<int>((total + threads - 1) / threads < 4096 ? (total + threads - 1) / threads : 4096);
  prep_weights_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(w, out, cout, cin, s_o, s_i, s_y,
                                                                                  s_x, flip);
  return static_cast<int>(cudaGetLastError());
}

// y (n, hout, w, cout) = the 3x3 conv of x (n, hin, w, cin), both NHWC
// float32 contiguous, with prepared weights `wsplit`, an optional bias
// (cout), a zero H padding of pad_h rows at each end (0, 1 or 2) and of one
// column in W: hout = hin + 2 pad_h - 2. cin and cout are multiples of 32;
// x and wsplit 16-byte aligned. Returns 0, a CUDA error code of the launch,
// or 1000 / 1001 when the tensor maps cannot be made.
extern "C" int conv3x3_f32x3_launch(const float* x, const float* wsplit, const float* bias, float* y, int n, int hin,
                                    int w, int cin, int cout, int pad_h, void* stream) {
  static int sms[kMaxDevices] = {0};  // per device, set at its first launch (before any graph capture)
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kErrNoEncoder;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(conv3x3_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(conv3x3_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(conv3x3_kernel<32>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the N tile: Cout itself up to 64, else 128 (a partial last tile past Cout's multiples of 128)
  const int bn = cout <= 32 ? 32 : cout <= 64 ? 64 : 128;
  const int b_slot_bytes = 2 * bn * kKC * 4;

  Params p;
  p.y = y;
  p.bias = bias;
  p.hout = hin + 2 * pad_h - 2;
  p.w = w;
  p.cin = cin;
  p.cout = cout;
  p.pad_h = pad_h;
  p.bw_log2 = 0;
  while ((1 << p.bw_log2) < w && (1 << p.bw_log2) < kBM) ++p.bw_log2;
  const int bw = 1 << p.bw_log2;
  p.bh = kBM / bw;
  p.tiles_x = (w + bw - 1) / bw;
  p.tiles_y = (p.hout + p.bh - 1) / p.bh;
  p.tiles_n = (cout + bn - 1) / bn;
  p.tiles = n * p.tiles_x * p.tiles_y * p.tiles_n;
  p.a_bytes = (bw + 2) * (p.bh + 2) * kKC * 4;
  p.a_slot_bytes = (p.a_bytes + 1023) / 1024 * 1024;
  const int room = kSmemLimit - 1024 - kBarrierBytes - kAStages * p.a_slot_bytes;
  p.b_stages = room / b_slot_bytes < kMaxBStages ? room / b_slot_bytes : kMaxBStages;
  const int smem = 1024 + kAStages * p.a_slot_bytes + p.b_stages * b_slot_bytes + kBarrierBytes;

  CUtensorMap map_x, map_w;
  const cuuint64_t xdims[4] = {(cuuint64_t)cin, (cuuint64_t)w, (cuuint64_t)hin, (cuuint64_t)n};
  const cuuint64_t xstrides[3] = {(cuuint64_t)cin * 4, (cuuint64_t)w * cin * 4, (cuuint64_t)hin * w * cin * 4};
  const cuuint32_t xbox[4] = {(cuuint32_t)kKC, (cuuint32_t)(bw + 2), (cuuint32_t)(p.bh + 2), 1};
  const cuuint64_t wdims[4] = {(cuuint64_t)cin, (cuuint64_t)cout, 9, 2};
  const cuuint64_t wstrides[3] = {(cuuint64_t)cin * 4, (cuuint64_t)cout * cin * 4, (cuuint64_t)9 * cout * cin * 4};
  const cuuint32_t wbox[4] = {(cuuint32_t)kKC, (cuuint32_t)bn, 1, 1};
  int bad = encode(enc, &map_x, x, xdims, xstrides, xbox);
  if (bad == 0) bad = encode(enc, &map_w, wsplit, wdims, wstrides, wbox);
  if (bad != 0) return bad;

  const int grid = p.tiles < sms[dev] ? p.tiles : sms[dev];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 128) {
    conv3x3_kernel<128><<<grid, kThreads, smem, st>>>(map_x, map_w, p);
  } else if (bn == 64) {
    conv3x3_kernel<64><<<grid, kThreads, smem, st>>>(map_x, map_w, p);
  } else {
    conv3x3_kernel<32><<<grid, kThreads, smem, st>>>(map_x, map_w, p);
  }
  return static_cast<int>(cudaGetLastError());
}
