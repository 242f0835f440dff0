// The tangent (forward-mode derivative) of the fused GroupNorm-apply ->
// SiLU -> 3x3 SAME conv, NHWC, in float32 for Hopper (sm_90a): wgmma in
// 3xTF32 with the activated tangent A in registers and the weights B fed by
// TMA, split-K across a thread-block cluster.
//
// The port's tangent of the TPU kernel soft_truncation_tpu/ops/pallas/
// gn_conv.py::gn_silu_conv3x3 (body _kernel; the JAX package differentiates
// its XLA chain, gn_silu_conv3x3_reference, instead): for tangents dx,
// dmean, drsqrt of x and the per-(sample, group) stats, gamma, beta and w
// held constant, out = conv3x3(SiLU'(a) * da, zero pad), no bias, where
// a = x * scale + shift, da = dx * scale + x * dscale + dshift, scale =
// rsqrt_g * gamma, shift = beta - mean_g * scale, dscale = drsqrt_g * gamma,
// dshift = -(dmean_g * scale + mean_g * dscale) and SiLU'(a) = s (1 + a (1 -
// s)), s = sigmoid(a) (ops/gn_conv.py::gn_silu_conv3x3_jvp_plain). All f32.
// The primal stays in gn_silu_conv3x3.cu, the bf16 modes in
// gn_silu_conv3x3_bf16.cu.
//
// What bounds it on an H100: the function is 2*N*H*W*C*O*9 FLOP on f32
// inputs against the 495 TFLOP/s of dense TF32, or its bytes, 4*(N*H*W*(2C
// + O) + 9*C*O) at 3.35 TB/s: operations at every site of the models. The
// 3xTF32 products below do those FLOP three times over, a cost of the
// f32 bar (1e-4 of max |plain|, which 1xTF32 misses), not of the function.
//
// Design (gn_silu_conv3x3_bf16.cu's, carried over to f32):
//   * GEMM view: M = N*H*W output pixels, N_gemm = O, K = 9*C. A block takes
//     BM = 64 or 128 GEMM rows: R = BM / TW pixel rows of TW = min(W, 64)
//     pixels (whole rows for W <= 64; a 64-pixel segment of one row
//     beyond), and BN = 64, 128 or 256 output channels (ops/gn_conv.py::
//     _jvp_plan), and activates its x and dx halo tile once for all of
//     them. 12 warps: two consumer warpgroups, each a 64 x BN/2 tile (BM
//     64) or a 64 x BN one (BM 128, BN <= 128: the rows split, the weights'
//     tile shared, half the weights' bytes per product) of
//     wgmma.mma_async m64nNk8 tf32 -> f32 with A from registers; three
//     activation warps; one warp that issues the weights' TMA loads.
//   * A, the activated tangent, 32 channels (a chunk: a 128-byte f32 pixel
//     row) at a time: a thread owns 16-byte pieces (a pixel's 4 channels) of
//     the halo tile ((R+2) x (TW+2) pixels), copies them from x and dx by
//     cp.async (zero fill outside x) and writes SiLU'(a) * da once per
//     element, in f32 (with the hardware's approximate exponential and
//     reciprocal), into one of two activated tiles: 128-byte pixel rows
//     whose 16-byte pieces are XOR-swizzled by the pixel index, so that an
//     ldmatrix's 8 rows fall in 8 bank groups. The consumer warps, idle
//     until then, take the first chunk while the activation warps take the
//     second into a second raw tile (one raw tile where two do not fit: then
//     all 11 warps take the first); the activation warps then take each
//     later chunk beside the products of the one before. Halo pixels outside
//     the image are written as 0 (the reference pads the activated tensor,
//     not x: SiLU(shift) != 0, so TMA's zero fill of x would be wrong), and
//     a zero pixel row follows the tile. The 9 taps are 9 shifted views of
//     the tile: each consumer lane reads its rows' A fragments with
//     ldmatrix.x4 (an f32 is two b16 halves: lane l gets word l % 4 of row
//     l / 4, the tf32 fragment's element) from per-row addresses (its
//     pixel's neighbour, or the zero row where the tap leaves the image), 4
//     k8 fragments per tap, and splits each value in registers into hi =
//     tf32(a) and lo = tf32(a - hi). Shifted views do not fit TMA's or
//     wgmma's swizzled layouts, hence the RS form (tf32 wgmma takes A from
//     registers; no transpose, so B is K-major).
//   * 3xTF32: per k8 step a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, accumulated in
//     f32 in that order, as gn_silu_conv3x3.cu orders them.
//   * B, the weights' hi and lo [Op, 9*Cp] f32 (K contiguous, ops/
//     gn_conv.py::jvp_weight_operand): per K step (one tap of a chunk) one
//     TMA box of BN x 32 of each, 128-byte swizzled, through a ring of 2 to
//     4 stages with full / empty mbarriers. The two tensor maps are made on
//     the host once per weight operand (gn_silu_conv3x3_jvp_tensor_map) and
//     passed as __grid_constant__ parameters.
//   * Split-K where the tiles alone leave most SMs idle (every site of the
//     flagship at batch 8 but 32x32 256->256; ops/gn_conv.py::
//     _jvp_plan): a thread-block
//     cluster of S = 2, 4 or 8 blocks along K, block z taking chunks
//     [z * chunks / S, (z + 1) * chunks / S), all 9 taps of each. Each block
//     leaves its f32 partial tile in its own shared memory; after a cluster
//     barrier block z sums rows [z * BM / S, (z + 1) * BM / S) of all S
//     partials through distributed shared memory in rank order and stores
//     them. One launch, no atomics, no workspace: the same bits run after
//     run.
//
// Against the form it replaces (the tangent template of gn_silu_conv3x3.cu:
// mma.sync m16n8k8 in 3xTF32, a 2-stage cp.async ring of one 16-channel K
// step per __syncthreads, split-K through an f32 device workspace and a
// second reduce kernel): here one activated chunk serves 9 taps x 4 k8 x 3
// wgmma per mbarrier, the TMA ring keeps the weights in flight beside the
// products, the activation of the next chunk runs beside them, and the
// split's partials meet in the cluster's shared memory in the same launch.
// What holds it back now (PERF.md): about 8 us fixed per block (launch,
// the first chunk's copy and activation, the cluster's reduce), the
// activation of the halo tile on three warps, and the weights' bytes, which
// every block streams from L2 for its 64 or 128 rows.

#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kMinBM = 64;       // GEMM rows of the smaller block, and the
                                 // widest row segment of a tile
constexpr int kBK = 32;          // channels per chunk: a 128-byte f32 row
constexpr int kRowBytes = kBK * 4;
constexpr int kConsumers = 256;  // two wgmma warpgroups
constexpr int kActivators = 96;  // three activation warps
constexpr int kActive = kConsumers + kActivators;
constexpr int kThreads = kActive + 32;  // + the TMA warp: 12 warps
constexpr int kMaxSplits = 8;    // a portable cluster
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic maximum
constexpr int kAlign = 1024;     // the 128-byte swizzle's period

struct Params {
  const float* x;       // [N, H, W, C]
  const float* dx;      // [N, H, W, C]
  const float* mean;    // [N, G]
  const float* rsqrt;
  const float* dmean;
  const float* drsqrt;
  const float* gamma;   // [C]
  const float* beta;
  float* out;           // [N, H, W, O]
  int N, H, W, C, O, G;
  int rows, cols, segs;  // pixel rows and columns per tile, tiles per row
  int chunks, splits, stages, hp;  // hp: halo pixels
  int raws;              // raw halo tiles: 2 lets chunk 1 load beside 0
};

constexpr int kMaxBM = 128;      // GEMM rows of the larger block

// Shared memory, in bytes from a 1024-aligned base: the weights' ring
// [stages][hi, lo][BN][32] f32 (TMA, 128-byte swizzle; after the main loop
// the block's f32 partial tile [BM][BN + 8]), the activated tiles [2][hp +
// 1] pixel rows of 128 bytes (row hp zero), the raw halo tiles of x and dx
// [raws][2][hp] rows of 128 bytes (the first chunk's, and the later
// chunks' where a second fits), then the mbarriers: full and empty per
// stage, activated-tile full and empty per buffer. ops/gn_conv.py::
// smem_bytes computes the same total.
__host__ __device__ inline int stage_bytes(int bn) {
  return 2 * bn * kRowBytes;
}
__host__ __device__ inline int ring_bytes(int bn, int stages) {
  return stages * stage_bytes(bn);
}
__host__ __device__ inline int act_bytes(int hp) {
  return 2 * (hp + 1) * kRowBytes;
}
__host__ __device__ inline int smem_bytes(int hp, int bn, int stages,
                                          int raws) {
  return kAlign + ring_bytes(bn, stages) + act_bytes(hp) +
         raws * 2 * hp * kRowBytes + 8 * (2 * stages + 4);
}
__host__ __device__ inline int partial_bytes(int bm, int bn) {
  return bm * (bn + 8) * 4;
}

__device__ __forceinline__ uint32_t tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

// D[64 x kN] += A[64 x 8] (registers: the tf32 fragment a0..a3) x B[8 x kN]
// (shared memory, desc), tf32 -> f32
template <int kN>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// d/du SiLU(u) = s (1 + u (1 - s)), s = 1 / (1 + e^-u) by the hardware's
// approximate exponential and reciprocal (a few f32 ulps, far inside the
// 1e-4 bar; the rounded reciprocal and exponential took a third of the
// time at the 32x32 sites, the activation warps being the bottleneck)
__device__ __forceinline__ float silu_grad(float u) {
  float e, s;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(u * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(s) : "f"(1.f + e));
  return s * fmaf(u, 1.f - s, 1.f);
}

template <int kBN, int kBM>
__global__ void __launch_bounds__(kThreads, 1)
gn_silu_conv3x3_jvp_kernel(const __grid_constant__ CUtensorMap whi,
                           const __grid_constant__ CUtensorMap wlo,
                           const Params p) {
  // the consumer warpgroups split the rows (BM 128) or the columns (BM 64)
  constexpr bool kRowSplit = kBM == 128;
  constexpr int kWN = kRowSplit ? kBN : kBN / 2;  // a warpgroup's columns
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + kAlign - 1) & ~(kAlign - 1);
  unsigned char* smem = smem_raw + (base - raw_base);
  const int hp = p.hp;
  const int stages = p.stages;
  const uint32_t ring = base;
  const uint32_t act0 = ring + ring_bytes(kBN, stages);
  const uint32_t raw = act0 + act_bytes(hp);
  const uint32_t bars = raw + p.raws * 2 * hp * kRowBytes;
  const uint32_t full_b = bars;                  // [stages]
  const uint32_t empty_b = bars + 8 * stages;    // [stages]
  const uint32_t act_full = bars + 16 * stages;  // [2]
  const uint32_t act_empty = act_full + 16;      // [2]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * kBN;
  const int seg = blockIdx.y % p.segs;
  const int row0 = (blockIdx.y / p.segs) * p.rows;  // first pixel row n*H+y
  const int x0 = seg * p.cols;
  const int NH = p.N * p.H;
  const int W2 = p.cols + 2;
  const int split = blockIdx.z;
  const int ch0 = split * p.chunks / p.splits;
  const int ch1 = (split + 1) * p.chunks / p.splits;

  // ---- activation ------------------------------------------------------
  // A pass of T threads activates a chunk's halo tile: thread t owns the
  // 16-byte pieces (pixel t / 8 + (T / 8) * j, channels 4 * (t % 8) .. + 3):
  // it copies them from x and dx by cp.async into a raw tile and writes
  // them activated into an activated tile. The first chunk is the consumer
  // warps' (T = kConsumers), idle until it is done, while the activation
  // warps (T = kActivators) copy and activate the second into the second
  // raw tile, and then each later one beside the products of the one
  // before. Where only one raw tile fits, all 11 warps but the TMA warp
  // take the first chunk (T = kActive) before the activation warps reuse
  // its raw tile.
  const int q = tid & 7;
  const float* srcs[2] = {p.x, p.dx};
  const float inv_h = 1.f / p.H;
  const float inv_cg = 1.f / (p.C / p.G);
  const bool exact_img = NH < (1 << 22);  // (row + 0.5) * inv_h is exact
  // the per-channel fold of image img (its group's stats and tangents)
  auto fold = [&](int img, int c, float& sc, float& sh, float& dsc,
                  float& dsh) {
    const int g = img * p.G + static_cast<int>((c + 0.5f) * inv_cg);
    const float gam = __ldg(p.gamma + c);
    const float mg = __ldg(p.mean + g);
    sc = __fmul_rn(__ldg(p.rsqrt + g), gam);
    sh = __fsub_rn(__ldg(p.beta + c), __fmul_rn(mg, sc));
    dsc = __fmul_rn(__ldg(p.drsqrt + g), gam);
    dsh = -fmaf(__ldg(p.dmean + g), sc, __fmul_rn(mg, dsc));
  };
  auto copy_raw = [&](int ch, int t, int threads, uint32_t tile) {
    const int c = ch * kBK + 4 * q;
    const int step = threads / 8;
    int pr = (t >> 3) / W2;
    int pc = (t >> 3) - pr * W2;
    for (int pix = t >> 3; pix < hp; pix += step) {
      const int row = row0 - 1 + pr;
      const int xc = x0 - 1 + pc;
      const bool in = row >= 0 && row < NH && xc >= 0 && xc < p.W && c < p.C;
      const size_t off = in ? ((size_t)row * p.W + xc) * p.C + c : 0;
#pragma unroll
      for (int st = 0; st < 2; ++st)
        cp_async16(tile + (st * hp + pix) * kRowBytes + 16 * q, srcs[st] + off,
                   in ? 16 : 0);
      pc += step;
      while (pc >= W2) {
        pc -= W2;
        ++pr;
      }
    }
    cp_async_commit();
  };
  // this thread's pieces of chunk ch, from raw tile ``tile`` into activated
  // tile b (the thread's own cp.async copies must have landed)
  auto activate = [&](int ch, int b, int t, int threads, uint32_t tile) {
    const int c0 = ch * kBK + 4 * q;
    const int step = threads / 8;
    const unsigned char* rawp = smem + (tile - base);
    unsigned char* actp = smem + (act0 - base) + b * (hp + 1) * kRowBytes;
    int pr = (t >> 3) / W2;
    int pc = (t >> 3) - pr * W2;
    int cur = -1;  // the image whose fold sc, sh, dsc, dsh hold
    float sc[4], sh[4], dsc[4], dsh[4];
    for (int pix = t >> 3; pix < hp; pix += step) {
      const int row = row0 - 1 + pr;
      const int xc = x0 - 1 + pc;
      pc += step;
      while (pc >= W2) {
        pc -= W2;
        ++pr;
      }
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row >= 0 && row < NH && xc >= 0 && xc < p.W && c0 < p.C) {
        const int img = exact_img ? static_cast<int>((row + 0.5f) * inv_h)
                                  : row / p.H;
        if (img != cur) {
          cur = img;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            fold(img, c0 + e, sc[e], sh[e], dsc[e], dsh[e]);
        }
        const float4 v =
            *reinterpret_cast<const float4*>(rawp + pix * kRowBytes + 16 * q);
        const float4 dv = *reinterpret_cast<const float4*>(
            rawp + (hp + pix) * kRowBytes + 16 * q);
        const float vv[4] = {v.x, v.y, v.z, v.w};
        const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float u = fmaf(vv[e], sc[e], sh[e]);
          o[e] = silu_grad(u) * fmaf(dd[e], sc[e], fmaf(vv[e], dsc[e], dsh[e]));
        }
        a = make_float4(o[0], o[1], o[2], o[3]);
      }
      *reinterpret_cast<float4*>(actp + pix * kRowBytes +
                                 ((q ^ (pix & 7)) << 4)) = a;
    }
  };

  const bool active = tid < kActive;
  const int first = p.raws == 2 ? kConsumers : kActive;  // chunk 0's threads
  const uint32_t later = raw + (p.raws - 1) * 2 * hp * kRowBytes;
  const bool activator = active && tid >= kConsumers;
  if (tid < first) copy_raw(ch0, tid, first, raw);  // beside the set-up
  if (activator && p.raws == 2 && ch0 + 1 < ch1)
    copy_raw(ch0 + 1, tid - kConsumers, kActivators, later);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_b + 8 * s, 1);
      mbar_init(empty_b + 8 * s, kConsumers / 32);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(act_full + 8 * b, kActivators);
      mbar_init(act_empty + 8 * b, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the zero pixel row of both activated tiles
  if (tid < 2 * kRowBytes / 16) {
    const int b = tid / (kRowBytes / 16);
    *reinterpret_cast<uint4*>(smem + (act0 - base) +
                              (b * (hp + 1) + hp) * kRowBytes +
                              (tid % (kRowBytes / 16)) * 16) =
        make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  // the first chunk; the named barrier publishes it (and, with one raw
  // tile, frees it for the activation warps)
  if (tid < first) {
    cp_async_wait_all();
    activate(ch0, 0, tid, first, raw);
    asm volatile("bar.sync 1, %0;\n" ::"r"(first) : "memory");
  }

  float acc[kWN / 2];
#pragma unroll
  for (int i = 0; i < kWN / 2; ++i) acc[i] = 0.f;

  if (warp < kConsumers / 32) {
    // ---- consumers: 9 taps x 4 k8 x 3 products per activated chunk ----
    const int half = warp >> 2;  // which 64 rows, or which BN/2 columns
    const int row_base = kRowSplit ? 64 * half : 0;
    const int col_base = kRowSplit ? 0 : half * kWN;
    const int w4 = warp & 3;     // rows 16 * w4 .. + 15 of the 64
    const int khalf = lane >> 4;
    // this lane's ldmatrix row: its pixel's neighbour at dy = -1, 0, 1
    // (dx = 0) in the halo tile, or -1 for a zero
    int nb[3];
    {
      const int m = row_base + 16 * w4 + (lane & 15);
      const int r = m / p.cols;
      const int j = m - r * p.cols;
      const int row = row0 + r;
      const bool ok = r < p.rows && row < NH && x0 + j < p.W;
      const int y = row % p.H;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
        nb[dy + 1] = ok && y + dy >= 0 && y + dy < p.H
                         ? (r + 1 + dy) * W2 + j + 1
                         : -1;
    }
    uint32_t ahi[2][4][4], alo[2][4][4];
    int s = 0;
    uint32_t phase = 0;
    int prev = 0;
    for (int ch = ch0, i = 0; ch < ch1; ++ch, ++i) {
      const int b = i & 1;
      const uint32_t act = act0 + b * (hp + 1) * kRowBytes;
      // chunk 0 came with the named barrier; chunk i >= 1 is the
      // ((i - 1) / 2)-th completion of its tile's barrier
      if (i > 0) mbar_wait(act_full + 8 * b, ((i - 1) >> 1) & 1);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dyi = tap / 3;
        const int px = nb[dyi] < 0 ? hp : nb[dyi] + tap % 3 - 1;
        const uint32_t row_addr = act + px * kRowBytes;
        const int sw = px & 7;
        uint32_t(&hi)[4][4] = ahi[tap & 1];
        uint32_t(&lo)[4][4] = alo[tap & 1];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t f[4];
          ldmatrix_x4(f, row_addr + (((2 * kk + khalf) ^ sw) << 4));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = __uint_as_float(f[e]);
            hi[kk][e] = tf32(v);
            lo[kk][e] = tf32(v - __uint_as_float(hi[kk][e]));
          }
        }
        if (tap == 8) {
          // every ldmatrix of this chunk has returned: the tile is free
          __syncwarp();
          if (lane == 0) mbar_arrive(act_empty + 8 * b);
        }
        mbar_wait(full_b + 8 * s, phase);
        const uint32_t stage = ring + s * stage_bytes(kBN) + col_base *
                                                                 kRowBytes;
        const uint64_t dhi = b_desc(stage);
        const uint64_t dlo = b_desc(stage + kBN * kRowBytes);
        wgmma_fence();
        fence_operands(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          Wgmma<kWN>::mma(acc, lo[kk], dhi + 2 * kk);
          Wgmma<kWN>::mma(acc, hi[kk], dlo + 2 * kk);
          Wgmma<kWN>::mma(acc, hi[kk], dhi + 2 * kk);
        }
        wgmma_commit();
        fence_operands(acc);
        if (tap > 0) {
          // the previous step's products are done: its stage (and its A
          // registers) are free
          wgmma_wait<1>();
          fence_operands(acc);
          if (lane == 0) mbar_arrive(empty_b + 8 * prev);
        }
        prev = s;
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lane == 0) mbar_arrive(empty_b + 8 * prev);
    }
  } else if (activator) {
    // ---- activation warps: the chunks after the first -----------------
    const int t = tid - kConsumers;
    for (int ch = ch0 + 1, i = 1; ch < ch1; ++ch, ++i) {
      const int b = i & 1;
      if (i > 1 || p.raws == 1) copy_raw(ch, t, kActivators, later);
      cp_async_wait_all();
      mbar_wait(act_empty + 8 * b, ((i >> 1) & 1) ^ 1);
      activate(ch, b, t, kActivators, later);
      mbar_arrive(act_full + 8 * b);
    }
  } else if (lane == 0) {
    // ---- the weights: hi and lo boxes of BN x 32 per (chunk, tap) ------
    int s = 0;
    uint32_t phase = 0;
    for (int ch = ch0; ch < ch1; ++ch) {
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t stage = ring + s * stage_bytes(kBN);
        const int k = tap * (p.chunks * kBK) + ch * kBK;
        mbar_wait(empty_b + 8 * s, phase ^ 1);
        mbar_expect_tx(full_b + 8 * s, stage_bytes(kBN));
        tma_load_2d(stage, &whi, full_b + 8 * s, k, n0);
        tma_load_2d(stage + kBN * kRowBytes, &wlo, full_b + 8 * s, k, n0);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  }

  // ---- epilogue: the partial tile through shared memory ----------------
  __syncthreads();  // every role is done with the ring
  constexpr int kPStride = kBN + 8;  // floats per partial row
  float* part = reinterpret_cast<float*>(smem);
  if (warp < kConsumers / 32) {
    const int half = warp >> 2;
    const int g = lane >> 2;
    const int qq = lane & 3;
    const int m0 = (kRowSplit ? 64 * half : 0) + 16 * (warp & 3) + g;
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j) {
      const int col = (kRowSplit ? 0 : half * kWN) + 8 * j + 2 * qq;
      *reinterpret_cast<float2*>(part + m0 * kPStride + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(part + (m0 + 8) * kPStride + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  if (p.splits > 1) {
    cluster_sync();  // every block's partial tile is in place
  } else {
    __syncthreads();
  }
  const int rank = p.splits > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int per = kBM / p.splits;  // rows this block reduces and stores
  // each thread takes 4 columns over the rows it takes
  constexpr int kVec = kBN / 4;
  constexpr int kRowStep = kThreads / kVec;
  const int col = (tid % kVec) * 4;
  const int o = n0 + col;
  for (int mr = tid / kVec; mr < per && tid < kRowStep * kVec;
       mr += kRowStep) {
    const int m = rank * per + mr;
    const int r = m / p.cols;
    const int j = m - r * p.cols;
    const int row = row0 + r;
    if (r >= p.rows || row >= NH || x0 + j >= p.W || o >= p.O) continue;
    float4 v;
    if (p.splits == 1) {
      v = *reinterpret_cast<const float4*>(part + m * kPStride + col);
    } else {
      // every rank's partial first, then the sum in rank order
      const uint32_t addr = base + (m * kPStride + col) * 4;
      float4 pk[kMaxSplits];
#pragma unroll
      for (int k = 0; k < kMaxSplits; ++k)
        if (k < p.splits) pk[k] = ld_cluster4(addr, k);
      v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kMaxSplits; ++k)
        if (k < p.splits) {
          v.x += pk[k].x;
          v.y += pk[k].y;
          v.z += pk[k].z;
          v.w += pk[k].w;
        }
    }
    float* dst = p.out + ((size_t)row * p.W + x0 + j) * p.O + o;
    if ((p.O & 3) == 0) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (o + e < p.O) dst[e] = vs[e];
    }
  }
  if (p.splits > 1) cluster_sync();  // no block leaves while read
}

template <int kBN, int kBM>
int launch_bn(const CUtensorMap& hi, const CUtensorMap& lo, const Params& p,
              int grid_y, cudaStream_t stream) {
  auto kernel = gn_silu_conv3x3_jvp_kernel<kBN, kBM>;
  const int smem = smem_bytes(p.hp, kBN, p.stages, p.raws);
  if (smem > kMaxSmem || partial_bytes(kBM, kBN) > ring_bytes(kBN, p.stages))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured[kMaxDevices] = {};  // per instantiation
  cudaError_t err = allow_smem(kernel, kMaxSmem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)((p.O + kBN - 1) / kBN), (unsigned)grid_y,
                        (unsigned)p.splits);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = p.splits;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, hi, lo, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).

// Writes the 128-byte tensor map of a weight operand ``w`` ([rows, k] f32,
// k contiguous: hi or lo of ops/gn_conv.py::jvp_weight_operand) for boxes
// of 32 x box_n into ``map_out``; returns 0, or a CUresult / cudaError
// code. It binds the device's primary context where the calling thread
// has none (hopper.cuh).
extern "C" int gn_silu_conv3x3_jvp_tensor_map(const void* w, int rows, int k,
                                              int box_n, void* map_out) {
  if (w == nullptr || rows < 1 || k < kBK || k % kBK || box_n < 1 ||
      box_n > 256 || rows % box_n)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const int r = k_major_map(CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w, rows, k,
                            box_n, &map);
  if (r != 0) return r;
  memcpy(map_out, &map, sizeof(map));
  return 0;
}

// The size in bytes of the map gn_silu_conv3x3_jvp_tensor_map writes.
extern "C" int gn_silu_conv3x3_jvp_tensor_map_bytes() {
  return static_cast<int>(sizeof(CUtensorMap));
}

// out = the tangent (header) for tangents dx, dmean, drsqrt. All tensors
// are contiguous f32 on the current device: x and dx [N,H,W,C] (16-byte
// aligned), mean/rsqrt and dmean/drsqrt [N,G], gamma/beta [C], out
// [N,H,W,O]. ``map_hi`` / ``map_lo`` are the host copies of the tensor maps
// of the weights' hi and lo [Op, 9*Cp] (block_n rows per box). C % 4 == 0,
// Cp a multiple of 32 >= C, Op a multiple of block_n (64, 128 or 256) >=
// O; block_m 64 or 128 GEMM rows (128 with block_n <= 128); cols = min(W,
// 64) pixels and rows <= block_m / cols pixel rows per tile; splits (the
// cluster along K) 1, 2, 4 or 8 and <= Cp / 32; stages (the weights' ring)
// 2..8 and raws (raw halo tiles) 1 or 2 within shared memory. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int gn_silu_conv3x3_jvp_tf32x3(
    const float* x, const float* dx, const float* mean, const float* dmean,
    const float* rsqrt, const float* drsqrt, const float* gamma,
    const float* beta, const void* map_hi, const void* map_lo, float* out,
    int N, int H, int W, int C, int O, int G, int Cp, int Op, int rows,
    int cols, int block_n, int splits, int stages, int raws, int block_m,
    void* stream) {
  Params p = {};
  p.x = x;
  p.dx = dx;
  p.mean = mean;
  p.rsqrt = rsqrt;
  p.dmean = dmean;
  p.drsqrt = drsqrt;
  p.gamma = gamma;
  p.beta = beta;
  p.out = out;
  p.N = N;
  p.H = H;
  p.W = W;
  p.C = C;
  p.O = O;
  p.G = G;
  p.rows = rows;
  p.cols = cols;
  p.splits = splits;
  p.stages = stages;
  p.raws = raws;
  const long long M = (long long)N * H * W;
  if (map_hi == nullptr || map_lo == nullptr || x == nullptr ||
      dx == nullptr || mean == nullptr || rsqrt == nullptr ||
      dmean == nullptr || drsqrt == nullptr || gamma == nullptr ||
      beta == nullptr || out == nullptr || N < 1 || H < 1 || W < 1 ||
      C < 4 || C % 4 || O < 1 || G < 1 || C % G || Cp % kBK || Cp < C ||
      (block_n != 64 && block_n != 128 && block_n != 256) || Op % block_n ||
      Op < O || (block_m != kMinBM && block_m != kMaxBM) ||
      (block_m == kMaxBM && block_n > 128) ||
      cols != (W < kMinBM ? W : kMinBM) ||
      rows < 1 || rows * cols > block_m || splits < 1 ||
      splits > kMaxSplits || splits > Cp / kBK || stages < 2 || stages > 8 ||
      raws < 1 || raws > 2 || M * C >= (1LL << 31) || M * O >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(dx) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.segs = (W + cols - 1) / cols;
  p.chunks = Cp / kBK;
  p.hp = (rows + 2) * (cols + 2);
  const long long grid_y = ((long long)N * H + rows - 1) / rows * p.segs;
  if (grid_y > 65535 || Op / block_n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap hi, lo;
  memcpy(&hi, map_hi, sizeof(hi));
  memcpy(&lo, map_lo, sizeof(lo));
  const auto s = static_cast<cudaStream_t>(stream);
  if (block_m == kMaxBM)
    return block_n == 64 ? launch_bn<64, kMaxBM>(hi, lo, p, (int)grid_y, s)
                         : launch_bn<128, kMaxBM>(hi, lo, p, (int)grid_y, s);
  switch (block_n) {
    case 64:
      return launch_bn<64, kMinBM>(hi, lo, p, (int)grid_y, s);
    case 128:
      return launch_bn<128, kMinBM>(hi, lo, p, (int)grid_y, s);
    default:
      return launch_bn<256, kMinBM>(hi, lo, p, (int)grid_y, s);
  }
}
