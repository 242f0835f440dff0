// Fused GroupNorm-apply -> SiLU -> 3x3 SAME conv, NHWC, in bfloat16 for
// Hopper (sm_90a): wgmma with the activated operand A in registers and the
// weights B fed by TMA, and the tangent (forward-mode derivative) from the
// same source.
//
// Replaces, in bfloat16, the TPU kernel soft_truncation_tpu/ops/pallas/
// gn_conv.py::gn_silu_conv3x3 (body _kernel):  out = conv3x3(SiLU(x * scale
// + shift), zero pad) + b, with scale = rsqrt_g * gamma and shift = beta -
// mean_g * scale folded per (sample, channel) from the per-(sample, group)
// stats. x, w, b and out are bf16; the stats, gamma and beta f32. The fold
// and SiLU run in f32 and are rounded once to bf16 before the products (the
// TPU kernel rounds SiLU to w.dtype), the sums are f32, the bias is added in
// f32 and the output rounded to bf16 once. The tangent (tangents dx, dmean,
// drsqrt; gamma, beta, w held constant) is conv3x3(SiLU'(a) * da, zero pad),
// no bias, with SiLU'(a) * da rounded to bf16 before the products. The f32
// modes stay in gn_silu_conv3x3.cu.
//
// What bounds it on an H100: the function is 2*N*H*W*C*O*9 FLOP against the
// 989 TFLOP/s of dense bf16, or its bytes, 2*(N*H*W*(C+O) + 9*C*O) (x read
// twice in the tangent), at 3.35 TB/s: operations at every site of the
// models (8x8 and 4x4 sites at batch 8 are a microsecond either way, so
// there the launch and the pipeline's fill are what is left).
//
// Design:
//   * GEMM view: M = N*H*W output pixels, N_gemm = O, K = 9*C. A block takes
//     64 GEMM rows: R = 64 / TW pixel rows of TW = min(W, 64) pixels (whole
//     rows for W <= 64; a 64-pixel segment of one row beyond), and BN = 64,
//     128 or 256 output channels (the least of those >= O, 256 past it), so
//     at O <= 256 x is activated once per block. 12 warps: two consumer
//     warpgroups, each a 64 x BN/2 tile of wgmma.mma_async m64n{BN/2}k16
//     bf16 -> f32 with A from registers; three activation warps; one warp
//     that issues the weights' TMA loads. 168 registers a thread.
//   * A, the activated tile, 64 channels (a chunk) at a time: a thread owns
//     16-byte pieces (a pixel's 8 channels) of the halo tile ((R+2) x (TW+2)
//     pixels), copies them from x by cp.async (16-byte copies where C % 8 ==
//     0, 8-byte ones otherwise, zero fill outside x) and writes SiLU(x *
//     scale + shift) (or SiLU'(a) * da) once per element, in f32 with the
//     hardware's approximate exp2 and reciprocal, rounded to bf16, into one
//     of two activated tiles: 128-byte pixel rows whose 16-byte pieces are
//     XOR-swizzled by the pixel index, so that an ldmatrix's 8 rows fall in
//     8 bank groups. The consumer warps, idle until then, take the first
//     chunk while the activation warps take the second into a second raw
//     tile (one raw tile where two do not fit: then all 11 warps take the
//     first); the activation warps then take each later chunk beside the
//     products of the one before. Halo pixels outside the image are written
//     as 0 (the reference pads the activated tensor, not x: SiLU(shift) !=
//     0, so TMA's zero fill of x would be wrong), and a zero pixel row
//     follows the tile. The 9 taps are 9 shifted views of the tile: each
//     consumer lane builds its rows' A fragments with ldmatrix.x4 from
//     per-row addresses (its pixel's neighbour, or the zero row where the
//     tap leaves the image), 4 k16 fragments per tap. Shifted views do not
//     fit TMA's or wgmma's swizzled layouts, hence the RS form.
//   * B, the weights [Op, 9*Cp] (K contiguous, ops/gn_conv.py::
//     weight_operand): one TMA box of BN x 64 per K step (one tap of a
//     chunk), 128-byte swizzled, through a ring of 3 or 4 stages with full /
//     empty mbarriers. The tensor map is made on the host once per weight
//     operand (gn_silu_conv3x3_bf16_tensor_map) and passed as a
//     __grid_constant__ parameter.
//   * Split-K where the tiles alone leave most SMs idle (the 16x16, 8x8 and
//     4x4 sites at batch 8; ops/gn_conv.py::launch_plan): a thread-block
//     cluster of S = 2, 4 or 8 blocks along K (no more clusters than the
//     card holds at once), block z taking chunks [z * chunks / S, (z + 1) *
//     chunks / S), all 9 taps of each. Each block leaves its f32 partial
//     tile in its own shared memory; after a cluster barrier block z sums
//     rows [z * 64 / S, (z + 1) * 64 / S) of all S partials through
//     distributed shared memory in rank order, adds the bias and stores
//     bf16. One launch, no atomics, no workspace: the same bits run after
//     run.
//
// The three costs of the earlier bf16 form (a mode of gn_silu_conv3x3.cu,
// mma.sync m16n8k16) and what this one does about each:
//   1. one 16-channel K step per __syncthreads over a 2-stage ring: here a
//      chunk's activated tile serves 9 taps x 4 wgmma k16 steps per
//      mbarrier, the weights' ring keeps 3-4 TMA loads in flight, and the
//      activation of the next chunk runs beside the products;
//   2. split-K's f32 partial sums through a device-memory workspace (16.8 MB
//      each way at 32x32, 128->128) and a second reduce kernel: here no
//      split at 32x32 (128 blocks of 64 rows fill the card), and elsewhere
//      the partials meet in the cluster's shared memory, in the same launch;
//   3. x activated once per 128-wide output tile, twice at O = 256: here a
//      block covers O up to 256, so each x element of its halo tile is
//      activated once.
// What holds it back now (PERF.md): the activation, issue- and latency-
// bound on 3 warps beside the products, and each block's fixed cost
// (launch, the first chunk's copy and activation, the epilogue).

#include <cuda_bf16.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 64;         // GEMM rows (output pixels) per block
constexpr int kBK = 64;         // channels per chunk: a 128-byte pixel row
constexpr int kRowBytes = kBK * 2;
constexpr int kConsumers = 256;  // two wgmma warpgroups
constexpr int kActivators = 96;  // three activation warps
constexpr int kActive = kConsumers + kActivators;
constexpr int kThreads = kActive + 32;  // + the TMA warp: 12 warps
constexpr int kMaxSplits = 8;   // a portable cluster
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic maximum
constexpr int kAlign = 1024;    // the 128-byte swizzle's period

struct Params {
  const __nv_bfloat16* x;   // [N, H, W, C]
  const __nv_bfloat16* dx;  // [N, H, W, C], tangent only
  const float* mean;        // [N, G]
  const float* rsqrt;
  const float* dmean;       // tangent only
  const float* drsqrt;
  const float* gamma;       // [C]
  const float* beta;
  const __nv_bfloat16* bias;  // [O], primal only
  __nv_bfloat16* out;         // [N, H, W, O]
  int N, H, W, C, O, G;
  int rows, cols, segs;  // pixel rows and columns per tile, tiles per row
  int chunks, splits, stages, hp;  // hp: halo pixels
  int raws;              // raw halo tiles: 2 lets chunk 1 load beside 0
  int vec16;             // 16-byte copies of x (C % 8 == 0, aligned)
};

// Shared memory, in bytes from a 1024-aligned base: the weights' ring
// [stages][BN][64] bf16 (TMA, 128-byte swizzle; after the main loop the
// block's f32 partial tile [64][BN + 8]), the activated tiles [2][hp + 1]
// pixel rows of 128 bytes (row hp zero), the raw halo tiles of x (and of
// dx) [raws][streams][hp] rows of 128 bytes (the first chunk's, and the
// later chunks' where a second fits), then the mbarriers: full and empty per
// stage, activated-tile full and empty per buffer. ops/gn_conv.py::
// smem_bytes computes the same total.
__host__ __device__ inline int ring_bytes(int bn, int stages) {
  return stages * bn * kRowBytes;
}
__host__ __device__ inline int act_bytes(int hp) {
  return 2 * (hp + 1) * kRowBytes;
}
__host__ __device__ inline int smem_bytes(int hp, int bn, int stages,
                                          int streams, int raws) {
  return kAlign + ring_bytes(bn, stages) + act_bytes(hp) +
         raws * streams * hp * kRowBytes + 8 * (2 * stages + 4);
}
__host__ __device__ inline int partial_bytes(int bn) {
  return kBM * (bn + 8) * 4;
}

// D[64 x kN] += A[64 x 16] (registers, ldmatrix fragments) x B[16 x kN]
// (shared memory, desc), bf16 -> f32
template <int kN>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
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
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
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
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

// 1 / (1 + e^-u) by the hardware's approximate exponential and reciprocal
// (a few f32 ulps; the activation is rounded to bf16): 0 for u -> -inf
__device__ __forceinline__ float sigmoid(float u) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(u * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.f + e));
  return r;
}

__device__ __forceinline__ float silu(float u) { return u * sigmoid(u); }

// d/du SiLU(u) = s (1 + u (1 - s)), s = sigmoid(u)
__device__ __forceinline__ float silu_grad(float u) {
  const float s = sigmoid(u);
  return s * fmaf(u, 1.f - s, 1.f);
}

__device__ __forceinline__ void unpack8(const uint4& q, float (&v)[8]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&a)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool kTangent, int kBN>
__global__ void __launch_bounds__(kThreads, 1)
gn_silu_conv3x3_bf16_kernel(const __grid_constant__ CUtensorMap wmap,
                            const Params p) {
  constexpr int kStreams = kTangent ? 2 : 1;
  constexpr int kWN = kBN / 2;  // each consumer warpgroup's columns
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + kAlign - 1) & ~(kAlign - 1);
  unsigned char* smem = smem_raw + (base - raw_base);
  const int hp = p.hp;
  const int stages = p.stages;
  const uint32_t ring = base;
  const uint32_t act0 = ring + ring_bytes(kBN, stages);
  const uint32_t raw = act0 + act_bytes(hp);
  const uint32_t bars = raw + p.raws * kStreams * hp * kRowBytes;
  const uint32_t full_b = bars;                 // [stages]
  const uint32_t empty_b = bars + 8 * stages;   // [stages]
  const uint32_t act_full = bars + 16 * stages;  // [2]
  const uint32_t act_empty = act_full + 16;     // [2]

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
  // 16-byte pieces (pixel t / 8 + (T / 8) * j, channels 8 * (t % 8) .. + 7):
  // it copies them from x (and dx) by cp.async into the raw tile and writes
  // them activated into an activated tile. The first chunk is the consumer
  // warps' (T = kConsumers), idle until it is done, while the activation
  // warps (T = kActivators) copy and activate the second into the second
  // raw tile, and then each later one beside the products of the one
  // before. Where only one raw tile fits, all 11 warps but the TMA warp
  // take the first chunk (T = kActive) before the activation warps reuse
  // its raw tile.
  const int q = tid & 7;
  const __nv_bfloat16* srcs[2] = {p.x, p.dx};
  const float inv_h = 1.f / p.H;
  const float inv_cg = 1.f / (p.C / p.G);
  const bool exact_img = NH < (1 << 22);  // (row + 0.5) * inv_h is exact
  // the per-channel fold of image img (its group's stats) into sc, sh
  // (dsc, dsh)
  auto fold = [&](int img, int c, float& sc, float& sh, float& dsc,
                  float& dsh) {
    const bool in = c < p.C;
    const int cc = in ? c : p.C - 1;
    const int g = img * p.G + static_cast<int>((cc + 0.5f) * inv_cg);
    const float gam = in ? __ldg(p.gamma + cc) : 0.f;
    const float mg = __ldg(p.mean + g);
    sc = __fmul_rn(__ldg(p.rsqrt + g), gam);
    sh = __fsub_rn(in ? __ldg(p.beta + cc) : 0.f, __fmul_rn(mg, sc));
    if (kTangent) {
      dsc = __fmul_rn(__ldg(p.drsqrt + g), gam);
      dsh = -fmaf(__ldg(p.dmean + g), sc, __fmul_rn(mg, dsc));
    }
  };
  auto copy_raw = [&](int ch, int t, int threads, uint32_t tile) {
    const int c = ch * kBK + 8 * q;
    const int step = threads / 8;
    int pr = (t >> 3) / W2;
    int pc = (t >> 3) - pr * W2;
    for (int pix = t >> 3; pix < hp; pix += step) {
      const int row = row0 - 1 + pr;
      const int xc = x0 - 1 + pc;
      const bool ok = row >= 0 && row < NH && xc >= 0 && xc < p.W;
      const size_t off = ok ? ((size_t)row * p.W + xc) * p.C + c : 0;
#pragma unroll
      for (int st = 0; st < kStreams; ++st) {
        const __nv_bfloat16* src = srcs[st];
        const uint32_t dst = tile + (st * hp + pix) * kRowBytes + 16 * q;
        if (p.vec16) {
          const bool in = ok && c < p.C;
          cp_async16(dst, src + (in ? off : 0), in ? 16 : 0);
        } else {
          const bool lo = ok && c < p.C;
          const bool hi = ok && c + 4 < p.C;
          cp_async8(dst, src + (lo ? off : 0), lo ? 8 : 0);
          cp_async8(dst + 8, src + (hi ? off + 4 : 0), hi ? 8 : 0);
        }
      }
      pc += step;
      while (pc >= W2) {
        pc -= W2;
        ++pr;
      }
    }
    cp_async_commit();
  };
  // this thread's pieces of chunk ch, from the raw tile into activated tile
  // b from raw tile ``tile`` (the thread's own cp.async copies must have
  // landed)
  auto activate = [&](int ch, int b, int t, int threads, uint32_t tile) {
    const int c0 = ch * kBK + 8 * q;
    const int step = threads / 8;
    const unsigned char* rawp = smem + (tile - base);
    unsigned char* actp = smem + (act0 - base) + b * (hp + 1) * kRowBytes;
    int pr = (t >> 3) / W2;
    int pc = (t >> 3) - pr * W2;
    int cur = -1;  // the image whose fold sc, sh (dsc, dsh) hold
    float sc[8], sh[8], dsc[8], dsh[8];
    for (int pix = t >> 3; pix < hp; pix += step) {
      const int row = row0 - 1 + pr;
      const int xc = x0 - 1 + pc;
      pc += step;
      while (pc >= W2) {
        pc -= W2;
        ++pr;
      }
      float a[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] = 0.f;
      if (row >= 0 && row < NH && xc >= 0 && xc < p.W && c0 < p.C) {
        const int img = exact_img ? static_cast<int>((row + 0.5f) * inv_h)
                                  : row / p.H;
        if (img != cur) {
          cur = img;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            fold(img, c0 + e, sc[e], sh[e], dsc[e], dsh[e]);
        }
        float v[8];
        unpack8(*reinterpret_cast<const uint4*>(rawp + pix * kRowBytes +
                                                16 * q),
                v);
        if (kTangent) {
          float dv[8];
          unpack8(*reinterpret_cast<const uint4*>(
                      rawp + (hp + pix) * kRowBytes + 16 * q),
                  dv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float u = fmaf(v[e], sc[e], sh[e]);
            a[e] = silu_grad(u) *
                   fmaf(dv[e], sc[e], fmaf(v[e], dsc[e], dsh[e]));
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) a[e] = silu(fmaf(v[e], sc[e], sh[e]));
        }
      }
      *reinterpret_cast<uint4*>(actp + pix * kRowBytes +
                                ((q ^ (pix & 7)) << 4)) = pack8(a);
    }
  };

  const bool active = tid < kActive;
  const int first = p.raws == 2 ? kConsumers : kActive;  // chunk 0's threads
  const uint32_t later = raw + (p.raws - 1) * kStreams * hp * kRowBytes;
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
    // ---- consumers: 9 taps x 4 k16 products per activated chunk -------
    const int half = warp >> 2;  // which BN/2 columns
    const int w4 = warp & 3;     // rows 16 * w4 .. + 15 of the 64
    const int khalf = lane >> 4;
    // this lane's ldmatrix row: its pixel's neighbour at dy = -1, 0, 1
    // (dx = 0) in the halo tile, or -1 for a zero
    int nb[3];
    {
      const int m = 16 * w4 + (lane & 15);
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
    uint32_t afrag[2][4][4];
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
        mbar_wait(full_b + 8 * s, phase);
        const int dyi = tap / 3;
        const int px = nb[dyi] < 0 ? hp : nb[dyi] + tap % 3 - 1;
        const uint32_t row_addr = act + px * kRowBytes;
        const int sw = px & 7;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldmatrix_x4(afrag[tap & 1][kk],
                      row_addr + (((2 * kk + khalf) ^ sw) << 4));
        const uint64_t desc =
            b_desc(ring + s * kBN * kRowBytes + half * kWN * kRowBytes);
        wgmma_fence();
        fence_operands(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<kWN>::mma(acc, afrag[tap & 1][kk], desc + 2 * kk);
        wgmma_commit();
        fence_operands(acc);
        if (tap == 8) {
          // every ldmatrix of this chunk has returned: the tile is free
          __syncwarp();
          if (lane == 0) mbar_arrive(act_empty + 8 * b);
        }
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
    // ---- the weights: one TMA box of BN x 64 per (chunk, tap) ----------
    int s = 0;
    uint32_t phase = 0;
    for (int ch = ch0; ch < ch1; ++ch) {
      for (int tap = 0; tap < 9; ++tap) {
        mbar_wait(empty_b + 8 * s, phase ^ 1);
        mbar_expect_tx(full_b + 8 * s, kBN * kRowBytes);
        tma_load_2d(ring + s * kBN * kRowBytes, &wmap, full_b + 8 * s,
                    tap * (p.chunks * kBK) + ch * kBK, n0);
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
    const int m0 = 16 * (warp & 3) + g;
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j) {
      const int col = half * kWN + 8 * j + 2 * qq;
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
  // each thread keeps 4 columns (and their bias) over the rows it takes
  constexpr int kVec = kBN / 4;
  constexpr int kRowStep = kThreads / kVec;
  const int col = (tid % kVec) * 4;
  const int o = n0 + col;
  float bias[4] = {0.f, 0.f, 0.f, 0.f};
  if (!kTangent) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (o + e < p.O) bias[e] = __bfloat162float(p.bias[o + e]);
  }
  for (int mr = tid / kVec; mr < per && tid < kRowStep * kVec;
       mr += kRowStep) {
    const int m = rank * per + mr;
    const int r = m / p.cols;
    const int j = m - r * p.cols;
    const int row = row0 + r;
    if (r >= p.rows || row >= NH || x0 + j >= p.W || o >= p.O) continue;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (p.splits == 1) {
      const float4 pk =
          *reinterpret_cast<const float4*>(part + m * kPStride + col);
      v[0] = pk.x;
      v[1] = pk.y;
      v[2] = pk.z;
      v[3] = pk.w;
    } else {
      // every rank's partial first, then the sum in rank order
      const uint32_t addr = base + (m * kPStride + col) * 4;
      float4 pk[kMaxSplits];
#pragma unroll
      for (int k = 0; k < kMaxSplits; ++k)
        if (k < p.splits) pk[k] = ld_cluster4(addr, k);
#pragma unroll
      for (int k = 0; k < kMaxSplits; ++k)
        if (k < p.splits) {
          v[0] += pk[k].x;
          v[1] += pk[k].y;
          v[2] += pk[k].z;
          v[3] += pk[k].w;
        }
    }
    const size_t dst = ((size_t)row * p.W + x0 + j) * p.O + o;
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] += bias[e];
    if ((p.O & 3) == 0) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      uint2 w;
      w.x = *reinterpret_cast<const uint32_t*>(&lo);
      w.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(p.out + dst) = w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (o + e < p.O) p.out[dst + e] = __float2bfloat16_rn(v[e]);
    }
  }
  if (p.splits > 1) cluster_sync();  // no block leaves while read
}

template <bool kTangent, int kBN>
int launch_bn(const CUtensorMap& map, const Params& p, int grid_y,
              cudaStream_t stream) {
  auto kernel = gn_silu_conv3x3_bf16_kernel<kTangent, kBN>;
  const int smem = smem_bytes(p.hp, kBN, p.stages, kTangent ? 2 : 1, p.raws);
  if (smem > kMaxSmem || partial_bytes(kBN) > ring_bytes(kBN, p.stages))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured[kMaxDevices] = {};  // per instantiation
  cudaError_t err = allow_smem(kernel, kMaxSmem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.O > 0 ? (unsigned)((p.O + kBN - 1) / kBN) : 1u,
                        (unsigned)grid_y, (unsigned)p.splits);
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
  err = cudaLaunchKernelEx(&config, kernel, map, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Checks the arguments and launches on ``stream``.
template <bool kTangent>
int run(Params p, const void* map_bytes, int Cp, int Op, int block_n,
        void* stream) {
  const long long M = (long long)p.N * p.H * p.W;
  if (map_bytes == nullptr || p.N < 1 || p.H < 1 || p.W < 1 || p.C < 4 ||
      p.C % 4 || p.O < 1 || p.G < 1 || p.C % p.G || Cp % kBK || Cp < p.C ||
      (block_n != 64 && block_n != 128 && block_n != 256) || Op % block_n ||
      Op < p.O || p.cols != (p.W < kBM ? p.W : kBM) || p.rows < 1 ||
      p.rows * p.cols > kBM || p.splits < 1 || p.splits > kMaxSplits ||
      kBM % p.splits || p.splits > Cp / kBK || p.stages < 3 ||
      p.stages > 8 || p.raws < 1 || p.raws > 2 || M * p.C >= (1LL << 31) || M * p.O >= (1LL << 31) ||
      (kTangent && (p.dx == nullptr || p.dmean == nullptr ||
                    p.drsqrt == nullptr)) ||
      (!kTangent && p.bias == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.segs = (p.W + p.cols - 1) / p.cols;
  p.chunks = Cp / kBK;
  p.hp = (p.rows + 2) * (p.cols + 2);
  const long long grid_y =
      ((long long)p.N * p.H + p.rows - 1) / p.rows * p.segs;
  if (grid_y > 65535 || Op / block_n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  p.vec16 = p.C % 8 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
            (!kTangent || reinterpret_cast<uintptr_t>(p.dx) % 16 == 0);
  CUtensorMap map;
  memcpy(&map, map_bytes, sizeof(map));
  const auto s = static_cast<cudaStream_t>(stream);
  switch (block_n) {
    case 64:
      return launch_bn<kTangent, 64>(map, p, (int)grid_y, s);
    case 128:
      return launch_bn<kTangent, 128>(map, p, (int)grid_y, s);
    default:
      return launch_bn<kTangent, 256>(map, p, (int)grid_y, s);
  }
}

Params make_params(const void* x, const float* mean, const float* rsqrt,
                   const float* gamma, const float* beta, void* out, int N,
                   int H, int W, int C, int O, int G, int rows, int cols,
                   int splits, int stages, int raws) {
  Params p = {};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.mean = mean;
  p.rsqrt = rsqrt;
  p.gamma = gamma;
  p.beta = beta;
  p.out = static_cast<__nv_bfloat16*>(out);
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
  return p;
}

}  // namespace

// Plain C entry points (loaded with ctypes). All tensors are contiguous on
// the current device: x and dx [N,H,W,C], bias [O] and out [N,H,W,O] in
// bf16; mean/rsqrt and dmean/drsqrt [N,G], gamma/beta [C] in f32. ``map`` is
// the host copy of the weights' tensor map from
// gn_silu_conv3x3_bf16_tensor_map (the weight operand [Op, 9*Cp] bf16,
// block_n rows per box). C % 4 == 0, x (and dx) 8-byte aligned, Cp a
// multiple of 64 >= C, Op a multiple of block_n (64, 128 or 256) >= O;
// cols = min(W, 64) pixels and rows <= 64 / cols pixel rows per tile;
// splits (the cluster along K) 1, 2, 4 or 8 and <= Cp / 64; stages (the
// weights' ring) 3..8 and raws (raw halo tiles) 1 or 2 within shared
// memory. Each returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it does not take.

// Writes the 128-byte tensor map of the weight operand ``w`` ([rows, k]
// bf16, k contiguous) for boxes of 64 x box_n into ``map_out``; returns 0,
// or a CUresult / cudaError code. It binds the device's primary context
// where the calling thread has none (hopper.cuh).
extern "C" int gn_silu_conv3x3_bf16_tensor_map(const void* w, int rows, int k,
                                               int box_n, void* map_out) {
  if (w == nullptr || rows < 1 || k < kBK || k % kBK || box_n < 1 ||
      box_n > 256 || rows % box_n)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const int r = k_major_map(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, rows, k,
                            box_n, &map);
  if (r != 0) return r;
  memcpy(map_out, &map, sizeof(map));
  return 0;
}

// The size in bytes of the map gn_silu_conv3x3_bf16_tensor_map writes.
extern "C" int gn_silu_conv3x3_bf16_tensor_map_bytes() {
  return static_cast<int>(sizeof(CUtensorMap));
}

// out = conv3x3(SiLU(x * scale + shift), zero pad) + bias
extern "C" int gn_silu_conv3x3_bf16(
    const void* x, const float* mean, const float* rsqrt, const float* gamma,
    const float* beta, const void* map, const void* bias, void* out, int N,
    int H, int W, int C, int O, int G, int Cp, int Op, int rows, int cols,
    int block_n, int splits, int stages, int raws, void* stream) {
  Params p = make_params(x, mean, rsqrt, gamma, beta, out, N, H, W, C, O, G,
                         rows, cols, splits, stages, raws);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  return run<false>(p, map, Cp, Op, block_n, stream);
}

// out = the tangent of the above for tangents dx, dmean, drsqrt (header)
extern "C" int gn_silu_conv3x3_jvp_bf16(
    const void* x, const void* dx, const float* mean, const float* dmean,
    const float* rsqrt, const float* drsqrt, const float* gamma,
    const float* beta, const void* map, void* out, int N, int H, int W, int C,
    int O, int G, int Cp, int Op, int rows, int cols, int block_n,
    int splits, int stages, int raws, void* stream) {
  Params p = make_params(x, mean, rsqrt, gamma, beta, out, N, H, W, C, O, G,
                         rows, cols, splits, stages, raws);
  p.dx = static_cast<const __nv_bfloat16*>(dx);
  p.dmean = dmean;
  p.drsqrt = drsqrt;
  return run<true>(p, map, Cp, Op, block_n, stream);
}
