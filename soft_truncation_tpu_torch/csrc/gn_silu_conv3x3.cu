// Fused GroupNorm-apply -> SiLU -> 3x3 SAME conv, NHWC, forward, as an
// implicit GEMM on the tensor cores in 3xTF32 for float32. Its tangent
// (forward-mode derivative) is gn_silu_conv3x3_jvp.cu, the bfloat16 modes
// gn_silu_conv3x3_bf16.cu.
//
// Replaces the TPU kernel soft_truncation_tpu/ops/pallas/gn_conv.py::
// gn_silu_conv3x3:  out = conv3x3(SiLU(x * scale + shift), zero pad) + b,
// with scale = rsqrt_g * gamma and shift = beta - mean_g * scale folded per
// (sample, channel) inside the kernel from the per-(sample, group) stats.
//
// What bounds it on an H100: operations at the larger sites, bytes at the
// 4x4 ones. The function is 2*N*H*W*C*O*9 FLOP on f32 inputs, against the
// 495 TFLOP/s of dense TF32; its bytes, 4*(N*H*W*(C+O) + 9*C*O), move at
// 3.35 TB/s. The 3xTF32 scheme below does those FLOP three times over, a
// cost of this design, not of the function. The previous form ran plain
// FMA on the FP32 pipe (67 TFLOP/s) in per-image 8x8 tiles and lost to
// cuDNN's f32 chain.
//
// Design:
//   * GEMM view: M = N*H*W output pixels flattened across images (so a 4x4
//     site fills its tiles), N_gemm = O, K = 9*C. A block takes R = 128 / W
//     whole pixel rows (R*W <= 128 GEMM rows) x 128 output channels; 8
//     warps of 64 x 32, each a 4 x 4 grid of mma.sync.m16n8k8 tf32 tiles
//     accumulating in f32; at most 128 registers, so two blocks share an SM.
//   * Operand A is built on the way in, 16 channels at a time: cp.async
//     copies the raw x rows of the tile with their halo (the R rows, one row
//     above and one below, each with a zero column either side: (R+2) x
//     (W+2) pixels) into a 2-stage ring in dynamic shared memory; then each
//     element gets the GroupNorm fold (scale/shift from the per-(sample,
//     group) stats and gamma/beta, in shared memory), SiLU and the TF32
//     split once, into the buffer the MMA reads. The 9 taps of the chunk are
//     9 shifted views of that buffer: each GEMM row reads its pixel's
//     neighbour, or a zero row where the tap falls outside its image (taps
//     outside the image are 0, not SiLU(shift): the reference pads the
//     activated tensor, not x). The activated slab never reaches device
//     memory, and each x element is copied and activated once per block,
//     not once per tap.
//   * 3xTF32: a = hi + lo with hi = tf32(a) and lo = tf32(a - hi), the sum
//     taken as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in f32, which keeps about
//     f32 accuracy (1xTF32 keeps ~3 decimal digits). The weights come split
//     once per weight value by the wrapper, zero-padded to [9*Cp, Op]
//     (tap-major rows of Cp channels); each K step's 16 x 128 slice of both
//     halves streams through a 2-stage cp.async ring.
//   * mma.sync (Ampere's warp-level MMA), not wgmma: wgmma wants its B (and
//     A, or A in registers) in swizzled shared-memory layouts written by TMA
//     or matched by hand, three products per tile pair, and the shifted tap
//     views above would have to become TMA boxes; mma.sync kept this first
//     tensor-core form small. The tangent's redesign took wgmma
//     (gn_silu_conv3x3_jvp.cu); this primal's is a follow-up in ROADMAP.md.
//   * Split-K: where the tiles are fewer than the blocks the SMs hold at
//     once (every site of the models at batch 8; ops/gn_conv.py::
//     launch_plan), blockIdx.z takes a contiguous range of the 16-channel
//     chunks (all 9 taps of each) and writes its partial tile to an f32
//     workspace; a second small kernel sums the splits in a fixed order and
//     adds the bias. No atomics, so the result is the same bits run after
//     run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;               // GEMM rows per block (R * W used)
constexpr int kBN = 128;
constexpr int kBK = 16;                // channels per chunk and K step
constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;          // per SM: <= 128 registers
constexpr int kWarpsN = 4;             // warps laid out 2 (M) x 4 (N)
constexpr int kWM = 64;                // warp tile rows
constexpr int kWN = 32;                // warp tile columns
constexpr int kMF = kWM / 16;          // m16 fragments per warp
constexpr int kNF = kWN / 8;           // n8 fragments per warp
constexpr int kCPP = kBK / 4;          // 4-channel pieces per pixel
constexpr int kAStride = kBK + 4;      // f32: conflict-free A fragment reads
constexpr int kBStride = kBN + 8;      // f32: conflict-free B fragment reads
constexpr int kBFloats = kBK * kBStride;  // f32 B tile, per stage, hi or lo
constexpr int kMaxSmem = 232448;       // an H100 block's dynamic maximum

struct Params {
  const float* x;       // [N, H, W, C]
  const float* mean;    // [N, G]
  const float* rsqrt;   // [N, G]
  const float* gamma;   // [C]
  const float* beta;    // [C]
  const float* w_hi;    // [9 * Cp, Op] tf32 values
  const float* w_lo;
  const float* bias;    // [O]
  float* out;           // [N, H, W, O]
  float* ws;            // [splits, M, O] when splits > 1
  int N, H, W, C, O, G, Cp, Op, M, rows, chunks, splits, slots;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ uint32_t tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float silu(float u) {
  return u * __frcp_rn(1.f + __expf(-u));
}

// 4 consecutive channels of x, from the raw ring
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// Shared memory, in bytes, each region 16-byte aligned: the raw halo tile
// ring [2][hp][kBK]; the activated tile [hi, lo][hp + 1][kAStride] tf32
// words (row hp stays zero); the B ring [2][hi, lo][kBK][kBStride]; then
// gamma and beta [Cp] and the stats [2][slots][G] (mean, rsqrt) and, as
// ints, each GEMM row's base offset per dy [3][kBM]. ops/gn_conv.py::
// launch_plan computes the same total.
__host__ __device__ inline int raw_bytes(int hp) {
  return 2 * hp * kBK * 4;
}

__host__ __device__ inline int act_bytes(int hp) {
  return 2 * (hp + 1) * kAStride * 4;
}

__host__ __device__ inline int b_bytes() { return 2 * 2 * kBFloats * 4; }

__host__ __device__ inline int smem_bytes(int hp, int Cp, int slots,
                                          int G) {
  return raw_bytes(hp) + act_bytes(hp) + b_bytes() +
         4 * (2 * Cp + 2 * slots * G + 3 * kBM);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
gn_silu_conv3x3_kernel(const Params p) {
  // the activated tile's row stride in tf32 words
  constexpr int kRow = kAStride;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W2 = p.W + 2;
  const int hp = (p.rows + 2) * W2;  // halo pixels
  float* raw = reinterpret_cast<float*>(smem);  // [2][hp][kBK]
  unsigned char* actp = smem + raw_bytes(hp);
  unsigned char* bsmp = actp + act_bytes(hp);
  float* sgamma = reinterpret_cast<float*>(bsmp + b_bytes());  // [Cp]
  float* sbeta = sgamma + p.Cp;
  float* smean = sbeta + p.Cp;               // [slots][G]
  float* srsqrt = smean + p.slots * p.G;
  int* rowoff = reinterpret_cast<int*>(smean + 2 * p.slots * p.G);
  // [3][kBM]
  const float* x = p.x;

  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * kBN;
  const int r0 = blockIdx.y * p.rows;        // first pixel row (n * H + y)
  const int split = blockIdx.z;
  const int NH = p.N * p.H;
  const int n_first = max(r0 - 1, 0) / p.H;  // image of the first halo row

  // prologue tables: the affine, the stats of the images the halo touches,
  // and for each GEMM row m the activated-tile offset (in the tile's
  // elements) of its pixel's neighbour at dy = -1, 0, 1 (dx = 0), or -1
  // for a zero
  for (int i = tid; i < p.Cp; i += kThreads) {
    sgamma[i] = i < p.C ? p.gamma[i] : 0.f;
    sbeta[i] = i < p.C ? p.beta[i] : 0.f;
  }
  for (int i = tid; i < p.slots * p.G; i += kThreads) {
    const int n = n_first + i / p.G;
    const int src = n * p.G + i % p.G;
    smean[i] = n < p.N ? p.mean[src] : 0.f;
    srsqrt[i] = n < p.N ? p.rsqrt[src] : 0.f;
  }
  for (int m = tid; m < kBM; m += kThreads) {
    const int r = m / p.W;
    const int xx = m - r * p.W;
    const int row = r0 + r;
    const bool ok = r < p.rows && row < NH;
    const int y = row % p.H;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const bool in = ok && y + dy >= 0 && y + dy < p.H;
      rowoff[(dy + 1) * kBM + m] = in ? ((r + 1 + dy) * W2 + xx + 1) * kRow
                                      : -1;
    }
  }

  const int cg = p.C / p.G;
  // copy chunk ch's raw halo tile into ring slot s, 4 channels per copy
  // (zero where no pixel)
  auto load_a = [&](int ch, int s) {
    float* dst = raw + s * hp * kBK;
    const int c0 = ch * kBK;
    for (int i = tid; i < hp * kCPP; i += kThreads) {
      const int pix = i / kCPP;
      const int c = c0 + (i - pix * kCPP) * 4;
      const int sr = pix / W2;
      const int sx = pix - sr * W2 - 1;
      const int row = r0 - 1 + sr;
      const bool ok = row >= 0 && row < NH && sx >= 0 && sx < p.W && c < p.C;
      const size_t off = ok ? ((size_t)row * p.W + sx) * p.C + c : 0;
      const uint32_t d = smem_u32(dst + pix * kBK + (c - c0));
      cp_async16(d, x + off, ok ? 16 : 0);
    }
  };
  // fold, SiLU and the split into tf32 hi and lo, ring slot s into the
  // activated tile
  auto activate = [&](int ch, int s) {
    const float* src = raw + s * hp * kBK;
    const int c0 = ch * kBK;
    for (int i = tid; i < hp * kCPP; i += kThreads) {
      const int pix = i / kCPP;
      const int cc = (i - pix * kCPP) * 4;
      const int sr = pix / W2;
      const int sx = pix - sr * W2 - 1;
      const int row = r0 - 1 + sr;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (row >= 0 && row < NH && sx >= 0 && sx < p.W && c0 + cc < p.C) {
        float vv[4];
        load4(src + pix * kBK + cc, vv);
        const int slot = row / p.H - n_first;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + cc + e;
          const int g = slot * p.G + c / cg;
          const float sc = __fmul_rn(srsqrt[g], sgamma[c]);
          const float sh = __fsub_rn(sbeta[c], __fmul_rn(smean[g], sc));
          a[e] = silu(fmaf(vv[e], sc, sh));
        }
      }
      float* ahi = reinterpret_cast<float*>(actp);
      const int act = (hp + 1) * kAStride;
      uint4 hi, lo;
      hi.x = tf32(a[0]);
      hi.y = tf32(a[1]);
      hi.z = tf32(a[2]);
      hi.w = tf32(a[3]);
      lo.x = tf32(a[0] - __uint_as_float(hi.x));
      lo.y = tf32(a[1] - __uint_as_float(hi.y));
      lo.z = tf32(a[2] - __uint_as_float(hi.z));
      lo.w = tf32(a[3] - __uint_as_float(hi.w));
      *reinterpret_cast<uint4*>(ahi + pix * kAStride + cc) = hi;
      *reinterpret_cast<uint4*>(ahi + act + pix * kAStride + cc) = lo;
    }
  };
  // K step (chunk ch, tap) of the weights into B ring slot s: both halves'
  // [kBK][kBN] slices
  auto load_b = [&](int ch, int tap, int s) {
    const int k0 = tap * p.Cp + ch * kBK;
    float* bh = reinterpret_cast<float*>(bsmp) + s * 2 * kBFloats;
    const float* whi = p.w_hi;
    const float* wlo = p.w_lo;
#pragma unroll
    for (int i = 0; i < kBK * kBN / 4 / kThreads; ++i) {
      const int chunk = tid + i * kThreads;
      const int k = chunk / (kBN / 4);
      const int col = (chunk % (kBN / 4)) * 4;
      const int g = (k0 + k) * p.Op + o0 + col;
      cp_async16(smem_u32(bh + k * kBStride + col), whi + g, 16);
      cp_async16(smem_u32(bh + kBFloats + k * kBStride + col), wlo + g, 16);
    }
  };

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp / kWarpsN) * kWM;
  const int wn = (warp % kWarpsN) * kWN;

  // the zero row (index hp) of the activated tile, both halves
  {
    float* ahi = reinterpret_cast<float*>(actp);
    const int act = (hp + 1) * kAStride;
    for (int i = tid; i < kAStride; i += kThreads) {
      ahi[hp * kAStride + i] = 0.f;
      ahi[act + hp * kAStride + i] = 0.f;
    }
  }

  float acc[kMF][kNF][4];
#pragma unroll
  for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mf][nf][e] = 0.f;

  const int ch0 = split * p.chunks / p.splits;
  const int ch1 = (split + 1) * p.chunks / p.splits;
  load_a(ch0, 0);
  load_b(ch0, 0, 0);
  cp_async_commit();
  __syncthreads();  // the prologue tables
  int it = 0;
  for (int ch = ch0; ch < ch1; ++ch) {
    for (int tap = 0; tap < 9; ++tap, ++it) {
      cp_async_wait_all();
      if (tap == 0) {
        __syncthreads();  // every warp is past its MMAs on the last chunk
        activate(ch, (ch - ch0) & 1);
      }
      // the activated tile and every thread's copies are visible; every
      // warp is past its MMA of step it - 1, so that B slot is free
      __syncthreads();
      if (tap < 8) {
        load_b(ch, tap + 1, (it + 1) & 1);
      } else if (ch + 1 < ch1) {
        load_b(ch + 1, 0, (it + 1) & 1);
      }
      if (tap == 0 && ch + 1 < ch1) load_a(ch + 1, (ch + 1 - ch0) & 1);
      cp_async_commit();

      // this tap's view: row m reads pixel offset rowoff + dx * kRow
      const int dy = tap / 3;
      const int shift = (tap - dy * 3 - 1) * kRow;
      int off[kMF][2];
#pragma unroll
      for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = rowoff[dy * kBM + wm + mf * 16 + g + 8 * h];
          off[mf][h] = o < 0 ? hp * kRow : o + shift;
        }
      {
        const int act = (hp + 1) * kAStride;
        const uint32_t* A = reinterpret_cast<const uint32_t*>(actp);
        const uint32_t* Bh = reinterpret_cast<const uint32_t*>(bsmp) +
                             (it & 1) * 2 * kBFloats;
        const uint32_t* Bl = Bh + kBFloats;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 8) {
          uint32_t bh[kNF][2], bl[kNF][2];
#pragma unroll
          for (int nf = 0; nf < kNF; ++nf) {
            const int c0 = (kk + t) * kBStride + wn + nf * 8 + g;
            bh[nf][0] = Bh[c0];
            bh[nf][1] = Bh[c0 + 4 * kBStride];
            bl[nf][0] = Bl[c0];
            bl[nf][1] = Bl[c0 + 4 * kBStride];
          }
#pragma unroll
          for (int mf = 0; mf < kMF; ++mf) {
            const int i0 = off[mf][0] + kk + t;
            const int i1 = off[mf][1] + kk + t;
            const int idx[4] = {i0, i1, i0 + 4, i1 + 4};
            uint32_t ah[4], al[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ah[e] = A[idx[e]];
              al[e] = A[act + idx[e]];
            }
#pragma unroll
            for (int nf = 0; nf < kNF; ++nf) {
              mma_tf32(acc[mf][nf], al, bh[nf]);
              mma_tf32(acc[mf][nf], ah, bl[nf]);
              mma_tf32(acc[mf][nf], ah, bh[nf]);
            }
          }
        }
      }
    }
  }
  cp_async_wait_all();

  // GEMM row m is pixel r0 * W + m of the flattened N*H*W
  const bool direct = p.splits == 1;
  const int pix0 = r0 * p.W;
  const int used = min(p.rows * p.W, p.M - pix0);
  float* out = p.out;
  float* ws = direct ? nullptr : p.ws + (size_t)split * p.M * p.O;
  const float* bias = p.bias;
#pragma unroll
  for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = wm + mf * 16 + g + (e >> 1) * 8;
        const int o = o0 + wn + nf * 8 + 2 * t + (e & 1);
        if (m < used && o < p.O) {
          const size_t i = (size_t)(pix0 + m) * p.O + o;
          if (!direct) {
            ws[i] = acc[mf][nf][e];
          } else {
            out[i] = acc[mf][nf][e] + bias[o];
          }
        }
      }
}

// out = bias (0 where null) + the splits' partial sums, in split order.
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int MO, int O, int splits) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= MO) return;
  float s = bias != nullptr ? bias[i % O] : 0.f;
  for (int k = 0; k < splits; ++k) s += ws[(size_t)k * MO + i];
  out[i] = s;
}

// Checks the arguments and launches the conv (and, with splits > 1, the
// reduce) on ``stream``.
int run(Params p, int rows, int splits, int slots, void* stream) {
  const long long M = (long long)p.N * p.H * p.W;
  const int chunks = p.Cp / kBK;
  const long long smem = smem_bytes((rows + 2) * (p.W + 2), p.Cp, slots,
                                    p.G);
  if (p.N < 1 || p.H < 1 || p.W < 1 || p.W > kBM || p.C < 4 || p.C % 4 ||
      p.O < 1 || p.G < 1 || p.C % p.G || p.Cp % kBK || p.Cp < p.C ||
      p.Op % kBN || p.Op < p.O || rows < 1 || rows * p.W > kBM ||
      splits < 1 || splits > chunks || splits > 65535 || slots < 1 ||
      smem > kMaxSmem || M * p.C >= (1LL << 31) ||
      M * p.O * splits >= (1LL << 31) ||
      ((long long)p.N * p.H + rows - 1) / rows > 65535 ||
      p.bias == nullptr || p.w_lo == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The shared-memory attribute holds for the current device only, so it is
  // set once per device; a process that launches on a second card sets it
  // there too. Past kMaxDevices it is set at every launch.
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices || !configured[device]) {
    err = cudaFuncSetAttribute(gn_silu_conv3x3_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) configured[device] = true;
  }
  p.M = (int)M;
  p.rows = rows;
  p.chunks = chunks;
  p.splits = splits;
  p.slots = slots;
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(p.Op / kBN,
                  (unsigned)(((long long)p.N * p.H + rows - 1) / rows),
                  splits);
  gn_silu_conv3x3_kernel<<<grid, kThreads, (size_t)smem, s>>>(p);
  if (splits > 1) {
    const int MO = (int)M * p.O;
    splitk_reduce_kernel<<<(MO + 255) / 256, 256, 0, s>>>(p.ws, p.bias, p.out,
                                                          MO, p.O, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const float* x, const float* mean, const float* rsqrt,
                   const float* gamma, const float* beta, const float* w_hi,
                   const float* w_lo, float* out, float* ws, int N, int H,
                   int W, int C, int O, int G, int Cp, int Op) {
  Params p = {};
  p.x = x;
  p.mean = mean;
  p.rsqrt = rsqrt;
  p.gamma = gamma;
  p.beta = beta;
  p.w_hi = w_hi;
  p.w_lo = w_lo;
  p.out = out;
  p.ws = ws;
  p.N = N;
  p.H = H;
  p.W = W;
  p.C = C;
  p.O = O;
  p.G = G;
  p.Cp = Cp;
  p.Op = Op;
  return p;
}

}  // namespace

// Plain C entry point (loaded with ctypes). All tensors are contiguous f32
// on the current device: x [N,H,W,C], bias [O], out [N,H,W,O],
// mean/rsqrt [N,G], gamma/beta [C], ws [splits,N*H*W,O]
// (unused when splits == 1) and the weights w_hi/w_lo [9*Cp, Op] (tap-major
// rows of Cp channels, tf32 values, zero padding). C % 4 == 0, W <= 128, Cp
// a multiple of 16 >= C, Op a multiple of 128 >= O; ``rows`` (pixel rows
// per block) <= 128 / W; ``splits`` <= Cp / 16; ``slots`` >= the images
// rows + 2 consecutive pixel rows touch; x 16-byte aligned. It returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// arguments it does not take.

// out = conv3x3(SiLU(x * scale + shift), zero pad) + bias
extern "C" int gn_silu_conv3x3_tf32x3(
    const float* x, const float* mean, const float* rsqrt, const float* gamma,
    const float* beta, const float* w_hi, const float* w_lo,
    const float* bias, float* out, float* ws, int N, int H, int W, int C,
    int O, int G, int Cp, int Op, int rows, int splits, int slots,
    void* stream) {
  Params p = make_params(x, mean, rsqrt, gamma, beta, w_hi, w_lo, out, ws, N,
                         H, W, C, O, G, Cp, Op);
  p.bias = bias;
  return run(p, rows, splits, slots, stream);
}
