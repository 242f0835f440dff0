// Fused GroupNorm-apply -> SiLU -> 3x3 SAME conv, NHWC, float32, forward.
//
// Replaces the TPU kernel soft_truncation_tpu/ops/pallas/gn_conv.py::
// gn_silu_conv3x3:  out = conv3x3(SiLU(x * scale + shift), zero pad) + b,
// with scale = rsqrt_g * gamma and shift = beta - mean_g * scale folded per
// (sample, channel) by the Python wrapper (ops/gn_conv.py).
//
// What bounds it on an H100: in float32 without TF32 it runs on the FP32
// pipe, 2*N*H*W*C*O*9 FLOP against a datasheet peak of about 67 TFLOP/s.
// Its bytes, 4*(N*H*W*(C+O) + 9*C*O), at 3.35 TB/s take roughly an order
// of magnitude less time at the hot shape (N=8, 32x32, 128->128), so it is
// bound by operations. The design keeps the normalised, activated slab out
// of device memory: each block activates its haloed input tile on the way
// into shared memory and feeds it straight to the FMA loop.
//
// Design (an implicit-GEMM direct convolution, simple first):
//   * one block = an 8x8 tile of output pixels x 64 output channels of one
//     image, 256 threads, each owning 4 pixels (one row) x 4 channels;
//   * input channels are walked in chunks of 16: the block stages the
//     (8+2)x(8+2)x16 input tile, normalised and activated as it loads, and
//     the 3x3x16x64 weight slice in shared memory (43 KB), then every thread
//     accumulates 9*16 products per output in f32 registers;
//   * taps outside the image are 0, not SiLU(shift): the reference pads the
//     activated tensor, not x;
//   * plain f32 FMA, no tensor cores, so it agrees with the f32 reference to
//     the rounding of a reordered sum.
// Faster forms (wgmma, TMA, bf16/TF32 tensor cores) are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 8;
constexpr int kTileO = 64;
constexpr int kChunkC = 16;
constexpr int kThreads = 256;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;

__global__ void __launch_bounds__(kThreads)
gn_silu_conv3x3_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ scale,
                           const float* __restrict__ shift,
                           const float* __restrict__ w,
                           const float* __restrict__ b,
                           float* __restrict__ out,
                           int H, int W, int C, int O, int tiles_w) {
  __shared__ float sx[kChunkC][kHaloH][kHaloW];
  __shared__ __align__(16) float sw[9][kChunkC][kTileO];

  const int n = blockIdx.z;
  const int o0 = blockIdx.y * kTileO;
  const int ty0 = (blockIdx.x / tiles_w) * kTileH;
  const int tx0 = (blockIdx.x % tiles_w) * kTileW;
  const int tid = threadIdx.x;
  const int og = tid % (kTileO / 4);   // channels o0 + 4*og .. +3
  const int pg = tid / (kTileO / 4);   // pixels (py, px0 .. px0+3)
  const int py = pg / 2;
  const int px0 = (pg % 2) * 4;

  const float* xn = x + (size_t)n * H * W * C;
  const float* scn = scale + (size_t)n * C;
  const float* shn = shift + (size_t)n * C;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunkC) {
    // activated, zero-padded input tile; channel fastest for coalescing
    for (int i = tid; i < kChunkC * kHaloH * kHaloW; i += kThreads) {
      const int cc = i % kChunkC;
      const int p = i / kChunkC;
      const int iy = p / kHaloW;
      const int ix = p % kHaloW;
      const int gy = ty0 + iy - 1;
      const int gx = tx0 + ix - 1;
      const int c = c0 + cc;
      float v = 0.f;
      if (c < C && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const float u = xn[((size_t)gy * W + gx) * C + c] * scn[c] + shn[c];
        v = u / (1.f + expf(-u));
      }
      sx[cc][iy][ix] = v;
    }
    // weight slice [tap][c][o]; output channel fastest for coalescing
    for (int i = tid; i < 9 * kChunkC * kTileO; i += kThreads) {
      const int oo = i % kTileO;
      const int r = i / kTileO;
      const int cc = r % kChunkC;
      const int tap = r / kChunkC;
      const int c = c0 + cc;
      const int o = o0 + oo;
      sw[tap][cc][oo] =
          (c < C && o < O) ? w[((size_t)tap * C + c) * O + o] : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int cc = 0; cc < kChunkC; ++cc) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float a[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) a[k] = sx[cc][py + dy][px0 + k];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(&sw[dy * 3 + dx][cc][og * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][0] = fmaf(a[i + dx], w4.x, acc[i][0]);
            acc[i][1] = fmaf(a[i + dx], w4.y, acc[i][1]);
            acc[i][2] = fmaf(a[i + dx], w4.z, acc[i][2]);
            acc[i][3] = fmaf(a[i + dx], w4.w, acc[i][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int y = ty0 + py;
  if (y >= H) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int xg = tx0 + px0 + i;
    if (xg >= W) continue;
    float* op = out + (((size_t)n * H + y) * W + xg) * O;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + og * 4 + j;
      if (o < O) op[o] = acc[i][j] + b[o];
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). All tensors are contiguous f32
// on the current device: x [N,H,W,C], scale/shift [N,C], w [3,3,C,O],
// b [O], out [N,H,W,O]. Returns cudaGetLastError() after the launch.
extern "C" int gn_silu_conv3x3_f32(const float* x, const float* scale,
                                   const float* shift, const float* w,
                                   const float* b, float* out, int N, int H,
                                   int W, int C, int O, void* stream) {
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const dim3 grid(tiles_h * tiles_w, (O + kTileO - 1) / kTileO, N);
  gn_silu_conv3x3_f32_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      x, scale, shift, w, b, out, H, W, C, O, tiles_w);
  return static_cast<int>(cudaGetLastError());
}
