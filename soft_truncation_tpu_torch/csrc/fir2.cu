// 2x FIR up- or down-sampling of an NHWC float32 tensor, forward, in one
// pass over both spatial axes.
//
// Replaces the TPU kernel soft_truncation_tpu/ops/pallas/fir.py::
// _resample_pallas (:137), reached through fir_upsample2_pallas and
// fir_downsample2_pallas. With the flipped per-axis taps kf[t] = K[T-1-t]
// (host float64, cast to f32 by ops/fir.py) and the pads of _fir2_op:
//   up2:   out[o] = sum_t kf[t] * x[(o + t - pad0) / 2]  over even o+t-pad0
//   down2: out[o] = sum_t kf[t] * x[2*o + t - pad0]
// per axis, with taps outside the image reading zero (the zero padding of
// the reference), applied over H and W: out[oy, ox] = sum_tx kf[tx] *
// sum_ty kf[ty] * x[iy(oy, ty), ix(ox, tx)].
//
// What bounds it on an H100: bytes. Per output it does (T/2)^2 (up) or T^2
// (down) multiply-adds, 4 or 16 at T = 4, against 4 bytes written and 1 or
// 16 bytes read: far below the ~20 FLOP per byte where the FP32 pipe, not
// HBM at 3.35 TB/s, would be the limit.
//
// Design (simple first): one thread per output pixel and 4-channel vector
// (a float4 load per tap; a scalar path when C % 4 != 0, as for the C = 3
// pyramid inputs), channels fastest so that a warp reads contiguous
// memory. The TPU kernel runs two passes, H then W, through a VMEM
// intermediate; here the 2-D sum is taken in registers and the only device
// memory traffic is one read of the taps' input pixels (reused between
// neighbouring outputs through L1/L2) and one write of the output: no
// per-axis intermediate reaches device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 8;
constexpr int kThreads = 256;

struct Taps {
  float k[kMaxTaps];  // flipped: k[t] = K[T-1-t]
};

template <int kVec>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

__device__ __forceinline__ void axpy(float a, float4 v, float (&acc)[4]) {
  acc[0] = fmaf(a, v.x, acc[0]);
  acc[1] = fmaf(a, v.y, acc[1]);
  acc[2] = fmaf(a, v.z, acc[2]);
  acc[3] = fmaf(a, v.w, acc[3]);
}

__device__ __forceinline__ void axpy(float a, float v, float (&acc)[1]) {
  acc[0] = fmaf(a, v, acc[0]);
}

__device__ __forceinline__ void store(float* p, const float (&acc)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2],
                                              acc[3]);
}

__device__ __forceinline__ void store(float* p, const float (&acc)[1]) {
  *p = acc[0];
}

// Input index of output ``o`` under tap ``t``, or -1 where the tap falls
// on an inserted zero (up) or outside [0, L).
template <bool kUp>
__device__ __forceinline__ int tap_index(int o, int t, int pad0, int L) {
  int i;
  if (kUp) {
    const int m = o + t - pad0;
    if (m & 1) return -1;
    i = m >> 1;  // m is even, so the shift divides exactly
  } else {
    i = 2 * o + t - pad0;
  }
  return (i >= 0 && i < L) ? i : -1;
}

template <bool kUp, int kVec>
__global__ void __launch_bounds__(kThreads)
fir2_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                int H, int W, int C, int OH, int OW, int T, int pad0,
                Taps taps, long long total) {
  using V = typename Vec<kVec>::T;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int cv = C / kVec;
  const int c = (int)(idx % cv) * kVec;
  long long p = idx / cv;
  const int ox = (int)(p % OW);
  p /= OW;
  const int oy = (int)(p % OH);
  const int n = (int)(p / OH);
  const float* xn = x + (size_t)n * H * W * C + c;

  float acc[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) acc[v] = 0.f;

#pragma unroll
  for (int tx = 0; tx < kMaxTaps; ++tx) {
    if (tx >= T) break;
    const int ix = tap_index<kUp>(ox, tx, pad0, W);
    if (ix < 0) continue;
    float col[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) col[v] = 0.f;
#pragma unroll
    for (int ty = 0; ty < kMaxTaps; ++ty) {
      if (ty >= T) break;
      const int iy = tap_index<kUp>(oy, ty, pad0, H);
      if (iy < 0) continue;
      const V val =
          *reinterpret_cast<const V*>(xn + ((size_t)iy * W + ix) * C);
      axpy(taps.k[ty], val, col);
    }
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[v] = fmaf(taps.k[tx], col[v], acc[v]);
  }
  store(out + (((size_t)n * OH + oy) * OW + ox) * C + c, acc);
}

template <bool kUp>
int launch(const float* x, float* out, int N, int H, int W, int C, int OH,
           int OW, int T, int pad0, const Taps& taps, int vec,
           cudaStream_t stream) {
  const long long total = (long long)N * OH * OW * (C / vec);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (vec == 4) {
    fir2_f32_kernel<kUp, 4><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, out, H, W, C, OH, OW, T, pad0, taps, total);
  } else {
    fir2_f32_kernel<kUp, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, out, H, W, C, OH, OW, T, pad0, taps, total);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). x [N,H,W,C] and out
// [N,OH,OW,C] are contiguous f32 on the current device, OH and OW as the
// caller sizes them (2H for up2, or 2H+1 where up2 is the adjoint of a
// down2 of an odd size: taps past the input read zero); ``taps`` is a host
// array of T <= 8 flipped f32 taps, copied into the launch's parameters;
// ``up`` selects up2 (1) or down2 (0); ``vec`` is 4 (C % 4 == 0 and both
// pointers 16-byte aligned) or 1. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int fir2_f32(const float* x, float* out, int N, int H, int W,
                        int C, int OH, int OW, int up, int T, int pad0,
                        const float* taps, int vec, void* stream) {
  if (T < 1 || T > kMaxTaps || (vec != 1 && vec != 4) || C % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps k = {};
  for (int t = 0; t < T; ++t) k.k[t] = taps[t];
  const auto s = static_cast<cudaStream_t>(stream);
  return up ? launch<true>(x, out, N, H, W, C, OH, OW, T, pad0, k, vec, s)
            : launch<false>(x, out, N, H, W, C, OH, OW, T, pad0, k, vec, s);
}
