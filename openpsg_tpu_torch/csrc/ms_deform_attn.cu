// Multi-scale deformable attention's forward in one launch, sm_90a.
//
// Replaces no TPU kernel: the JAX package runs this op as XLA, with no
// Pallas kernel.  The function is `_ms_deform_attn_flat`
// (openpsg_tpu/ops/deform_attn.py:125), computed sample for sample as the
// port's plain path does it (ops/deform_attn.py `ms_deform_attn_plain`):
//
//   out[b, q, h*hd + :] = sum over levels l, points k < K_l, corners c of
//                         cw_c * value[b, start_l + row_c, h, :]
//
// in float32, with x = loc_x * w - 0.5 and y = loc_y * h - 0.5, the base
// bx = clamp(floor(x), 0, max(w - 2, 0)) (by alike), the tent weights
// max(0, 1 - |d|) of x against bx and bx + 1 (y against by and by + 1), each
// product of two tents times the attention weight, and the corner rows
// (r, r + 1, r + w, r + w + 1) mod h*w, r = by * w + bx: the plain path's
// rolled copies, so a level of width or height 1 reads what they read.  The
// sum rounds once to value's type at the end.
//
// What bounds it on an H100 SXM: bytes.  A v4 encoder call at the 1024x1344
// bucket (Lq = Lv = 28,560, 8 heads of 32 channels, 4 levels x 4 points,
// bf16) reads the value map (14.6 MB, which the 50 MB L2 holds), the
// locations (29 MB) and the weights (15 MB) once and writes 14.6 MB: about
// 22 us at 3.35 TB/s.  The arithmetic, 4,096 float32 FLOP per (query,
// head), is far below that.  Each value row is read 64 times on average, so
// what has to hold is locality: the reads after the first hit L1 or L2.
//
// Design.  A group of G threads takes one (b, q, head); each thread holds V
// consecutive channels of the head (16 bytes: 8 bf16 or 4 float32; 8 bytes
// for a bf16 head of 4 (mod 8) channels), so the group reads a corner row's
// hd channels on neighbouring addresses.  Per level, each thread of the
// group loads one point's location and weight and computes its corner rows
// and weights; the group shares them by warp shuffle and every thread adds
// its channels in registers.  No shared memory, tensor cores or atomics.
// Consecutive groups are consecutive queries of one head, so neighbouring
// groups read neighbouring rows through L1.  Where B*Lq*nH*G threads would
// not fill the card (the decoder's 300 queries), the wrapper gives a group
// P = 2 or 4 times the threads (ops/deform_attn.py `launch_plan`): part p
// takes levels p, p + P, ..., and the parts add their sums by shuffle.  The
// level geometry is a by-value kernel argument.  The kernel allocates
// nothing, never synchronises and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels], kl[kMaxLevels];
};

// V channels at p, widened to float32 (bf16 -> f32 is exact), and back,
// rounded to nearest even as the plain path's .to(value.dtype)
template <typename T, int V> struct Vec;

template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

__device__ __forceinline__ void unpack2(uint32_t w, float* v) {
  // a bf16 is the high half of the float32 with the same value
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&t);
}

template <> struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    unpack2(r.x, v); unpack2(r.y, v + 2); unpack2(r.z, v + 4); unpack2(r.w, v + 6);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                                              pack2(v[4], v[5]), pack2(v[6], v[7]));
  }
};

template <> struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    unpack2(r.x, v); unpack2(r.y, v + 2);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  }
};

// max(0, 1 - |d|), rounded as the plain path rounds it (no contraction)
__device__ __forceinline__ float tent(float d) {
  return fmaxf(__fsub_rn(1.0f, fabsf(d)), 0.0f);
}

template <typename T, int V>
__device__ __forceinline__ void add_corner(const T* row, float wgt, float* acc) {
  float v[V];
  Vec<T, V>::load(row, v);
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = fmaf(wgt, v[e], acc[e]);
}

// One thread per V channels of a (b, q, head); G * P threads per (b, q, head),
// a power of two up to 32, so a group never straddles a warp.  Group gi is
// (b, head, q) with q fastest.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
ms_deform_attn_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                      const float* __restrict__ aw, T* __restrict__ out, const Levels lv,
                      int L, int K, int Lq, int Lv, int nH, int G, int P, long long groups) {
  const int width = G * P;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gi = t / width;
  const int sub = (int)(t - gi * width);
  const int c = sub % G;                    // this thread's channels c*V .. c*V + V - 1
  const int part = sub / G;                 // its levels: part, part + P, ...
  const bool live = gi < groups;            // the grid's tail runs the shuffles only
  const long long g = live ? gi : 0;
  const int q = (int)(g % Lq);
  const long long bh = g / Lq;
  const int head = (int)(bh % nH);
  const long long b = bh / nH;
  const int hd = G * V;
  const long long qh = (b * Lq + q) * nH + head;          // row of loc, aw and out
  const float* locq = loc + qh * L * K * 2;
  const float* awq = aw + qh * L * K;
  const long long row_stride = (long long)nH * hd;
  const T* vb = value + (b * Lv * nH + head) * hd + c * V;

  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.0f;

  for (int l0 = 0; l0 < L; l0 += P) {       // the same trip counts in every lane
    const int l = l0 + part;
    int h = 1, w = 1, start = 0, kl = 0;    // kl stays 0 past the last level
#pragma unroll
    for (int j = 0; j < kMaxLevels; ++j)
      if (j == l) { h = lv.h[j]; w = lv.w[j]; start = lv.start[j]; kl = lv.kl[j]; }
    if (!live) kl = 0;
    const int hw = h * w;
    const T* vl = vb + start * row_stride;
    const float bx_max = (float)max(w - 2, 0), by_max = (float)max(h - 2, 0);
    for (int k0 = 0; k0 < K; k0 += G) {
      // this thread's point k0 + c: its base row and corner weights
      int r = 0;
      float w00 = 0.0f, w01 = 0.0f, w10 = 0.0f, w11 = 0.0f;
      if (k0 + c < kl) {
        const int s = l * K + k0 + c;
        const float2 xy = __ldg(reinterpret_cast<const float2*>(locq) + s);
        const float a = __ldg(awq + s);
        const float x = __fsub_rn(__fmul_rn(xy.x, (float)w), 0.5f);
        const float y = __fsub_rn(__fmul_rn(xy.y, (float)h), 0.5f);
        const float bx = fminf(fmaxf(floorf(x), 0.0f), bx_max);
        const float by = fminf(fmaxf(floorf(y), 0.0f), by_max);
        const float fx0 = tent(__fsub_rn(x, bx)), fx1 = tent(__fsub_rn(x, __fadd_rn(bx, 1.0f)));
        const float fy0 = tent(__fsub_rn(y, by)), fy1 = tent(__fsub_rn(y, __fadd_rn(by, 1.0f)));
        w00 = __fmul_rn(__fmul_rn(fx0, fy0), a);
        w01 = __fmul_rn(__fmul_rn(fx1, fy0), a);
        w10 = __fmul_rn(__fmul_rn(fx0, fy1), a);
        w11 = __fmul_rn(__fmul_rn(fx1, fy1), a);
        r = (int)by * w + (int)bx;
      }
      const int n = min(G, K - k0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int src = part * G + j;
        const int rj = __shfl_sync(kFull, r, src, width);
        const float c00 = __shfl_sync(kFull, w00, src, width);
        const float c01 = __shfl_sync(kFull, w01, src, width);
        const float c10 = __shfl_sync(kFull, w10, src, width);
        const float c11 = __shfl_sync(kFull, w11, src, width);
        if (k0 + j < kl) {
          int r1 = rj + 1;
          if (r1 >= hw) r1 -= hw;
          int r2 = rj + w;
          if (r2 >= hw) r2 -= hw;
          int r3 = rj + w + 1;                // < 3 h*w: two wraps at most (h = w = 1)
          if (r3 >= hw) r3 -= hw;
          if (r3 >= hw) r3 -= hw;
          add_corner<T, V>(vl + rj * row_stride, c00, acc);
          add_corner<T, V>(vl + r1 * row_stride, c01, acc);
          add_corner<T, V>(vl + r2 * row_stride, c10, acc);
          add_corner<T, V>(vl + r3 * row_stride, c11, acc);
        }
      }
    }
  }
  for (int off = G; off < width; off <<= 1) {
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] += __shfl_xor_sync(kFull, acc[e], off, width);
  }
  if (live && part == 0) Vec<T, V>::store(out + qh * hd + c * V, acc);
}

template <typename T, int V>
cudaError_t launch(const void* value, const void* loc, const void* aw, void* out,
                   const Levels& lv, int B, int Lq, int Lv, int nH, int hd, int L, int K,
                   int P, int threads, cudaStream_t stream) {
  if (hd % V) return cudaErrorInvalidValue;
  const int G = hd / V;
  const int width = G * P;
  if (P < 1 || width > 32 || (width & (width - 1)) || threads < 32 || threads > kMaxThreads
      || threads % 32)
    return cudaErrorInvalidValue;
  const long long groups = (long long)B * Lq * nH;
  const long long blocks = (groups * width + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ms_deform_attn_kernel<T, V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(aw), static_cast<T*>(out), lv, L, K, Lq, Lv, nH, G, P, groups);
  return cudaGetLastError();
}

}  // namespace

// value [B, Lv, nH, hd] (dtype 0 = float32, 1 = bfloat16), loc [B, Lq, nH, L,
// K, 2] and aw [B, Lq, nH, L, K] float32, out [B, Lq, nH * hd] in value's
// type; all contiguous and 16-byte aligned.  `levels` is a host array of L
// (h, w, K_l) triples, 1 <= L <= 4, the levels laid out one after another in
// Lv.  hd * the type's size is a power of two from 16 to 512 bytes (or 8 for
// a bf16 head of 4 channels); P (1, 2 or 4) and the block's threads come
// from the wrapper's plan.  Returns the launch's cudaGetLastError() (0 on
// success).
extern "C" int openpsg_ms_deform_attn_forward(const void* value, const void* loc,
                                              const void* aw, void* out, int B, int Lq,
                                              int Lv, int nH, int hd, int L, int K,
                                              const int* levels, int dtype, int P, int threads,
                                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Lq <= 0 || Lv <= 0 || nH <= 0 || hd <= 0 || K <= 0 || L < 1
      || L > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  long long total = 0;
  for (int l = 0; l < L; ++l) {
    const int h = levels[3 * l], w = levels[3 * l + 1], kl = levels[3 * l + 2];
    if (h <= 0 || w <= 0 || kl <= 0 || kl > K) return (int)cudaErrorInvalidValue;
    lv.h[l] = h; lv.w[l] = w; lv.start[l] = (int)total; lv.kl[l] = kl;
    total += (long long)h * w;
  }
  if (total != Lv) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float, 4>(value, loc, aw, out, lv, B, Lq, Lv, nH, hd, L, K, P, threads, s);
  if (dtype == 1 && hd % 8 == 0)
    return (int)launch<__nv_bfloat16, 8>(value, loc, aw, out, lv, B, Lq, Lv, nH, hd, L, K, P,
                                         threads, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, 4>(value, loc, aw, out, lv, B, Lq, Lv, nH, hd, L, K, P,
                                         threads, s);
  return (int)cudaErrorInvalidValue;
}
