// Exact row gather for multi-scale deformable attention, sm_90a.
//
// Replaces the Pallas TPU kernel `sparse_row_gather`
// (openpsg_tpu/ops/pallas/msda_gather.py:70, body `_kernel` :44).
//
//   out[h, s, :] = float(quad[h, idx[h, s], :])   if 0 <= idx[h, s] < HW
//                = 0                               otherwise
//
// The TPU has no vector gather, so its kernel is a one-hot matmul over
// 512-row value tiles, predicated by an exact occupancy bitmap; an index
// outside [0, HW) matches no row there (or a zero padding row) and gives a
// zero row.  Hopper gathers directly, so this kernel only moves bytes: a
// group of C / V threads moves one gathered row, each thread one 16-byte
// load of V elements (V = 8 bf16 or 4 f32), converted to float32 in
// registers (bf16 -> f32 is exact) and written with 16-byte streaming
// stores.  An out-of-range index reads nothing and writes a zero row.
//
// What bounds it on an H100 SXM: bytes.  At the main-path shape (level 0 of
// the first pixel-decoder encoder layer at 1344^2: nH=8, HW=168^2=28,224,
// C=4*32=128, S=37,485*4=149,940, bf16) it reads the quad table (58 MB, each
// row at most once from DRAM when rows repeat in L2), the indices (5 MB)
// and writes the f32 rows (614 MB): ~0.20 ms at 3.35 TB/s, with no
// arithmetic to speak of.  The output write dominates; streaming stores keep
// it from evicting the quad table out of L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load_row_vec(const float* src, float* v) {
  const float4 r = __ldg(reinterpret_cast<const float4*>(src));
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}

__device__ __forceinline__ void load_row_vec(const __nv_bfloat16* src, float* v) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(src));
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the high half of the float32 with the same value
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sparse_row_gather_kernel(const T* __restrict__ quad, const int32_t* __restrict__ idx,
                         float* __restrict__ out, int S, int HW, int C,
                         long long n_vec) {
  constexpr int V = 16 / sizeof(T);               // elements per 16-byte load
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_vec) return;
  const int per_row = C / V;
  const long long row = t / per_row;              // flattened (h, s)
  const int c = (int)(t - row * per_row) * V;
  const long long h = row / S;
  const int r = __ldg(idx + row);
  float v[V];
  if (r >= 0 && r < HW) {
    load_row_vec(quad + (h * HW + r) * C + c, v);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = 0.0f;
  }
  float4* dst = reinterpret_cast<float4*>(out + row * C + c);
#pragma unroll
  for (int e = 0; e < V; e += 4) __stcs(dst + e / 4, make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]));
}

template <typename T>
cudaError_t launch(const void* quad, const void* idx, void* out, int nH, int S, int HW,
                   int C, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (C % V) return cudaErrorInvalidValue;
  const long long n_vec = (long long)nH * S * (C / V);
  const long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  sparse_row_gather_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(quad), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), S, HW, C, n_vec);
  return cudaGetLastError();
}

}  // namespace

// quad [nH, HW, C] (dtype 0 = float32, 1 = bfloat16), idx [nH, S] int32,
// out [nH, S, C] float32; all contiguous and 16-byte aligned, C a multiple
// of 16 bytes' worth of quad elements.  Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int openpsg_sparse_row_gather(const void* quad, const void* idx, void* out,
                                         int nH, int S, int HW, int C, int dtype,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nH <= 0 || S <= 0 || HW <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch<float>(quad, idx, out, nH, S, HW, C, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(quad, idx, out, nH, S, HW, C, s);
  return (int)cudaErrorInvalidValue;
}
