// Shared-KV masked cross-attention for the relation Q-Former, sm_90a.
//
// Replaces the Pallas TPU kernel `flash_shared_kv_cross_attn`
// (openpsg_tpu/ops/pallas/flash_cross_attn.py:80, body `_kernel` :35).
//
//   out[n, h, l, :] = softmax_p(q[n,h,l,:] . k[h,p,:] * hd^-0.5, -1e9 where
//                     !mask[n,p]) @ v[h,p,:]
//
// Every object pair n shares the same K/V (the image patches); only its
// boolean patch mask differs.  Online softmax over patch chunks exactly as
// the Pallas body does it: p = exp(s - m_new) * mask, so a fully masked
// chunk adds exactly 0 and a fully masked row ends as 0 / max(l, 1e-20) = 0.
// Accumulation is float32; p is rounded to the input type before the P.V
// product, as in the Pallas body.
//
// What bounds it on an H100 SXM: at the main-path shape (NP=1024 pairs,
// H=12, Lq=33, hd=64, P=441, bf16) one call is 4*NP*H*Lq*P*hd = 45.8 GFLOP,
// 46 us at 989 TFLOP/s bf16, and moves ~105 MB (q and out 52 MB each), 31 us
// at 3.35 TB/s: compute-bound on the tensor cores at ~46 us.  Every chunk
// is computed whatever the mask holds, so the work does not depend on it.
//
// Design (simple first; wgmma/TMA are later work).  The TPU's sequential
// chunk grid axis becomes a loop inside the block.  One block = 16 * kWarps
// rows of the flattened (pair, query) row space of one head, one 16-row
// strip per warp.  Per 64-patch chunk the block stages K, V and the masks of
// the pairs its rows belong to in shared memory; each
// warp computes its strip's scores (bf16: WMMA 16x16x16 on the tensor cores
// with f32 accumulation; f32: CUDA-core FMAs, to keep full f32 accuracy),
// applies the masked online-softmax update with two lanes per row, and adds
// P.V into a float32 accumulator strip kept in shared memory.  Rows of one
// strip may belong to two pairs: the mask is looked up per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;            // one 16-row strip per warp
constexpr int kRows = 16 * kWarps;   // rows per block
constexpr int kChunk = 64;           // patches per chunk
constexpr float kNegBig = -1e9f;     // the Pallas body's masked fill

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Row strides are padded (+8 elements, +4 floats) so that consecutive rows
// start in different shared-memory banks for the WMMA loads and stores.
template <typename T, int HD>
struct Smem {
  static constexpr int kLd = HD + 8;                           // Q, K, V rows
  static constexpr int kLdP = kChunk + 8;                      // P rows
  static constexpr int kSw = (HD > kChunk ? HD : kChunk) + 4;  // scratch rows
  static constexpr size_t q = sizeof(T) * kRows * kLd;
  static constexpr size_t kv = sizeof(T) * kChunk * kLd;
  static constexpr size_t s = sizeof(float) * kRows * kSw;
  static constexpr size_t p = sizeof(T) * kRows * kLdP;
  static constexpr size_t o = sizeof(float) * kRows * HD;
  static constexpr size_t a = sizeof(float) * kRows;
  static constexpr size_t m = kRows * kChunk;               // mask bytes
  static constexpr size_t total = q + 2 * kv + s + p + o + a + m;
};

// Copy `rows` rows of HD elements from a dense source into rows of stride
// `ld` with 16-byte vectors (HD * sizeof(T) a multiple of 16, pointers
// 16-byte aligned), or zero-fill when src is null.
template <typename T, int HD>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src, int rows,
                                          int tid, int nthreads) {
  constexpr int kVpr = HD * (int)sizeof(T) / 16;  // vectors per row
  for (int i = tid; i < rows * kVpr; i += nthreads) {
    const int r = i / kVpr, c = (i % kVpr) * (16 / (int)sizeof(T));
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        src ? *reinterpret_cast<const uint4*>(src + r * HD + c) : make_uint4(0, 0, 0, 0);
  }
}

// S[16][kChunk] = Q[16][HD] . K[kChunk][HD]^T for one warp's strip.
template <typename T, int HD>
__device__ __forceinline__ void strip_scores_fma(const T* Qw, const T* Ks, float* Sw,
                                                 int lane) {
  constexpr int kSw = Smem<T, HD>::kSw, kLd = Smem<T, HD>::kLd;
  // lane owns columns lane and lane + 32; the d loop starts at the lane's
  // own offset so the 32 lanes read 32 different banks
  float acc[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int i = 0; i < HD; ++i) {
    const int d = (i + lane) % HD;
    const float k0 = to_f(Ks[lane * kLd + d]);
    const float k1 = to_f(Ks[(lane + 32) * kLd + d]);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float qv = to_f(Qw[r * kLd + d]);
      acc[r][0] = fmaf(qv, k0, acc[r][0]);
      acc[r][1] = fmaf(qv, k1, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    Sw[r * kSw + lane] = acc[r][0];
    Sw[r * kSw + lane + 32] = acc[r][1];
  }
}

template <int HD>
__device__ __forceinline__ void strip_scores_wmma(const __nv_bfloat16* Qw,
                                                  const __nv_bfloat16* Ks, float* Sw) {
  using namespace nvcuda;
  constexpr int kSw = Smem<__nv_bfloat16, HD>::kSw, kLd = Smem<__nv_bfloat16, HD>::kLd;
#pragma unroll
  for (int nt = 0; nt < kChunk / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kt = 0; kt < HD / 16; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, Qw + kt * 16, kLd);
      // K chunk is row-major [kChunk][kLd]: K^T is column-major with ld = kLd
      wmma::load_matrix_sync(b, Ks + nt * 16 * kLd + kt * 16, kLd);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(Sw + nt * 16, c, kSw, wmma::mem_row_major);
  }
}

// PV[16][HD] = P[16][kChunk] . V[kChunk][HD] into the strip's scratch.
template <typename T, int HD>
__device__ __forceinline__ void strip_pv_fma(const T* Pw, const T* Vs, float* Sw,
                                             int lane) {
  constexpr int kSw = Smem<T, HD>::kSw, kLd = Smem<T, HD>::kLd, kLdP = Smem<T, HD>::kLdP;
  for (int d = lane; d < HD; d += 32) {
    float acc[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r] = 0.f;
    for (int j = 0; j < kChunk; ++j) {
      const float vv = to_f(Vs[j * kLd + d]);
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r] = fmaf(to_f(Pw[r * kLdP + j]), vv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) Sw[r * kSw + d] = acc[r];
  }
}

template <int HD>
__device__ __forceinline__ void strip_pv_wmma(const __nv_bfloat16* Pw,
                                              const __nv_bfloat16* Vs, float* Sw) {
  using namespace nvcuda;
  constexpr int kSw = Smem<__nv_bfloat16, HD>::kSw, kLd = Smem<__nv_bfloat16, HD>::kLd;
  constexpr int kLdP = Smem<__nv_bfloat16, HD>::kLdP;
#pragma unroll
  for (int nt = 0; nt < HD / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kt = 0; kt < kChunk / 16; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, Pw + kt * 16, kLdP);
      wmma::load_matrix_sync(b, Vs + kt * 16 * kLd + nt * 16, kLd);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(Sw + nt * 16, c, kSw, wmma::mem_row_major);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(32 * kWarps, 3)
skv_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const uint8_t* __restrict__ mask,
                T* __restrict__ out, int NP, int H, int Lq, int P, float scale) {
  using S = Smem<T, HD>;
  constexpr int kSw = S::kSw, kLd = S::kLd, kLdP = S::kLdP;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + S::q);
  T* Vs = reinterpret_cast<T*>(smem + S::q + S::kv);
  float* Ss = reinterpret_cast<float*>(smem + S::q + 2 * S::kv);
  T* Ps = reinterpret_cast<T*>(smem + S::q + 2 * S::kv + S::s);
  float* Os = reinterpret_cast<float*>(smem + S::q + 2 * S::kv + S::s + S::p);
  float* As = reinterpret_cast<float*>(smem + S::q + 2 * S::kv + S::s + S::p + S::o);
  uint8_t* Ms = smem + S::q + 2 * S::kv + S::s + S::p + S::o + S::a;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int h = blockIdx.y;
  const long long rows_total = (long long)NP * Lq;
  const long long row0 = (long long)blockIdx.x * kRows;

  // stage this block's query rows (row = pair * Lq + l); zero past the end
  for (int r = warp; r < kRows; r += kWarps) {
    const long long gr = row0 + r;
    const T* src = nullptr;
    if (gr < rows_total) {
      const long long n = gr / Lq, l = gr % Lq;
      src = q + ((n * H + h) * Lq + l) * HD;
    }
    copy_rows<T, HD>(Qs + r * kLd, kLd, src, 1, lane, 32);
  }
  for (int i = tid; i < kRows * HD; i += blockDim.x) Os[i] = 0.f;

  // softmax state: lanes 2r and 2r+1 both own row r of the warp's strip
  const int srow = lane >> 1;
  const int half = lane & 1;
  const long long my_row = row0 + warp * 16 + srow;
  const bool row_ok = my_row < rows_total;
  // pairs spanned by this block's rows; their mask chunk is staged in Ms
  const long long pair0 = row0 / Lq;
  const int n_pairs =
      (int)((min(row0 + kRows, rows_total) - 1) / Lq - pair0 + 1);
  const uint8_t* mrow = Ms + (row_ok ? (int)(my_row / Lq - pair0) * kChunk : 0);
  float m_run = -INFINITY, l_run = 0.f;

  const T* Qw = Qs + warp * 16 * kLd;
  float* Sw = Ss + warp * 16 * kSw;
  T* Pw = Ps + warp * 16 * kLdP;
  float* Ow = Os + warp * 16 * HD;
  float* Aw = As + warp * 16;
  const T* kh = k + (long long)h * P * HD;
  const T* vh = v + (long long)h * P * HD;

  for (int c0 = 0; c0 < P; c0 += kChunk) {
    __syncthreads();  // previous chunk's K/V no longer read
    const int n_valid = min(kChunk, P - c0);
    copy_rows<T, HD>(Ks, kLd, kh + (long long)c0 * HD, n_valid, tid, blockDim.x);
    copy_rows<T, HD>(Vs, kLd, vh + (long long)c0 * HD, n_valid, tid, blockDim.x);
    if (n_valid < kChunk) {
      copy_rows<T, HD>(Ks + n_valid * kLd, kLd, nullptr, kChunk - n_valid, tid, blockDim.x);
      copy_rows<T, HD>(Vs + n_valid * kLd, kLd, nullptr, kChunk - n_valid, tid, blockDim.x);
    }
    for (int i = tid; i < n_pairs * kChunk; i += blockDim.x) {
      const int pp = i / kChunk, col = i % kChunk;
      Ms[i] = col < n_valid ? mask[(pair0 + pp) * P + c0 + col] : 0;
    }
    __syncthreads();

    if constexpr (sizeof(T) == 2) {
      strip_scores_wmma<HD>(Qw, Ks, Sw);
    } else {
      strip_scores_fma<T, HD>(Qw, Ks, Sw, lane);
    }
    __syncwarp();

    // masked online-softmax update; column index rotated by lane so the two
    // lanes of every row read different banks
    uint32_t valid_bits = 0;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = half * 32 + ((i + lane) & 31);
      const bool ok = row_ok && mrow[col];
      valid_bits |= (ok ? 1u : 0u) << i;
      mx = fmaxf(mx, Sw[srow * kSw + col] * scale + (ok ? 0.f : kNegBig));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = half * 32 + ((i + lane) & 31);
      // masked entries give exactly 0 (the Pallas body's exp(s - m) * mask)
      const float p =
          ((valid_bits >> i) & 1u) ? expf(Sw[srow * kSw + col] * scale - m_new) : 0.f;
      psum += p;
      Pw[srow * kLdP + col] = from_f<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    const float alpha = expf(m_run - m_new);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    if (half == 0) Aw[srow] = alpha;
    __syncwarp();

    if constexpr (sizeof(T) == 2) {
      strip_pv_wmma<HD>(Pw, Vs, Sw);
    } else {
      strip_pv_fma<T, HD>(Pw, Vs, Sw, lane);
    }
    __syncwarp();
    for (int i = lane; i < 16 * HD; i += 32) {
      const int r = i / HD, d = i % HD;
      Ow[i] = Ow[i] * Aw[r] + Sw[r * kSw + d];
    }
    __syncwarp();
  }

  // out = acc / max(l, 1e-20), written row by row with 16-byte stores
  if (half == 0) Aw[srow] = fmaxf(l_run, 1e-20f);
  __syncwarp();
  constexpr int kVec = 16 / sizeof(T);            // elements per 16 B
  constexpr int kPerRow = HD / kVec;              // vectors per row
  for (int i = lane; i < 16 * kPerRow; i += 32) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const long long gr = row0 + warp * 16 + r;
    if (gr >= rows_total) continue;
    const long long n = gr / Lq, l = gr % Lq;
    alignas(16) T pack[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) pack[e] = from_f<T>(Ow[r * HD + c + e] / Aw[r]);
    *reinterpret_cast<uint4*>(out + ((n * H + h) * Lq + l) * HD + c) =
        *reinterpret_cast<const uint4*>(pack);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   void* out, int NP, int H, int Lq, int P, cudaStream_t stream) {
  const size_t smem = Smem<T, HD>::total;
  cudaError_t err = cudaFuncSetAttribute(
      skv_attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)NP * Lq;
  dim3 grid((unsigned)((rows + kRows - 1) / kRows), (unsigned)H);
  skv_attn_kernel<T, HD><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), NP, H, Lq, P,
      1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const void* mask, void* out, int NP, int H, int Lq, int P,
                        cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, mask, out, NP, H, Lq, P, stream);
    case 64: return launch<T, 64>(q, k, v, mask, out, NP, H, Lq, P, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {16, 64} (the tiny and the
// baseline_v4_ov Q-Former).  mask is [NP, P]
// bool (one byte each).  All tensors contiguous, 16-byte aligned.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int openpsg_flash_skv_forward(const void* q, const void* k, const void* v,
                                         const void* mask, void* out, int NP, int H,
                                         int Lq, int P, int hd, int dtype,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (NP <= 0 || H <= 0 || Lq <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch_hd<float>(hd, q, k, v, mask, out, NP, H, Lq, P, s);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, mask, out, NP, H, Lq, P, s);
  return (int)cudaErrorInvalidValue;
}
