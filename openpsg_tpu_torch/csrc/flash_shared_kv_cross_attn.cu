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
// at 3.35 TB/s.  It also takes NP*H*Lq*P = 1.79e8 exponentials: at 16 per
// clock per SM (the MUFU units) that is 43-50 us, as much as the tensor
// work (hd = 64 gives only 256 FLOP per score).  So a design that does not
// overlap the softmax of one tile with the products of another reaches at
// most about half of the ~46 us bound.  Every chunk is computed whatever
// the mask holds, so the work does not depend on it.
//
// Two variants behind one entry point; the caller picks one by dtype, hd
// and P (ops/flash_cross_attn.py `kernel_variant`):
//
// "hopper" (bf16, hd = 64, P <= kMaxP = 448; the main path).  A tile is 64
// consecutive pairs at one query index l and one head h, so every row has
// its own pair and the tile's mask is the same [64, P] block for all Lq
// values of l; a small pre-kernel packs the mask into bits (16 words per
// pair) and a warpgroup loads its tile's bits once per pair tile.  A
// persistent grid of (SMs / H) CTAs per head: each CTA loads its head's K
// and V once by TMA (2 x 56 KB at the cap, resident in shared memory) and
// walks a contiguous share of that head's (pair tile, l) items, each of its
// three warpgroups taking every third item.  A warpgroup keeps its next
// item's Q tile in flight by TMA (a 3-D tensor map over q's own
// [NP, H, Lq, hd] layout, 128-byte swizzle; no transposing copy).  Per
// 64-patch chunk: S = Q.K^T by wgmma m64n64k16 (both operands K-major in
// shared memory), the masked online softmax on the accumulator fragment in
// registers, P cast to bf16 in registers as the A operand of O += P.V
// (wgmma, V the MN-major B operand).  The chunks are pipelined as in
// FlashAttention-3: S of chunk c and P.V of chunk c - 1 are issued
// together, and chunk c's exponentials run while the tensor cores do that
// P.V; the other two warpgroups fill the remaining gaps.  O stays in
// registers until the epilogue, which goes through shared memory and a TMA
// store.  No score, P or accumulator tile touches shared memory.  On an
// H100 80GB HBM3 (700 W) at the main-path shape it takes 0.156 ms against
// the 0.046 ms bound (PERF.md): the products on realistic operands and the
// exponentials still overlap only in part.

// "simple" (float32, hd = 16, or P above the cap).  The TPU's sequential
// chunk grid axis becomes a loop inside the block.  One block = 16 * kWarps
// rows of the flattened (pair, query) row space of one head, one 16-row
// strip per warp.  Per 64-patch chunk the block stages K, V and the masks of
// the pairs its rows belong to in shared memory; each
// warp computes its strip's scores (bf16: WMMA 16x16x16 on the tensor cores
// with f32 accumulation; f32: CUDA-core FMAs, to keep full f32 accuracy),
// applies the masked online-softmax update with two lanes per row, and adds
// P.V into a float32 accumulator strip kept in shared memory.  Rows of one
// strip may belong to two pairs: the mask is looked up per row.
//
// The hopper variant computes exp(x) as exp2(x * log2 e) with the 1/sqrt(hd)
// scale folded into the same factor, and masks a score with -inf for the
// running max, using 0 as the exponent's offset while a row has seen no
// unmasked patch: masked entries then add exactly 0, and a row's sum and
// accumulator stay 0 until its first unmasked patch, exactly as with the
// Pallas body's -1e9 fill and mask product.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
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
cudaError_t launch_simple(const void* q, const void* k, const void* v, const void* mask,
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
cudaError_t dispatch_simple(int hd, const void* q, const void* k, const void* v,
                            const void* mask, void* out, int NP, int H, int Lq, int P,
                            cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_simple<T, 16>(q, k, v, mask, out, NP, H, Lq, P, stream);
    case 64: return launch_simple<T, 64>(q, k, v, mask, out, NP, H, Lq, P, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The hopper variant (bf16, hd = 64, P <= kMaxP).

constexpr int kHd = 64;
constexpr int kTile = 64;                        // pairs per tile: one wgmma M of 64
constexpr int kChunkN = 64;                      // patches per score chunk (wgmma N)
constexpr int kMaxP = 448;                       // patches K/V can hold resident
constexpr int kKvBox = 64;                       // K/V rows per TMA load
constexpr int kWords = 16;                       // mask words per pair (>= kMaxP / 32)
constexpr int kWarpgroups = 3;
constexpr int kStages = 2 * kWarpgroups;         // Q tiles: each item's, and the next item's
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTileBytes = kTile * kHd * 2;      // one 64 x 64 bf16 tile, 128-byte rows
constexpr float kLog2e = 1.4426950408889634f;

// shared memory, from a 1024-byte aligned base (the 128-byte swizzle atom)
constexpr int kOffK = 0;
constexpr int kOffV = kOffK + kMaxP * kHd * 2;
constexpr int kOffQ = kOffV + kMaxP * kHd * 2;
constexpr int kOffO = kOffQ + kStages * kTileBytes;
constexpr int kOffBits = kOffO + kWarpgroups * kTileBytes;
constexpr int kOffBar = kOffBits + kWarpgroups * kTile * kWords * 4;
constexpr int kSmemBytes = kOffBar + 8 * (1 + kStages) + 1024;  // + alignment slack

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// returns once the phase of parity `parity` has completed; a wait that never
// completes (a pipeline fault) traps after ~2^31 tries instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t tries = 0;
  do {
    if (++tries == 0x80000000u) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

// named barrier of one warpgroup (ids 1 .. kWarpgroups; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  Both byte offsets are
// 1024 (8 rows of 128 bytes): the stride between 8-row groups.  A K-major
// operand never crosses a 128-byte row within k16, and the MN-major V tile
// is one 64-wide MN block, so the other offset field is never used.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that reads or writes them
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

#define SKV_ACC32(d)                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SKV_D32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         uint32_t accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SKV_D32
      ", %32, %33, p, 1, 1, 0, 0;\n\t}"
      : SKV_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (bf16 pairs), B
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SKV_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : SKV_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1u));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&b);
}

// bits[n][w] bit b = mask[n][32 w + b] (0 past P): one warp per pair
__global__ void pack_mask_bits(const uint8_t* __restrict__ mask, uint32_t* __restrict__ bits,
                               int NP, int P) {
  const long long n = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (n >= NP) return;  // whole warps
  const uint8_t* row = mask + n * P;
  uint32_t mine = 0;
#pragma unroll 4
  for (int w = 0; w < kWords; ++w) {
    const int col = w * 32 + lane;
    const uint32_t b = __ballot_sync(0xffffffffu, col < P && row[col]);
    if (lane == w) mine = b;
  }
  if (lane < kWords) bits[n * kWords + lane] = mine;
}

// The masked online-softmax step on one chunk's scores sc (wgmma's
// accumulator fragment, see below): masks with -inf, updates the running
// max m and this thread's share of the sum l of rows r0 and r0 + 8, and
// returns P as the A fragment of P.V (k-step kk holds the 8-column groups
// 2kk and 2kk + 1) and the factors the accumulator rows must be scaled by.
// It works on a copy of sc: sc is a register operand of the next chunk's
// wgmma, and ptxas serializes the wgmma pipeline (warning C7513) when the
// softmax works on those registers in place.
__device__ __forceinline__ void softmax_chunk(const float (&sc)[32], uint2 w0, uint2 w1, int cl,
                                              float k2, float& m0, float& m1, float& l0,
                                              float& l1, uint32_t (&pa)[4][4], float& al0,
                                              float& al1) {
  float s[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = sc[e];
  if ((w0.x & w0.y & w1.x & w1.y) != 0xffffffffu) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int sh = 8 * (n & 3) + 2 * cl + jj;
        if (!(((n < 4 ? w0.x : w0.y) >> sh) & 1u)) s[4 * n + jj] = -INFINITY;
        if (!(((n < 4 ? w1.x : w1.y) >> sh) & 1u)) s[4 * n + 2 + jj] = -INFINITY;
      }
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0 * k2), mn1 = fmaxf(m1, mx1 * k2);
  const float mu0 = mn0 == -INFINITY ? 0.f : mn0;  // no unmasked patch yet
  const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
  al0 = ex2(m0 - mu0);
  al1 = ex2(m1 - mu1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float p00 = ex2(fmaf(s[4 * n], k2, -mu0));
    const float p01 = ex2(fmaf(s[4 * n + 1], k2, -mu0));
    const float p10 = ex2(fmaf(s[4 * n + 2], k2, -mu1));
    const float p11 = ex2(fmaf(s[4 * n + 3], k2, -mu1));
    ps0 += p00 + p01;
    ps1 += p10 + p11;
    pa[n / 2][2 * (n % 2)] = pack_bf16(p00, p01);
    pa[n / 2][2 * (n % 2) + 1] = pack_bf16(p10, p11);
  }
  l0 = l0 * al0 + ps0;  // this thread's columns; summed over the quad at the end
  l1 = l1 * al1 + ps1;
}

// Thread layout of one warpgroup (wgmma's accumulator fragment): warp wl
// of the group owns tile rows 16 wl .. 16 wl + 15; lane (g = lane/4,
// cl = lane%4) holds rows r0 = 16 wl + g and r0 + 8, and of each 8-column
// group n the columns 8n + 2cl and 8n + 2cl + 1: d[4n + j] is (r0, 8n+2cl+j),
// d[4n + 2 + j] is (r0 + 8, 8n+2cl+j).
//
// Work: warpgroup wg takes the CTA's items wg, wg + kWarpgroups, ...  It owns two Q
// stages: while it computes one item, its next item's Q tile arrives by
// TMA.  Per item the chunks are pipelined (as FlashAttention-3 does): S of
// chunk c and O += P.V of chunk c - 1 are issued together, and the softmax
// of chunk c runs while the tensor cores work on that P.V.
__global__ void __launch_bounds__(kThreads, 1)
skv_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap omap,
                  const uint32_t* __restrict__ bits, int NP, int Lq, int P, float k2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_u32(smem);
  const uint32_t bar_kv = sb + kOffBar;
  const uint32_t bar_q = bar_kv + 8;  // + 8 stage

  const int h = blockIdx.y;
  const long long n_items = (long long)((NP + kTile - 1) / kTile) * Lq;
  const long long first = n_items * blockIdx.x / gridDim.x;
  const int n_local = (int)(n_items * (blockIdx.x + 1) / gridDim.x - first);
  const int n_chunks = (P + kChunkN - 1) / kChunkN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int tw = threadIdx.x % 128;
  const int g = lane / 4, cl = lane % 4;
  const int r0 = (warp % 4) * 16 + g;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_q + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (n_local <= 0) return;
  if (threadIdx.x == 0) {  // K and V of this head, once; rows past P read as 0
    mbar_expect_tx(bar_kv, 2u * n_chunks * kChunkN * kHd * 2);
    for (int r = 0; r < n_chunks * kChunkN; r += kKvBox) {
      tma_load_3d(sb + kOffK + r * kHd * 2, &kmap, bar_kv, 0, r, h);
      tma_load_3d(sb + kOffV + r * kHd * 2, &vmap, bar_kv, 0, r, h);
    }
  }

  // this warpgroup's k-th item (local item wg + kWarpgroups k) goes to its stage k % 2
  auto stage = [&](int k) { return wg * 2 + (k & 1); };
  auto load_item = [&](int k) {
    const int i = wg + k * kWarpgroups;
    if (tw != 0 || i >= n_local) return;
    const long long j = first + i;
    const uint32_t bar = bar_q + 8 * stage(k);
    mbar_expect_tx(bar, kTileBytes);
    tma_load_3d(sb + kOffQ + stage(k) * kTileBytes, &qmap, bar, 0, h * Lq + (int)(j % Lq),
                (int)(j / Lq) * kTile);
  };
  load_item(0);

  uint32_t* mb = reinterpret_cast<uint32_t*>(smem + kOffBits) + wg * kTile * kWords;
  const uint32_t* mrow0 = mb + r0 * kWords;
  const uint32_t* mrow1 = mrow0 + 8 * kWords;
  unsigned char* os = smem + kOffO + wg * kTileBytes;
  int cur_tile = -1;
  mbar_wait(bar_kv, 0);

  for (int k = 0; wg + k * kWarpgroups < n_local; ++k) {
    const long long j = first + wg + k * kWarpgroups;
    const int tile = (int)(j / Lq), l = (int)(j % Lq);
    load_item(k + 1);  // its stage was last read by item k - 1, finished
    if (tile != cur_tile) {
      // this tile's mask bits, once per pair tile; rows past NP stay 0
      wg_sync(1 + wg);
      for (int e = tw; e < kTile * kWords / 4; e += 128) {
        const int row = e / (kWords / 4), q4 = e % (kWords / 4);
        const long long pair = (long long)tile * kTile + row;
        uint4 w = make_uint4(0, 0, 0, 0);
        if (pair < NP) w = *reinterpret_cast<const uint4*>(bits + pair * kWords + 4 * q4);
        *reinterpret_cast<uint4*>(mb + row * kWords + 4 * q4) = w;
      }
      wg_sync(1 + wg);
      cur_tile = tile;
    }
    mbar_wait(bar_q + 8 * stage(k), (k >> 1) & 1);
    const uint32_t qaddr = sb + kOffQ + stage(k) * kTileBytes;
    // S = Q . K_c^T: k = hd in 4 steps of 16, +32 bytes along the swizzled rows
    auto issue_s = [&](float (&s)[32], int c) {
      const uint32_t kaddr = sb + kOffK + c * kChunkN * kHd * 2;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, desc_sw128(qaddr + 32 * kk), desc_sw128(kaddr + 32 * kk), kk > 0);
    };
    // O += P . V_c: k = 64 patches in 4 steps of 16 rows, +2048 bytes
    auto issue_pv = [&](float (&o)[32], const uint32_t (&pa)[4][4], int c) {
      const uint32_t vaddr = sb + kOffV + c * kChunkN * kHd * 2;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(o, pa[kk], desc_sw128(vaddr + 2048 * kk));
    };
    auto mask_words = [&](int c, uint2& w0, uint2& w1) {
      w0 = *reinterpret_cast<const uint2*>(mrow0 + 2 * c);
      w1 = *reinterpret_cast<const uint2*>(mrow1 + 2 * c);
    };

    float o[32], s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, al0, al1;
    uint32_t pa[4][4], pb[4][4];
    uint2 w0, w1;

    fence_regs(o);  // defined before the first wgmma stage, not inside it
    wgmma_fence();
    issue_s(s, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    mask_words(0, w0, w1);
    softmax_chunk(s, w0, w1, cl, k2, m0, m1, l0, l1, pa, al0, al1);
    for (int c = 1; c < n_chunks; ++c) {
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      issue_s(s, c);
      wgmma_commit();
      issue_pv(o, pa, c - 1);
      wgmma_commit();
      mask_words(c, w0, w1);
      wgmma_wait<1>();  // S of chunk c; P.V of chunk c - 1 may still run
      fence_regs(s);
      softmax_chunk(s, w0, w1, cl, k2, m0, m1, l0, l1, pb, al0, al1);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);  // read by that P.V until here: pb must not share its registers
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[4 * n] *= al0;
        o[4 * n + 1] *= al0;
        o[4 * n + 2] *= al1;
        o[4 * n + 3] *= al1;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) pa[kk][x] = pb[kk][x];
    }
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    issue_pv(o, pa, n_chunks - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);

    // out = O / max(l, 1e-20) in bf16, through a swizzled tile and a TMA store
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
    if (tw == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    wg_sync(1 + wg);  // the previous item's store has read the tile
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int off = ((n ^ (r0 & 7)) * 16) + 4 * cl;  // rows r0, r0 + 8 share r & 7
      *reinterpret_cast<uint32_t*>(os + r0 * 128 + off) = pack_bf16(o[4 * n] / d0, o[4 * n + 1] / d0);
      *reinterpret_cast<uint32_t*>(os + (r0 + 8) * 128 + off) =
          pack_bf16(o[4 * n + 2] / d1, o[4 * n + 3] / d1);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    wg_sync(1 + wg);
    if (tw == 0) {
      tma_store_3d(&omap, smem_u32(os), 0, h * Lq + l, tile * kTile);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (tw == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: taken from the driver library
// the CUDA runtime has already loaded, so the build links nothing extra
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// a 3-D bf16 map with 128-byte rows (dim 0 = hd = 64), 128-byte swizzle
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base, uint64_t d1, uint64_t d2,
              uint32_t box1, uint32_t box2) {
  const cuuint64_t dims[3] = {(cuuint64_t)kHd, d1, d2};
  const cuuint64_t strides[2] = {kHd * 2, d1 * kHd * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {(cuuint32_t)kHd, box1, box2};
  const cuuint32_t estr[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_hopper(const void* q, const void* k, const void* v, const void* mask,
                          void* out, void* bits, int NP, int H, int Lq, int P,
                          cudaStream_t stream) {
  if (P > kMaxP || bits == nullptr) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  // q and out: dims (hd, H Lq, NP), box (hd, 1, 64 pairs); k and v: dims
  // (hd, P, H), box (hd, kKvBox patches, 1); rows past NP or P read as 0 and
  // are not written
  CUtensorMap qmap, kmap, vmap, omap;
  if (!make_map(encode, &qmap, q, (uint64_t)H * Lq, NP, 1, kTile) ||
      !make_map(encode, &omap, out, (uint64_t)H * Lq, NP, 1, kTile) ||
      !make_map(encode, &kmap, k, P, H, kKvBox, 1) ||
      !make_map(encode, &vmap, v, P, H, kKvBox, 1))
    return cudaErrorInvalidValue;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(skv_hopper_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err != cudaSuccess) return err;
  pack_mask_bits<<<(unsigned)(((long long)NP * 32 + 255) / 256), 256, 0, stream>>>(
      static_cast<const uint8_t*>(mask), static_cast<uint32_t*>(bits), NP, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per_head = n_sm / H > 1 ? n_sm / H : 1;  // one CTA per SM when H divides them
  skv_hopper_kernel<<<dim3(per_head, H), kThreads, kSmemBytes, stream>>>(
      qmap, kmap, vmap, omap, static_cast<const uint32_t*>(bits), NP, Lq, P,
      kLog2e / sqrtf((float)kHd));
  return cudaGetLastError();
}

}  // namespace

// variant: 0 = simple, 1 = hopper.  dtype: 0 = float32, 1 = bfloat16; hd in
// {16, 64} (the tiny and the baseline_v4_ov Q-Former).  mask is [NP, P]
// bool (one byte each).  bits is int32 scratch of NP * 16 words for the
// hopper variant (unused by the simple one).  All tensors contiguous,
// 16-byte aligned.  The hopper variant takes bf16, hd = 64, P <= kMaxP only.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int openpsg_flash_skv_forward(const void* q, const void* k, const void* v,
                                         const void* mask, void* out, void* bits, int NP,
                                         int H, int Lq, int P, int hd, int dtype, int variant,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (NP <= 0 || H <= 0 || Lq <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    if (dtype != 1 || hd != kHd) return (int)cudaErrorInvalidValue;
    return (int)launch_hopper(q, k, v, mask, out, bits, NP, H, Lq, P, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch_simple<float>(hd, q, k, v, mask, out, NP, H, Lq, P, s);
  if (dtype == 1)
    return (int)dispatch_simple<__nv_bfloat16>(hd, q, k, v, mask, out, NP, H, Lq, P, s);
  return (int)cudaErrorInvalidValue;
}

// The hopper kernel's registers per thread, shared memory per CTA (bytes,
// dynamic and static) and local memory per thread (bytes; > 0 means spills),
// as built.  Returns a cudaError_t.
extern "C" int openpsg_flash_skv_hopper_attrs(int* regs, int* smem_bytes, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, skv_hopper_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *smem_bytes = kSmemBytes + (int)a.sharedSizeBytes;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
