// Flash attention forward and backward for NVIDIA Hopper (sm_90a): kernels
// K1/K3 (forward) and K2/K4 (backward) of the port.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py
// (each kernel here in a 16-bit form, `_16`, templated over bf16 and fp16,
// and a CUDA-core form, `_cc` / `_f32` / `_wide`):
//   flash_fwd_kernel  <- `_fwd_rect` -> `_fwd_kernel` (K1) and
//                        `_fwd_tri` -> `_fwd_kernel_tri` (K3);
//   flash_dq_kernel   <- `_dq_kernel` (K2) and `_dq_kernel_tri` (K4);
//   flash_dkv_kernel  <- `_dkv_kernel` (K2) and `_dkv_kernel_tri` (K4).
// K3/K4 fold the causal triangle into a dense grid because Mosaic runs its grid
// in order and spends a DMA slot on every skipped tick. A GPU runs CTAs in
// parallel and a CTA simply stops at its diagonal, so each pair is one kernel
// here; launching the heaviest causal tiles first does what the fold did.
//
// Layout: q [B, sq, H, D], k/v [B, sk, KV, D] with H = g * KV (GQA), read in
// place through their batch/sequence/head strides (the last dimension is
// contiguous); no transpose copy and no expansion of K/V to H heads. Outputs
// are contiguous: out/dq [B, sq, H, D], dk/dv [B, sk, KV, D], lse f32
// [B, H, sq]. delta = rowsum(dout * out) f32 [B, H, sq] comes from the caller,
// as the JAX package computes it outside its kernels. Causal attention needs
// sq == sk (the wrapper raises otherwise), where top-left and bottom-right
// alignment agree; ragged lengths (not a multiple of the tile) are masked
// here.
//
// Which runs: bf16 and fp16 at head_dim 64 and 128 take the 16-bit
// kernels; f32 at 64 and 128 the CUDA-core f32 kernels; every type at 256
// the CUDA-core forward and the one-tile dq and dkv (their note is above
// them). The wrapper pads other widths up to 256 to the next of these.
//
// 16-bit forward (flash_fwd_kernel_16): TMA, wgmma and 128-row tiles, its
// design in the note above the kernel. A CTA owns a 128-row q tile of one
// (batch, query head); one thread loads Q once and streams K and V by TMA
// into a two-stage ring; two consumer warpgroups of 64 rows each multiply
// with wgmma (S = Q K^T from shared memory, O += P V with P from registers),
// take turns on the tensor cores so that one's softmax runs beside the
// other's products, and mask only the diagonal and ragged key tiles.
//
// 16-bit backward (flash_dq_kernel_16, flash_dkv_kernel_16): the same
// design, its note above the kernels. dq: a CTA owns a 128-row q tile of
// one (batch, query head) and streams 64-key tiles of K and V; dkv: a CTA
// owns a 128-key tile of one (batch, KV head) and streams 64-query tiles
// of Q, dO, lse and delta for each query head of the GQA group. All seven
// products run on wgmma, P and dS as A from registers; no atomics.
//
// The f32 kernels: a CTA of 4 warps owns one 64-row tile; each warp owns
// 16 rows of it and everything computed along those rows, so warps meet
// only where the CTA stages a shared tile into shared memory:
//   forward: CTA = (q tile, query head, batch). Per 64-key tile: S = Q K^T,
//            online softmax (running max m, sum l, f32), O = O * alpha + P V.
//   dq:      CTA = (q tile, query head, batch). Per key tile: P = exp(S - lse),
//            dP = dO V^T, dS = P (dP - delta), dQ += dS K.
//   dkv:     CTA = (key tile, KV head, batch). For each of the g query heads of
//            the group and each of their q tiles: P^T, dV += P^T dO,
//            dP^T = V dO^T, dS^T, dK += dS^T Q. No atomics: every dq, dk and dv
//            element is summed by one warp in a fixed order (deterministic).
// With `causal`, a q tile stops at its diagonal key tile and a key tile starts
// at its diagonal q tile. Grids are 1-D and ordered so the longest causal
// tiles launch first. They run on the CUDA cores in f32 FMA with register
// tiles (no TF32), with S and P staged through shared memory.
//
// 16-bit products run on the tensor cores (bf16 or fp16 operands, f32
// accumulators); P and dS are rounded to the input type before their
// products, as the Pallas kernels cast them to the input dtype (the
// CUDA-core kernels round them too at 16 bits). Softmax and all elementwise
// math are f32.
//
// What bounds it on an H100: at Llama training shapes (B=2, H=32, D=128,
// s=4096, causal) the forward does 4 B H s^2 D / 2 = 0.27 TFLOP against 0.27 GB
// of q/k/v/out, about 10^3 operations per byte, so it is bound by operations:
// 0.28 ms at the 989 TFLOP/s bf16 peak; the dq kernel does 1.5 times the
// forward's products, the dkv kernel 2 times. Every kernel keeps S and P out
// of device memory; the bf16 kernels feed the tensor cores by TMA and wgmma.
//
// Interface: plain C, loaded with ctypes. Each launcher returns the
// cudaError_t of its launch.

#include <math.h>
#include <stddef.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;     // query rows and key rows of a CTA tile
constexpr int kWarps = 4;     // each warp owns 16 rows of the tile
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ constexpr size_t r128(size_t n) { return (n + 127) & ~size_t(127); }

// f32 path: shared-memory row pitches, in elements. Input tiles are padded by
// one so that lanes reading one column of 32 different rows hit 32 banks.
template <int D>
struct Pitch {
  static constexpr int kIn = D + 1;      // q/k/v/dout tiles
  static constexpr int kS = kTile + 4;   // scores
  static constexpr int kP = kTile + 4;   // P or dS
};

// Bytes of each shared-memory region and of each f32 kernel's carve-out.
template <int D>
struct Smem {
  using P = Pitch<D>;
  static constexpr size_t in = r128(size_t(kTile) * P::kIn * sizeof(float));
  static constexpr size_t s = r128(size_t(kTile) * P::kS * sizeof(float));
  static constexpr size_t p = r128(size_t(kTile) * P::kP * sizeof(float));
  static constexpr size_t vec = r128(kTile * sizeof(float));
  static constexpr size_t fwd = 3 * in + s + p;
  static constexpr size_t dq = 4 * in + 2 * s + p + 2 * vec;
  static constexpr size_t dkv = 4 * in + 2 * s + p + 2 * vec;
};

struct Carve {
  char* p;
  template <typename U>
  __device__ U* take(size_t bytes) {
    U* r = reinterpret_cast<U*>(p);
    p += bytes;
    return r;
  }
};

// The CUDA-core kernels' element types: f32, and at head_dim 256 bf16 and
// fp16 too, read into f32 tiles and written back from f32.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (kIsF16<T>)
    return __float2half_rn(x);
  else if constexpr (sizeof(T) == 2)
    return __float2bfloat16_rn(x);
  else
    return x;
}

// x rounded to T: P and dS are rounded to the input type before their
// products, as the Pallas kernels cast them (f32: x itself)
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f32(from_f32<T>(x));
}

// Copy a 64-row tile (row pitch `stride` elements in device memory, rows
// contiguous) into an f32 tile in shared memory with pitch P. Rows at or
// past `rows` are zero, so masked rows never carry garbage (0 * NaN) into
// a product.
template <typename T, int D, int P>
__device__ void load_tile(float* dst, const T* src, long long stride, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) v = __ldg(reinterpret_cast<const uint4*>(src + r * stride + c));
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) dst[r * P + c + k] = to_f32(e[k]);
  }
}

// S[16][64] (f32, pitch PS) = A[16][D] . B[64][D]^T: one warp, operands in
// shared memory. Lane l computes columns l and l + 32 of every row.
template <int D, int PA, int PB, int PS>
__device__ void warp_scores(const float* A, const float* B, float* S) {
  const int lane = threadIdx.x & 31;
  float c0[16], c1[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) c0[r] = c1[r] = 0.f;
  const float* b0 = B + lane * PB;
  const float* b1 = B + (lane + 32) * PB;
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    const float x0 = b0[k], x1 = b1[k];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float a = A[r * PA + k];
      c0[r] = fmaf(a, x0, c0[r]);
      c1[r] = fmaf(a, x1, c1[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    S[r * PS + lane] = c0[r];
    S[r * PS + lane + 32] = c1[r];
  }
}

// A warp's f32 accumulator of 16 rows x D columns in registers; lane l owns
// columns l + 32 j (j < D / 32) of every row.
template <int D>
struct Acc {
  float v[16][D / 32];

  __device__ void init() {
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int j = 0; j < D / 32; ++j) v[r][j] = 0.f;
  }
  __device__ void scale_rows(const float (&alpha)[16]) {
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int j = 0; j < D / 32; ++j) v[r][j] *= alpha[r];
  }
  // += Pm[16][64] . B[64][D]
  template <int PP, int PB>
  __device__ void add(const float* Pm, const float* B) {
    const int lane = threadIdx.x & 31;
#pragma unroll 2
    for (int n = 0; n < kTile; ++n) {
      float b[D / 32];
#pragma unroll
      for (int j = 0; j < D / 32; ++j) b[j] = B[n * PB + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float p = Pm[r * PP + n];
#pragma unroll
        for (int j = 0; j < D / 32; ++j) v[r][j] = fmaf(p, b[j], v[r][j]);
      }
    }
  }
  __device__ float get(int r, int j) const { return v[r][j]; }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out;  // forward output, or dq
  void* dk;
  void* dv;
  float* lse_out;
  long long qs[3], ks[3], vs[3], ds[3];  // batch, sequence, head strides
  int B, H, KV, sq, sk, causal;
  int group;  // bf16 forward: (batch, head) pairs per group of CTAs
  float scale;
};

// ----------------------------------------------------------------------------
// forward
// ----------------------------------------------------------------------------

// T = float at every head_dim; at 256 also bf16 and fp16 (P rounded to T)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel_cc(Args a) {
  using Pt = Pitch<D>;
  using Sz = Smem<D>;
  extern __shared__ __align__(128) char smem[];
  Carve cv{smem};
  float* sQ = cv.take<float>(Sz::in);
  float* sK = cv.take<float>(Sz::in);
  float* sV = cv.take<float>(Sz::in);
  float* sS = cv.take<float>(Sz::s);
  float* sP = cv.take<float>(Sz::p);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = (a.sq + kTile - 1) / kTile;
  const int bh = blockIdx.x % (a.B * a.H);
  const int q0 = (ntiles - 1 - blockIdx.x / (a.B * a.H)) * kTile;  // heaviest first
  const int hq = bh % a.H, b = bh / a.H;
  const int kh = hq / (a.H / a.KV);

  const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + hq * a.qs[2];
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + kh * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + kh * a.vs[2];
  load_tile<T, D, Pt::kIn>(sQ, qb + q0 * a.qs[1], a.qs[1], min(kTile, a.sq - q0));

  Acc<D> acc;
  acc.init();
  float m[16], l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  float* S = sS + warp * 16 * Pt::kS;
  float* Pw = sP + warp * 16 * Pt::kP;
  const int row0 = q0 + warp * 16;
  const int kend = a.causal ? min(a.sk, q0 + kTile) : a.sk;

  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous K/V tile
    const int krows = min(kTile, a.sk - k0);
    load_tile<T, D, Pt::kIn>(sK, kb + k0 * a.ks[1], a.ks[1], krows);
    load_tile<T, D, Pt::kIn>(sV, vb + k0 * a.vs[1], a.vs[1], krows);
    __syncthreads();
    warp_scores<D, Pt::kIn, Pt::kIn, Pt::kS>(sQ + warp * 16 * Pt::kIn, sK, S);
    __syncwarp();
    float alpha[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int qi = row0 + r;
      const int c0 = k0 + lane, c1 = k0 + lane + 32;
      const bool v0 = c0 < a.sk && (!a.causal || c0 <= qi);
      const bool v1 = c1 < a.sk && (!a.causal || c1 <= qi);
      const float s0 = v0 ? S[r * Pt::kS + lane] * a.scale : kNegInf;
      const float s1 = v1 ? S[r * Pt::kS + lane + 32] * a.scale : kNegInf;
      const float mn = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float p0 = v0 ? expf(s0 - mn) : 0.f;
      const float p1 = v1 ? expf(s1 - mn) : 0.f;
      alpha[r] = expf(m[r] - mn);
      l[r] = l[r] * alpha[r] + warp_sum(p0 + p1);
      m[r] = mn;
      Pw[r * Pt::kP + lane] = rnd<T>(p0);
      Pw[r * Pt::kP + lane + 32] = rnd<T>(p1);
    }
    __syncwarp();
    acc.scale_rows(alpha);
    acc.template add<Pt::kP, Pt::kIn>(Pw, sV);
    __syncwarp();
  }

  T* ob = static_cast<T*>(a.out) + ((size_t)b * a.sq * a.H + hq) * D;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qi = row0 + r;
    if (qi >= a.sq) continue;
    const float lsafe = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 32; ++j)
      ob[(size_t)qi * a.H * D + lane + 32 * j] = from_f32<T>(acc.get(r, j) / lsafe);
    if (lane == 0) a.lse_out[((size_t)b * a.H + hq) * a.sq + qi] = m[r] + logf(lsafe);
  }
}

// ----------------------------------------------------------------------------
// backward: dq
// ----------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel_f32(Args a) {
  using T = float;
  using Pt = Pitch<D>;
  using Sz = Smem<D>;
  extern __shared__ __align__(128) char smem[];
  Carve cv{smem};
  T* sQ = cv.take<T>(Sz::in);
  T* sdO = cv.take<T>(Sz::in);
  T* sK = cv.take<T>(Sz::in);
  T* sV = cv.take<T>(Sz::in);
  float* sS = cv.take<float>(Sz::s);
  float* sdP = cv.take<float>(Sz::s);
  T* sP = cv.take<T>(Sz::p);
  float* sLse = cv.take<float>(Sz::vec);
  float* sDelta = cv.take<float>(Sz::vec);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = (a.sq + kTile - 1) / kTile;
  const int bh = blockIdx.x % (a.B * a.H);
  const int q0 = (ntiles - 1 - blockIdx.x / (a.B * a.H)) * kTile;
  const int hq = bh % a.H, b = bh / a.H;
  const int kh = hq / (a.H / a.KV);
  const int qrows = min(kTile, a.sq - q0);

  const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + hq * a.qs[2];
  const T* db = static_cast<const T*>(a.dout) + b * a.ds[0] + hq * a.ds[2];
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + kh * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + kh * a.vs[2];
  load_tile<T, D, Pt::kIn>(sQ, qb + q0 * a.qs[1], a.qs[1], qrows);
  load_tile<T, D, Pt::kIn>(sdO, db + q0 * a.ds[1], a.ds[1], qrows);
  const size_t row_base = ((size_t)b * a.H + hq) * a.sq + q0;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    sLse[i] = i < qrows ? a.lse_in[row_base + i] : 0.f;
    sDelta[i] = i < qrows ? a.delta[row_base + i] : 0.f;
  }

  Acc<D> acc;
  acc.init();
  float* S = sS + warp * 16 * Pt::kS;
  float* dP = sdP + warp * 16 * Pt::kS;
  T* Pw = sP + warp * 16 * Pt::kP;
  const int row0 = q0 + warp * 16;
  const int kend = a.causal ? min(a.sk, q0 + kTile) : a.sk;

  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();
    const int krows = min(kTile, a.sk - k0);
    load_tile<T, D, Pt::kIn>(sK, kb + k0 * a.ks[1], a.ks[1], krows);
    load_tile<T, D, Pt::kIn>(sV, vb + k0 * a.vs[1], a.vs[1], krows);
    __syncthreads();
    warp_scores<D, Pt::kIn, Pt::kIn, Pt::kS>(sQ + warp * 16 * Pt::kIn, sK, S);
    warp_scores<D, Pt::kIn, Pt::kIn, Pt::kS>(sdO + warp * 16 * Pt::kIn, sV, dP);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int qi = row0 + r;
      const float lse = sLse[warp * 16 + r], dl = sDelta[warp * 16 + r];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h, kj = k0 + c;
        const bool valid = qi < a.sq && kj < a.sk && (!a.causal || kj <= qi);
        const float p = valid ? expf(S[r * Pt::kS + c] * a.scale - lse) : 0.f;
        Pw[r * Pt::kP + c] = (p * (dP[r * Pt::kS + c] - dl));
      }
    }
    __syncwarp();
    acc.template add<Pt::kP, Pt::kIn>(Pw, sK);  // dQ += dS K
    __syncwarp();
  }

  T* ob = static_cast<T*>(a.out) + ((size_t)b * a.sq * a.H + hq) * D;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qi = row0 + r;
    if (qi >= a.sq) continue;
#pragma unroll
    for (int j = 0; j < D / 32; ++j)
      ob[(size_t)qi * a.H * D + lane + 32 * j] = (acc.get(r, j) * a.scale);
  }
}

// ----------------------------------------------------------------------------
// backward: dk, dv
// ----------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel_f32(Args a) {
  using T = float;
  using Pt = Pitch<D>;
  using Sz = Smem<D>;
  extern __shared__ __align__(128) char smem[];
  Carve cv{smem};
  T* sK = cv.take<T>(Sz::in);
  T* sV = cv.take<T>(Sz::in);
  T* sQ = cv.take<T>(Sz::in);
  T* sdO = cv.take<T>(Sz::in);
  float* sS = cv.take<float>(Sz::s);
  float* sdP = cv.take<float>(Sz::s);
  T* sP = cv.take<T>(Sz::p);
  float* sLse = cv.take<float>(Sz::vec);
  float* sDelta = cv.take<float>(Sz::vec);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = a.H / a.KV;
  const int bk = blockIdx.x % (a.B * a.KV);
  const int k0 = (blockIdx.x / (a.B * a.KV)) * kTile;  // first tiles see the most queries
  const int kh = bk % a.KV, b = bk / a.KV;
  const int krows = min(kTile, a.sk - k0);

  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + kh * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + kh * a.vs[2];
  load_tile<T, D, Pt::kIn>(sK, kb + k0 * a.ks[1], a.ks[1], krows);
  load_tile<T, D, Pt::kIn>(sV, vb + k0 * a.vs[1], a.vs[1], krows);

  Acc<D> dk, dv;
  dk.init();
  dv.init();
  float* S = sS + warp * 16 * Pt::kS;
  float* dP = sdP + warp * 16 * Pt::kS;
  T* Pw = sP + warp * 16 * Pt::kP;
  const int key0 = k0 + warp * 16;
  const int qstart = a.causal ? k0 : 0;

  for (int t = 0; t < g; ++t) {
    const int hq = kh * g + t;
    const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + hq * a.qs[2];
    const T* db = static_cast<const T*>(a.dout) + b * a.ds[0] + hq * a.ds[2];
    const size_t row_base = ((size_t)b * a.H + hq) * a.sq;
    for (int q0 = qstart; q0 < a.sq; q0 += kTile) {
      __syncthreads();
      const int qrows = min(kTile, a.sq - q0);
      load_tile<T, D, Pt::kIn>(sQ, qb + q0 * a.qs[1], a.qs[1], qrows);
      load_tile<T, D, Pt::kIn>(sdO, db + q0 * a.ds[1], a.ds[1], qrows);
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        sLse[i] = i < qrows ? a.lse_in[row_base + q0 + i] : 0.f;
        sDelta[i] = i < qrows ? a.delta[row_base + q0 + i] : 0.f;
      }
      __syncthreads();
      // transposed scores: rows are this warp's keys, columns the q tile
      warp_scores<D, Pt::kIn, Pt::kIn, Pt::kS>(sK + warp * 16 * Pt::kIn, sQ, S);
      warp_scores<D, Pt::kIn, Pt::kIn, Pt::kS>(sV + warp * 16 * Pt::kIn, sdO, dP);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int kj = key0 + r;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = lane + 32 * h, qi = q0 + c;
          const bool valid = qi < a.sq && kj < a.sk && (!a.causal || kj <= qi);
          const float p = valid ? expf(S[r * Pt::kS + c] * a.scale - sLse[c]) : 0.f;
          S[r * Pt::kS + c] = p;
          Pw[r * Pt::kP + c] = (p);
        }
      }
      __syncwarp();
      dv.template add<Pt::kP, Pt::kIn>(Pw, sdO);  // dV += P^T dO
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 16; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = lane + 32 * h;
          Pw[r * Pt::kP + c] =
              (S[r * Pt::kS + c] * (dP[r * Pt::kS + c] - sDelta[c]));
        }
      __syncwarp();
      dk.template add<Pt::kP, Pt::kIn>(Pw, sQ);  // dK += dS^T Q
      __syncwarp();
    }
  }

  T* dkb = static_cast<T*>(a.dk) + ((size_t)b * a.sk * a.KV + kh) * D;
  T* dvb = static_cast<T*>(a.dv) + ((size_t)b * a.sk * a.KV + kh) * D;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int kj = key0 + r;
    if (kj >= a.sk) continue;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) {
      const size_t o = (size_t)kj * a.KV * D + lane + 32 * j;
      dkb[o] = (dk.get(r, j) * a.scale);
      dvb[o] = (dv.get(r, j));
    }
  }
}

// ----------------------------------------------------------------------------
// backward at head_dim 256 (f32, bf16, fp16): CUDA cores, one shared tile
// ----------------------------------------------------------------------------
//
// At D = 256 a 64-row f32 tile is 64 KB, so the f32 dq and dkv kernels'
// four resident tiles do not fit the 227 KB a block may hold, and a warp
// cannot keep both dK and dV (128 registers each). These kernels keep the
// f32 kernels' warps, tiles and arithmetic, with one shared tile that takes
// the streamed operands in turn, each loaded once:
//   dq   Q and dO resident; per key tile, V into the tile (dP = dO V^T),
//        then K (S = Q K^T, dS in place of S, dQ += dS K).
//   dkv  two launches over the same grid, dK then dV, each with one
//        accumulator: K (and for dK, V) resident; per (query head, q
//        tile), for dK dO into the tile (dP^T = V dO^T), then Q (S^T = K
//        Q^T, dS^T in place, dK += dS^T Q); for dV Q (S^T, P^T in place),
//        then dO (dV += P^T dO).
// P and dS are rounded to T before their products, as the Pallas kernels
// cast them; everything else is f32. A simple design, right first: its
// times are in PERF.md.

template <int D>
struct WideSmem {
  static constexpr int kPi = D + 1;      // input tiles
  static constexpr int kPs = kTile + 2;  // scores (and P / dS in place)
  static constexpr size_t in = r128(size_t(kTile) * kPi * sizeof(float));
  static constexpr size_t s = r128(size_t(kTile) * kPs * sizeof(float));
  static constexpr size_t vec = r128(kTile * sizeof(float));
  static constexpr size_t total = 3 * in + 2 * s + 2 * vec;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel_wide(Args a) {
  using Sz = WideSmem<D>;
  constexpr int PI = Sz::kPi, PS = Sz::kPs;
  extern __shared__ __align__(128) char smem[];
  Carve cv{smem};
  float* sQ = cv.take<float>(Sz::in);
  float* sdO = cv.take<float>(Sz::in);
  float* sB = cv.take<float>(Sz::in);  // the key tile's V, then its K
  float* sS = cv.take<float>(Sz::s);
  float* sdP = cv.take<float>(Sz::s);
  float* sLse = cv.take<float>(Sz::vec);
  float* sDelta = cv.take<float>(Sz::vec);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = (a.sq + kTile - 1) / kTile;
  const int bh = blockIdx.x % (a.B * a.H);
  const int q0 = (ntiles - 1 - blockIdx.x / (a.B * a.H)) * kTile;
  const int hq = bh % a.H, b = bh / a.H;
  const int kh = hq / (a.H / a.KV);
  const int qrows = min(kTile, a.sq - q0);

  const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + hq * a.qs[2];
  const T* db = static_cast<const T*>(a.dout) + b * a.ds[0] + hq * a.ds[2];
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + kh * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + kh * a.vs[2];
  load_tile<T, D, PI>(sQ, qb + q0 * a.qs[1], a.qs[1], qrows);
  load_tile<T, D, PI>(sdO, db + q0 * a.ds[1], a.ds[1], qrows);
  const size_t row_base = ((size_t)b * a.H + hq) * a.sq + q0;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    sLse[i] = i < qrows ? a.lse_in[row_base + i] : 0.f;
    sDelta[i] = i < qrows ? a.delta[row_base + i] : 0.f;
  }

  Acc<D> acc;
  acc.init();
  float* S = sS + warp * 16 * PS;
  float* dP = sdP + warp * 16 * PS;
  const int row0 = q0 + warp * 16;
  const int kend = a.causal ? min(a.sk, q0 + kTile) : a.sk;

  for (int k0 = 0; k0 < kend; k0 += kTile) {
    const int krows = min(kTile, a.sk - k0);
    __syncthreads();  // every warp is done with the previous K
    load_tile<T, D, PI>(sB, vb + k0 * a.vs[1], a.vs[1], krows);
    __syncthreads();
    warp_scores<D, PI, PI, PS>(sdO + warp * 16 * PI, sB, dP);
    __syncthreads();  // every warp is done with V
    load_tile<T, D, PI>(sB, kb + k0 * a.ks[1], a.ks[1], krows);
    __syncthreads();
    warp_scores<D, PI, PI, PS>(sQ + warp * 16 * PI, sB, S);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int qi = row0 + r;
      const float lse = sLse[warp * 16 + r], dl = sDelta[warp * 16 + r];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h, kj = k0 + c;
        const bool valid = qi < a.sq && kj < a.sk && (!a.causal || kj <= qi);
        const float p = valid ? expf(S[r * PS + c] * a.scale - lse) : 0.f;
        S[r * PS + c] = rnd<T>(p * (dP[r * PS + c] - dl));
      }
    }
    __syncwarp();
    acc.template add<PS, PI>(S, sB);  // dQ += dS K
  }

  T* ob = static_cast<T*>(a.out) + ((size_t)b * a.sq * a.H + hq) * D;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int qi = row0 + r;
    if (qi >= a.sq) continue;
#pragma unroll
    for (int j = 0; j < D / 32; ++j)
      ob[(size_t)qi * a.H * D + lane + 32 * j] = from_f32<T>(acc.get(r, j) * a.scale);
  }
}

// DK: the dK launch (else the dV launch)
template <typename T, int D, bool DK>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel_wide(Args a) {
  using Sz = WideSmem<D>;
  constexpr int PI = Sz::kPi, PS = Sz::kPs;
  extern __shared__ __align__(128) char smem[];
  Carve cv{smem};
  float* sK = cv.take<float>(Sz::in);
  float* sV = cv.take<float>(Sz::in);  // dK only
  float* sB = cv.take<float>(Sz::in);  // the q tile's dO, then its Q (dK); Q, then dO (dV)
  float* sS = cv.take<float>(Sz::s);
  float* sdP = cv.take<float>(Sz::s);  // dK only
  float* sLse = cv.take<float>(Sz::vec);
  float* sDelta = cv.take<float>(Sz::vec);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = a.H / a.KV;
  const int bk = blockIdx.x % (a.B * a.KV);
  const int k0 = (blockIdx.x / (a.B * a.KV)) * kTile;
  const int kh = bk % a.KV, b = bk / a.KV;
  const int krows = min(kTile, a.sk - k0);

  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + kh * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + kh * a.vs[2];
  load_tile<T, D, PI>(sK, kb + k0 * a.ks[1], a.ks[1], krows);
  if (DK) load_tile<T, D, PI>(sV, vb + k0 * a.vs[1], a.vs[1], krows);

  Acc<D> acc;
  acc.init();
  float* S = sS + warp * 16 * PS;
  float* dP = sdP + warp * 16 * PS;
  const int key0 = k0 + warp * 16;
  const int qstart = a.causal ? k0 : 0;

  for (int t = 0; t < g; ++t) {
    const int hq = kh * g + t;
    const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + hq * a.qs[2];
    const T* db = static_cast<const T*>(a.dout) + b * a.ds[0] + hq * a.ds[2];
    const size_t row_base = ((size_t)b * a.H + hq) * a.sq;
    for (int q0 = qstart; q0 < a.sq; q0 += kTile) {
      const int qrows = min(kTile, a.sq - q0);
      __syncthreads();  // every warp is done with the previous tile
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        sLse[i] = i < qrows ? a.lse_in[row_base + q0 + i] : 0.f;
        sDelta[i] = i < qrows ? a.delta[row_base + q0 + i] : 0.f;
      }
      if (DK) {
        load_tile<T, D, PI>(sB, db + q0 * a.ds[1], a.ds[1], qrows);
        __syncthreads();
        // transposed: rows are this warp's keys, columns the q tile
        warp_scores<D, PI, PI, PS>(sV + warp * 16 * PI, sB, dP);
        __syncthreads();  // every warp is done with dO
      }
      load_tile<T, D, PI>(sB, qb + q0 * a.qs[1], a.qs[1], qrows);
      __syncthreads();
      warp_scores<D, PI, PI, PS>(sK + warp * 16 * PI, sB, S);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int kj = key0 + r;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = lane + 32 * h, qi = q0 + c;
          const bool valid = qi < a.sq && kj < a.sk && (!a.causal || kj <= qi);
          const float p = valid ? expf(S[r * PS + c] * a.scale - sLse[c]) : 0.f;
          S[r * PS + c] = DK ? rnd<T>(p * (dP[r * PS + c] - sDelta[c])) : rnd<T>(p);
        }
      }
      __syncwarp();
      if (!DK) {
        __syncthreads();  // every warp is done with Q
        load_tile<T, D, PI>(sB, db + q0 * a.ds[1], a.ds[1], qrows);
        __syncthreads();
      }
      acc.template add<PS, PI>(S, sB);  // dK += dS^T Q, or dV += P^T dO
    }
  }

  T* ob = static_cast<T*>(DK ? a.dk : a.dv) + ((size_t)b * a.sk * a.KV + kh) * D;
  const float f = DK ? a.scale : 1.f;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int kj = key0 + r;
    if (kj >= a.sk) continue;
#pragma unroll
    for (int j = 0; j < D / 32; ++j)
      ob[(size_t)kj * a.KV * D + lane + 32 * j] = from_f32<T>(acc.get(r, j) * f);
  }
}

// ----------------------------------------------------------------------------
// bf16 helpers
// ----------------------------------------------------------------------------

// reductions over the quad of lanes (4 g + t, t < 4) that shares a row of
// a wgmma accumulator fragment
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ----------------------------------------------------------------------------
// bf16 forward: TMA, wgmma, warp-specialised
// ----------------------------------------------------------------------------
//
// A CTA owns a 128-row q tile of one (batch, query head). CTAs are ordered
// in groups of `group` (batch, head) pairs, heaviest q tile first within a
// group: the CTAs that run together share their K/V in L2 (the wrapper's
// fwd_group sizes a group to 16 MiB of K/V). 3 warpgroups:
//   producer   (warpgroup 0, one thread) loads the Q tile once and streams
//              the key tiles, K and V each into a ring of kFwdStages
//              stages, by TMA: 4-D maps over (d, heads, seq, batch) from
//              the tensors' own strides, 64-column boxes with the 128-byte
//              swizzle (a d = 128 row is two boxes), rows past sq or sk
//              zero. Every stage completes on its own mbarrier and is
//              refilled once the consumers release it.
//   consumers  (warpgroups 1, 2) own q rows 0-63 and 64-127 of the tile.
//              Per key tile:
//     S = Q K^T    wgmma m64n128k16, both K-major from shared memory
//     softmax      on the accumulator fragment in registers: the running
//                  max m over the quad that shares a row, p = 2^(s scale
//                  log2e - m scale log2e) (one FFMA and ex2), l summed per
//                  lane (the quad's partials are added once, at the end),
//                  alpha rescales O
//     O += P V     wgmma m64n{d}k16 with A = P from registers (the S
//                  fragment packed pairwise to bf16 is wgmma's A fragment)
//                  and V read MN-major straight from its TMA tile
//   Tile i's S is issued before tile i - 1's P V (O is rescaled between
//   the two issues), and its softmax runs while that product is on the
//   tensor cores; the two warpgroups take turns to issue their products
//   (named barriers), so one's softmax runs beside the other's products.
// Key tiles run from the last down: the causal diagonal tile and a ragged
// last tile (the only ones with a mask) come first, the interior tiles
// after them take the unmasked path. The epilogue divides O by l, stores it
// as bf16 from the fragment, and stores lse = (m scale log2e + log2 l) ln 2.
// ops/hopper/flash_attention.py's fwd_tile_plan, fwd_cta_order and
// fwd_schedule_model mirror the tile order, the CTA order, the masks and
// this arithmetic.

// 2^x, flushing denormal results to zero (a p that small is 0 in the sums)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kFwdBM = 128;  // q rows of a CTA: 2 consumer warpgroups x 64
// keys of a tile; at d = 64, 64 and 192 were no faster (PERF.md)
constexpr int kFwdBN = 128;
constexpr int kFwdStages = 2;     // K/V ring
constexpr int kFwdThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct FwdSmem {
  static constexpr int q = kFwdBM * D * 2;      // D / 64 boxes of [128 rows][128 B]
  static constexpr int kv = kFwdBN * D * 2;     // a K or V stage
  static constexpr int total = 1024 + q + 2 * kFwdStages * kv;
};

struct FwdArgs {
  void* out;   // [B, sq, H, D] bf16
  float* lse;  // [B, H, sq]
  int B, H, KV, sq, sk, causal;
  int group;         // (batch, head) pairs per group of CTAs
  float scale_log2;  // scale * log2(e)
};

template <typename E, int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_kernel_16(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, FwdArgs a) {
  using Sm = FwdSmem<D>;
  constexpr int BN = kFwdBN;
  constexpr int kBoxes = D / 64;  // 64-column boxes of a row
  extern __shared__ __align__(128) unsigned char fwd_smem[];
  __shared__ __align__(8) uint64_t full_q, full_k[kFwdStages], full_v[kFwdStages],
      empty_k[kFwdStages], empty_v[kFwdStages];
  const uint32_t q_u = smem_u32(align1024(fwd_smem));
  const uint32_t k_u = q_u + Sm::q;  // stage s at + s Sm::kv
  const uint32_t v_u = k_u + kFwdStages * Sm::kv;

  // this CTA's q tile, query head and batch, and its key tiles
  const int ntiles = (a.sq + kFwdBM - 1) / kFwdBM;
  const int grp0 = blockIdx.x / (a.group * ntiles) * a.group;
  const int gc = min(a.group, a.B * a.H - grp0);
  const int within = blockIdx.x - grp0 * ntiles;
  const int bh = grp0 + within % gc;
  const int q0 = (ntiles - 1 - within / gc) * kFwdBM;
  const int hq = bh % a.H, b = bh / a.H, kh = hq / (a.H / a.KV);
  const int kend = a.causal ? min(a.sk, q0 + kFwdBM) : a.sk;
  const int ntk = (kend + BN - 1) / BN;
  // key tiles from first_masked on cross the diagonal or the ragged end
  const int first_masked = a.causal ? q0 / BN : (a.sk % BN ? ntk - 1 : ntk);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&full_q, 1);
#pragma unroll
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);  // one arrival per consumer warp
      mbar_init(&empty_v[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // producer: key tile i (the i-th from the last) to stage i %
    // kFwdStages, K once the products of tile i - kFwdStages have read its
    // K, V once they have read its V
    setmaxnreg_dec<40>();
    if (tid == 0) {
      prefetch_map(&map_q);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      mbar_expect_tx(&full_q, Sm::q);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c)
        tma_4d(q_u + c * kFwdBM * 128, &map_q, &full_q, 64 * c, hq, q0, b);
      for (int i = 0; i < ntk; ++i) {
        const int s = i % kFwdStages, k0 = (ntk - 1 - i) * BN;
        const int par = ((i / kFwdStages) & 1) ^ 1;
        if (i >= kFwdStages) mbar_wait(&empty_k[s], par);
        mbar_expect_tx(&full_k[s], Sm::kv);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_4d(k_u + s * Sm::kv + c * BN * 128, &map_k, &full_k[s], 64 * c, kh, k0, b);
        if (i >= kFwdStages) mbar_wait(&empty_v[s], par);
        mbar_expect_tx(&full_v[s], Sm::kv);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_4d(v_u + s * Sm::kv + c * BN * 128, &map_v, &full_v[s], 64 * c, kh, k0, b);
      }
    }
  } else {
    // consumers
    setmaxnreg_inc<232>();
    const int cw = tid / 128 - 1, warp = (tid / 32) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + 64 * cw + 16 * warp + g;  // and row0 + 8
    const uint32_t qa = q_u + cw * 64 * 128;        // this warpgroup's 64 rows
    float o[D / 2], sc[BN / 2];
    uint32_t p[BN / 16][4];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

    // S = Q K^T of tile i into sc, issued, not waited for
    auto issue_s = [&](int i) {
      const int s = i % kFwdStages;
      mbar_wait(&full_k[s], (i / kFwdStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n128<0, 0, E>(
            sc, smem_desc(qa + (ks / 4) * kFwdBM * 128 + (ks % 4) * 32, 1, 64),
            smem_desc(k_u + s * Sm::kv + (ks / 4) * BN * 128 + (ks % 4) * 32, 1, 64), ks > 0);
      wgmma_commit();
    };
    // O += P V of tile i, issued, not waited for. V rows 16 kk .. as B
    // [keys x d]: MN-major, the d / 64 atoms BN * 128 bytes apart (LBO),
    // 8-key groups 1024 bytes apart (SBO)
    auto issue_pv = [&](int i) {
      const int s = i % kFwdStages;
      mbar_wait(&full_v[s], (i / kFwdStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db = smem_desc(v_u + s * Sm::kv + kk * 16 * 128, BN * 128 / 16, 64);
        if constexpr (D == 128)
          wgmma_rs_n128<1, E>(o, p[kk], db, 1);
        else
          wgmma_rs_n64<1, E>(o, p[kk], db, 1);
      }
      wgmma_commit();
    };
    // the online softmax of tile i on sc (in place: sc becomes P in f32),
    // the mask on the edge tiles only
    auto softmax = [&](int i) {
      const int k0 = (ntk - 1 - i) * BN;
      if (k0 >= first_masked * BN) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + 2 * t + (e & 1), row = row0 + 8 * (e >> 1);
            if (col >= a.sk || (a.causal && col > row)) sc[4 * j + e] = -INFINITY;
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
      float ms[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = quad_max(mx[h]);
        // a row with no key yet keeps m = -inf: subtract 0, not -inf
        ms[h] = mx[h] == -INFINITY ? 0.f : mx[h] * a.scale_log2;
        alpha[h] = ex2(m[h] * a.scale_log2 - ms[h]);
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], a.scale_log2, -ms[e >> 1]));
          l[e >> 1] += sc[4 * j + e];
        }
    };
    // P rounded to bf16: the S fragment packed pairwise is wgmma's A
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[kk][r] = pack2<E>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    };
    // O scaled to the running max of the last softmax
    auto rescale_o = [&]() {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    // the warpgroups take turns to issue their products: a warpgroup waits
    // on its own named barrier, then lets the other go; the first opens its
    // own to start
    const int my_bar = 1 + cw, other_bar = 2 - cw;
    if (cw == 0) named_arrive(my_bar, 256);
    mbar_wait(&full_q, 0);
    named_sync(my_bar, 256);
    issue_s(0);
    named_arrive(other_bar, 256);
    wgmma_wait<0>();
    fence_operand(sc);
    release(&empty_k[0]);
    softmax(0);
    pack_p();
    // O is rescaled by the previous tile's alpha while this tile's S runs
    for (int i = 1; i < ntk; ++i) {
      named_sync(my_bar, 256);
      issue_s(i);
      rescale_o();
      issue_pv(i - 1);
      named_arrive(other_bar, 256);
      wgmma_wait<1>();
      fence_operand(sc);
      release(&empty_k[i % kFwdStages]);
      softmax(i);
      wgmma_wait<0>();
      fence_operand(o);
      release(&empty_v[(i - 1) % kFwdStages]);
      pack_p();
    }
    rescale_o();
    issue_pv(ntk - 1);
    wgmma_wait<0>();
    fence_operand(o);

    E* const ob = static_cast<E*>(a.out) + ((size_t)b * a.sq * a.H + hq) * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const float lt = quad_sum(l[h]);
      if (row >= a.sq) continue;
      const float inv = 1.f / lt;
      E* const orow = ob + (size_t)row * a.H * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack2<E>(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      if (t == 0)
        a.lse[((size_t)b * a.H + hq) * a.sq + row] = (m[h] * a.scale_log2 + log2f(lt)) * kLn2;
    }
  }
}

// ----------------------------------------------------------------------------
// bf16 backward: TMA, wgmma, warp-specialised
// ----------------------------------------------------------------------------
//
// Two kernels, as the JAX package has two: dq, and dk/dv. Each recomputes
// S = Q K^T and dP = dO V^T from the saved lse and delta; neither uses
// atomics, so every dq, dk and dv element is summed by one warpgroup in a
// fixed order and two calls give the same bits. Both have the forward's
// shape: 3 warpgroups, a producer (one thread issues TMA loads; in dkv one
// warp also stages lse and delta; 24 registers a thread) and two consumer
// warpgroups of 64 rows (240 registers) that run every product with
// wgmma, the accumulators in registers.
// Tiles come by TMA with the forward's 4-D maps (64-column boxes, 128-byte
// swizzle, zero fill outside the tensor), streamed through rings of
// stages with full/empty mbarriers.
//
//   dq   CTA = a 128-row q tile of one (batch, query head). Q and dO are
//        loaded once; the key tiles (64 keys, last first) stream K and V.
//        Per key tile and consumer warpgroup (64 rows):
//          S  = Q K^T      wgmma m64n64k16, both K-major
//          dP = dO V^T     the same on dO and V
//          P  = 2^(S scale log2e - lse log2e), dS = P (dP - delta)
//          dQ += dS K      A = dS from registers (the accumulator packed
//                          pairwise to bf16), K read MN-major from the tile
//                          S read it K-major from (two descriptors, one tile)
//        dS is computed once S and dP are both done, then the tile's dQ
//        product is issued with the next tile's S and dP; a K stage is
//        released once its dQ product is done, a V stage once dP is.
//   dkv  CTA = a 128-key tile of one (batch, KV head). K and V are loaded
//        once; for each query head of the GQA group in turn, the q tiles
//        (64 queries) stream Q, dO and the tile's lse (times log2e) and
//        delta strips. Per q tile and consumer warpgroup (64 keys):
//          S^T  = K Q^T    P^T = 2^(S^T scale log2e - lse log2e)
//          dV  += P^T dO   A = P^T from registers, dO read MN-major
//          dP^T = V dO^T   dS^T = P^T (dP^T - delta)
//          dK  += dS^T Q   A = dS^T from registers, Q read MN-major
//        lse and delta vary along the accumulator's columns here: a lane
//        reads the pair for its columns 8 j + 2 t, 8 j + 2 t + 1 from the
//        staged strip. P^T and dS^T are packed once S^T and dP^T are both
//        done; the dV and dK products are issued with the next pass's S^T
//        and dP^T, from a ring of 3 stages. At d = 128 a consumer thread
//        holds dK and dV (64 registers each), S^T and dP^T (32 each) and
//        the P^T and dS^T fragments (16 each): ptxas spills 16 bytes and
//        serialises some products (C7512); 32-query tiles fit but ran
//        slower (PERF.md).
// No instruction but wgmma writes an accumulator: a value computed in
// place in S's registers, or a zero fill of dq/dk/dv, makes ptxas
// serialise the products (C7515), so each kernel's first accumulating
// product overwrites (scale-d 0).
// P and dS are rounded to bf16 for their products, as the Pallas kernels
// cast them; P and dS themselves are f32. The scale is applied once, to
// dq and dk at the end.
//
// Padding contributes exactly zero: TMA zero-fills Q and dO rows past sq
// and K and V rows past sk, and a q row past sq takes lse = +inf, so its p
// is 0 (dkv; dq stores no such row). Keys past sk would give p =
// 2^(-lse) != 0 in dq, so dq masks the ragged last key tile; dkv stores
// no such key row. Otherwise only the tiles that cross the causal
// diagonal take the mask. CTAs launch in groups of `group` (batch, head)
// pairs, the heaviest tile first within a group (dq: the last q tile;
// dkv: the first key tile), so that the CTAs running together share
// their K/V (dq) or Q/dO (dkv) in L2. ops/hopper/flash_attention.py's
// bwd_tile_plan and bwd_schedule_model mirror the tiles, masks and
// arithmetic.

constexpr int kBwdThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kDqBM = 128;        // q rows of a dq CTA
constexpr int kDqBN = 64;         // keys of a streamed tile
constexpr int kDqStages = 2;
constexpr int kDkvBN = 128;  // keys of a dkv CTA
constexpr int kDkvBM = 64;   // queries of a streamed tile
constexpr int kDkvStages = 3;

template <int D>
struct DqSmem {
  static constexpr int q = kDqBM * D * 2;   // Q or dO: D / 64 boxes of [128 rows][128 B]
  static constexpr int kv = kDqBN * D * 2;  // a K or V stage
  static constexpr int total = 1024 + 2 * q + 2 * kDqStages * kv;
};

template <int D>
struct DkvSmem {
  static constexpr int kv = kDkvBN * D * 2;  // K or V
  static constexpr int q = kDkvBM * D * 2;   // a Q or dO stage
  static constexpr int rows = kDkvBM * 4;    // a stage's lse or delta strip
  static constexpr int total = 1024 + 2 * kv + kDkvStages * (2 * q + 2 * rows);
};

struct BwdArgs {
  const float* lse;    // [B, H, sq]
  const float* delta;  // [B, H, sq]
  void* dq;            // [B, sq, H, D] bf16
  void* dk;            // [B, sk, KV, D] bf16
  void* dv;
  int B, H, KV, sq, sk, causal;
  int group;         // (batch, head) pairs per group of CTAs
  float scale;       // applied to dq and dk at the end
  float scale_log2;  // scale * log2(e)
};

// This CTA's (batch, head) pair and rank: CTAs run in groups of `group`
// pairs, rank 0 of every pair of the group first, then rank 1, ...
__device__ __forceinline__ void grouped_cta(int pairs, int ntiles, int group, int& pair,
                                            int& rank) {
  const int grp0 = blockIdx.x / (group * ntiles) * group;
  const int gc = min(group, pairs - grp0);
  const int within = blockIdx.x - grp0 * ntiles;
  pair = grp0 + within % gc;
  rank = within / gc;
}

template <typename E, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dq_kernel_16(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do, BwdArgs a) {
  using Sm = DqSmem<D>;
  constexpr int BM = kDqBM, BN = kDqBN, S = kDqStages;
  constexpr int kBoxes = D / 64;
  extern __shared__ __align__(128) unsigned char dq_smem[];
  __shared__ __align__(8) uint64_t full_q, full_k[S], full_v[S], empty_k[S], empty_v[S];
  const uint32_t q_u = smem_u32(align1024(dq_smem));
  const uint32_t do_u = q_u + Sm::q;
  const uint32_t k_u = do_u + Sm::q;  // stage s at + s Sm::kv
  const uint32_t v_u = k_u + S * Sm::kv;

  const int ntiles = (a.sq + BM - 1) / BM;
  int bh, rank;
  grouped_cta(a.B * a.H, ntiles, a.group, bh, rank);
  const int q0 = (ntiles - 1 - rank) * BM;  // heaviest first
  const int hq = bh % a.H, b = bh / a.H, kh = hq / (a.H / a.KV);
  const int kend = a.causal ? min(a.sk, q0 + BM) : a.sk;
  const int ntk = (kend + BN - 1) / BN;
  // key tiles from first_masked on cross the diagonal or the ragged end
  const int first_masked = a.causal ? q0 / BN : (a.sk % BN ? ntk - 1 : ntk);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&full_q, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);  // one arrival per consumer warp
      mbar_init(&empty_v[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // producer: Q and dO once, then key tile i (the i-th from the last) to
    // stage i % S, K once the dQ product of tile i - S has read its K, V
    // once the dP product of tile i - S has read its V
    setmaxnreg_dec<24>();
    if (tid == 0) {
      prefetch_map(&map_q);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      prefetch_map(&map_do);
      mbar_expect_tx(&full_q, 2 * Sm::q);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c) {
        tma_4d(q_u + c * BM * 128, &map_q, &full_q, 64 * c, hq, q0, b);
        tma_4d(do_u + c * BM * 128, &map_do, &full_q, 64 * c, hq, q0, b);
      }
      for (int i = 0; i < ntk; ++i) {
        const int s = i % S, k0 = (ntk - 1 - i) * BN;
        const int par = ((i / S) & 1) ^ 1;
        if (i >= S) mbar_wait(&empty_k[s], par);
        mbar_expect_tx(&full_k[s], Sm::kv);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_4d(k_u + s * Sm::kv + c * BN * 128, &map_k, &full_k[s], 64 * c, kh, k0, b);
        if (i >= S) mbar_wait(&empty_v[s], par);
        mbar_expect_tx(&full_v[s], Sm::kv);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_4d(v_u + s * Sm::kv + c * BN * 128, &map_v, &full_v[s], 64 * c, kh, k0, b);
      }
    }
  } else {
    // consumers
    setmaxnreg_inc<240>();
    const int cw = tid / 128 - 1, warp = (tid / 32) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + 64 * cw + 16 * warp + g;  // and row0 + 8
    const uint32_t qa = q_u + cw * 64 * 128;        // this warpgroup's 64 rows
    const uint32_t da = do_u + cw * 64 * 128;
    // lse (times log2e) and delta of this lane's two rows; a row past sq
    // takes lse = +inf (p = 0) and reads nothing
    float lse2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const size_t at = ((size_t)b * a.H + hq) * a.sq + row;
      lse2[h] = row < a.sq ? a.lse[at] * kLog2e : INFINITY;
      dl[h] = row < a.sq ? a.delta[at] : 0.f;
    }
    float sc[BN / 2], dp[BN / 2], dq[D / 2];
    uint32_t ds[BN / 16][4];

    // S = Q K^T and dP = dO V^T of tile i, issued (one group each)
    auto issue_s_dp = [&](int i) {
      const int s = i % S;
      mbar_wait(&full_k[s], (i / S) & 1);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64<0, 0, E>(sc, smem_desc(qa + (ks / 4) * BM * 128 + (ks % 4) * 32, 1, 64),
                           smem_desc(k_u + s * Sm::kv + (ks / 4) * BN * 128 + (ks % 4) * 32, 1, 64),
                           ks > 0);
      wgmma_commit();
      mbar_wait(&full_v[s], (i / S) & 1);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64<0, 0, E>(dp, smem_desc(da + (ks / 4) * BM * 128 + (ks % 4) * 32, 1, 64),
                           smem_desc(v_u + s * Sm::kv + (ks / 4) * BN * 128 + (ks % 4) * 32, 1, 64),
                           ks > 0);
      wgmma_commit();
    };
    // dQ += dS K of tile i, issued; tile 0's first product overwrites
    // (no zero fill, which ptxas would count as a write to the
    // accumulator). K rows 16 kk .. as B [keys x d]: MN-major, the d / 64
    // atoms BN * 128 bytes apart (LBO), 8-key groups 1024 bytes apart
    // (SBO)
    auto issue_dq = [&](int i) {
      const int s = i % S;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db = smem_desc(k_u + s * Sm::kv + kk * 16 * 128, BN * 128 / 16, 64);
        if constexpr (D == 128)
          wgmma_rs_n128<1, E>(dq, ds[kk], db, i > 0 || kk > 0);
        else
          wgmma_rs_n64<1, E>(dq, ds[kk], db, i > 0 || kk > 0);
      }
      wgmma_commit();
    };
    // dS = P (dP - delta) with P = 2^(S scale log2e - lse log2e), the
    // mask on the edge tiles only, rounded to bf16 into wgmma's A
    // fragments, once S and dP are both done: no other instruction writes
    // an accumulator, so ptxas keeps the products asynchronous
    auto make_ds = [&](int i) {
      const int k0 = (ntk - 1 - i) * BN;
      const bool masked = k0 >= first_masked * BN;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float v[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int x = 8 * kk + 2 * r + c, h = r & 1;
            const int col = k0 + 8 * (x >> 2) + 2 * t + c, row = row0 + 8 * h;
            float p = ex2(fmaf(sc[x], a.scale_log2, -lse2[h]));
            if (masked && (col >= a.sk || (a.causal && col > row))) p = 0.f;
            v[c] = p * (dp[x] - dl[h]);
          }
          ds[kk][r] = pack2<E>(v[0], v[1]);
        }
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    mbar_wait(&full_q, 0);
    issue_s_dp(0);
    for (int i = 0; i < ntk; ++i) {
      // in flight: dQ of tile i - 1, S and dP of tile i
      wgmma_wait<0>();
      fence_operand(sc);
      fence_operand(dp);
      if (i > 0) release(&empty_k[(i - 1) % S]);
      release(&empty_v[i % S]);
      make_ds(i);
      issue_dq(i);
      if (i + 1 < ntk) issue_s_dp(i + 1);
    }
    wgmma_wait<0>();
    fence_operand(dq);

    E* const ob = static_cast<E*>(a.dq) + ((size_t)b * a.sq * a.H + hq) * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= a.sq) continue;
      E* const orow = ob + (size_t)row * a.H * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack2<E>(dq[4 * j + 2 * h] * a.scale, dq[4 * j + 2 * h + 1] * a.scale);
    }
  }
}

template <typename E, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_dkv_kernel_16(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do, BwdArgs a) {
  using Sm = DkvSmem<D>;
  constexpr int BM = kDkvBM, BN = kDkvBN, S = kDkvStages;
  constexpr int kBoxes = D / 64;
  extern __shared__ __align__(128) unsigned char dkv_smem[];
  __shared__ __align__(8) uint64_t full_kv, full[S], empty[S];
  unsigned char* const base = align1024(dkv_smem);
  const uint32_t k_u = smem_u32(base);
  const uint32_t v_u = k_u + Sm::kv;
  const uint32_t q_u = v_u + Sm::kv;  // stage s at + s Sm::q
  const uint32_t do_u = q_u + S * Sm::q;
  // stage s's strips: lse * log2e at sL + s BM, delta at sD + s BM
  float* const sL = reinterpret_cast<float*>(base + 2 * Sm::kv + 2 * S * Sm::q);
  float* const sD = sL + S * BM;

  const int G = a.H / a.KV;
  const int ntiles = (a.sk + BN - 1) / BN;
  int bk, rank;
  grouped_cta(a.B * a.KV, ntiles, a.group, bk, rank);
  const int k0 = rank * BN;  // the first key tiles see the most queries
  const int kh = bk % a.KV, b = bk / a.KV;
  const int qstart = a.causal ? k0 : 0;
  const int nqt = (a.sq - qstart + BM - 1) / BM;  // q tiles per query head
  const int n = G * nqt;                          // (query head, q tile) passes

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&full_kv, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // producer: K and V once, then pass i (query head kh G + i / nqt, q
    // tile i % nqt) to stage i % S once the products of pass i - S are
    // done. The first warp stages the lse and delta strips (a query past
    // sq takes lse = +inf, delta = 0, and reads nothing), then its first
    // lane arrives on the stage's barrier with the Q and dO bytes to come.
    setmaxnreg_dec<24>();
    if (tid < 32) {
      if (tid == 0) {
        prefetch_map(&map_q);
        prefetch_map(&map_k);
        prefetch_map(&map_v);
        prefetch_map(&map_do);
        mbar_expect_tx(&full_kv, 2 * Sm::kv);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c) {
          tma_4d(k_u + c * BN * 128, &map_k, &full_kv, 64 * c, kh, k0, b);
          tma_4d(v_u + c * BN * 128, &map_v, &full_kv, 64 * c, kh, k0, b);
        }
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % S, hq = kh * G + i / nqt, q0 = qstart + (i % nqt) * BM;
        if (i >= S) mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        const size_t row = ((size_t)b * a.H + hq) * a.sq;
        for (int r = tid; r < BM; r += 32) {
          const bool ok = q0 + r < a.sq;
          sL[s * BM + r] = ok ? a.lse[row + q0 + r] * kLog2e : INFINITY;
          sD[s * BM + r] = ok ? a.delta[row + q0 + r] : 0.f;
        }
        __syncwarp();
        if (tid == 0) {
          mbar_expect_tx(&full[s], 2 * Sm::q);
#pragma unroll
          for (int c = 0; c < kBoxes; ++c) {
            tma_4d(q_u + s * Sm::q + c * BM * 128, &map_q, &full[s], 64 * c, hq, q0, b);
            tma_4d(do_u + s * Sm::q + c * BM * 128, &map_do, &full[s], 64 * c, hq, q0, b);
          }
        }
      }
    }
  } else {
    // consumers
    setmaxnreg_inc<240>();
    const int cw = tid / 128 - 1, warp = (tid / 32) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int key0 = k0 + 64 * cw + 16 * warp + g;  // and key0 + 8
    const uint32_t ka = k_u + cw * 64 * 128;        // this warpgroup's 64 keys
    const uint32_t va = v_u + cw * 64 * 128;
    float st[BM / 2], dpt[BM / 2], dk[D / 2], dv[D / 2];
    uint32_t pp[BM / 16][4], ds[BM / 16][4];

    // S^T = K Q^T and dP^T = V dO^T of pass i, issued (one group each)
    auto issue_s_dp = [&](int i) {
      const int s = i % S;
      mbar_wait(&full[s], (i / S) & 1);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64<0, 0, E>(st, smem_desc(ka + (ks / 4) * BN * 128 + (ks % 4) * 32, 1, 64),
                           smem_desc(q_u + s * Sm::q + (ks / 4) * BM * 128 + (ks % 4) * 32, 1, 64),
                           ks > 0);
      wgmma_commit();
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64<0, 0, E>(dpt, smem_desc(va + (ks / 4) * BN * 128 + (ks % 4) * 32, 1, 64),
                           smem_desc(do_u + s * Sm::q + (ks / 4) * BM * 128 + (ks % 4) * 32, 1, 64),
                           ks > 0);
      wgmma_commit();
    };
    // acc += A B over the stage's 64 queries, A from registers, B = the
    // stage's dO or Q tile [queries x d] read MN-major
    auto issue_acc = [&](float(&acc)[D / 2], const uint32_t(&af)[BM / 16][4], uint32_t tile,
                         bool first) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        const uint64_t db = smem_desc(tile + kk * 16 * 128, BM * 128 / 16, 64);
        if constexpr (D == 128)
          wgmma_rs_n128<1, E>(acc, af[kk], db, !first || kk > 0);
        else
          wgmma_rs_n64<1, E>(acc, af[kk], db, !first || kk > 0);
      }
      wgmma_commit();
    };
    // P^T and dS^T = P^T (dP^T - delta) from S^T and dP^T, rounded to
    // bf16 into A fragments; the causal mask on the diagonal tiles only
    auto make_p_ds = [&](int i) {
      const int s = i % S, q0 = qstart + (i % nqt) * BM;
      const float* lse2 = sL + s * BM;
      const float* delta = sD + s * BM;
      const bool masked = a.causal && q0 < k0 + BN;
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int x = 8 * kk + 2 * r, col = 8 * (x >> 2) + 2 * t;
          const float2 l = *reinterpret_cast<const float2*>(lse2 + col);
          const float2 d2 = *reinterpret_cast<const float2*>(delta + col);
          float p0 = ex2(fmaf(st[x], a.scale_log2, -l.x));
          float p1 = ex2(fmaf(st[x + 1], a.scale_log2, -l.y));
          if (masked) {
            const int key = key0 + 8 * (r & 1);
            if (key > q0 + col) p0 = 0.f;
            if (key > q0 + col + 1) p1 = 0.f;
          }
          pp[kk][r] = pack2<E>(p0, p1);
          ds[kk][r] = pack2<E>(p0 * (dpt[x] - d2.x), p1 * (dpt[x + 1] - d2.y));
        }
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    mbar_wait(&full_kv, 0);
    issue_s_dp(0);
    for (int i = 0; i < n; ++i) {
      const int s = i % S;
      // in flight: dV and dK of pass i - 1, S^T and dP^T of pass i
      wgmma_wait<0>();
      fence_operand(st);
      fence_operand(dpt);
      if (i > 0) release(&empty[(i - 1) % S]);
      make_p_ds(i);
      issue_acc(dv, pp, do_u + s * Sm::q, i == 0);  // dV += P^T dO
      issue_acc(dk, ds, q_u + s * Sm::q, i == 0);   // dK += dS^T Q
      if (i + 1 < n) issue_s_dp(i + 1);
    }
    wgmma_wait<0>();
    fence_operand(dk);
    fence_operand(dv);

    E* const dkb = static_cast<E*>(a.dk) + ((size_t)b * a.sk * a.KV + kh) * D;
    E* const dvb = static_cast<E*>(a.dv) + ((size_t)b * a.sk * a.KV + kh) * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + 8 * h;
      if (key >= a.sk) continue;
      const size_t row = (size_t)key * a.KV * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkb + row + 8 * j + 2 * t) =
            pack2<E>(dk[4 * j + 2 * h] * a.scale, dk[4 * j + 2 * h + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvb + row + 8 * j + 2 * t) =
            pack2<E>(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ----------------------------------------------------------------------------
// launchers
// ----------------------------------------------------------------------------

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

struct Launch {
  void (*kernel)(Args);
  size_t smem;
};

template <int D>
Launch pick_f32(Which which) {
  using Sz = Smem<D>;
  if (which == kFwd) return {flash_fwd_kernel_cc<float, D>, Sz::fwd};
  if (which == kDq) return {flash_dq_kernel_f32<D>, Sz::dq};
  return {flash_dkv_kernel_f32<D>, Sz::dkv};
}

// A CUDA-core kernel: 64-row tiles, 4 warps
int launch_cc(Launch l, int blocks, const Args& a, cudaStream_t st) {
  // above 48 KB of dynamic shared memory a kernel must opt in
  const cudaError_t err = cudaFuncSetAttribute(
      l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  l.kernel<<<blocks, kThreads, l.smem, st>>>(a);
  return (int)cudaGetLastError();
}

// head_dim 256, every type: the CUDA-core forward, the one-tile dq, and the
// dK then the dV launch of the one-tile dkv
template <typename T>
int run_wide(Which which, const Args& a, cudaStream_t st) {
  constexpr int D = 256;
  const int qblocks = (a.sq + kTile - 1) / kTile * a.B * a.H;
  const int kblocks = (a.sk + kTile - 1) / kTile * a.B * a.KV;
  if (which == kFwd) return launch_cc({flash_fwd_kernel_cc<T, D>, Smem<D>::fwd}, qblocks, a, st);
  constexpr size_t smem = WideSmem<D>::total;
  if (which == kDq) return launch_cc({flash_dq_kernel_wide<T, D>, smem}, qblocks, a, st);
  const int rc = launch_cc({flash_dkv_kernel_wide<T, D, true>, smem}, kblocks, a, st);
  if (rc != 0) return rc;
  return launch_cc({flash_dkv_kernel_wide<T, D, false>, smem}, kblocks, a, st);
}

// A 4-D tensor map over (d, heads, seq, batch) of a bf16 or fp16 (E)
// [batch, seq, heads, d] tensor with element strides st (batch, seq, heads;
// d contiguous): boxes of 64 columns x `rows` rows of one head, 128-byte
// swizzle, zeros outside the tensor.
template <typename E>
bool make_map(CUtensorMap* map, const void* ptr, int d, int heads, int seq, int batch,
              const long long* st, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type =
      kIsF16<E> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return enc(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename E, int D>
int run_fwd_16(const Args& a, cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  if (!make_map<E>(&mq, a.q, D, a.H, a.sq, a.B, a.qs, kFwdBM) ||
      !make_map<E>(&mk, a.k, D, a.KV, a.sk, a.B, a.ks, kFwdBN) ||
      !make_map<E>(&mv, a.v, D, a.KV, a.sk, a.B, a.vs, kFwdBN))
    return (int)cudaErrorInvalidValue;
  // the shared-memory opt-in holds per device: set it on every call
  constexpr int smem = FwdSmem<D>::total;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel_16<E, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  FwdArgs f;
  f.out = a.out, f.lse = a.lse_out;
  f.B = a.B, f.H = a.H, f.KV = a.KV, f.sq = a.sq, f.sk = a.sk, f.causal = a.causal;
  f.group = a.group;
  f.scale_log2 = a.scale * kLog2e;
  const int blocks = (a.sq + kFwdBM - 1) / kFwdBM * a.B * a.H;
  flash_fwd_kernel_16<E, D><<<blocks, kFwdThreads, smem, st>>>(mq, mk, mv, f);
  return (int)cudaGetLastError();
}

// The 16-bit dq (which == kDq) or dkv kernel: Q and dO in boxes of the q
// tile's rows, K and V of the key tile's.
template <typename E, int D>
int run_bwd_16(const Args& a, Which which, cudaStream_t st) {
  const bool dq = which == kDq;
  const int qrows = dq ? kDqBM : kDkvBM, krows = dq ? kDqBN : kDkvBN;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map<E>(&mq, a.q, D, a.H, a.sq, a.B, a.qs, qrows) ||
      !make_map<E>(&mk, a.k, D, a.KV, a.sk, a.B, a.ks, krows) ||
      !make_map<E>(&mv, a.v, D, a.KV, a.sk, a.B, a.vs, krows) ||
      !make_map<E>(&mdo, a.dout, D, a.H, a.sq, a.B, a.ds, qrows))
    return (int)cudaErrorInvalidValue;
  BwdArgs f;
  f.lse = a.lse_in, f.delta = a.delta;
  f.dq = a.out, f.dk = a.dk, f.dv = a.dv;
  f.B = a.B, f.H = a.H, f.KV = a.KV, f.sq = a.sq, f.sk = a.sk, f.causal = a.causal;
  f.group = a.group;
  f.scale = a.scale;
  f.scale_log2 = a.scale * kLog2e;
  void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, BwdArgs) =
      dq ? flash_dq_kernel_16<E, D> : flash_dkv_kernel_16<E, D>;
  const int smem = dq ? DqSmem<D>::total : DkvSmem<D>::total;
  const int blocks = dq ? (a.sq + kDqBM - 1) / kDqBM * a.B * a.H
                        : (a.sk + kDkvBN - 1) / kDkvBN * a.B * a.KV;
  // the shared-memory opt-in holds per device: set it on every call
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<blocks, kBwdThreads, smem, st>>>(mq, mk, mv, mdo, f);
  return (int)cudaGetLastError();
}

template <typename E>
int run_16(int d, Which which, const Args& a, cudaStream_t st) {
  if (which == kFwd) return d == 64 ? run_fwd_16<E, 64>(a, st) : run_fwd_16<E, 128>(a, st);
  return d == 64 ? run_bwd_16<E, 64>(a, which, st) : run_bwd_16<E, 128>(a, which, st);
}

int run(int dtype, int d, Which which, const Args& a, void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.KV <= 0 || a.H % a.KV != 0 || a.sq <= 0 || a.sk <= 0 ||
      (a.causal && a.sq != a.sk) || (d != 64 && d != 128 && d != 256) || dtype < 0 ||
      dtype > 2 || (dtype != 0 && d != 256 && a.group < 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 256)
    return dtype == 0 ? run_wide<float>(which, a, st)
                      : dtype == 1 ? run_wide<bf16>(which, a, st) : run_wide<__half>(which, a, st);
  if (dtype == 1) return run_16<bf16>(d, which, a, st);
  if (dtype == 2) return run_16<__half>(d, which, a, st);
  const Launch l = d == 64 ? pick_f32<64>(which) : pick_f32<128>(which);
  const int qtiles = (a.sq + kTile - 1) / kTile, ktiles = (a.sk + kTile - 1) / kTile;
  return launch_cc(l, which == kDkv ? ktiles * a.B * a.KV : qtiles * a.B * a.H, a, st);
}

Args make_args(const void* q, const void* k, const void* v, const long long* strides, int B,
               int H, int KV, int sq, int sk, int causal, float scale) {
  Args a{};
  a.q = q, a.k = k, a.v = v;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.ds[i] = strides[9 + i];
  }
  a.B = B, a.H = H, a.KV = KV, a.sq = sq, a.sk = sk, a.causal = causal, a.scale = scale;
  return a;
}

}  // namespace

// strides: 12 int64 values, the batch/sequence/head strides (in elements) of
// q, k, v and dout in that order (dout's are unused by the forward).
// d: 64, 128 or 256.
// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (all inputs and outputs
// share it).
// group: a 16-bit kernel's (batch, head) pairs per group of CTAs (>= 1;
// the wrapper's fwd_group for the forward and dq, dkv_group for dkv),
// unused by the CUDA-core kernels (f32, and every type at d = 256).
// The caller checks shapes, devices, dtypes and 16-byte alignment of rows
// (the bf16 kernels' tensor maps need a 16-byte aligned base and strides
// that are multiples of 16 bytes; they return cudaErrorInvalidValue when a
// map cannot be made).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                void* lse, const long long* strides, int B, int H, int KV,
                                int sq, int sk, int d, int dtype, int causal, float scale,
                                int group, void* stream) {
  Args a = make_args(q, k, v, strides, B, H, KV, sq, sk, causal, scale);
  a.group = group;
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  return run(dtype, d, kFwd, a, stream);
}

// which: 0 launches the dq kernel (writes dq), 1 the dkv kernel (writes dk, dv).
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, void* dk,
                                void* dv, const long long* strides, int B, int H, int KV,
                                int sq, int sk, int d, int dtype, int causal, float scale,
                                int which, int group, void* stream) {
  if (which != 0 && which != 1) return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, strides, B, H, KV, sq, sk, causal, scale);
  a.group = group;
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dq, a.dk = dk, a.dv = dv;
  return run(dtype, d, which == 0 ? kDq : kDkv, a, stream);
}
