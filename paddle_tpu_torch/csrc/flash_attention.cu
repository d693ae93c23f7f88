// Flash attention forward and backward for NVIDIA Hopper (sm_90a): kernels
// K1/K3 (forward) and K2/K4 (backward) of the port.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py
// (each kernel here in a bf16 and an f32 form, `_bf16` / `_f32`):
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
// bf16 forward (flash_fwd_kernel_bf16): TMA, wgmma and 128-row tiles, its
// design in the note above the kernel. A CTA owns a 128-row q tile of one
// (batch, query head); one thread loads Q once and streams K and V by TMA
// into a two-stage ring; two consumer warpgroups of 64 rows each multiply
// with wgmma (S = Q K^T from shared memory, O += P V with P from registers),
// take turns on the tensor cores so that one's softmax runs beside the
// other's products, and mask only the diagonal and ragged key tiles.
//
// The backward and the f32 forward: a CTA of 4 warps owns one 64-row tile;
// each warp owns 16 rows of it and everything computed along those rows, so
// warps meet only where the CTA stages a shared tile into shared memory
// (bf16: the streamed tiles are double-buffered with cp.async, the next one
// copying in while the current one is used):
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
// tiles launch first.
//
// Products of the backward: bfloat16 goes through the tensor cores with
// mma.sync m16n8k16 (bf16 operands from shared memory through ldmatrix, f32
// accumulators in registers); the score tile S, P and dS stay in registers,
// where the C fragments of one product are the A fragments of the next. P
// and dS are rounded to bf16 before their products, as the Pallas kernels
// cast them to the input dtype (the bf16 forward rounds P the same way).
// float32 runs on the CUDA cores in f32 FMA with register tiles (no TF32),
// with S and P staged through shared memory. Softmax and all elementwise
// math are f32.
//
// What bounds it on an H100: at Llama training shapes (B=2, H=32, D=128,
// s=4096, causal) the forward does 4 B H s^2 D / 2 = 0.27 TFLOP against 0.27 GB
// of q/k/v/out, about 10^3 operations per byte, so it is bound by operations:
// 0.28 ms at the 989 TFLOP/s bf16 peak; the dq kernel does 1.5 times the
// forward's products, the dkv kernel 2 times. Every kernel keeps S and P out
// of device memory; the forward feeds the tensor cores by TMA and wgmma, the
// backward is still the simple form (64-row tiles of 4 warps, cp.async,
// mma.sync).
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

// Copy a 64-row tile (row pitch `stride` elements in device memory, rows
// contiguous) into shared memory with pitch P. Rows at or past `rows` are
// zero, so masked rows never carry garbage (0 * NaN) into a product.
template <typename T, int D, int P>
__device__ void load_tile(T* dst, const T* src, long long stride, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) v = __ldg(reinterpret_cast<const uint4*>(src + r * stride + c));
    if constexpr ((P * sizeof(T)) % 16 == 0) {
      *reinterpret_cast<uint4*>(dst + r * P + c) = v;
    } else {
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int k = 0; k < kVec; ++k) dst[r * P + c + k] = e[k];
    }
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

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel_f32(Args a) {
  using T = float;
  using Pt = Pitch<D>;
  using Sz = Smem<D>;
  extern __shared__ __align__(128) char smem[];
  Carve cv{smem};
  T* sQ = cv.take<T>(Sz::in);
  T* sK = cv.take<T>(Sz::in);
  T* sV = cv.take<T>(Sz::in);
  float* sS = cv.take<float>(Sz::s);
  T* sP = cv.take<T>(Sz::p);

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
  T* Pw = sP + warp * 16 * Pt::kP;
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
      Pw[r * Pt::kP + lane] = (p0);
      Pw[r * Pt::kP + lane + 32] = (p1);
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
      ob[(size_t)qi * a.H * D + lane + 32 * j] = (acc.get(r, j) / lsafe);
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
// bf16 path: tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate),
// with every accumulator in registers
// ----------------------------------------------------------------------------
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): lane = 4 * g + t. An A
// fragment (16 x 16, row-major) is 4 registers of two bf16: rows g and g + 8,
// columns 2t, 2t + 1 and 2t + 8, 2t + 9. A B fragment (16 x 8, k x n) is 2
// registers: k = 2t, 2t + 1 and 2t + 8, 2t + 9 of column n = g. A C fragment
// (16 x 8 f32) is c0, c1 at row g, columns 2t, 2t + 1, and c2, c3 at row g + 8.
// So a row of scores lives in the 4 lanes of a quad, and the C fragments of
// two neighbouring 8-column tiles are, packed to bf16, the A fragment of the
// next product: P and dS never leave registers.

constexpr int kPitchBf16Pad = 8;  // keeps rows 16-byte aligned, ldmatrix conflict-free

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Start copying a 64-row tile into shared memory (pitch P) with cp.async,
// 16 bytes a thread at a time; rows at or past `rows` are zero-filled. The
// copy lands after cp_async_wait and a barrier.
template <int D, int P>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, long long stride,
                                                int rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = r < rows;
    const bf16* from = ok ? src + r * stride + c : src;  // read nothing when !ok
    const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * P + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(from),
                 "r"(ok ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The A fragment of rows r0..r0+15, columns k0..k0+15 of a row-major tile.
template <int P>
__device__ __forceinline__ void load_a(uint32_t (&f)[4], const bf16* tile, int r0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(f, tile + (r0 + (lane & 15)) * P + k0 + (lane >> 4) * 8);
}

// B fragments of two 8-column tiles n0..n0+15 at k0..k0+15, where the tile is
// stored [n][k] (rows of K or Q against which scores are taken): f[0], f[1]
// belong to n0..n0+7, f[2], f[3] to n0+8..n0+15.
template <int P>
__device__ __forceinline__ void load_b(uint32_t (&f)[4], const bf16* tile, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(f, tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * P + k0 + ((lane >> 3) & 1) * 8);
}

// The same for a tile stored [k][n] (V, dO, Q or K as the right-hand side of
// a product over keys or queries), through the transposing load.
template <int P>
__device__ __forceinline__ void load_bt(uint32_t (&f)[4], const bf16* tile, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(f, tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * P + n0 + (lane >> 4) * 8);
}

// acc[N8][4] (16 rows x 8*N8 columns) += A[16][16*KC] . B, where A comes in as
// the C fragments c[2*KC][4] of the previous product (16 rows x 16*KC), packed
// to bf16, and B rows k0.. of a [k][n] tile.
template <int P, int KC, int N8>
__device__ __forceinline__ void mma_pv(float (&acc)[N8][4], const float (&c)[2 * KC][4],
                                       const bf16* tile, int k0) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const uint32_t a[4] = {pack_bf16(c[2 * kc][0], c[2 * kc][1]),
                           pack_bf16(c[2 * kc][2], c[2 * kc][3]),
                           pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]),
                           pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3])};
#pragma unroll
    for (int n = 0; n < N8; n += 2) {
      uint32_t b[4];
      load_bt<P>(b, tile, k0 + kc * 16, n * 8);
      mma_bf16(acc[n], a, b[0], b[1]);
      mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// s[N8][4] = A rows r0.. of tile_a (D wide) . (rows n0.. of tile_b)^T.
template <int P, int D, int N8>
__device__ __forceinline__ void mma_scores(float (&s)[N8][4], const bf16* tile_a, int r0,
                                           const bf16* tile_b, int n0) {
#pragma unroll
  for (int n = 0; n < N8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    load_a<P>(a, tile_a, r0, kc * 16);
#pragma unroll
    for (int n = 0; n < N8; n += 2) {
      uint32_t b[4];
      load_b<P>(b, tile_b, n0 + n * 8, kc * 16);
      mma_bf16(s[n], a, b[0], b[1]);
      mma_bf16(s[n + 1], a, b[2], b[3]);
    }
  }
}

template <int D>
__host__ __device__ constexpr size_t bf16_tile_bytes() {
  return r128(size_t(kTile) * (D + kPitchBf16Pad) * sizeof(bf16));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel_bf16(Args a) {
  constexpr int P = D + kPitchBf16Pad;
  constexpr size_t kT = bf16_tile_bytes<D>();
  extern __shared__ __align__(128) char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = reinterpret_cast<bf16*>(smem + kT);
  bf16* sK[2] = {reinterpret_cast<bf16*>(smem + 2 * kT), reinterpret_cast<bf16*>(smem + 3 * kT)};
  bf16* sV[2] = {reinterpret_cast<bf16*>(smem + 4 * kT), reinterpret_cast<bf16*>(smem + 5 * kT)};

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = (a.sq + kTile - 1) / kTile;
  const int bh = blockIdx.x % (a.B * a.H);
  const int q0 = (ntiles - 1 - blockIdx.x / (a.B * a.H)) * kTile;
  const int hq = bh % a.H, b = bh / a.H;
  const int kh = hq / (a.H / a.KV);
  const int qrows = min(kTile, a.sq - q0);

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs[0] + hq * a.qs[2];
  const bf16* db = static_cast<const bf16*>(a.dout) + b * a.ds[0] + hq * a.ds[2];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks[0] + kh * a.ks[2];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs[0] + kh * a.vs[2];
  load_tile<bf16, D, P>(sQ, qb + q0 * a.qs[1], a.qs[1], qrows);
  load_tile<bf16, D, P>(sdO, db + q0 * a.ds[1], a.ds[1], qrows);

  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const size_t row_base = ((size_t)b * a.H + hq) * a.sq;
  float lse[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse[h] = rows[h] < a.sq ? a.lse_in[row_base + rows[h]] : 0.f;
    dl[h] = rows[h] < a.sq ? a.delta[row_base + rows[h]] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const int kend = a.causal ? min(a.sk, q0 + kTile) : a.sk;
  const int ntk = (kend + kTile - 1) / kTile;
  auto issue = [&](int it) {
    const int k0 = it * kTile, krows = min(kTile, a.sk - k0);
    load_tile_async<D, P>(sK[it & 1], kb + k0 * a.ks[1], a.ks[1], krows);
    load_tile_async<D, P>(sV[it & 1], vb + k0 * a.vs[1], a.vs[1], krows);
    cp_async_commit();
  };
  issue(0);

  for (int it = 0; it < ntk; ++it) {
    const int k0 = it * kTile;
    if (it + 1 < ntk) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // also orders the Q and dO tiles before their first use
    const bf16* tK = sK[it & 1];
    float s[kTile / 8][4], dp[kTile / 8][4];
    mma_scores<P, D, kTile / 8>(s, sQ, warp * 16, tK, 0);
    mma_scores<P, D, kTile / 8>(dp, sdO, warp * 16, sV[it & 1], 0);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1), h = e >> 1;
        const bool valid = rows[h] < a.sq && col < a.sk && (!a.causal || col <= rows[h]);
        const float p = valid ? expf(s[n][e] * a.scale - lse[h]) : 0.f;
        s[n][e] = p * (dp[n][e] - dl[h]);  // dS
      }
    mma_pv<P, kTile / 16, D / 8>(dq, s, tK, 0);  // dQ += dS K
    __syncthreads();  // every warp is done with buffer it & 1 before it refills
  }

  bf16* ob = static_cast<bf16*>(a.out) + ((size_t)b * a.sq * a.H + hq) * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= a.sq) continue;
    bf16* orow = ob + (size_t)rows[h] * a.H * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_bf16(dq[n][2 * h] * a.scale, dq[n][2 * h + 1] * a.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel_bf16(Args a) {
  constexpr int P = D + kPitchBf16Pad;
  constexpr size_t kT = bf16_tile_bytes<D>();
  constexpr int kHalf = kTile / 2;  // queries per pass: bounds the live registers
  extern __shared__ __align__(128) char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + kT);
  bf16* sQ[2] = {reinterpret_cast<bf16*>(smem + 2 * kT), reinterpret_cast<bf16*>(smem + 3 * kT)};
  bf16* sdO[2] = {reinterpret_cast<bf16*>(smem + 4 * kT), reinterpret_cast<bf16*>(smem + 5 * kT)};

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int G = a.H / a.KV;
  const int bk = blockIdx.x % (a.B * a.KV);
  const int k0 = (blockIdx.x / (a.B * a.KV)) * kTile;  // first tiles see the most queries
  const int kh = bk % a.KV, b = bk / a.KV;

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks[0] + kh * a.ks[2];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs[0] + kh * a.vs[2];
  load_tile<bf16, D, P>(sK, kb + k0 * a.ks[1], a.ks[1], min(kTile, a.sk - k0));
  load_tile<bf16, D, P>(sV, vb + k0 * a.vs[1], a.vs[1], min(kTile, a.sk - k0));

  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int qstart = a.causal ? k0 : 0;
  const int nqt = (a.sq - qstart + kTile - 1) / kTile;  // q tiles per query head
  // one pass per (query head of the group, q tile), streamed double-buffered
  auto issue = [&](int it) {
    const int hq = kh * G + it / nqt, q0 = qstart + (it % nqt) * kTile;
    const int qrows = min(kTile, a.sq - q0);
    const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs[0] + hq * a.qs[2];
    const bf16* db = static_cast<const bf16*>(a.dout) + b * a.ds[0] + hq * a.ds[2];
    load_tile_async<D, P>(sQ[it & 1], qb + q0 * a.qs[1], a.qs[1], qrows);
    load_tile_async<D, P>(sdO[it & 1], db + q0 * a.ds[1], a.ds[1], qrows);
    cp_async_commit();
  };
  issue(0);

  for (int it = 0; it < G * nqt; ++it) {
    if (it + 1 < G * nqt) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // also orders the K and V tiles before their first use
    const int hq = kh * G + it / nqt, q0 = qstart + (it % nqt) * kTile;
    const size_t row_base = ((size_t)b * a.H + hq) * a.sq;
    const bf16* tQ = sQ[it & 1];
    const bf16* tdO = sdO[it & 1];
#pragma unroll 1
    for (int half = 0; half < kTile; half += kHalf) {
      // transposed scores: rows are this warp's keys, columns queries
      float s[kHalf / 8][4], dp[kHalf / 8][4];
      mma_scores<P, D, kHalf / 8>(s, sK, warp * 16, tQ, half);
      mma_scores<P, D, kHalf / 8>(dp, sV, warp * 16, tdO, half);
#pragma unroll
      for (int n = 0; n < kHalf / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + half + n * 8 + 2 * t + (e & 1), key = keys[e >> 1];
          const bool valid = qi < a.sq && key < a.sk && (!a.causal || key <= qi);
          const float p = valid ? expf(s[n][e] * a.scale - a.lse_in[row_base + qi]) : 0.f;
          s[n][e] = p;
          dp[n][e] = valid ? p * (dp[n][e] - a.delta[row_base + qi]) : 0.f;  // dS^T
        }
      mma_pv<P, kHalf / 16, D / 8>(dv, s, tdO, half);  // dV += P^T dO
      mma_pv<P, kHalf / 16, D / 8>(dk, dp, tQ, half);  // dK += dS^T Q
    }
    __syncthreads();  // every warp is done with buffer it & 1 before it refills
  }

  bf16* dkb = static_cast<bf16*>(a.dk) + ((size_t)b * a.sk * a.KV + kh) * D;
  bf16* dvb = static_cast<bf16*>(a.dv) + ((size_t)b * a.sk * a.KV + kh) * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keys[h] >= a.sk) continue;
    const size_t row = (size_t)keys[h] * a.KV * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dkb + row + n * 8 + 2 * t) =
          pack_bf16(dk[n][2 * h] * a.scale, dk[n][2 * h + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + row + n * 8 + 2 * t) =
          pack_bf16(dv[n][2 * h], dv[n][2 * h + 1]);
    }
  }
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

// Named barriers 1.. (0 is __syncthreads): wait until n threads have
// arrived (the waiting ones included), or arrive without waiting.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

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

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_kernel_bf16(const __grid_constant__ CUtensorMap map_q,
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
        wgmma_ss_n128<0, 0>(
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
          wgmma_rs_n128<1>(o, p[kk], db, 1);
        else
          wgmma_rs_n64<1>(o, p[kk], db, 1);
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
          p[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
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

    bf16* const ob = static_cast<bf16*>(a.out) + ((size_t)b * a.sq * a.H + hq) * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const float lt = quad_sum(l[h]);
      if (row >= a.sq) continue;
      const float inv = 1.f / lt;
      bf16* const orow = ob + (size_t)row * a.H * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      if (t == 0)
        a.lse[((size_t)b * a.H + hq) * a.sq + row] = (m[h] * a.scale_log2 + log2f(lt)) * kLn2;
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
  if (which == kFwd) return {flash_fwd_kernel_f32<D>, Sz::fwd};
  if (which == kDq) return {flash_dq_kernel_f32<D>, Sz::dq};
  return {flash_dkv_kernel_f32<D>, Sz::dkv};
}

// the backward's bf16 kernels (the bf16 forward launches in run_fwd_bf16)
template <int D>
Launch pick_bf16(Which which) {
  constexpr size_t kT = bf16_tile_bytes<D>();
  if (which == kDq) return {flash_dq_kernel_bf16<D>, 6 * kT};
  return {flash_dkv_kernel_bf16<D>, 6 * kT};
}

// A 4-D tensor map over (d, heads, seq, batch) of a bf16 [batch, seq,
// heads, d] tensor with element strides st (batch, seq, heads; d
// contiguous): boxes of 64 columns x `rows` rows of one head, 128-byte
// swizzle, zeros outside the tensor.
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
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int run_fwd_bf16(const Args& a, cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, a.q, D, a.H, a.sq, a.B, a.qs, kFwdBM) ||
      !make_map(&mk, a.k, D, a.KV, a.sk, a.B, a.ks, kFwdBN) ||
      !make_map(&mv, a.v, D, a.KV, a.sk, a.B, a.vs, kFwdBN))
    return (int)cudaErrorInvalidValue;
  // the shared-memory opt-in holds per device: set it on every call
  constexpr int smem = FwdSmem<D>::total;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  FwdArgs f;
  f.out = a.out, f.lse = a.lse_out;
  f.B = a.B, f.H = a.H, f.KV = a.KV, f.sq = a.sq, f.sk = a.sk, f.causal = a.causal;
  f.group = a.group;
  f.scale_log2 = a.scale * kLog2e;
  const int blocks = (a.sq + kFwdBM - 1) / kFwdBM * a.B * a.H;
  flash_fwd_kernel_bf16<D><<<blocks, kFwdThreads, smem, st>>>(mq, mk, mv, f);
  return (int)cudaGetLastError();
}

int run(int dtype, int d, Which which, const Args& a, void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.KV <= 0 || a.H % a.KV != 0 || a.sq <= 0 || a.sk <= 0 ||
      (a.causal && a.sq != a.sk) || (d != 64 && d != 128) || (dtype != 0 && dtype != 1) ||
      (which == kFwd && a.group < 1))
    return (int)cudaErrorInvalidValue;
  const bool f32 = dtype == 0;
  if (!f32 && which == kFwd)
    return d == 64 ? run_fwd_bf16<64>(a, static_cast<cudaStream_t>(stream))
                   : run_fwd_bf16<128>(a, static_cast<cudaStream_t>(stream));
  const Launch l = d == 64 ? (f32 ? pick_f32<64>(which) : pick_bf16<64>(which))
                           : (f32 ? pick_f32<128>(which) : pick_bf16<128>(which));
  // above 48 KB of dynamic shared memory a kernel must opt in
  cudaError_t err = cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  const int qtiles = (a.sq + kTile - 1) / kTile, ktiles = (a.sk + kTile - 1) / kTile;
  const int blocks = which == kDkv ? ktiles * a.B * a.KV : qtiles * a.B * a.H;
  l.kernel<<<blocks, kThreads, l.smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
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
// dtype: 0 = float32, 1 = bfloat16 (all inputs and outputs share it).
// group: the bf16 forward's (batch, head) pairs per group of CTAs (>= 1;
// the wrapper's fwd_group), unused by the f32 forward.
// The caller checks shapes, devices, dtypes and 16-byte alignment of rows
// (the bf16 forward's tensor maps need a 16-byte aligned base and strides
// that are multiples of 16 bytes; it returns cudaErrorInvalidValue when a
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
                                int which, void* stream) {
  if (which != 0 && which != 1) return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, strides, B, H, KV, sq, sk, causal, scale);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dq, a.dk = dk, a.dv = dv;
  return run(dtype, d, which == 0 ? kDq : kDkv, a, stream);
}
