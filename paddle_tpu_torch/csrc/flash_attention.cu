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
// alignment agree; ragged lengths (not a multiple of the 64-row tile) are
// masked here.
//
// Work split: a CTA of 4 warps owns one 64-row tile; each warp owns 16 rows of
// it and everything computed along those rows, so warps meet only where the
// CTA stages a shared tile into shared memory (bf16: the streamed tiles are
// double-buffered with cp.async, the next one copying in while the current
// one is used):
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
// Products: bfloat16 goes through the tensor cores with mma.sync m16n8k16
// (bf16 operands from shared memory through ldmatrix, f32 accumulators in
// registers); the score tile S, P and dS stay in registers, where the C
// fragments of one product are the A fragments of the next. P and dS are
// rounded to bf16 before their products, as the Pallas kernels cast them to
// the input dtype. float32 runs on the CUDA cores in f32 FMA with register
// tiles (no TF32), with S and P staged through shared memory. Softmax and all
// elementwise math are f32.
//
// What bounds it on an H100: at Llama training shapes (B=2, H=32, D=128,
// s=4096, causal) the forward does 4 B H s^2 D / 2 = 0.27 TFLOP against 0.27 GB
// of q/k/v/out, about 10^3 operations per byte, so it is bound by operations:
// 0.28 ms at the 989 TFLOP/s bf16 peak; the dq kernel does 1.5 times the
// forward's products, the dkv kernel 2 times. The design keeps S and P out of
// device memory and feeds the tensor cores from shared memory. It is still a
// simple form: 64-row tiles of 4 warps, cp.async instead of TMA, mma.sync
// instead of wgmma; those are the steps to the bound.
//
// Interface: plain C, loaded with ctypes. Each launcher returns the
// cudaError_t of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel_bf16(Args a) {
  constexpr int P = D + kPitchBf16Pad;
  constexpr size_t kT = bf16_tile_bytes<D>();
  extern __shared__ __align__(128) char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  // K and V double-buffered: tile i + 1 copies in while tile i is used
  bf16* sK[2] = {reinterpret_cast<bf16*>(smem + kT), reinterpret_cast<bf16*>(smem + 2 * kT)};
  bf16* sV[2] = {reinterpret_cast<bf16*>(smem + 3 * kT), reinterpret_cast<bf16*>(smem + 4 * kT)};

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = (a.sq + kTile - 1) / kTile;
  const int bh = blockIdx.x % (a.B * a.H);
  const int q0 = (ntiles - 1 - blockIdx.x / (a.B * a.H)) * kTile;  // heaviest first
  const int hq = bh % a.H, b = bh / a.H;
  const int kh = hq / (a.H / a.KV);

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs[0] + hq * a.qs[2];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks[0] + kh * a.ks[2];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs[0] + kh * a.vs[2];
  load_tile<bf16, D, P>(sQ, qb + q0 * a.qs[1], a.qs[1], min(kTile, a.sq - q0));
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) load_a<P>(qf[kc], sQ, warp * 16, kc * 16);

  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's columns
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
    __syncthreads();
    const bf16* tK = sK[it & 1];
    const bf16* tV = sV[it & 1];
    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int n = 0; n < kTile / 8; n += 2) {
        uint32_t bf[4];
        load_b<P>(bf, tK, n * 8, kc * 16);
        mma_bf16(s[n], qf[kc], bf[0], bf[1]);
        mma_bf16(s[n + 1], qf[kc], bf[2], bf[3]);
      }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1), row = rows[e >> 1];
        const bool valid = col < a.sk && (!a.causal || col <= row);
        s[n][e] = valid ? s[n][e] * a.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = expf(m[h] - mn);
      m[h] = mn;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[n][e] == kNegInf ? 0.f : expf(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0], o[n][1] *= alpha[0];
      o[n][2] *= alpha[1], o[n][3] *= alpha[1];
    }
    mma_pv<P, kTile / 16, D / 8>(o, s, tV, 0);
    __syncthreads();  // every warp is done with buffer it & 1 before it refills
  }

  bf16* ob = static_cast<bf16*>(a.out) + ((size_t)b * a.sq * a.H + hq) * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lsafe = fmaxf(quad_sum(l[h]), 1e-30f);
    if (rows[h] >= a.sq) continue;
    bf16* orow = ob + (size_t)rows[h] * a.H * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_bf16(o[n][2 * h] / lsafe, o[n][2 * h + 1] / lsafe);
    if (t == 0) a.lse_out[((size_t)b * a.H + hq) * a.sq + rows[h]] = m[h] + logf(lsafe);
  }
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

template <int D>
Launch pick_bf16(Which which) {
  constexpr size_t kT = bf16_tile_bytes<D>();
  if (which == kFwd) return {flash_fwd_kernel_bf16<D>, 5 * kT};
  if (which == kDq) return {flash_dq_kernel_bf16<D>, 6 * kT};
  return {flash_dkv_kernel_bf16<D>, 6 * kT};
}

int run(int dtype, int d, Which which, const Args& a, void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.KV <= 0 || a.H % a.KV != 0 || a.sq <= 0 || a.sk <= 0 ||
      (a.causal && a.sq != a.sk) || (d != 64 && d != 128) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool f32 = dtype == 0;
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
// The caller checks shapes, devices, dtypes and 16-byte alignment of rows.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                void* lse, const long long* strides, int B, int H, int KV,
                                int sq, int sk, int d, int dtype, int causal, float scale,
                                void* stream) {
  Args a = make_args(q, k, v, strides, B, H, KV, sq, sk, causal, scale);
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
