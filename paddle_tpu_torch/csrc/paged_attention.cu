// Ragged paged attention for NVIDIA Hopper (sm_90a): kernel K5 of the port.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// (`paged_attend_pallas` -> `_kernel`). One launch serves a ragged batch:
// row b's chunk of s queries starts at absolute position positions[b], and
// query row r sees pool columns col <= positions[b] + r. K/V are read straight
// out of the [num_blocks, block_size, kv, d] pool through the row's block table;
// no contiguous copy of a sequence's context is ever made. GQA stays packed:
// the g = h / kv query heads of one KV head share every K/V load.
//
// Grid: one CTA per (q tile, kv head, batch row). A q tile holds up to
// kMaxQ / g rows, so a CTA owns at most kMaxQ query vectors. The CTA reads its
// own positions[b] and streams the row's K/V in chunks of kKeys columns only up
// to the tile's causal horizon min(pos + r0 + rows, max_blocks * bs) -- the
// same page set as the TPU kernel's nb = (pos + q_end - 1) // bs + 1. The
// tile masks its own ragged edge (s need not divide by the tile).
//
// Per chunk: the chunk's K and V rows for head kh are gathered through the
// block table into shared memory as f32; scores q.k are summed in f32;
// columns past each row's diagonal are masked to -1e30; an online softmax
// (running max m, running sum l) rescales the f32 accumulator; the output is
// acc / max(l, 1e-30), written as f32 [B, s, kv, g, d] (= [B, s, h, d]).
// Idle decode slots read scratch block 0 at position 0: column 0 is always
// visible, so l > 0 and the output stays finite.
//
// What bounds it on an H100: decode (s = 1) reads every resident K/V byte of
// every row once and does 4 flops per byte or so -- far below the ~295
// flops/byte the card needs to be compute-bound -- so it is bound by HBM bytes,
// the resident K/V pages. This version streams them with plain coalesced loads
// through shared memory and computes on the CUDA cores in f32; it does not use
// wgmma or TMA. At the engine's 8 decode slots the grid is 8 x kv CTAs (256 for
// Llama-2-7B, 64 for a GQA model with kv = 8), and a deep row is streamed by
// one CTA from start to end; splitting a row's pages across CTAs and merging
// the partial softmaxes by their log-sum-exp is the next step for long decode.
//
// Interface: plain C, loaded with ctypes. Returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 64;   // query vectors (rows x group heads) per CTA
constexpr int kKeys = 32;   // columns per streamed chunk: one per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <int D>
constexpr size_t smem_floats() {
  // sQ + sAcc [kMaxQ][D], sK [kKeys][D + 1], sV [kKeys][D],
  // sP [kMaxQ][kKeys], sM/sL/sAlpha [kMaxQ]
  return 2 * kMaxQ * D + kKeys * (D + 1) + kKeys * D + kMaxQ * kKeys + 3 * kMaxQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attend_kernel(const T* __restrict__ q, const T* __restrict__ kbuf,
                    const T* __restrict__ vbuf, const int* __restrict__ tables,
                    const int* __restrict__ positions, float* __restrict__ out,
                    int s, int kv, int g, int bs, int max_blocks, int q_rows,
                    float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;                    // queries, pre-scaled
  float* sAcc = sQ + kMaxQ * D;        // output accumulators
  float* sK = sAcc + kMaxQ * D;        // padded rows: conflict-free column reads
  float* sV = sK + kKeys * (D + 1);
  float* sP = sV + kKeys * D;          // scores, then probabilities
  float* sM = sP + kMaxQ * kKeys;      // running max per query
  float* sL = sM + kMaxQ;              // running sum per query
  float* sAlpha = sL + kMaxQ;          // this chunk's rescale per query

  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * q_rows;
  const int rows = min(q_rows, s - r0);
  const int nq = rows * g;
  const int h = kv * g;
  const int pos = positions[b];
  const int ncols = min(pos + r0 + rows, max_blocks * bs);

  for (int i = tid; i < nq * D; i += kThreads) {
    const int qi = i / D, dd = i % D;
    const int r = qi / g, t = qi % g;
    const size_t src = (((size_t)b * s + r0 + r) * h + (size_t)kh * g + t) * D + dd;
    sQ[i] = to_f32(q[src]) * scale;
    sAcc[i] = 0.f;
  }
  for (int i = tid; i < nq; i += kThreads) {
    sM[i] = kNegInf;
    sL[i] = 0.f;
  }

  const size_t page_elems = (size_t)bs * kv * D;
  for (int c0 = 0; c0 < ncols; c0 += kKeys) {
    const int nk = min(kKeys, ncols - c0);
    __syncthreads();  // the previous chunk's readers of sK/sV/sP are done
    for (int i = tid; i < nk * D; i += kThreads) {
      const int kk = i / D, dd = i % D;
      const int col = c0 + kk;
      const int blk = tables[(size_t)b * max_blocks + col / bs];
      const size_t src = (size_t)blk * page_elems + ((size_t)(col % bs) * kv + kh) * D + dd;
      sK[kk * (D + 1) + dd] = to_f32(kbuf[src]);
      sV[kk * D + dd] = to_f32(vbuf[src]);
    }
    __syncthreads();
    // scores: neighbouring threads take neighbouring keys of one query
    for (int i = tid; i < nq * kKeys; i += kThreads) {
      const int qi = i / kKeys, kk = i % kKeys;
      const int row = pos + r0 + qi / g;
      float sc = kNegInf;
      if (kk < nk && c0 + kk <= row) {
        const float* qr = sQ + qi * D;
        const float* kr = sK + kk * (D + 1);
        float acc = 0.f;
#pragma unroll 16
        for (int dd = 0; dd < D; ++dd) acc = fmaf(qr[dd], kr[dd], acc);
        sc = acc;
      }
      sP[i] = sc;
    }
    __syncthreads();
    // online softmax: one warp per query, one lane per key of the chunk
    for (int qi = warp; qi < nq; qi += kThreads / 32) {
      const float sc = sP[qi * kKeys + lane];
      float mx = sc;
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sM[qi];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(sc - m_new);
      float sum = p;
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sP[qi * kKeys + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sAlpha[qi] = alpha;
        sL[qi] = sL[qi] * alpha + sum;
        sM[qi] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < nq * D; i += kThreads) {
      const int qi = i / D, dd = i % D;
      const float* pr = sP + qi * kKeys;
      float acc = sAcc[i] * sAlpha[qi];
      for (int kk = 0; kk < nk; ++kk) acc = fmaf(pr[kk], sV[kk * D + dd], acc);
      sAcc[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < nq * D; i += kThreads) {
    const int qi = i / D, dd = i % D;
    const int r = qi / g, t = qi % g;
    const size_t dst = (((size_t)b * s + r0 + r) * h + (size_t)kh * g + t) * D + dd;
    out[dst] = sAcc[i] / fmaxf(sL[qi], 1e-30f);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kbuf, const void* vbuf, const int* tables,
                   const int* positions, float* out, int B, int s, int h, int kv, int bs,
                   int max_blocks, float scale, cudaStream_t stream) {
  const int g = h / kv;
  const int q_rows = kMaxQ / g;
  const size_t smem = smem_floats<D>() * sizeof(float);
  // above 48 KB of dynamic shared memory a kernel must opt in, per device
  cudaError_t err = cudaFuncSetAttribute(paged_attend_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + q_rows - 1) / q_rows, kv, B);
  paged_attend_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kbuf), static_cast<const T*>(vbuf),
      tables, positions, out, s, kv, g, bs, max_blocks, q_rows, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* kbuf, const void* vbuf,
                       const int* tables, const int* positions, float* out, int B, int s,
                       int h, int kv, int bs, int max_blocks, float scale,
                       cudaStream_t stream) {
  if (d == 64)
    return launch<T, 64>(q, kbuf, vbuf, tables, positions, out, B, s, h, kv, bs, max_blocks,
                         scale, stream);
  if (d == 128)
    return launch<T, 128>(q, kbuf, vbuf, tables, positions, out, B, s, h, kv, bs,
                          max_blocks, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q and the pool share it).
// The caller checks shapes: h % kv == 0, h / kv <= 64, d in {64, 128}, all
// tensors contiguous on the current device.
extern "C" int paged_attend_launch(const void* q, const void* kbuf, const void* vbuf,
                                   const void* tables, const void* positions, void* out,
                                   int B, int s, int h, int kv, int d, int bs,
                                   int max_blocks, int dtype, float scale, void* stream) {
  if (B <= 0 || s <= 0 || kv <= 0 || h % kv != 0 || h / kv > kMaxQ || bs <= 0 ||
      max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const int* tab = static_cast<const int*>(tables);
  const int* pos = static_cast<const int*>(positions);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_d<float>(d, q, kbuf, vbuf, tab, pos, o, B, s, h, kv, bs,
                                    max_blocks, scale, st);
    case 1:
      return (int)dispatch_d<__nv_bfloat16>(d, q, kbuf, vbuf, tab, pos, o, B, s, h, kv, bs,
                                            max_blocks, scale, st);
    case 2:
      return (int)dispatch_d<__half>(d, q, kbuf, vbuf, tab, pos, o, B, s, h, kv, bs,
                                     max_blocks, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
