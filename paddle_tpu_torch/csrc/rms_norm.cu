// RMSNorm forward for NVIDIA Hopper (sm_90a): kernel K6 of the port.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/rms_norm.py
// (`rms_norm_pallas` -> `_fwd` -> `_fwd_kernel`): per row of x [rows, h],
// out = x * rsqrt(mean(x^2) + eps) * w in f32, cast once to x's dtype, and
// rstd = rsqrt(mean(x^2) + eps) in f32 [rows, 1] for the backward. x and w
// share one dtype: f32, bf16 or f16. The backward is XLA code in the JAX
// package and plain PyTorch in the port (ops/hopper/rms_norm.py).
//
// What bounds it on an H100: HBM bytes. Each element is read once and
// written once (about 4 bytes each way per element in bf16 against four
// flops), so at the training shape (8192 x 4096 bf16, 17 launches a step)
// the bound is 0.040 ms. At the serving shape (8 x 4096, 65 launches a
// dispatch) the bytes take 0.04 us: the launch on the device and the wrapper
// on the host set the time, so the wrapper makes one ctypes call, this file's
// rms_norm_launch, which makes the one launch.
//
// The design reads each row once:
//  - Registers (h <= kRegWidth = 8192). A row group of G threads owns a row;
//    each thread holds NV packs of V elements, pack i of the row at
//    thread i % G. V is 16 bytes of elements (8 bf16/f16, 4 f32) where the
//    width is a multiple of it and every pointer 16-byte aligned, so every
//    load and store is one 16-byte access; otherwise V = 1 (a width that is
//    not a multiple of the vector leaves rows off 16-byte boundaries). The
//    packs past the row's end are masked. The width picks G: one warp a row
//    while a warp's lanes hold the row in at most 8 packs each (CTAs of 4
//    rows), else one CTA of 256 threads a row (at most 8 packs each), else,
//    for V = 1 only, 1024 threads. w is loaded beside x, before the sum.
//  - Shared memory (kRegWidth < h <= kMaxWidth = 32768). One CTA of 1024
//    threads a row; the row is staged in dynamic shared memory (up to 128 KB
//    in f32) as it is loaded, four packs in flight a thread, and read back
//    for the output. Each thread reads back only the packs it wrote, so the
//    only barrier is the sum's.
// The sum of squares: each thread adds its elements in a fixed order (fmaf),
// then a warp's lanes combine by __shfl_xor_sync, and where a row spans
// several warps their sums pass through shared memory and every thread adds
// them in warp order. The order is fixed, so two calls give equal bits.
// rstd is written by the row's first thread; the output is x * r * w in f32
// in that order (the plain version's), rounded to nearest once.
//
// Interface: plain C, loaded with ctypes. Returns the cudaError_t of the
// launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWidth = 32768;
constexpr int kRegWidth = 8192;
constexpr int kSmemThreads = 1024;
constexpr int kSmemUnroll = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

// V elements moved as one access (16 bytes when V * sizeof(T) == 16)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> zero_pack() {
  Pack<T, V> p;
#pragma unroll
  for (int j = 0; j < V; ++j) p.v[j] = from_f32<T>(0.f);
  return p;
}

template <typename T, int V>
__device__ __forceinline__ float sum_squares(const Pack<T, V>& p, float ss) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float f = to_f32(p.v[j]);
    ss = fmaf(f, f, ss);
  }
  return ss;
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> scale(const Pack<T, V>& x, const Pack<T, V>& w, float r) {
  Pack<T, V> o;
#pragma unroll
  for (int j = 0; j < V; ++j) o.v[j] = from_f32<T>(to_f32(x.v[j]) * r * to_f32(w.v[j]));
  return o;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One row per G threads, the row in registers (NV packs of V a thread).
template <typename T, int V, int G, int NV>
__global__ void __launch_bounds__(G < 128 ? 128 : G)
    rms_norm_fwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
                             T* __restrict__ out, float* __restrict__ rstd, int rows, int h,
                             float eps) {
  constexpr int kThreads = G < 128 ? 128 : G;
  constexpr int kRowsPerCta = kThreads / G;
  constexpr int kWarps = G / 32;  // warps a row
  using P = Pack<T, V>;
  __shared__ float red[kWarps];

  const int t = threadIdx.x % G;
  const long long row = (long long)blockIdx.x * kRowsPerCta + threadIdx.x / G;
  // a row is a whole warp (G == 32) or the whole CTA (G >= 128): the
  // threads that leave leave together
  if (row >= rows) return;
  const int nvec = h / V;
  const P* xr = reinterpret_cast<const P*>(x + row * h);
  const P* wr = reinterpret_cast<const P*>(w);
  P xv[NV], wv[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = k * G + t;
    xv[k] = i < nvec ? xr[i] : zero_pack<T, V>();
    wv[k] = i < nvec ? wr[i] : zero_pack<T, V>();
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) ss = sum_squares(xv[k], ss);
  ss = warp_sum(ss);
  if constexpr (kWarps > 1) {
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = red[0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) ss += red[i];
  }
  const float r = rsqrtf(ss / (float)h + eps);
  if (t == 0) rstd[row] = r;
  P* orow = reinterpret_cast<P*>(out + row * h);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = k * G + t;
    if (i < nvec) orow[i] = scale(xv[k], wv[k], r);
  }
}

// One row per CTA of kSmemThreads, the row staged in shared memory.
template <typename T, int V>
__global__ void __launch_bounds__(kSmemThreads)
    rms_norm_fwd_smem_kernel(const T* __restrict__ x, const T* __restrict__ w,
                             T* __restrict__ out, float* __restrict__ rstd, int h, float eps) {
  using P = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char stage_raw[];
  P* stage = reinterpret_cast<P*>(stage_raw);
  __shared__ float red[kSmemThreads / 32];

  const long long row = blockIdx.x;
  const int nvec = h / V;
  const P* xr = reinterpret_cast<const P*>(x + row * h);
  float ss = 0.f;
  for (int i0 = threadIdx.x; i0 < nvec; i0 += kSmemThreads * kSmemUnroll) {
    P v[kSmemUnroll];
#pragma unroll
    for (int u = 0; u < kSmemUnroll; ++u) {
      const int i = i0 + u * kSmemThreads;
      v[u] = i < nvec ? xr[i] : zero_pack<T, V>();
    }
#pragma unroll
    for (int u = 0; u < kSmemUnroll; ++u) {
      const int i = i0 + u * kSmemThreads;
      if (i < nvec) stage[i] = v[u];
      ss = sum_squares(v[u], ss);
    }
  }
  ss = warp_sum(ss);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = ss;
  __syncthreads();
  ss = red[0];
#pragma unroll
  for (int i = 1; i < kSmemThreads / 32; ++i) ss += red[i];
  const float r = rsqrtf(ss / (float)h + eps);
  if (threadIdx.x == 0) rstd[row] = r;
  const P* wr = reinterpret_cast<const P*>(w);
  P* orow = reinterpret_cast<P*>(out + row * h);
  for (int i = threadIdx.x; i < nvec; i += kSmemThreads) orow[i] = scale(stage[i], wr[i], r);
}

template <typename T, int V, int G, int NV>
void launch_rows(const T* x, const T* w, T* out, float* rstd, int rows, int h, float eps,
                 cudaStream_t st) {
  constexpr int kThreads = G < 128 ? 128 : G;
  constexpr int kRowsPerCta = kThreads / G;
  const int ctas = (rows + kRowsPerCta - 1) / kRowsPerCta;
  rms_norm_fwd_rows_kernel<T, V, G, NV><<<ctas, kThreads, 0, st>>>(x, w, out, rstd, rows, h, eps);
}

// The work unit by width: one warp a row up to 8 packs a lane, else one
// CTA of 256 threads up to 8 packs a thread, else 1024 threads (V = 1).
template <typename T, int V>
void launch_regs(const T* x, const T* w, T* out, float* rstd, int rows, int h, float eps,
                 cudaStream_t st) {
  const int nvec = h / V;
  if (nvec <= 32)
    launch_rows<T, V, 32, 1>(x, w, out, rstd, rows, h, eps, st);
  else if (nvec <= 64)
    launch_rows<T, V, 32, 2>(x, w, out, rstd, rows, h, eps, st);
  else if (nvec <= 128)
    launch_rows<T, V, 32, 4>(x, w, out, rstd, rows, h, eps, st);
  else if (nvec <= 256)
    launch_rows<T, V, 32, 8>(x, w, out, rstd, rows, h, eps, st);
  else if (nvec <= 512)
    launch_rows<T, V, 256, 2>(x, w, out, rstd, rows, h, eps, st);
  else if (nvec <= 1024)
    launch_rows<T, V, 256, 4>(x, w, out, rstd, rows, h, eps, st);
  else if (nvec <= 2048)
    launch_rows<T, V, 256, 8>(x, w, out, rstd, rows, h, eps, st);
  else if constexpr (V == 1) {  // h <= kRegWidth: nvec <= 8192 only here
    if (nvec <= 4096)
      launch_rows<T, V, 1024, 4>(x, w, out, rstd, rows, h, eps, st);
    else
      launch_rows<T, V, 1024, 8>(x, w, out, rstd, rows, h, eps, st);
  }
}

template <typename T, int V>
cudaError_t launch_smem(const T* x, const T* w, T* out, float* rstd, int rows, int h, float eps,
                        cudaStream_t st) {
  const int bytes = h * (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(rms_norm_fwd_smem_kernel<T, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  rms_norm_fwd_smem_kernel<T, V><<<rows, kSmemThreads, bytes, st>>>(x, w, out, rstd, h, eps);
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, float* rstd, int rows, int h,
                   float eps, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  const bool vec = h % kVec == 0 && aligned16(x) && aligned16(w) && aligned16(out);
  if (h > kRegWidth) {
    return vec ? launch_smem<T, kVec>(xt, wt, ot, rstd, rows, h, eps, st)
               : launch_smem<T, 1>(xt, wt, ot, rstd, rows, h, eps, st);
  }
  if (vec)
    launch_regs<T, kVec>(xt, wt, ot, rstd, rows, h, eps, st);
  else
    launch_regs<T, 1>(xt, wt, ot, rstd, rows, h, eps, st);
  return cudaSuccess;
}

// Makes `device` current for its scope, then restores the caller's.
struct CurrentDevice {
  int prev = -1;
  cudaError_t err;
  explicit CurrentDevice(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    else prev = -1;
  }
  ~CurrentDevice() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

// x [rows, h] and out [rows, h] contiguous, w [h], rstd f32 [rows];
// dtype 0 f32, 1 bf16, 2 f16 (x, w and out alike); the launch goes to
// `device` (made current for the call, then restored) on `stream`.
extern "C" int rms_norm_launch(const void* x, const void* w, void* out, void* rstd, int rows,
                               int h, int dtype, float eps, int device, void* stream) {
  if (rows < 0 || h < 1 || h > kMaxWidth || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch<float>(x, w, out, r, rows, h, eps, st);
      break;
    case 1:
      err = launch<__nv_bfloat16>(x, w, out, r, rows, h, eps, st);
      break;
    default:
      err = launch<__half>(x, w, out, r, rows, h, eps, st);
      break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
