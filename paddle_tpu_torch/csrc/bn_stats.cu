// BatchNorm statistics for NVIDIA Hopper (sm_90a): kernel K9 of the port.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/bn_stats.py
// (`bn_stats` -> `_stats_fwd_impl` -> `_kernel`): per channel of a
// channel-last activation x [rows, c] (bf16 or f16, c % 128 == 0),
// mean = sum(x) / rows and E[x^2] = sum(x^2) / rows, accumulated in f32.
// The backward is a closed form left to XLA in the JAX package and plain
// PyTorch in the port (ops/hopper/bn_stats.py).
//
// What bounds it on an H100: HBM bytes. Each element is read once for two
// f32 adds (rows * c * 2 bytes over 3.35 TB/s: 0.123 ms at 802,816 x 256,
// 0.015 ms at 12,544 x 2048).
//
// The TPU kernel carries its sums through a sequential grid in VMEM. Here the
// CTAs run in parallel, so the sums go through per-CTA partials and a second
// kernel, both launched by one call of bn_stats_launch:
//  - bn_stats_partial_kernel: a grid of (parts, strips) CTAs of kThreads.
//    CTA (p, s) owns the channel strip s (S = 256 channels where c allows,
//    else 128) and the contiguous rows [p * rows_per_part, min(rows,
//    (p + 1) * rows_per_part)). A thread owns 8 channels (one 16-byte load),
//    L = S / 8 threads cover a row of the strip, so a CTA has R = kThreads / L
//    row slots; slot j walks the rows j, j + R, j + 2R, ... of the range with
//    kUnroll loads in flight, adding into 8 f32 sums of x and 8 of x^2. The
//    rows past the range's end are masked (a load of zero). The slots then
//    combine in shared memory in slot order, into one partial [2, S] per CTA.
//    rows_per_part is a whole number of row groups (R * kUnroll rows, one
//    step of every slot) and the grid about kCtasPerSm CTAs on each SM, all
//    resident at once (the launch bound caps the registers to fit).
//  - bn_stats_final_kernel: c / 32 CTAs of kFinalWarps warps; a lane owns a
//    channel, warp w adds the partials w, w + kFinalWarps, ... in order, the
//    warps combine in shared memory in warp order, and the sums are scaled by
//    1 / rows.
// No atomics, and every sum has a fixed order: two calls give equal bits.
// Offsets are 64-bit. bn_stats_plan in ops/hopper/bn_stats.py mirrors
// make_plan, and bn_stats_tiles_reference models the summation order.
//
// Interface: plain C, loaded with ctypes. Returns the cudaError_t of the
// launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kCtasPerSm = 4;
constexpr int kFinalWarps = 32;

struct Plan {
  int strip;                    // channels a CTA owns: 256, or 128
  int slots;                    // rows a CTA loads at once (R)
  int group;                    // rows of one step of every slot
  int strips;                   // c / strip
  long long rows_per_part;      // a whole number of groups
  int parts;                    // CTAs along the rows
};

Plan make_plan(long long rows, int c, int sms) {
  Plan p;
  p.strip = c % 256 == 0 ? 256 : 128;
  p.slots = kThreads / (p.strip / 8);
  p.group = p.slots * kUnroll;
  p.strips = c / p.strip;
  long long target = (long long)sms * kCtasPerSm / p.strips;
  if (target < 1) target = 1;
  const long long per = (rows + target - 1) / target;
  p.rows_per_part = (per + p.group - 1) / p.group * p.group;
  p.parts = (int)((rows + p.rows_per_part - 1) / p.rows_per_part);
  return p;
}

__device__ __forceinline__ float2 to_f32x2(uint32_t v, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ float2 to_f32x2(uint32_t v, __half) {
  return __half22float2(*reinterpret_cast<const __half2*>(&v));
}

template <typename T>
__device__ __forceinline__ void add8(const uint4& v, float* s1, float* s2) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = to_f32x2(w[i], T());
    s1[2 * i] += f.x;
    s2[2 * i] = fmaf(f.x, f.x, s2[2 * i]);
    s1[2 * i + 1] += f.y;
    s2[2 * i + 1] = fmaf(f.y, f.y, s2[2 * i + 1]);
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    bn_stats_partial_kernel(const T* __restrict__ x, float* __restrict__ part, long long rows,
                            int c, long long rows_per_part) {
  constexpr int L = S / 8;          // threads a row of the strip
  constexpr int R = kThreads / L;   // row slots
  __shared__ __align__(16) float red[2][R][S];

  const int lc = threadIdx.x % L;
  const int slot = threadIdx.x / L;
  const int col = blockIdx.y * S + lc * 8;
  const long long r0 = (long long)blockIdx.x * rows_per_part;
  const long long r1 = min(rows, r0 + rows_per_part);
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
  for (long long r = r0 + slot; r < r1; r += (long long)R * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = r + (long long)u * R;
      v[u] = rr < r1 ? __ldg(reinterpret_cast<const uint4*>(x + rr * c + col))
                     : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add8<T>(v[u], s1, s2);
  }
  float4* m1 = reinterpret_cast<float4*>(&red[0][slot][lc * 8]);
  float4* m2 = reinterpret_cast<float4*>(&red[1][slot][lc * 8]);
  m1[0] = make_float4(s1[0], s1[1], s1[2], s1[3]);
  m1[1] = make_float4(s1[4], s1[5], s1[6], s1[7]);
  m2[0] = make_float4(s2[0], s2[1], s2[2], s2[3]);
  m2[1] = make_float4(s2[4], s2[5], s2[6], s2[7]);
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * S; o += kThreads) {
    const int m = o / S, ch = o % S;
    float acc = red[m][0][ch];
#pragma unroll
    for (int j = 1; j < R; ++j) acc += red[m][j][ch];
    part[((long long)blockIdx.x * 2 + m) * c + blockIdx.y * S + ch] = acc;
  }
}

__global__ void __launch_bounds__(kFinalWarps * 32)
    bn_stats_final_kernel(const float* __restrict__ part, float* __restrict__ mean,
                          float* __restrict__ m2, int parts, int c, float inv_rows) {
  __shared__ float red[2][kFinalWarps][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ch = blockIdx.x * 32 + lane;
  float a = 0.f, b = 0.f;
#pragma unroll 4
  for (int p = warp; p < parts; p += kFinalWarps) {
    a += part[(long long)p * 2 * c + ch];
    b += part[((long long)p * 2 + 1) * c + ch];
  }
  red[0][warp][lane] = a;
  red[1][warp][lane] = b;
  __syncthreads();
  if (threadIdx.x < 64) {
    const int m = threadIdx.x / 32;
    float acc = red[m][0][lane];
#pragma unroll
    for (int w = 1; w < kFinalWarps; ++w) acc += red[m][w][lane];
    (m ? m2 : mean)[ch] = acc * inv_rows;
  }
}

template <typename T>
void launch_partial(const Plan& p, const void* x, float* part, long long rows, int c,
                    cudaStream_t st) {
  const dim3 grid(p.parts, p.strips);
  const T* xt = static_cast<const T*>(x);
  if (p.strip == 256)
    bn_stats_partial_kernel<T, 256><<<grid, kThreads, 0, st>>>(xt, part, rows, c,
                                                               p.rows_per_part);
  else
    bn_stats_partial_kernel<T, 128><<<grid, kThreads, 0, st>>>(xt, part, rows, c,
                                                               p.rows_per_part);
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

// x [rows, c] contiguous and 16-byte aligned (dtype 1 bf16, 2 f16), part
// f32 [parts, 2, c] with parts from bn_stats_plan, mean and m2 f32 [c]; the
// launches go to `device` (made current for the call, then restored) on
// `stream`.
extern "C" int bn_stats_launch(const void* x, void* part, void* mean, void* m2,
                               long long rows, int c, int dtype, int sms, int device,
                               void* stream) {
  if (rows < 1 || c < 128 || c % 128 != 0 || c / 128 > 65535 || sms < 1 ||
      (dtype != 1 && dtype != 2) || (reinterpret_cast<uintptr_t>(x) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const Plan p = make_plan(rows, c, sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  if (dtype == 1)
    launch_partial<__nv_bfloat16>(p, x, pt, rows, c, st);
  else
    launch_partial<__half>(p, x, pt, rows, c, st);
  bn_stats_final_kernel<<<c / 32, kFinalWarps * 32, 0, st>>>(
      pt, static_cast<float*>(mean), static_cast<float*>(m2), p.parts, c,
      (float)(1.0 / (double)rows));
  return (int)cudaGetLastError();
}
