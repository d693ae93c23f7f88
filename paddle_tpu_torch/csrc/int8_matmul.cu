// Weight-only int8 matmul for NVIDIA Hopper (sm_90a): kernel K10 of the port.
//
// out[M, N] = (x[M, K] @ q[K, N]) * s[N] with q int8 in Paddle's [in, out]
// layout (N contiguous), s the f32 per-output-channel scale of
// quantize_for_decode, f32 accumulation, and out in x's dtype (bf16 or f32).
// It replaces no pl.pallas_call: the JAX package writes (x @ convert(q)) * s
// behind an optimization_barrier (paddle_tpu/distributed/fleet/mpu.py:132
// `_int8_matmul`, paddle_tpu/models/llama.py:328 the LM head), and XLA fuses
// the convert into the dot so that the int8 bytes stream through it. PyTorch
// has no such fusion: x @ q.to(bf16) would write a dense bf16 copy of every
// weight and read it back, 5 bytes a weight against the dense model's 2. This
// kernel reads the int8 bytes from HBM once and converts them in registers;
// it never writes a dense copy of q.
//
// The rounding points are the plain version's (ops/hopper/int8_matmul.py
// `int8_matmul_plain`): in bf16 the f32 sum is rounded to bf16, then
// multiplied by s rounded to bf16 and rounded again; in f32, sum * s.
//
// What bounds it on an H100: HBM bytes. A decode step (M = 8 rows) reads
// every weight once and does 2 * M operations a weight byte, far under the
// tensor cores' ~295 operations a byte; prefill chunks (M up to 512) reach the
// same weights from L2 once per 64-row tile.
//
// Design (bf16 activations, `int8_mm_bf16_kernel<MI>`): a CTA of 4 warps owns
// 128 output columns and BM = 16 * MI rows (MI = 1 for M <= 16, else 4), and
// walks K in 64-row stages, 4 stages deep in shared memory, each filled by
// 16-byte cp.async loads of q (coalesced along N, rows padded to 144 bytes)
// and of x. Products run on mma.sync m16n8k16 (bf16 in, f32 out). A warp owns
// 32 columns as four n8 tiles whose columns are interleaved: tile j's column
// c is the warp's column 4c + j. Then a thread's B fragments of all four tiles
// for one k row are one 32-bit word of shared memory (4 adjacent int8), read
// with no bank conflict, and its accumulators of one row cover 8 adjacent
// output columns (one 16-byte store). A byte becomes a float exactly by
// __byte_perm into the mantissa of 2^23 and one subtraction, then a pair of
// floats one bf16x2 register (|q| <= 127 is exact in bf16). Where the output
// tiles do not fill the card (decode), K is split over CTAs: each writes its
// f32 partial sums to a workspace and a second kernel adds them in split
// order and applies the epilogue, so two calls give equal bits.
//
// f32 activations (`int8_mm_f32_kernel`, the f32 parity checks): a plain tiled
// CUDA-core product, 64 x 64 outputs a CTA, 4 x 4 a thread, 16-row K stages
// with q converted to f32 in shared memory, fmaf in K order; the same split
// and reduction.
//
// Contract (checked by the wrapper, which raises): x and out contiguous, q
// contiguous int8 [K, N], s f32 [N]; N % 16 == 0 and K % 8 == 0; every base
// pointer 16-byte aligned. Interface: plain C, loaded with ctypes; returns the
// cudaError_t of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBN = 128;          // output columns a CTA (4 warps x 32)
constexpr int kBK = 64;           // K rows a stage
constexpr int kStages = 4;
constexpr int kQStride = kBN + 16;  // bytes a q row in shared memory
constexpr int kXStride = kBK + 8;   // bf16 elements an x row (144 bytes)
constexpr int kQBytes = kBK * kQStride;

constexpr int kFThreads = 256;
constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

template <int MI>
__host__ __device__ constexpr int stage_bytes() {
  return kQBytes + 16 * MI * kXStride * 2;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// byte J of u (an int8 with its sign bit flipped, i.e. q + 128) as the float q
template <int J>
__device__ __forceinline__ float byte_to_f32(uint32_t u) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | J)) - 8388736.0f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 8 adjacent outputs of one row: the plain version's rounding points
__device__ __forceinline__ void store8_bf16(__nv_bfloat16* dst, const float (&v)[8],
                                            const float* s) {
  const float4 s0 = *reinterpret_cast<const float4*>(s);
  const float4 s1 = *reinterpret_cast<const float4*>(s + 4);
  const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = pack_bf16(round_bf16(v[2 * i]) * round_bf16(sc[2 * i]),
                     round_bf16(v[2 * i + 1]) * round_bf16(sc[2 * i + 1]));
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store8_f32(float* dst, const float (&v)[8], const float* s) {
  const float4 s0 = *reinterpret_cast<const float4*>(s);
  const float4 s1 = *reinterpret_cast<const float4*>(s + 4);
  *reinterpret_cast<float4*>(dst) = make_float4(v[0] * s0.x, v[1] * s0.y, v[2] * s0.z, v[3] * s0.w);
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(v[4] * s1.x, v[5] * s1.y, v[6] * s1.z, v[7] * s1.w);
}

__device__ __forceinline__ void store8_partial(float* dst, const float (&v)[8]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// grid (ceil(N / 128), ceil(M / BM), splits); split z takes the K stages
// [z * per, min((z + 1) * per, ceil(K / 64))). ws == nullptr: one split,
// the epilogue writes out; else f32 partials into ws[z][M][N].
template <int MI>
__global__ void __launch_bounds__(kThreads)
    int8_mm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                        const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
                        float* __restrict__ ws, int M, int N, int K, int per) {
  constexpr int BM = 16 * MI;
  constexpr int kStage = stage_bytes<MI>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem = smem_raw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM, split = blockIdx.z;
  const int chunks = (K + kBK - 1) / kBK;
  const int c_begin = split * per;
  const int n_chunks = min(chunks, c_begin + per) - c_begin;

  auto load_stage = [&](int slot, int chunk) {
    unsigned char* st = smem + slot * kStage;
    const int k0 = chunk * kBK;
    for (int i = tid; i < kBK * (kBN / 16); i += kThreads) {
      const int r = i / (kBN / 16), c16 = i % (kBN / 16);
      const int k = k0 + r, n = n0 + c16 * 16;
      const bool ok = k < K && n < N;
      cp_async16(st + r * kQStride + c16 * 16, ok ? q + (size_t)k * N + n : q, ok);
    }
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + kQBytes);
    for (int i = tid; i < BM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c8 = i % (kBK / 8);
      const int m = m0 + r, k = k0 + c8 * 8;
      const bool ok = m < M && k < K;
      cp_async16(xs + r * kXStride + c8 * 8, ok ? x + (size_t)m * K + k : x, ok);
    }
  };

  float acc[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_chunks) load_stage(st, c_begin + st);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = c + kStages - 1;
    if (next < n_chunks) load_stage(next % kStages, c_begin + next);
    cp_async_commit();
    const unsigned char* st = smem + (c % kStages) * kStage;
    const unsigned char* qs = st + warp * 32 + 4 * g;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st + kQBytes);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const unsigned char* qr = qs + (kk * 16 + 2 * t) * kQStride;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(qr) ^ 0x80808080u;
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(qr + kQStride) ^ 0x80808080u;
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(qr + 8 * kQStride) ^ 0x80808080u;
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(qr + 9 * kQStride) ^ 0x80808080u;
      uint32_t b[4][2];
      b[0][0] = pack_bf16(byte_to_f32<0>(w0), byte_to_f32<0>(w1));
      b[0][1] = pack_bf16(byte_to_f32<0>(w8), byte_to_f32<0>(w9));
      b[1][0] = pack_bf16(byte_to_f32<1>(w0), byte_to_f32<1>(w1));
      b[1][1] = pack_bf16(byte_to_f32<1>(w8), byte_to_f32<1>(w9));
      b[2][0] = pack_bf16(byte_to_f32<2>(w0), byte_to_f32<2>(w1));
      b[2][1] = pack_bf16(byte_to_f32<2>(w8), byte_to_f32<2>(w9));
      b[3][0] = pack_bf16(byte_to_f32<3>(w0), byte_to_f32<3>(w1));
      b[3][1] = pack_bf16(byte_to_f32<3>(w8), byte_to_f32<3>(w9));
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const __nv_bfloat16* xr = xs + (mi * 16 + g) * kXStride + kk * 16 + 2 * t;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(xr);
        a[1] = *reinterpret_cast<const uint32_t*>(xr + 8 * kXStride);
        a[2] = *reinterpret_cast<const uint32_t*>(xr + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(xr + 8 * kXStride + 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mi][j], a, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  // tile j's fragment columns 2t and 2t + 1 are the warp's columns 8t + j
  // and 8t + 4 + j: a thread's values of one row are 8 adjacent columns
  const int nc = n0 + warp * 32 + 8 * t;
  if (nc >= N) return;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + mi * 16 + g + 8 * h;
      if (m >= M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[mi][j][2 * h];
        v[4 + j] = acc[mi][j][2 * h + 1];
      }
      if (ws != nullptr)
        store8_partial(ws + ((size_t)split * M + m) * N + nc, v);
      else
        store8_bf16(out + (size_t)m * N + nc, v, s + nc);
    }
}

// grid (ceil(N / 64), ceil(M / 64), splits), 256 threads of 4 x 4 outputs
__global__ void __launch_bounds__(kFThreads)
    int8_mm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ s, float* __restrict__ out,
                       float* __restrict__ ws, int M, int N, int K, int per) {
  __shared__ float xs[kFBK][kFBM + 4];
  __shared__ float qs[kFBK][kFBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kFBN, m0 = blockIdx.y * kFBM, split = blockIdx.z;
  const int chunks = (K + kFBK - 1) / kFBK;
  const int c_begin = split * per;
  const int c_end = min(chunks, c_begin + per);
  float acc[4][4] = {};
  for (int c = c_begin; c < c_end; ++c) {
    const int k0 = c * kFBK;
#pragma unroll
    for (int r = 0; r < kFBM * kFBK / kFThreads; ++r) {
      const int i = tid + r * kFThreads;
      const int m = i / kFBK, kk = i % kFBK;
      const bool ok = m0 + m < M && k0 + kk < K;
      xs[kk][m] = ok ? x[(size_t)(m0 + m) * K + k0 + kk] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kFBK * kFBN / kFThreads; ++r) {
      const int i = tid + r * kFThreads;
      const int kk = i / kFBN, n = i % kFBN;
      const bool ok = k0 + kk < K && n0 + n < N;
      qs[kk][n] = ok ? static_cast<float>(q[(size_t)(k0 + kk) * N + n0 + n]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = qs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  const int n = n0 + tx * 4;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (ws != nullptr) {
      *reinterpret_cast<float4*>(ws + ((size_t)split * M + m) * N + n) = v;
    } else {
      const float4 sc = *reinterpret_cast<const float4*>(s + n);
      v = make_float4(v.x * sc.x, v.y * sc.y, v.z * sc.z, v.w * sc.w);
      *reinterpret_cast<float4*>(out + (size_t)m * N + n) = v;
    }
  }
}

// the partial sums of every split added in split order, then the epilogue;
// a thread takes 8 adjacent outputs of one row
__global__ void int8_mm_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ s,
                                      void* __restrict__ out, int M, int N, int splits,
                                      int bf16) {
  const int per_row = N / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)M * per_row) return;
  const int m = (int)(idx / per_row), nc = (int)(idx % per_row) * 8;
  float v[8] = {};
  for (int z = 0; z < splits; ++z) {
    const float* p = ws + ((size_t)z * M + m) * N + nc;
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] += a.x;
    v[1] += a.y;
    v[2] += a.z;
    v[3] += a.w;
    v[4] += b.x;
    v[5] += b.y;
    v[6] += b.z;
    v[7] += b.w;
  }
  if (bf16)
    store8_bf16(static_cast<__nv_bfloat16*>(out) + (size_t)m * N + nc, v, s + nc);
  else
    store8_f32(static_cast<float*>(out) + (size_t)m * N + nc, v, s + nc);
}

template <int MI>
cudaError_t launch_bf16(const void* x, const void* q, const float* s, void* out, float* ws,
                        int M, int N, int K, int splits, int per, cudaStream_t st) {
  constexpr int smem = kStages * stage_bytes<MI>();
  static cudaError_t attr = cudaFuncSetAttribute(
      int8_mm_bf16_kernel<MI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + kBN - 1) / kBN, (M + 16 * MI - 1) / (16 * MI), splits);
  int8_mm_bf16_kernel<MI><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q), s,
      static_cast<__nv_bfloat16*>(out), splits > 1 ? ws : nullptr, M, N, K, per);
  return cudaGetLastError();
}

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

// x [M, K] (dtype 0 f32, 1 bf16), q int8 [K, N], s f32 [N], out [M, N] in
// x's dtype, ws f32 [splits, M, N] (unused when splits == 1). mi: the bf16
// body's row tiles of 16 (1 or 4); per: K stages a split (64 rows each for
// bf16, 16 for f32). The launches go to `device` on `stream`.
extern "C" int int8_matmul_launch(const void* x, const void* q, const void* s, void* out,
                                  void* ws, int M, int N, int K, int dtype, int mi, int splits,
                                  int per, int device, void* stream) {
  if (M < 0 || N < 16 || N % 16 != 0 || K < 8 || K % 8 != 0 || dtype < 0 || dtype > 1 ||
      splits < 1 || per < 1 || (dtype == 1 && mi != 1 && mi != 4))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(s);
  float* w = static_cast<float*>(ws);
  cudaError_t err;
  if (dtype == 1) {
    err = mi == 1 ? launch_bf16<1>(x, q, sc, out, w, M, N, K, splits, per, st)
                  : launch_bf16<4>(x, q, sc, out, w, M, N, K, splits, per, st);
  } else {
    const dim3 grid((N + kFBN - 1) / kFBN, (M + kFBM - 1) / kFBM, splits);
    int8_mm_f32_kernel<<<grid, kFThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q), sc,
        static_cast<float*>(out), splits > 1 ? w : nullptr, M, N, K, per);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long work = (long long)M * (N / 8);
  const int threads = 256;
  int8_mm_reduce_kernel<<<(unsigned)((work + threads - 1) / threads), threads, 0, st>>>(
      w, sc, out, M, N, splits, dtype);
  return (int)cudaGetLastError();
}
