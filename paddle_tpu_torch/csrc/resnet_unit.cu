// Fused 1x1 convolution + BatchNorm kernels for NVIDIA Hopper (sm_90a): kernel
// K7 of the port.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/resnet_unit.py:
//   K7 forward  `_fwd_impl` -> `_fwd_kernel`        (resnet_unit_fwd)
//   K7 backward `_bwd_impl` -> `_bwd_kernel`        (resnet_unit_bwd)
// K8, the 3x3 conv (`_conv3_fwd_impl`, `_conv3_bwd_impl`), has its own source,
// conv3x3_bn.cu, built around bands of whole image rows in shared memory.
//
// Function (rows of NHWC, bf16 activations and weights, f32 accumulation):
//   forward   xn = relu(x * a + b) rounded to bf16 (the optional prologue: the
//             previous BatchNorm's f32 scale/shift), y = xn w, and the
//             BatchNorm statistics s1 = sum_rows(y), s2 = sum_rows(y^2) taken
//             from the f32 accumulator before y is rounded to bf16.
//   backward  dyc = bf16(dy + gs1 + 2 y gs2) (the statistics' cotangent
//             folded into dy, y recomputed), dw = xn^T dyc (f32), dxn = dyc w^T,
//             and with the prologue du = dxn [u > 0], dx = bf16(du a),
//             da = sum(du x), db = sum(du).
//
// Work split. The TPU kernels run their grid in order and carry s1/s2, dw, da
// and db in VMEM from one grid step to the next. Hopper's CTAs run in parallel
// and in no order, so every cross-CTA sum here is a partial per CTA followed by
// a second, deterministic pass (col_reduce_kernel: fixed order, no atomics):
//   gemm_rows_kernel  C[M, N] = A[M, Ca] B[Ca, N], a 128 x BN tile per CTA
//                     (BN = 128, or 64 for 64 channels), 8 warps of 32 x
//                     BN/2; A is x (forward, with the prologue applied in
//                     shared memory after the copy lands) or dyc (dx).
//                     Epilogues: y + s1/s2 partials;
//                     dyc; dx + da/db partials; each stages its output tile (and the
//                     dy or x tile it reads) in shared memory, so device
//                     memory sees whole 16-byte row pieces.
//   gemm_dw_kernel    dw partials: a BM x BN tile of [cin, cout] per CTA, one
//                     chunk of rows (split-K over M), A = xn^T from
//                     rows of x through the transposing ldmatrix.
//   col_reduce_kernel out[c] = sum_t part[t][c] in a fixed order.
// K7 backward is dyc (GEMM recomputing y), dx, dw and two reductions.
//
// Products go through the tensor cores with mma.sync m16n8k16 (bf16 operands
// from shared memory through ldmatrix, f32 accumulators in registers); tiles of
// 32 rows (K) stream through a four-stage cp.async pipeline (three tiles in
// flight ahead of the one in use, one barrier a tile), and cp.async zero-fills
// rows that lie past M.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at ResNet-50's
// shapes (batch 256, 224^2) the 1x1 convs of stage 1 do cin cout / (cin + cout)
// = 32-51 operations per byte and are bound by bytes; stage 4's 1x1 (2048 ->
// 512, 12,544 rows) does ~1,150 and is bound by operations (the card's
// balance point is ~295). The design reads each activation once per GEMM and keeps xn,
// y (K7 backward) and the statistics out of device memory. It is the simple
// form: mma.sync instead of wgmma, cp.async instead of TMA; those are the
// steps toward the bound.
//
// Interface: plain C, loaded with ctypes. The caller allocates every output
// and scratch buffer and checks shapes, dtypes, devices, contiguity and 16-byte
// alignment. Each launcher returns the first cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;       // rows of a gemm_rows_kernel tile
constexpr int kBK = 32;        // depth of one pipeline stage
constexpr int kPad = 8;        // keeps smem rows 16-byte aligned, ldmatrix conflict-free
constexpr int kStages = 4;     // cp.async pipeline depth (tiles in flight)

enum Epi { kEpiY = 0, kEpiDyc = 1, kEpiDx = 2 };

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

// 16 bytes from global to shared memory; `ok == false` zero-fills and reads
// nothing.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool ok) {
  const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Fragment loads (PTX ISA, mma.m16n8k16 .bf16; lane = 4 g + t). A: 16 x 16
// row-major, rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9. B: 16 x 8
// (k x n), k = 2t, 2t + 1 and 2t + 8, 2t + 9 of column g. C: rows g and g + 8,
// columns 2t, 2t + 1.

// A fragment of rows r0.., columns k0.. of a tile stored [m][k] (pitch P).
template <int P>
__device__ __forceinline__ void load_a(uint32_t (&f)[4], const bf16* tile, int r0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(f, tile + (r0 + (lane & 15)) * P + k0 + (lane >> 4) * 8);
}

// A fragment of rows (m) m0.., columns (k) k0.. of a tile stored [k][m].
template <int P>
__device__ __forceinline__ void load_at(uint32_t (&f)[4], const bf16* tile, int k0, int m0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(f, tile + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * P + m0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two 8-column tiles n0.. and n0 + 8.. at k0.. of a tile
// stored [n][k]: f[0], f[1] for the first, f[2], f[3] for the second.
template <int P>
__device__ __forceinline__ void load_b(uint32_t (&f)[4], const bf16* tile, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(f, tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * P + k0 + ((lane >> 3) & 1) * 8);
}

// The same for a tile stored [k][n], through the transposing load.
template <int P>
__device__ __forceinline__ void load_bt(uint32_t (&f)[4], const bf16* tile, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(f, tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * P + n0 + (lane >> 4) * 8);
}

// relu(x * a + b) rounded to bf16 for 8 channels c.. of one row, in place.
__device__ __forceinline__ void prologue8(bf16* p, const float* a, const float* b, int c) {
  uint4 v = *reinterpret_cast<uint4*>(p);
  __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
  const float4 a0 = __ldg(reinterpret_cast<const float4*>(a + c));
  const float4 a1 = __ldg(reinterpret_cast<const float4*>(a + c + 4));
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(b + c));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(b + c + 4));
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(e[k]);
    e[k] = __floats2bfloat162_rn(fmaxf(f.x * av[2 * k] + bv[2 * k], 0.f),
                                 fmaxf(f.y * av[2 * k + 1] + bv[2 * k + 1], 0.f));
  }
  *reinterpret_cast<uint4*>(p) = v;
}

// Shared-memory tiles of gemm_rows_kernel: A [128][PA] and B ([32][PB] when
// stored [k][n], [BN][PB] when stored [n][k]), kStages of each.
template <int BN, bool BTRANS>
struct RowsTile {
  static constexpr int PA = kBK + kPad;
  static constexpr int PB = BTRANS ? BN + kPad : kBK + kPad;
  static constexpr int kAElems = kBM * PA;
  static constexpr int kBElems = BTRANS ? kBK * PB : BN * PB;
  static constexpr int kBytes = kStages * (kAElems + kBElems) * 2;
  // the epilogue stages a [128][BN + pad] output tile in the same memory
  static_assert(kBM * (BN + kPad) * 2 <= kBytes, "staged tile does not fit");
};

// The same for gemm_dw_kernel: A [32][BM + pad] and B [32][BN + pad].
template <int BM, int BN>
struct DwTile {
  static constexpr int PA = BM + kPad, PB = BN + kPad;
  static constexpr int kAElems = kBK * PA, kBElems = kBK * PB;
  static constexpr int kBytes = kStages * (kAElems + kBElems) * 2;
};

struct RowsArgs {
  const bf16* src;    // A rows [M, Ca]: x, or dyc for dx
  const bf16* w;      // weights: [Ca, N] (BTRANS) or [N, Ca]
  const float* a;     // prologue / mask scale [channels of x], or null
  const float* b;     // prologue / mask shift
  const bf16* xe;     // dx epilogue: x [M, N]
  const bf16* dy;     // dyc epilogue: dy [M, N]
  const float* gs1;   // dyc epilogue: [N]
  const float* gs2;
  bf16* out;          // y, dyc or dx [M, N]
  float* part;        // column partials [M tiles, 2, N] (y: s1, s2; dx: da, db)
  int M, N, Ca;       // rows (32-bit: the wrapper bounds M), output channels, A channels
};

// C[M, N] = A[M, Ca] B[Ca, N] with one of three epilogues.
// Grid: (N / BN, ceil(M / 128)).
template <int BN, bool APRO, bool BTRANS, int EPI, bool EMASK>
__global__ void __launch_bounds__(kThreads) gemm_rows_kernel(RowsArgs p) {
  constexpr int WN = BN / 2;      // warp tile: 32 rows x WN columns
  constexpr int NT = WN / 8;      // 8-column MMA tiles per warp
  using T = RowsTile<BN, BTRANS>;
  constexpr int PA = T::PA, PB = T::PB;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const sA = reinterpret_cast<bf16*>(smem);  // [kStages][kAElems]
  bf16* const sB = sA + kStages * T::kAElems;       // [kStages][kBElems]
  __shared__ float red[2][4][BN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kBM;
  const int steps = p.Ca / kBK;
  // the two rows whose A chunks this thread copies
  int rm[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) rm[q] = m0 + ((tid + q * kThreads) >> 2);

  auto load_stage = [&](int step, int buf) {
    const int c0 = step * kBK;
    // A: 128 rows x 4 chunks of 8 channels; two chunks a thread (rows past M
    // zero-filled)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = (tid + q * kThreads) >> 2, cc = (tid & 3) * 8;
      const bool ok = rm[q] < p.M;
      const bf16* from = ok ? p.src + static_cast<long long>(rm[q]) * p.Ca + c0 + cc : p.src;
      cp_async16(sA + buf * T::kAElems + r * PA + cc, from, ok);
    }
    // B: rows k = c0.., columns n0..
    if (BTRANS) {
      constexpr int kChunks = kBK * BN / 8;
      for (int chunk = tid; chunk < kChunks; chunk += kThreads) {
        const int k = chunk / (BN / 8), nn = (chunk % (BN / 8)) * 8;
        const bf16* from = p.w + static_cast<long long>(c0 + k) * p.N + n0 + nn;
        cp_async16(sB + buf * T::kBElems + k * PB + nn, from, true);
      }
    } else {
      constexpr int kChunks = BN * kBK / 8;
      for (int chunk = tid; chunk < kChunks; chunk += kThreads) {
        const int nn = chunk >> 2, k = (chunk & 3) * 8;
        const bf16* from = p.w + static_cast<long long>(n0 + nn) * p.Ca + c0 + k;
        cp_async16(sB + buf * T::kBElems + nn * PB + k, from, true);
      }
    }
    cp_async_commit();
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  // kStages - 1 tiles in flight ahead of the one in use; an empty group
  // keeps the count uniform where no tile is left to copy
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      load_stage(s, s);
    else
      cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    const int buf = step % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of tile `step` landed
    const bf16* a_tile = sA + buf * T::kAElems;
    const bf16* b_tile = sB + buf * T::kBElems;
    if (APRO) {
      // apply the prologue to this thread's own chunks, but not to the
      // zero-filled rows past M
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = (tid + q * kThreads) >> 2, cc = (tid & 3) * 8;
        if (rm[q] < p.M) prologue8(sA + buf * T::kAElems + r * PA + cc, p.a, p.b, step * kBK + cc);
      }
    }
    // tile `step` is complete for every thread, and every warp is done with
    // tile step - 1, whose buffer the next copy reuses
    __syncthreads();
    const int next = step + kStages - 1;
    if (next < steps)
      load_stage(next, next % kStages);
    else
      cp_async_commit();
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) load_a<PA>(af[mt], a_tile, warp_m * 32 + mt * 16, kc * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        if (BTRANS)
          load_bt<PB>(bfr, b_tile, kc * 16, warp_n * WN + np * 16);
        else
          load_b<PB>(bfr, b_tile, warp_n * WN + np * 16, kc * 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  // Epilogue. The pipeline's buffers are free once every warp is past its
  // last product: the output tile (and the tile the epilogue reads, dy or x)
  // is staged there, so that device memory sees whole 16-byte row pieces
  // rather than the 4-byte pairs of the MMA fragments.
  __syncthreads();
  constexpr int PC = BN + kPad;  // staged tile [128][PC]
  bf16* const sC = sA;
  const int rows_here = p.M - m0 < kBM ? p.M - m0 : kBM;
  if (EPI == kEpiDyc || (EPI == kEpiDx && EMASK)) {
    const bf16* in = EPI == kEpiDyc ? p.dy : p.xe;
    for (int i = tid; i < kBM * (BN / 8); i += kThreads) {
      const int r = i / (BN / 8), cc = (i % (BN / 8)) * 8;
      if (r < rows_here)
        *reinterpret_cast<uint4*>(sC + r * PC + cc) = *reinterpret_cast<const uint4*>(
            in + static_cast<long long>(m0 + r) * p.N + n0 + cc);
    }
    __syncthreads();
  }

  // lane 4 g + t holds rows g, g + 8 of each 16-row tile and columns 2t,
  // 2t + 1 of each 8-column tile; it reads and writes only those places of
  // the staged tile
  const int g = lane >> 2, t4 = lane & 3;
  float cs1[NT][2], cs2[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) cs1[nt][0] = cs1[nt][1] = cs2[nt][0] = cs2[nt][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = warp_m * 32 + mt * 16 + g + half * 8;
      if (rl >= rows_here) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int cl = warp_n * WN + nt * 8 + 2 * t4, c = n0 + cl;
        __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(sC + rl * PC + cl);
        float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (EPI == kEpiY) {
          cs1[nt][0] += v0, cs1[nt][1] += v1;
          cs2[nt][0] += v0 * v0, cs2[nt][1] += v1 * v1;
        } else if (EPI == kEpiDyc) {
          const float2 d = __bfloat1622float2(*at);
          v0 = d.x + p.gs1[c] + 2.f * v0 * p.gs2[c];
          v1 = d.y + p.gs1[c + 1] + 2.f * v1 * p.gs2[c + 1];
        } else if (EMASK) {
          const float2 xv = __bfloat1622float2(*at);
          const float a0 = p.a[c], a1 = p.a[c + 1];
          const float du0 = xv.x * a0 + p.b[c] > 0.f ? v0 : 0.f;
          const float du1 = xv.y * a1 + p.b[c + 1] > 0.f ? v1 : 0.f;
          cs1[nt][0] += du0 * xv.x, cs1[nt][1] += du1 * xv.y;
          cs2[nt][0] += du0, cs2[nt][1] += du1;
          v0 = du0 * a0, v1 = du1 * a1;
        }
        *at = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kBM * (BN / 8); i += kThreads) {
    const int r = i / (BN / 8), cc = (i % (BN / 8)) * 8;
    if (r < rows_here)
      *reinterpret_cast<uint4*>(p.out + static_cast<long long>(m0 + r) * p.N + n0 + cc) =
          *reinterpret_cast<const uint4*>(sC + r * PC + cc);
  }
  if (EPI == kEpiY || (EPI == kEpiDx && EMASK)) {
    // column sums over the CTA's rows, in a fixed order: the 8 row groups of
    // the warp by shuffles, then the 4 warps along M through shared memory
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          cs1[nt][e] += __shfl_xor_sync(0xffffffffu, cs1[nt][e], o);
          cs2[nt][e] += __shfl_xor_sync(0xffffffffu, cs2[nt][e], o);
        }
    if (g == 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = warp_n * WN + nt * 8 + 2 * t4 + e;
          red[0][warp_m][c] = cs1[nt][e];
          red[1][warp_m][c] = cs2[nt][e];
        }
    }
    __syncthreads();
    for (int i = tid; i < 2 * BN; i += kThreads) {
      const int which = i / BN, c = i % BN;
      const float s = ((red[which][0][c] + red[which][1][c]) + red[which][2][c]) + red[which][3][c];
      p.part[(static_cast<long long>(blockIdx.y) * 2 + which) * p.N + n0 + c] = s;
    }
  }
}

struct DwArgs {
  const bf16* x;      // [M, Cin]
  const bf16* dyc;    // [M, N]
  const float* a;     // prologue, or null
  const float* b;
  float* part;        // [splits, Cin, N]
  int M, Cin, N, ksplit;
};

// dw partials: part[split] = sum over the split's rows m of xn[m]^T dyc[m],
// a BM x BN tile of [Cin, N] per CTA.
// Grid: ((Cin / BM) * (N / BN), 1, splits).
template <int BM, int BN, bool APRO>
__global__ void __launch_bounds__(kThreads) gemm_dw_kernel(DwArgs p) {
  constexpr int WARPS_M = BM / 32, WARPS_N = 8 / WARPS_M;
  constexpr int WN = BN / WARPS_N, NT = WN / 8;
  using T = DwTile<BM, BN>;
  constexpr int PA = T::PA, PB = T::PB;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const sA = reinterpret_cast<bf16*>(smem);  // [kStages][kAElems]
  bf16* const sB = sA + kStages * T::kAElems;       // [kStages][kBElems]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp % WARPS_M, warp_n = warp / WARPS_M;
  const int tiles_m = p.Cin / BM;
  const int ci0 = (blockIdx.x % tiles_m) * BM, co0 = (blockIdx.x / tiles_m) * BN;
  const int k_begin = blockIdx.z * p.ksplit;
  const int k_end = k_begin + p.ksplit < p.M ? k_begin + p.ksplit : p.M;
  const int steps = k_begin < k_end ? (k_end - k_begin + kBK - 1) / kBK : 0;

  auto load_stage = [&](int step, int buf) {
    const int r0 = k_begin + step * kBK;
    constexpr int kAChunks = kBK * BM / 8;
    for (int chunk = tid; chunk < kAChunks; chunk += kThreads) {
      const int r = chunk / (BM / 8), cc = (chunk % (BM / 8)) * 8;
      const int m = r0 + r;
      const bool ok = m < k_end;
      const bf16* from = ok ? p.x + static_cast<long long>(m) * p.Cin + ci0 + cc : p.x;
      cp_async16(sA + buf * T::kAElems + r * PA + cc, from, ok);
    }
    constexpr int kBChunks = kBK * BN / 8;
    for (int chunk = tid; chunk < kBChunks; chunk += kThreads) {
      const int r = chunk / (BN / 8), cc = (chunk % (BN / 8)) * 8;
      const int m = r0 + r;
      const bool ok = m < k_end;
      const bf16* from = ok ? p.dyc + static_cast<long long>(m) * p.N + co0 + cc : p.dyc;
      cp_async16(sB + buf * T::kBElems + r * PB + cc, from, ok);
    }
    cp_async_commit();
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      load_stage(s, s);
    else
      cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    const int buf = step % kStages;
    cp_async_wait<kStages - 2>();
    const bf16* a_tile = sA + buf * T::kAElems;
    const bf16* b_tile = sB + buf * T::kBElems;
    if (APRO) {
      const int r0 = k_begin + step * kBK;
      constexpr int kAChunks = kBK * BM / 8;
      for (int chunk = tid; chunk < kAChunks; chunk += kThreads) {
        const int r = chunk / (BM / 8), cc = (chunk % (BM / 8)) * 8;
        if (r0 + r < k_end)
          prologue8(sA + buf * T::kAElems + r * PA + cc, p.a, p.b, ci0 + cc);
      }
    }
    __syncthreads();  // as in gemm_rows_kernel
    const int next = step + kStages - 1;
    if (next < steps)
      load_stage(next, next % kStages);
    else
      cp_async_commit();
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) load_at<PA>(af[mt], a_tile, kc * 16, warp_m * 32 + mt * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        load_bt<PB>(bfr, b_tile, kc * 16, warp_n * WN + np * 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
  float* out = p.part + static_cast<long long>(blockIdx.z) * p.Cin * p.N;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = ci0 + warp_m * 32 + mt * 16 + g + half * 8;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = co0 + warp_n * WN + nt * 8 + 2 * t4;
        *reinterpret_cast<float2*>(out + static_cast<long long>(ci) * p.N + co) =
            make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
}

// out[c] = sum_{t < T} part[t][c], in a fixed order: each of 16 row groups sums
// its rows t = ty, ty + 16, ... in turn, then the 16 group sums are added in
// order. Grid: ceil(C / 32); block (32, 16).
__global__ void col_reduce_kernel(const float* part, float* out, int T, long long C) {
  __shared__ float s[16][33];
  const long long c = static_cast<long long>(blockIdx.x) * 32 + threadIdx.x;
  float acc = 0.f;
  if (c < C)
    for (int t = threadIdx.y; t < T; t += 16) acc += part[static_cast<long long>(t) * C + c];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float r = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) r += s[k][threadIdx.x];
    out[c] = r;
  }
}

#define RU_TRY(expr)          \
  do {                        \
    const int rc_ = (expr);   \
    if (rc_ != 0) return rc_; \
  } while (0)

int reduce(const float* part, float* out, int T, long long C, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((C + 31) / 32)), block(32, 16);
  col_reduce_kernel<<<grid, block, 0, st>>>(part, out, T, C);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, bool APRO, bool BTRANS, int EPI, bool EMASK>
int launch_rows(const RowsArgs& p, cudaStream_t st) {
  const auto kernel = gemm_rows_kernel<BN, APRO, BTRANS, EPI, EMASK>;
  constexpr int bytes = RowsTile<BN, BTRANS>::kBytes;
  // dynamic shared memory above the default 48 KB is opted into once per kernel
  static const int attr = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  RU_TRY(attr);
  const dim3 grid(p.N / BN, (p.M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The row GEMM for a given output width (BN = 128 when it divides N, else 64).
template <bool APRO, bool BTRANS, int EPI, bool EMASK>
int rows_any(const RowsArgs& p, cudaStream_t st) {
  return p.N % 128 == 0 ? launch_rows<128, APRO, BTRANS, EPI, EMASK>(p, st)
                        : launch_rows<64, APRO, BTRANS, EPI, EMASK>(p, st);
}

template <int BM, int BN, bool APRO>
int launch_dw(const DwArgs& p, int splits, cudaStream_t st) {
  const auto kernel = gemm_dw_kernel<BM, BN, APRO>;
  constexpr int bytes = DwTile<BM, BN>::kBytes;
  static const int attr = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  RU_TRY(attr);
  const dim3 grid((p.Cin / BM) * (p.N / BN), 1, splits);
  kernel<<<grid, kThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool APRO>
int dw_any(const DwArgs& p, int splits, cudaStream_t st) {
  const bool m128 = p.Cin % 128 == 0, n128 = p.N % 128 == 0;
  if (m128 && n128) return launch_dw<128, 128, APRO>(p, splits, st);
  if (m128) return launch_dw<128, 64, APRO>(p, splits, st);
  if (n128) return launch_dw<64, 128, APRO>(p, splits, st);
  return launch_dw<64, 64, APRO>(p, splits, st);
}

}  // namespace

// Forward of K7.
//   x [M, cin] bf16 (NHWC rows), w [cin, cout] bf16, a/b [cin] f32 or null,
//   y [M, cout] bf16, part [ceil(M / 128), 2, cout] f32 scratch, stats [2,
//   cout] f32 (s1, s2).
extern "C" int resnet_unit_fwd(const void* x, const void* w, const float* a, const float* b,
                               void* y, float* part, float* stats, int M, int cin, int cout,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  RowsArgs p{};
  p.src = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.a = a, p.b = b;
  p.out = static_cast<bf16*>(y);
  p.part = part;
  p.M = M, p.N = cout, p.Ca = cin;
  if (a != nullptr)
    RU_TRY((rows_any<true, true, kEpiY, false>(p, st)));
  else
    RU_TRY((rows_any<false, true, kEpiY, false>(p, st)));
  return reduce(part, stats, (M + kBM - 1) / kBM, 2LL * cout, st);
}

// Backward of K7.
//   dy [M, cout] bf16, gs1/gs2 [cout] f32; scratch dyc [M, cout] bf16,
//   part_dx [ceil(M / 128), 2, cin] f32, part_dw [splits, cin, cout] f32.
//   Outputs dx [M, cin] bf16, dw [cin, cout] f32, dadb [2, cin] f32 (da,
//   db; with a prologue only). splits chunks of ksplit rows (a multiple of 32)
//   cover M.
extern "C" int resnet_unit_bwd(const void* x, const void* w, const float* a, const float* b,
                               const void* dy, const float* gs1, const float* gs2, void* dyc,
                               void* dx, float* part_dx, float* dadb, float* part_dw, float* dw,
                               int M, int cin, int cout, int splits, int ksplit, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pro = a != nullptr;
  if ((pro && b == nullptr) || ksplit % kBK != 0 || static_cast<long long>(splits) * ksplit < M)
    return static_cast<int>(cudaErrorInvalidValue);
  // 1. dyc, recomputing y
  {
    RowsArgs p{};
    p.src = static_cast<const bf16*>(x);
    p.w = static_cast<const bf16*>(w);
    p.a = a, p.b = b;
    p.dy = static_cast<const bf16*>(dy);
    p.gs1 = gs1, p.gs2 = gs2;
    p.out = static_cast<bf16*>(dyc);
    p.M = M, p.N = cout, p.Ca = cin;
    if (pro)
      RU_TRY((rows_any<true, true, kEpiDyc, false>(p, st)));
    else
      RU_TRY((rows_any<false, true, kEpiDyc, false>(p, st)));
  }
  // 2. dx (with the mask, da/db partials)
  {
    RowsArgs p{};
    p.src = static_cast<const bf16*>(dyc);
    p.w = static_cast<const bf16*>(w);
    p.a = a, p.b = b;
    p.xe = static_cast<const bf16*>(x);
    p.out = static_cast<bf16*>(dx);
    p.part = part_dx;
    p.M = M, p.N = cin, p.Ca = cout;
    if (pro)
      RU_TRY((rows_any<false, false, kEpiDx, true>(p, st)));
    else
      RU_TRY((rows_any<false, false, kEpiDx, false>(p, st)));
  }
  // 3. dw partials per row chunk, then their sum
  {
    DwArgs p{};
    p.x = static_cast<const bf16*>(x);
    p.dyc = static_cast<const bf16*>(dyc);
    p.a = a, p.b = b;
    p.part = part_dw;
    p.M = M, p.Cin = cin, p.N = cout, p.ksplit = ksplit;
    if (pro)
      RU_TRY((dw_any<true>(p, splits, st)));
    else
      RU_TRY((dw_any<false>(p, splits, st)));
  }
  RU_TRY(reduce(part_dw, dw, splits, static_cast<long long>(cin) * cout, st));
  if (pro) RU_TRY(reduce(part_dx, dadb, (M + kBM - 1) / kBM, 2LL * cin, st));
  return 0;
}
