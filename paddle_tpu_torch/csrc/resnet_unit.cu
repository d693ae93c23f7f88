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
// The TPU kernels run their grid in order and carry s1/s2, dw, da and db in
// VMEM from one grid step to the next. Hopper's CTAs run in parallel and in no
// order, so every cross-CTA sum here is a partial per CTA followed by a
// second, deterministic pass (bwd_reduce_kernel: fixed order, no atomics),
// and two calls give the same bits.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at ResNet-50's
// shapes (batch 256, 224^2) the 1x1 convs of stage 1 do cin cout / (cin +
// cout) = 32-51 operations per byte and are bound by bytes; stage 4's 1x1
// (2048 -> 512, 12,544 rows) does ~1,150 and is bound by operations (the
// card's balance point is ~295). The backward does three products (y
// recomputed, dx, dw) against the forward's one.
//
// Every product is a wgmma fed by TMA (2-D maps, 128-byte swizzle, rows past
// M zero-filled), in CTAs of three warpgroups: a producer (one thread issues
// the loads; 24 registers) and two consumer warpgroups (240 registers).
//
// Forward: k7_rows_kernel<y>, y [M, cout] = xn w in 128 x BN tiles (BN =
// 128, or 64 where 128 does not divide cout; k7_fwd_plan in
// ops/hopper/resnet_unit.py mirrors it), the backward's dyc kernel with
// another epilogue: a persistent grid (a multiple of the column tiles, so a
// CTA stays in one), K = cin streamed in 64-wide chunks through a 4-stage
// ring with the prologue applied in place, y rounded into one of two
// epilogue buffers and stored by TMA, so that a tile's store overlaps the
// next tile's loads. s1/s2 are added from the f32 accumulator over the
// tile's rows below M into registers held across the CTA's tiles (rows
// past M: the prologue turns TMA's zero rows into relu(b) != 0, so their y
// is not zero; TMA's store drops them and s1/s2 skip them), and reduced
// over warps once at the end: one partial per CTA. What bounds it: bytes at
// every ResNet-50 shape but layer 4's 1024 -> 512, 2048 -> 512 and 512 ->
// 2048 (cin cout / (cin + cout) = 32-410 operations per byte against the
// card's ~295). Measured against two other designs (scripts/
// k7_fwd_variants.py, PERF.md): 128 x 256 tiles at 64 -> 256 with w
// resident, so that x is read and transformed once, ran no faster (x's
// second read comes from L2), and 128 x 256 tiles at the operation-bound
// shapes ran 3% faster at 512 -> 2048 and 12-43% slower at the others.
//
// Backward: the consumer warpgroups own 64 rows each. Two designs, chosen
// per shape by k7_bwd_plan in ops/hopper/resnet_unit.py:
//
//   One pass (k7_onepass_kernel), where w and a CTA's dw partial fit: one of
//   cin, cout is 64 and the other at most 256 (ResNet-50's layer-1 64 -> 64,
//   256 -> 64 and 64 -> 256, 6 of a step's 32 launches), the prologue only at
//   cin = 64 (da/db stay in registers). A persistent grid: each CTA owns a
//   contiguous range of 128-row tiles and keeps w (<= 32 KB) resident; tile
//   by tile, x and dy arrive by TMA into one of two stages, and each consumer
//   warpgroup, for its 64 rows,
//     applies the prologue to x in place (shared memory),
//     recomputes y in 64-column chunks of cout (wgmma, xn K-major, w
//     MN-major), forms the chunk's dyc in registers from dy (read from the
//     stage), rounds it to bf16, writes it back over dy and packs it as
//     wgmma's A fragment,
//     issues dx += dyc w^T from that fragment (w read K-major from the same
//     tile; at cout = 64, dx runs per 64-column chunk of cin instead),
//   then, once both warpgroups' dyc is in shared memory, dw += xn^T dyc
//   (both MN-major from the stage) into an accumulator that stays in
//   registers over the CTA's tiles: each warpgroup owns half of dw (half the
//   cout columns at cin = 64, half the cin rows at cout = 64; at 64 x 64 the
//   whole of dw over its own 64 rows, two partials a CTA). Once both
//   warpgroups' dw products are done, the dx epilogue (mask, dx = du a,
//   da/db in registers) writes dx over x in the stage and one thread stores
//   the tile by TMA. dyc never reaches device memory: 64 -> 256 moves x, dy
//   and dx once (0.62 GB at 802,816 rows instead of three passes' 2.06).
//
//   Three passes (every other shape):
//     k7_rows_kernel<dyc>  dyc [M, cout] = f(dy, xn w) in 128 x BN tiles,
//                          K = cin streamed in 64-wide chunks through a
//                          4-stage ring; xn K-major (the prologue applied in
//                          place by each consumer warpgroup to its 64 rows
//                          while the previous chunk's products run), w
//                          MN-major.
//     k7_rows_kernel<dx>   dx [M, cin] = dyc w^T: the same tiles and ring,
//                          dyc and w both K-major; the epilogue applies the
//                          mask from x and writes one da/db partial per
//                          128-row tile.
//                          Both are persistent (a CTA per SM takes the tiles
//                          in turn, and the producer runs ahead across
//                          them): the epilogue's input (dy, or x for the
//                          mask) arrives by TMA a tile ahead into one of
//                          two buffers, the epilogue writes its output over
//                          it, and one thread stores the tile by TMA, so a
//                          tile's epilogue overlaps the next tile's loads.
//     k7_dw_kernel         dw partials: a BM (cin) x BN (cout) tile per CTA
//                          over one split of rows (split-K, 64-row chunks in a
//                          4-stage ring); A = xn^T read MN-major from x's row
//                          tile (prologue in place), B = dyc MN-major. Each
//                          consumer warpgroup owns 64 cin rows (BM = 128), or
//                          both share a 64-row tile and split each chunk's
//                          rows, their sums added in order at the end.
//   and bwd_reduce_kernel sums the dw and da/db partials in a fixed order.
//
// ptxas serialises wgmma (C7515) when another instruction writes an
// accumulator, so every accumulator's first product overwrites it (scale-d
// 0) and dyc is packed from y after y's product is done. ops/hopper/
// resnet_unit.py's k7_bwd_plan mirrors the designs, tiles and shared memory;
// conv1x1_bn_bwd_onepass_reference models the one pass's schedule.
//
// Interface: plain C, loaded with ctypes. The caller allocates every output
// and scratch buffer and checks shapes, dtypes, devices, contiguity and 16-byte
// alignment. Each launcher returns the first cudaError_t of its launches (or
// cudaErrorInvalidValue when a tensor map cannot be made).

#include "sm90.cuh"

#include <stddef.h>

namespace {

using bf16 = __nv_bfloat16;

// ----------------------------------------------------------------------------
// shared helpers
// ----------------------------------------------------------------------------

// relu(x * a + b) rounded to bf16 for 8 channels: a, b hold the channels'
// scale and shift.
__device__ __forceinline__ uint4 prologue8(uint4 v, const float (&a)[8], const float (&b)[8]) {
  __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(e[k]);
    e[k] = __floats2bfloat162_rn(fmaxf(f.x * a[2 * k] + b[2 * k], 0.f),
                                 fmaxf(f.y * a[2 * k + 1] + b[2 * k + 1], 0.f));
  }
  return v;
}

// the scale and shift of channels c .. c + 7
__device__ __forceinline__ void load8(float (&a)[8], float (&b)[8], const float* pa,
                                      const float* pb, int c) {
  const float4 a0 = __ldg(reinterpret_cast<const float4*>(pa + c));
  const float4 a1 = __ldg(reinterpret_cast<const float4*>(pa + c + 4));
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(pb + c));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(pb + c + 4));
  a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w, a[4] = a1.x, a[5] = a1.y, a[6] = a1.z,
  a[7] = a1.w;
  b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w, b[4] = b1.x, b[5] = b1.y, b[6] = b1.z,
  b[7] = b1.w;
}

#define RU_TRY(expr)          \
  do {                        \
    const int rc_ = (expr);   \
    if (rc_ != 0) return rc_; \
  } while (0)

// The partials' sums (s1/s2, dw, da/db): out[c] = sum_{t < T} part[t][c] over C = 4 C4
// columns, in a fixed order: thread (x, y) sums the four columns of float4
// x over the rows t = y, y + 8, ... in turn, then the 8 row groups' sums are
// added in order. Block (32, 8).
__global__ void bwd_reduce_kernel(const float4* part, float4* out, int T, long long C4) {
  __shared__ float4 s[8][32];
  const long long c = static_cast<long long>(blockIdx.x) * 32 + threadIdx.x;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < C4) {
#pragma unroll 4
    for (int t = threadIdx.y; t < T; t += 8) {
      const float4 v = part[static_cast<long long>(t) * C4 + c];
      acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
    }
  }
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < C4) {
    float4 r = s[0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      const float4 v = s[k][threadIdx.x];
      r.x += v.x, r.y += v.y, r.z += v.z, r.w += v.w;
    }
    out[c] = r;
  }
}

// C: a multiple of 4 (the channel counts are multiples of 64)
int reduce4(const float* part, float* out, int T, long long C, cudaStream_t st) {
  const long long C4 = C / 4;
  bwd_reduce_kernel<<<static_cast<unsigned>((C4 + 31) / 32), dim3(32, 8), 0, st>>>(
      reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(out), T, C4);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------------------
// wgmma, TMA, warp-specialised (see the note at the top)
// ----------------------------------------------------------------------------

constexpr int kBwdThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kTileM = 128;       // rows of a row tile: 2 consumer warpgroups x 64
constexpr int kBox = kTileM * 128;  // a [128 rows][64 channels] bf16 box: 16 KB
constexpr int kRowStages = 4;     // k7_rows_kernel's ring
constexpr int kDwRows = 64;       // rows of a k7_dw_kernel chunk
constexpr int kDwBox = kDwRows * 128;  // a [64 rows][64 channels] box: 8 KB
constexpr int kDwStages = 4;
// named barriers: 1, 2 for one consumer warpgroup, 3 for both
constexpr int kBarBoth = 3;

// k7_rows_kernel's epilogues: the backward's dyc and dx, the forward's y
enum { kDyc = 0, kDx = 1, kY = 2 };

struct K7Args {
  const bf16* x;      // [M, cin]
  const float* a;     // prologue [cin], or null
  const float* b;
  const bf16* dy;     // [M, cout]
  const float* gs1;   // [cout]
  const float* gs2;
  bf16* dyc;          // [M, cout] (three passes)
  bf16* dx;           // [M, cin]
  // column sums per CTA (CTAs of one column tile share a row): s1/s2 of y
  // (forward, [CTAs / column tiles, 2, cout]) or da/db (backward, [CTAs
  // (one pass; dx CTAs / column tiles), 2, cin])
  float* part_sums;
  float* part_dw;     // dw partials [parts, cin, cout]
  int M, cin, cout;
  int ksplit;  // dw kernel: rows of a split (a multiple of 64)
  int ctas;    // one pass: CTAs of the persistent grid
};

// a bf16 pair as two floats
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint32_t ldg_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// one arrival per consumer warp on a stage's `empty` barrier
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// D[64 x BN] (+)= A B, both from shared memory, BN = 64 or 128
template <int BN, int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 128)
    wgmma_ss_n128<TA, TB>(d, da, db, scale_d);
  else
    wgmma_ss_n64<TA, TB>(d, da, db, scale_d);
}

// The sum of v over the 8 lanes of a warp that share t = lane % 4 (the
// row groups g of a wgmma accumulator fragment), in a fixed order.
__device__ __forceinline__ float sum_rows8(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The prologue, in place, on the 16-byte chunks of a swizzled [rows][64
// channels] box at shared address `box` (generic pointer `boxp`): a thread
// takes logical chunk lc (channels c0 + 8 lc, scale and shift in av, bv) of
// rows r0, r0 + 16, ... (R of them); the rows' swizzle phase is the same, so
// the chunk's place in the row is too.
template <int R>
__device__ __forceinline__ void prologue_rows(unsigned char* boxp, uint32_t box, int r0, int lc,
                                              const float (&av)[8], const float (&bv)[8]) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const uint32_t row = box + (r0 + 16 * q) * 128;
    uint4* at = reinterpret_cast<uint4*>(boxp + (swz(row, 8 * lc) - box));
    *at = prologue8(*at, av, bv);
  }
}

template <int BN>
struct RowsSmem {
  static constexpr int a = kBox;          // [128 rows][64 of K]
  static constexpr int b = 64 * BN * 2;   // [64 of K][BN] (y, dyc) or [BN][64 of K] (dx)
  static constexpr int stage = a + b;
  static constexpr int e = kTileM * BN * 2;  // a tile's epilogue input and output: BN / 64 boxes
  static constexpr int total = 1024 + kRowStages * stage + 2 * e;
};

// y (EPI = kY: C = xn w, N = cout, K = cin), dyc (EPI = kDyc: the same
// product) or dx (EPI = kDx: C = dyc w^T, N = cin, K = cout), 128 x BN
// tiles on a persistent grid: CTA k takes tiles k, k + gridDim.x, ... (n
// fastest: neighbouring CTAs share A's rows), and the producer streams
// their 64-wide chunks of K through one ring of stages across the tiles, so
// that a tile's epilogue overlaps the next tile's loads. map_a: boxes [128
// rows][64] of x or dyc; map_b: w [cin, cout] in boxes [64 cin][64 cout]
// (y, dyc: B = w MN-major, BN / 64 boxes a stage) or [BN cin][64 cout] (dx:
// B = w^T K-major); map_e: boxes [128 rows][64] of the epilogue's input
// (dyc: dy; dx with the mask: x; unused by y), two tiles in flight; map_o:
// the same boxes of the output (y, dyc or dx). The epilogue writes the
// output tile over its input in shared memory, and one thread stores it by
// TMA. PRO: the prologue (y, dyc) or the mask (dx). y and the mask sum
// columns (s1/s2 from the f32 products of the rows below M; da/db) in
// registers over the CTA's tiles into one partial per CTA (row k / nt of
// part_sums). Grid: a multiple of the nt = N / BN column tiles (or all
// tiles), so that CTA k always takes column tile k % nt.
template <int EPI, bool PRO, int BN>
__global__ void __launch_bounds__(kBwdThreads, 1)
    k7_rows_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   const __grid_constant__ CUtensorMap map_e,
                   const __grid_constant__ CUtensorMap map_o, K7Args p) {
  constexpr bool kIn = EPI == kDyc || (EPI == kDx && PRO);
  constexpr bool kMask = PRO && EPI == kDx;
  constexpr bool kSums = kMask || EPI == kY;
  constexpr bool kMN = EPI != kDx;  // B = w, MN-major
  using Sm = RowsSmem<BN>;
  constexpr int S = kRowStages;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[S], empty[S], full_e[2], empty_e[2];
  __shared__ float red[kSums ? 8 : 1][2][BN];
  unsigned char* const smb = align1024(smem);
  const uint32_t base = smem_u32(smb);
  const uint32_t e_u = base + S * Sm::stage;  // tile j's epilogue buffer at + (j & 1) Sm::e
  const int N = kMN ? p.cout : p.cin, K = kMN ? p.cin : p.cout;
  const int nk = K / 64, nt = N / BN;
  const int tiles = nt * ((p.M + kTileM - 1) / kTileM);
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mbar_init(&full_e[e], 1);
      mbar_init(&empty_e[e], 1);  // the storing thread, once the store has read it
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // producer: chunk i (counted over the CTA's tiles) to stage i % S once
    // the products of chunk i - S are done; tile j's epilogue input to
    // buffer j & 1 once tile j - 2's output has left it
    setmaxnreg_dec<24>();
    if (tid == 0) {
      prefetch_map(&map_a);
      prefetch_map(&map_b);
      if (kIn) prefetch_map(&map_e);
      int i = 0, j = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
        const int n0 = (tile % nt) * BN, m0 = (tile / nt) * kTileM;
        if (kIn) {
          const int e = j & 1;
          if (j >= 2) mbar_wait(&empty_e[e], ((j >> 1) & 1) ^ 1);
          mbar_expect_tx(&full_e[e], Sm::e);
#pragma unroll
          for (int q = 0; q < BN / 64; ++q)
            tma_2d(e_u + e * Sm::e + q * kBox, &map_e, &full_e[e], n0 + 64 * q, m0);
        }
        for (int k = 0; k < nk; ++k, ++i) {
          const int s = i % S;
          if (i >= S) mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
          const uint32_t st = base + s * Sm::stage;
          mbar_expect_tx(&full[s], Sm::stage);
          tma_2d(st, &map_a, &full[s], 64 * k, m0);
          if (kMN) {
#pragma unroll
            for (int q = 0; q < BN / 64; ++q)
              tma_2d(st + Sm::a + q * 64 * 128, &map_b, &full[s], n0 + 64 * q, 64 * k);
          } else {
            tma_2d(st + Sm::a, &map_b, &full[s], 64 * k, n0);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int c = tid / 128 - 1, ct = tid & 127, warp = ct >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rl = 64 * c + 16 * warp + g;  // tile row of the fragment's first half
    float acc[BN / 2];
    // column sums over the CTA's tiles: s1/s2 (y) or da/db (the mask)
    float su[kSums ? BN / 8 : 1][2], sv[kSums ? BN / 8 : 1][2];
    if constexpr (kSums) {
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) su[q][0] = su[q][1] = sv[q][0] = sv[q][1] = 0.f;
    }
    int i = 0, j = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
      const int n0 = (tile % nt) * BN, m0 = (tile / nt) * kTileM;
      for (int k = 0; k < nk; ++k, ++i) {
        const int s = i % S;
        const uint32_t st = base + s * Sm::stage;
        mbar_wait(&full[s], (i / S) & 1);
        if (kMN && PRO) {
          // this warpgroup's 64 rows of the x chunk: logical chunk ct & 7,
          // rows 64 c + ct / 8 + 16 q
          float av[8], bv[8];
          load8(av, bv, p.a, p.b, 64 * k + 8 * (ct & 7));
          prologue_rows<4>(smb + (st - base), st, 64 * c + (ct >> 3), ct & 7, av, bv);
          fence_proxy_async();
          named_sync(1 + c, 128);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = smem_desc(st + 64 * c * 128 + kk * 32, 1, 64);
          // y, dyc: w MN-major, 8-row groups of K 1024 bytes apart, the
          // 64-wide boxes along N 8 KB apart; dx: w^T K-major, 32 bytes per
          // k16
          const uint64_t db = kMN ? smem_desc(st + Sm::a + kk * 16 * 128, 64 * 128 / 16, 64)
                                  : smem_desc(st + Sm::a + kk * 32, 1, 64);
          mma_ss<BN, 0, (kMN ? 1 : 0)>(acc, da, db, (k | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (k > 0) release(&empty[(i - 1) % S]);
      }
      wgmma_wait<0>();
      release(&empty[(i - 1) % S]);
      fence_operand(acc);

      // epilogue: lane 4 g + t holds rows rl, rl + 8 and columns 8 q + 2 t,
      // 8 q + 2 t + 1 of the tile; its pair of the buffer sits in box q / 8,
      // row rl (+ 8), 16-byte chunk q % 8 (swizzled), bytes 4 t. Rows past M
      // read zeros (their output is not stored; in dx, A's zero rows make
      // du zero there); y's rows past M are not zero with the prologue
      // (relu(b) w), so s1/s2 leave them out.
      const uint32_t eb = e_u + (j & 1) * Sm::e;
      if (kIn) mbar_wait(&full_e[j & 1], (j >> 1) & 1);
      const bool in_m[2] = {m0 + rl < p.M, m0 + rl + 8 < p.M};
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        const int col = n0 + 8 * q + 2 * t;
        float2 f1 = make_float2(0.f, 0.f), f2 = f1;  // gs1, gs2 (dyc) or a, b (mask)
        if constexpr (EPI == kDyc) {
          f1 = __ldg(reinterpret_cast<const float2*>(p.gs1 + col));
          f2 = __ldg(reinterpret_cast<const float2*>(p.gs2 + col));
        } else if constexpr (kMask) {
          f1 = __ldg(reinterpret_cast<const float2*>(p.a + col));
          f2 = __ldg(reinterpret_cast<const float2*>(p.b + col));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t rowa = eb + (q >> 3) * kBox + (rl + 8 * h) * 128;
          uint32_t* const at =
              reinterpret_cast<uint32_t*>(smb + (swz(rowa, 8 * (q & 7)) - base) + 4 * t);
          float v0 = acc[4 * q + 2 * h], v1 = acc[4 * q + 2 * h + 1];
          const float2 in = kIn ? unpack_bf16(*at) : make_float2(0.f, 0.f);
          if constexpr (EPI == kY) {
            if (in_m[h]) {
              su[q][0] += v0, su[q][1] += v1;
              sv[q][0] += v0 * v0, sv[q][1] += v1 * v1;
            }
          } else if constexpr (EPI == kDyc) {
            v0 = in.x + f1.x + 2.f * v0 * f2.x;
            v1 = in.y + f1.y + 2.f * v1 * f2.y;
          } else if constexpr (kMask) {
            const float du0 = in.x * f1.x + f2.x > 0.f ? v0 : 0.f;
            const float du1 = in.y * f1.y + f2.y > 0.f ? v1 : 0.f;
            su[q][0] += du0 * in.x, su[q][1] += du1 * in.y;
            sv[q][0] += du0, sv[q][1] += du1;
            v0 = du0 * f1.x, v1 = du1 * f1.y;
          }
          *at = pack_bf16(v0, v1);
        }
      }
      fence_proxy_async();
      named_sync(kBarBoth, 256);  // the output tile is in the buffer
      if (tid == 128) {
        // TMA drops the rows past M
#pragma unroll
        for (int q = 0; q < BN / 64; ++q) tma_store_2d(&map_o, eb + q * kBox, n0 + 64 * q, m0);
        bulk_commit();
        bulk_wait_read();
        if (kIn) mbar_arrive(&empty_e[j & 1]);
      }
    }
    if constexpr (kSums) {
      // the sums over the CTA's rows (all in one column tile: the grid is a
      // multiple of the column tiles) in a fixed order: the 8 row groups of
      // a warp by shuffles, then the 8 consumer warps through shared memory
#pragma unroll
      for (int q = 0; q < BN / 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          su[q][e] = sum_rows8(su[q][e]);
          sv[q][e] = sum_rows8(sv[q][e]);
        }
      if (g == 0) {
#pragma unroll
        for (int q = 0; q < BN / 8; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            red[4 * c + warp][0][8 * q + 2 * t + e] = su[q][e];
            red[4 * c + warp][1][8 * q + 2 * t + e] = sv[q][e];
          }
      }
      named_sync(kBarBoth, 256);
      const int n0 = (blockIdx.x % nt) * BN;
      for (int r = tid - 128; r < 2 * BN; r += 256) {
        const int which = r / BN, cc = r % BN;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) sum += red[w][which][cc];
        p.part_sums[(static_cast<long long>(blockIdx.x / nt) * 2 + which) * N + n0 + cc] = sum;
      }
    }
    if (tid == 128) bulk_wait();  // the last stores have landed
  }
}

template <int BM, int BN>
struct DwSmem {
  static constexpr int x = kDwRows * BM * 2;  // BM / 64 boxes [64 rows][64 cin]
  static constexpr int d = kDwRows * BN * 2;  // BN / 64 boxes [64 rows][64 cout]
  static constexpr int stage = x + d;
  static constexpr int total = 1024 + kDwStages * stage;
};

// dw partials: part_dw[split] tile (BM cin x BN cout) = sum over the split's
// rows of xn^T dyc. map_x, map_d: boxes [64 rows][64] of x and dyc. A CTA
// owns one tile and one split of ksplit rows (64-row chunks; the last split
// ends at M, past which TMA reads zeros: dyc's zero rows add nothing). BM =
// 128: consumer warpgroup c owns cin rows 64 c..; BM = 64: both take the
// tile, warpgroup c the rows 32 c .. 32 c + 31 of each chunk, and their sums
// are added in order at the end. Grid: ((cin / BM) (cout / BN), splits).
template <bool PRO, int BM, int BN>
__global__ void __launch_bounds__(kBwdThreads, 1)
    k7_dw_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_d, K7Args p) {
  using Sm = DwSmem<BM, BN>;
  constexpr int S = kDwStages;
  constexpr bool kSplitRows = BM == 64;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  unsigned char* const smb = align1024(smem);
  const uint32_t base = smem_u32(smb);
  const int tiles_ci = p.cin / BM;
  const int ci0 = (blockIdx.x % tiles_ci) * BM, co0 = (blockIdx.x / tiles_ci) * BN;
  const int r0 = blockIdx.y * p.ksplit;
  const int r1 = min(r0 + p.ksplit, p.M);
  const int nk = (r1 - r0 + kDwRows - 1) / kDwRows;
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    setmaxnreg_dec<24>();
    if (tid == 0) {
      prefetch_map(&map_x);
      prefetch_map(&map_d);
      for (int i = 0; i < nk; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        const uint32_t st = base + s * Sm::stage;
        const int row = r0 + kDwRows * i;
        mbar_expect_tx(&full[s], Sm::stage);
#pragma unroll
        for (int j = 0; j < BM / 64; ++j) tma_2d(st + j * kDwBox, &map_x, &full[s], ci0 + 64 * j, row);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_2d(st + Sm::x + j * kDwBox, &map_d, &full[s], co0 + 64 * j, row);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int c = tid / 128 - 1, ct = tid & 127, warp = ct >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int xbox = kSplitRows ? 0 : c;
    // the prologue's channels are fixed per thread: logical chunk ct & 7
    float av[8], bv[8];
    if (PRO) load8(av, bv, p.a, p.b, ci0 + 64 * xbox + 8 * (ct & 7));
    float acc[BN / 2];
    for (int i = 0; i < nk; ++i) {
      const int s = i % S;
      const uint32_t st = base + s * Sm::stage;
      mbar_wait(&full[s], (i / S) & 1);
      if (PRO) {
        const uint32_t box = st + xbox * kDwBox;
        if (kSplitRows)
          prologue_rows<2>(smb + (box - base), box, 32 * c + (ct >> 3), ct & 7, av, bv);
        else
          prologue_rows<4>(smb + (box - base), box, ct >> 3, ct & 7, av, bv);
        fence_proxy_async();
        named_sync(1 + c, 128);
      }
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < (kSplitRows ? 2 : 4); ++q) {
        const int kk = kSplitRows ? 2 * c + q : q;
        // A = xn^T and B = dyc, both MN-major: 8-row groups of K 1024 bytes
        // apart; dyc's 64-wide boxes along N 8 KB apart
        const uint64_t da = smem_desc(st + xbox * kDwBox + kk * 16 * 128, 1, 64);
        const uint64_t db = smem_desc(st + Sm::x + kk * 16 * 128, kDwBox / 16, 64);
        mma_ss<BN, 1, 1>(acc, da, db, (i | q) != 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (i > 0) release(&empty[(i - 1) % S]);
    }
    wgmma_wait<0>();
    fence_operand(acc);

    float* const out = p.part_dw + static_cast<long long>(blockIdx.y) * p.cin * p.cout;
    float* const other = reinterpret_cast<float*>(smb);  // kSplitRows: warpgroup 1's sums
    if (kSplitRows) {
      // every product has read its stage, and every stage has landed
      named_sync(kBarBoth, 256);
      if (c == 1) {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) other[e * 128 + ct] = acc[e];
      }
      named_sync(kBarBoth, 256);
    }
    if (!kSplitRows || c == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = ci0 + 64 * xbox + 16 * warp + g + 8 * h;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (kSplitRows) {
            v0 += other[(4 * j + 2 * h) * 128 + ct];
            v1 += other[(4 * j + 2 * h + 1) * 128 + ct];
          }
          *reinterpret_cast<float2*>(out + static_cast<long long>(ci) * p.cout + co0 + 8 * j +
                                     2 * t) = make_float2(v0, v1);
        }
      }
    }
  }
}

template <int CIN, int COUT>
struct OneSmem {
  static constexpr int w = CIN * COUT * 2;     // COUT / 64 boxes [CIN rows][64 cout]
  static constexpr int x = kTileM * CIN * 2;   // CIN / 64 boxes [128 rows][64 cin]
  static constexpr int d = kTileM * COUT * 2;  // COUT / 64 boxes [128 rows][64 cout]
  static constexpr int stage = x + d;
  static constexpr int total = 1024 + w + 2 * stage;
};

// The one pass (see the note at the top). map_x, map_dy, map_dx: boxes [128
// rows][64] of x, dy and dx; map_w: boxes [CIN rows][64 cout] of w. CTA k of p.ctas owns
// the 128-row tiles [k T / ctas, (k + 1) T / ctas) of T. Writes dx, one dw
// partial per CTA (two at 64 x 64, one per warpgroup) and, with the
// prologue, one da/db partial per CTA. Grid: p.ctas.
template <int CIN, int COUT, bool PRO>
__global__ void __launch_bounds__(kBwdThreads, 1)
    k7_onepass_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_dy,
                      const __grid_constant__ CUtensorMap map_w,
                      const __grid_constant__ CUtensorMap map_dx, K7Args p) {
  static_assert(CIN == 64 || COUT == 64, "one of the channel counts is 64");
  static_assert(!PRO || CIN == 64, "the prologue's da/db stay in registers at cin = 64");
  using Sm = OneSmem<CIN, COUT>;
  constexpr int NC = COUT / 64, KC = CIN / 64;
  constexpr bool kOwnRows = CIN == 64 && COUT == 64;
  // a consumer warpgroup's dw accumulators: DW_M tiles of 64 cin x DW_N cout
  constexpr int DW_N = CIN == 64 && !kOwnRows ? COUT / 2 : 64;
  constexpr int DW_M = CIN == 64 ? 1 : CIN / 128;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full_w, full[2], empty[2];
  __shared__ float s_g[2][COUT];
  __shared__ float s_ab[2][PRO ? CIN : 1];
  __shared__ float red[PRO ? 8 : 1][2][CIN];
  unsigned char* const smb = align1024(smem);
  const uint32_t w_u = smem_u32(smb);
  const uint32_t stage0 = w_u + Sm::w;
  const int tiles = (p.M + kTileM - 1) / kTileM;
  const int t0 = static_cast<int>(static_cast<long long>(blockIdx.x) * tiles / p.ctas);
  const int t1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * tiles / p.ctas);
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * COUT; i += kBwdThreads)
    s_g[i / COUT][i % COUT] = (i < COUT ? p.gs1 : p.gs2)[i % COUT];
  if constexpr (PRO)
    for (int i = tid; i < 2 * CIN; i += kBwdThreads)
      s_ab[i / CIN][i % CIN] = (i < CIN ? p.a : p.b)[i % CIN];
  if (tid == 0) {
    mbar_init(&full_w, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);  // the thread that stores dx from the stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // producer: w once, then tile i of the CTA's range to stage i % 2 once
    // the dw products of tile i - 2 are done
    setmaxnreg_dec<24>();
    if (tid == 0) {
      prefetch_map(&map_x);
      prefetch_map(&map_dy);
      prefetch_map(&map_w);
      mbar_expect_tx(&full_w, Sm::w);
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) tma_2d(w_u + cc * CIN * 128, &map_w, &full_w, 64 * cc, 0);
      for (int i = 0; i < t1 - t0; ++i) {
        const int s = i & 1;
        if (i >= 2) mbar_wait(&empty[s], ((i >> 1) & 1) ^ 1);
        const uint32_t st = stage0 + s * Sm::stage;
        const int row0 = (t0 + i) * kTileM;
        mbar_expect_tx(&full[s], Sm::stage);
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) tma_2d(st + kc * kBox, &map_x, &full[s], 64 * kc, row0);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
          tma_2d(st + Sm::x + cc * kBox, &map_dy, &full[s], 64 * cc, row0);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int c = tid / 128 - 1, ct = tid & 127, warp = ct >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int rl = 64 * c + 16 * warp + g;  // tile row of the fragment's first half
    float dw[DW_M][DW_N / 2];
    float dxa[32], ya[32];
    uint32_t dp[4][4];  // a 64-column chunk of dyc as wgmma's A fragment
    float da[PRO ? 8 : 1][2], db[PRO ? 8 : 1][2];
    if constexpr (PRO) {
#pragma unroll
      for (int j = 0; j < 8; ++j) da[j][0] = da[j][1] = db[j][0] = db[j][1] = 0.f;
    }
    // the dx epilogue of cin chunk nc into x's box nc of the stage (free once
    // both warpgroups' dw products are done), which one thread then stores;
    // lane 4 g + t holds rows rl, rl + 8 and columns 64 nc + 8 j + 2 t, + 1
    auto epilogue = [&](uint32_t st, int nc, const uint32_t (&xr)[2][8]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t row = st + nc * kBox + (rl + 8 * h) * 128;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v0 = dxa[4 * j + 2 * h], v1 = dxa[4 * j + 2 * h + 1];
          if constexpr (PRO) {
            const int col = 8 * j + 2 * t;
            const float2 xv = unpack_bf16(xr[h][j]);
            const float du0 = xv.x * s_ab[0][col] + s_ab[1][col] > 0.f ? v0 : 0.f;
            const float du1 = xv.y * s_ab[0][col + 1] + s_ab[1][col + 1] > 0.f ? v1 : 0.f;
            da[j][0] += du0 * xv.x, da[j][1] += du1 * xv.y;
            db[j][0] += du0, db[j][1] += du1;
            v0 = du0 * s_ab[0][col], v1 = du1 * s_ab[0][col + 1];
          }
          *reinterpret_cast<uint32_t*>(smb + (swz(row, 8 * j) - w_u) + 4 * t) = pack_bf16(v0, v1);
        }
      }
    };
    // dx (cin chunk nc) = dyc w^T from the packed dyc chunk cc: B = w^T, rows
    // n = cin of w's box cc read K-major
    auto issue_dx = [&](int cc, int nc, bool first) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n64<0>(dxa, dp[kk], smem_desc(w_u + (cc * CIN + 64 * nc) * 128 + kk * 32, 1, 64),
                        !(first && kk == 0));
      wgmma_commit();
    };

    mbar_wait(&full_w, 0);
    for (int i = 0; i < t1 - t0; ++i) {
      const int s = i & 1;
      const uint32_t st = stage0 + s * Sm::stage, dst = st + Sm::x;
      const int row0 = (t0 + i) * kTileM;
      // raw x for the mask and da (PRO), read while the products run
      uint32_t xr[2][8];
      if constexpr (PRO) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + rl + 8 * h;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            xr[h][j] = row < p.M ? ldg_u32(p.x + static_cast<long long>(row) * CIN + 8 * j + 2 * t)
                                 : 0u;
        }
      }
      mbar_wait(&full[s], (i >> 1) & 1);
      if constexpr (PRO) {
        float av[8], bv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) av[e] = s_ab[0][8 * (ct & 7) + e], bv[e] = s_ab[1][8 * (ct & 7) + e];
        prologue_rows<4>(smb + (st - w_u), st, 64 * c + (ct >> 3), ct & 7, av, bv);
        fence_proxy_async();
        named_sync(1 + c, 128);
      }
      // y, dyc and (cin = 64) dx, chunk by chunk of cout
#pragma unroll 1
      for (int cc = 0; cc < NC; ++cc) {
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_ss_n64<0, 1>(
                ya, smem_desc(st + kc * kBox + 64 * c * 128 + ks * 32, 1, 64),
                smem_desc(w_u + (cc * CIN + 64 * kc + 16 * ks) * 128, 1, 64), (kc | ks) != 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(ya);
        // dyc from dy in the stage, written back over it (zero past M: those
        // rows must add nothing to dw) and packed as A
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool ok = row0 + rl + 8 * h < p.M;
          const uint32_t row = dst + cc * kBox + (rl + 8 * h) * 128;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * cc + 8 * j + 2 * t;
            uint32_t* const at = reinterpret_cast<uint32_t*>(smb + (swz(row, 8 * j) - w_u) + 4 * t);
            const float2 d = unpack_bf16(*at);
            const float v0 = ok ? d.x + s_g[0][col] + 2.f * ya[4 * j + 2 * h] * s_g[1][col] : 0.f;
            const float v1 =
                ok ? d.y + s_g[0][col + 1] + 2.f * ya[4 * j + 2 * h + 1] * s_g[1][col + 1] : 0.f;
            const uint32_t pk = pack_bf16(v0, v1);
            *at = pk;
            dp[j >> 1][2 * (j & 1) + h] = pk;
          }
        }
        if (KC == 1) issue_dx(cc, 0, cc == 0);
      }
      if (KC > 1) issue_dx(0, 0, true);
      fence_proxy_async();
      named_sync(kBarBoth, 256);  // both warpgroups' dyc is in the stage
      // dw += xn^T dyc over the tile's rows, both MN-major from the stage
      const bool first = i == 0;
      wgmma_fence();
      if constexpr (kOwnRows) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n64<1, 1>(dw[0], smem_desc(st + (64 * c + 16 * kk) * 128, 1, 64),
                             smem_desc(dst + (64 * c + 16 * kk) * 128, 1, 64),
                             !(first && kk == 0));
      } else if constexpr (CIN == 64) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint64_t da_ = smem_desc(st + kk * 16 * 128, 1, 64);
          const uint64_t db_ = smem_desc(dst + c * (DW_N / 64) * kBox + kk * 16 * 128, kBox / 16, 64);
          mma_ss<DW_N, 1, 1>(dw[0], da_, db_, !(first && kk == 0));
        }
      } else {
#pragma unroll
        for (int m = 0; m < DW_M; ++m)
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            wgmma_ss_n64<1, 1>(dw[m], smem_desc(st + (c * DW_M + m) * kBox + kk * 16 * 128, 1, 64),
                               smem_desc(dst + kk * 16 * 128, 1, 64), !(first && kk == 0));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(dxa);
      named_sync(kBarBoth, 256);  // both warpgroups' dw has read x
      epilogue(st, 0, xr);
#pragma unroll 1
      for (int nc = 1; nc < KC; ++nc) {
        issue_dx(0, nc, true);
        wgmma_wait<0>();
        fence_operand(dxa);
        epilogue(st, nc, xr);
      }
      fence_proxy_async();
      named_sync(kBarBoth, 256);  // dx's tile is in the stage
      if (tid == 128) {
        // TMA drops the rows past M; the stage is free once the store has
        // read it
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) tma_store_2d(&map_dx, st + kc * kBox, 64 * kc, row0);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(&empty[s]);
      }
    }
    if (tid == 128) bulk_wait();  // the last stores have landed
#pragma unroll
    for (int m = 0; m < DW_M; ++m) fence_operand(dw[m]);

    // this CTA's dw partial(s); lane 4 g + t holds cin rows 16 warp + g (+ 8)
    // and cout columns 8 j + 2 t (+ 1) of each accumulator
    if (t1 > t0) {
      float* const part =
          p.part_dw + static_cast<long long>(kOwnRows ? 2 * blockIdx.x + c : blockIdx.x) * CIN * COUT;
#pragma unroll
      for (int m = 0; m < DW_M; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ci = (CIN == 64 ? 0 : 64 * (c * DW_M + m)) + 16 * warp + g + 8 * h;
          const int co0 = CIN == 64 && !kOwnRows ? c * DW_N : 0;
#pragma unroll
          for (int j = 0; j < DW_N / 8; ++j)
            *reinterpret_cast<float2*>(part + ci * COUT + co0 + 8 * j + 2 * t) =
                make_float2(dw[m][4 * j + 2 * h], dw[m][4 * j + 2 * h + 1]);
        }
    }
    if constexpr (PRO) {
      // da/db over the CTA's rows in a fixed order: the 8 row groups of a
      // warp by shuffles, then the 8 consumer warps through shared memory
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          da[j][e] = sum_rows8(da[j][e]);
          db[j][e] = sum_rows8(db[j][e]);
        }
      if (g == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            red[4 * c + warp][0][8 * j + 2 * t + e] = da[j][e];
            red[4 * c + warp][1][8 * j + 2 * t + e] = db[j][e];
          }
      }
      named_sync(kBarBoth, 256);
      if (tid - 128 < 2 * CIN) {
        const int which = (tid - 128) / CIN, cc = (tid - 128) % CIN;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) sum += red[w][which][cc];
        p.part_sums[(static_cast<long long>(blockIdx.x) * 2 + which) * CIN + cc] = sum;
      }
    }
  }
}

// 2-D tensor maps over a row-major [rows, cols] bf16 matrix: boxes of
// [box_rows][64 columns] with the 128-byte swizzle, zeros past the matrix.
bool map2d(CUtensorMap* map, const void* ptr, long long rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  return make_map(map, ptr, 2, dims, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// dynamic shared memory above 48 KB, opted into once per kernel
template <typename Kernel>
int opt_in(Kernel kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// k7_rows_kernel's persistent grid over N / BN column tiles of M rows: every
// tile, or the most CTAs up to one per SM that is a multiple of the column
// tiles
int rows_grid(int N, int BN, int M, int sms) {
  const int nt = N / BN, tiles = nt * ((M + kTileM - 1) / kTileM);
  return tiles <= sms ? tiles : sms / nt * nt;
}

template <int EPI, bool PRO, int BN>
int launch_rows(const CUtensorMap& ma, const CUtensorMap& mb, const CUtensorMap& me,
                const CUtensorMap& mo, const K7Args& p, int sms, cudaStream_t st) {
  const auto kernel = k7_rows_kernel<EPI, PRO, BN>;
  constexpr int bytes = RowsSmem<BN>::total;
  static const int attr = opt_in(kernel, bytes);
  RU_TRY(attr);
  kernel<<<rows_grid(EPI == kDx ? p.cin : p.cout, BN, p.M, sms), kBwdThreads, bytes, st>>>(
      ma, mb, me, mo, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool PRO, int BM, int BN>
int launch_dw(const CUtensorMap& mx, const CUtensorMap& md, const K7Args& p, int splits,
              cudaStream_t st) {
  const auto kernel = k7_dw_kernel<PRO, BM, BN>;
  constexpr int bytes = DwSmem<BM, BN>::total;
  static const int attr = opt_in(kernel, bytes);
  RU_TRY(attr);
  kernel<<<dim3((p.cin / BM) * (p.cout / BN), splits), kBwdThreads, bytes, st>>>(mx, md, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool PRO>
int dw_any(const CUtensorMap& mx, const CUtensorMap& md, const K7Args& p, int splits,
           cudaStream_t st) {
  const bool m128 = p.cin % 128 == 0, n128 = p.cout % 128 == 0;
  if (m128 && n128) return launch_dw<PRO, 128, 128>(mx, md, p, splits, st);
  if (m128) return launch_dw<PRO, 128, 64>(mx, md, p, splits, st);
  if (n128) return launch_dw<PRO, 64, 128>(mx, md, p, splits, st);
  return launch_dw<PRO, 64, 64>(mx, md, p, splits, st);
}

template <int CIN, int COUT, bool PRO>
int launch_onepass(const void* x, const void* w, const K7Args& p, cudaStream_t st) {
  CUtensorMap mx, mdy, mw, mdx;
  if (!map2d(&mx, x, p.M, CIN, kTileM) || !map2d(&mdy, p.dy, p.M, COUT, kTileM) ||
      !map2d(&mw, w, CIN, COUT, CIN) || !map2d(&mdx, p.dx, p.M, CIN, kTileM))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = k7_onepass_kernel<CIN, COUT, PRO>;
  constexpr int bytes = OneSmem<CIN, COUT>::total;
  static const int attr = opt_in(kernel, bytes);
  RU_TRY(attr);
  kernel<<<p.ctas, kBwdThreads, bytes, st>>>(mx, mdy, mw, mdx, p);
  return static_cast<int>(cudaGetLastError());
}

// The one pass at the shapes it takes (k7_bwd_plan's choice); -1 elsewhere.
int onepass_any(const void* x, const void* w, const K7Args& p, bool pro, cudaStream_t st) {
  const int key = p.cin * 1000 + p.cout;
  if (pro) {
    switch (key) {
      case 64064: return launch_onepass<64, 64, true>(x, w, p, st);
      case 64128: return launch_onepass<64, 128, true>(x, w, p, st);
      case 64256: return launch_onepass<64, 256, true>(x, w, p, st);
      default: return -1;
    }
  }
  switch (key) {
    case 64064: return launch_onepass<64, 64, false>(x, w, p, st);
    case 64128: return launch_onepass<64, 128, false>(x, w, p, st);
    case 64256: return launch_onepass<64, 256, false>(x, w, p, st);
    case 128064: return launch_onepass<128, 64, false>(x, w, p, st);
    case 256064: return launch_onepass<256, 64, false>(x, w, p, st);
    default: return -1;
  }
}

// K7's forward: k7_rows_kernel<kY> in 128 x BN tiles (k7_fwd_plan mirrors
// it); *parts: the s1/s2 partials it writes
template <bool PRO>
int launch_fwd(const void* w, void* y, const K7Args& p, int sms, int* parts, cudaStream_t st) {
  CUtensorMap ma, mb, mo;
  if (!map2d(&ma, p.x, p.M, p.cin, kTileM) || !map2d(&mb, w, p.cin, p.cout, 64) ||
      !map2d(&mo, y, p.M, p.cout, kTileM))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.cout % 128 == 0) {
    *parts = rows_grid(p.cout, 128, p.M, sms) / (p.cout / 128);
    return launch_rows<kY, PRO, 128>(ma, mb, ma, mo, p, sms, st);
  }
  *parts = rows_grid(p.cout, 64, p.M, sms) / (p.cout / 64);
  return launch_rows<kY, PRO, 64>(ma, mb, ma, mo, p, sms, st);
}

}  // namespace

// Forward of K7.
//   x [M, cin] bf16 (NHWC rows), w [cin, cout] bf16, a/b [cin] f32 or null,
//   y [M, cout] bf16, stats [2, cout] f32 (s1, s2); scratch part [P, 2,
//   cout] f32, P = rows_grid(cout, BN, M, sms) / (cout / BN) (BN = 128
//   where it divides cout, else 64): the s1/s2 partials, one per CTA of a
//   column tile.
extern "C" int resnet_unit_fwd(const void* x, const void* w, const float* a, const float* b,
                               void* y, float* part, float* stats, int M, int cin, int cout,
                               int sms, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((a == nullptr) != (b == nullptr) || M < 1 || cin < 64 || cin % 64 != 0 || cout < 64 ||
      cout % 64 != 0 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  K7Args p{};
  p.x = static_cast<const bf16*>(x);
  p.a = a, p.b = b;
  p.part_sums = part;
  p.M = M, p.cin = cin, p.cout = cout;
  int parts = 0;
  RU_TRY(a != nullptr ? launch_fwd<true>(w, y, p, sms, &parts, st)
                      : launch_fwd<false>(w, y, p, sms, &parts, st));
  return reduce4(part, stats, parts, 2LL * cout, st);
}

// Backward of K7.
//   x [M, cin], w [cin, cout], dy [M, cout] bf16; a/b [cin] f32 or null,
//   gs1/gs2 [cout] f32. Outputs dx [M, cin] bf16, dw [cin, cout] f32, dadb
//   [2, cin] f32 (da, db; with a prologue only).
//   ctas > 0: the one pass on a persistent grid of `ctas` CTAs; scratch
//     part_dw [ctas (2 ctas at 64 x 64), cin, cout], part_dx [ctas, 2, cin];
//     dyc unused (may be null).
//   ctas == 0: three passes, the row kernels on grids of at most `sms` CTAs
//     (rows_grid); scratch dyc [M, cout] bf16, part_dx [rows_grid(cin, BN,
//     M, sms) / (cin / BN), 2, cin] (BN = 128 where it divides cin, else
//     64), part_dw [splits, cin, cout]; splits chunks of ksplit rows (a
//     multiple of 64) cover M.
extern "C" int resnet_unit_bwd(const void* x, const void* w, const float* a, const float* b,
                               const void* dy, const float* gs1, const float* gs2, void* dyc,
                               void* dx, float* part_dx, float* dadb, float* part_dw, float* dw,
                               int M, int cin, int cout, int ctas, int sms, int splits,
                               int ksplit, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pro = a != nullptr;
  if ((pro && b == nullptr) || M < 1 || cin < 64 || cin % 64 != 0 || cout < 64 ||
      cout % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  K7Args p{};
  p.x = static_cast<const bf16*>(x);
  p.a = a, p.b = b;
  p.dy = static_cast<const bf16*>(dy);
  p.gs1 = gs1, p.gs2 = gs2;
  p.dyc = static_cast<bf16*>(dyc);
  p.dx = static_cast<bf16*>(dx);
  p.part_sums = part_dx, p.part_dw = part_dw;
  p.M = M, p.cin = cin, p.cout = cout;
  p.ctas = ctas, p.ksplit = ksplit;
  if (ctas > 0) {
    if (ctas > (M + kTileM - 1) / kTileM) return static_cast<int>(cudaErrorInvalidValue);
    const int rc = onepass_any(x, w, p, pro, st);
    if (rc < 0) return static_cast<int>(cudaErrorInvalidValue);
    RU_TRY(rc);
    const int parts = cin == 64 && cout == 64 ? 2 * ctas : ctas;
    RU_TRY(reduce4(part_dw, dw, parts, static_cast<long long>(cin) * cout, st));
    return pro ? reduce4(part_dx, dadb, ctas, 2LL * cin, st) : 0;
  }
  if (sms < 1 || ksplit < kDwRows || ksplit % kDwRows != 0 || splits < 1 ||
      static_cast<long long>(splits) * ksplit < M || static_cast<long long>(splits - 1) * ksplit >= M)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bn_dyc = cout % 128 == 0 ? 128 : 64, bn_dx = cin % 128 == 0 ? 128 : 64;
  CUtensorMap m_x, m_dy, m_wy, m_dyc, m_wx, m_dx, m_xd, m_dd;
  if (!map2d(&m_x, x, M, cin, kTileM) || !map2d(&m_dy, dy, M, cout, kTileM) ||
      !map2d(&m_dx, dx, M, cin, kTileM) ||
      !map2d(&m_wy, w, cin, cout, 64) || !map2d(&m_dyc, dyc, M, cout, kTileM) ||
      !map2d(&m_wx, w, cin, cout, bn_dx) || !map2d(&m_xd, x, M, cin, kDwRows) ||
      !map2d(&m_dd, dyc, M, cout, kDwRows))
    return static_cast<int>(cudaErrorInvalidValue);
  // 1. dyc, recomputing y
  if (pro)
    RU_TRY((bn_dyc == 128 ? launch_rows<kDyc, true, 128>(m_x, m_wy, m_dy, m_dyc, p, sms, st)
                         : launch_rows<kDyc, true, 64>(m_x, m_wy, m_dy, m_dyc, p, sms, st)));
  else
    RU_TRY((bn_dyc == 128 ? launch_rows<kDyc, false, 128>(m_x, m_wy, m_dy, m_dyc, p, sms, st)
                         : launch_rows<kDyc, false, 64>(m_x, m_wy, m_dy, m_dyc, p, sms, st)));
  // 2. dx (with the mask, da/db partials)
  if (pro)
    RU_TRY((bn_dx == 128 ? launch_rows<kDx, true, 128>(m_dyc, m_wx, m_x, m_dx, p, sms, st)
                        : launch_rows<kDx, true, 64>(m_dyc, m_wx, m_x, m_dx, p, sms, st)));
  else
    RU_TRY((bn_dx == 128 ? launch_rows<kDx, false, 128>(m_dyc, m_wx, m_x, m_dx, p, sms, st)
                        : launch_rows<kDx, false, 64>(m_dyc, m_wx, m_x, m_dx, p, sms, st)));
  // 3. dw partials per row split, then their sum
  if (pro)
    RU_TRY((dw_any<true>(m_xd, m_dd, p, splits, st)));
  else
    RU_TRY((dw_any<false>(m_xd, m_dd, p, splits, st)));
  RU_TRY(reduce4(part_dw, dw, splits, static_cast<long long>(cin) * cout, st));
  if (pro) RU_TRY(reduce4(part_dx, dadb, rows_grid(cin, bn_dx, M, sms) / (cin / bn_dx), 2LL * cin, st));
  return 0;
}
