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
// kernel reads the int8 bytes once and converts them in registers; it never
// writes a dense copy of q.
//
// The rounding points are the plain version's (ops/hopper/int8_matmul.py
// `int8_matmul_plain`): in bf16 the f32 sum is rounded to bf16, then
// multiplied by s rounded to bf16 and rounded again; in f32, sum * s.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16): a decode step (M <=
// 16 rows) does 2 M operations a weight byte, far under the ~295 a byte the
// tensor cores need, so it is bound by the int8 bytes of q: every SM must
// keep streaming. A 512-row prefill chunk does 1,024 a byte and is bound by
// operations: the tensor cores must be fed bf16 although q arrives as int8
// and has to be converted first, and the 128-row tiles of x, which every
// column tile reads again, must come from L2 fast enough.
//
// Design (bf16 activations, `int8_mm_wgmma_kernel<BM>`, every row count):
// the product runs with its operands swapped, out^T = q^T x^T (design "ii"):
// a tile of q^T is wgmma's A, from registers, and x is its B, from shared
// memory, K-major as it lies in memory. So the token rows are wgmma's N, any
// multiple of 8 up to 256: BM = 8, 16, 32, 64 or 128 rows a tile, and one
// body serves decode and prefill alike.
// - A CTA is WG consumer warpgroups and a producer. Warpgroup c owns 128
//   columns of q (two m64 A tiles); all share the CTA's BM rows of x (Cfg):
//   decode tiles (BM < 64) take 1 warpgroup and a producer warp, 3 CTAs an
//   SM, since there the conversion sets the pace and only more warps hide its
//   latency; prefill tiles take 2 warpgroups, so that each stage of x serves
//   256 columns (half the L2 reads of x), and a producer warpgroup that gives
//   its registers to the consumers (setmaxnreg: 232 a consumer thread, whose
//   accumulators alone are BM; all consumer code lies after the setmaxnreg,
//   or ptxas compiles it to the launch's 168 and serialises the wgmma,
//   C7512).
// - The producer's one thread keeps TMA loads in flight through a ring of
//   stages on mbarriers: a stage is 64 of K, a [64][128] int8 box of q per
//   warpgroup and a [BM][64] bf16 box of x, both with the 128-byte swizzle
//   (the boxes past N, M or K read zeros).
// - A consumer thread reads 4 adjacent columns of q at one k as one 32-bit
//   word of shared memory (no bank conflict under the swizzle) and turns each
//   byte into a float by __byte_perm into the mantissa of 2^23 and one
//   subtraction; two such floats are an exact bf16 pair by one more
//   __byte_perm (|q| <= 127 is exact in bf16). The A rows are interleaved so
//   that the word's 4 columns are the thread's 4 A rows of the two m64 tiles
//   (rows g and g + 8 of each): a thread's accumulators of one token row are
//   4 adjacent output columns, one 8-byte store.
// - A stage runs in two halves of 32 of K, each converted into its own 16
//   registers of A and issued as one group of 4 wgmma m64nBMk16: one half's
//   products run while the next half is converted (wgmma_wait<1>; ptxas
//   serialises a deeper ring of A registers, C7513).
// - Tiles run with M innermost (grid y = n tile * m tiles + m tile): the CTAs
//   that read one column tile of q are neighbours in launch order and share
//   it through L2 (the 131 MB head is larger than the 50 MB L2).
// - Where the tiles do not fill the card, K is split over the CTAs of a
//   thread-block cluster (grid x = split, cluster (splits, 1, 1), at most 8):
//   each CTA puts its f32 partial sums in its own shared memory, and after a
//   cluster barrier CTA z adds up the z-th slice of the tile from every CTA's
//   shared memory in split order and writes the epilogue. One launch, no
//   workspace and no counter: calls on two streams or inside a CUDA-graph
//   capture share nothing, and two calls give equal bits.
// Why (ii) and not (i), converting q once into a bf16 B tile in shared memory
// for wgmma with both operands from shared memory: (i) adds a 32 KB store and
// a fence to each 128 x 256 stage beside the 48 KB that TMA and wgmma move,
// at 512 rows, where the loads from L2 already take most of the time (on an
// H100 at 11008 -> 4096, a variant without the products took 0.066 ms of the
// kernel's 0.083: scripts/k10_variants.py);
// (ii) moves each converted value once, in registers, and serves decode with
// the same body, where (i) would pad 8 rows to wgmma's 64. (i) was not built.
//
// f32 activations (`int8_mm_f32_kernel`, the f32 parity checks): a plain tiled
// CUDA-core product, 64 x 64 outputs a CTA, 4 x 4 a thread, 16-row K stages
// with q converted to f32 in shared memory, fmaf in K order.
//
// Contract (checked by the wrapper, which raises): x and out contiguous, q
// contiguous int8 [K, N], s f32 [N]; N % 16 == 0 and K % 8 == 0; every base
// pointer 16-byte aligned. Interface: plain C, loaded with ctypes; returns the
// cudaError_t of the launch. The tensor map of q is kept per weight (its
// pointer and shape; encoding one costs host time every call), x's is
// encoded per call.

#include "sm90.cuh"

#include <mutex>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kCols = 128;            // columns of q a consumer warpgroup
constexpr int kBK = 64;               // K a stage
constexpr int kQBox = kBK * kCols;    // a [64][128] int8 box of q: 8 KB
constexpr int kMaxSplits = 8;         // a portable cluster

constexpr int kFThreads = 256;
constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

// The launch of int8_mm_wgmma_kernel<BM>. Prefill tiles (BM >= 64) take 2
// consumer warpgroups (each stage of x serves 256 columns of q) and a
// producer warpgroup, which gives its registers to the consumers
// (setmaxnreg): their accumulators alone are BM registers a thread; one CTA
// an SM. Decode tiles take 1 consumer warpgroup and one producer warp, 3
// CTAs an SM: there the conversion sets the pace, and more warps hide its
// latency.
template <int BM>
struct Cfg {
  static constexpr bool big = BM >= 64;
  static constexpr int WG = big ? 2 : 1;
  static constexpr int consumers = 128 * WG;
  static constexpr int threads = consumers + (big ? 128 : 32);
  static constexpr int ctas = big ? 1 : 3;  // an SM
  static constexpr int producer_regs = 40;
  static constexpr int consumer_regs = (65536 / ctas - 128 * producer_regs) / consumers / 8 * 8;
  static constexpr int q = WG * kQBox;
  static constexpr int x = BM * 128;  // [BM rows][64 of K] bf16
  static constexpr int stage = q + x;
  static constexpr int budget = big ? 196 * 1024 : 72 * 1024;
  static constexpr int stages = budget / stage > 8 ? 8 : budget / stage;
  // split partials: f32 [BM][WG 128] rows padded by 16 bytes (no bank
  // conflict between the 4 rows of a store), over the drained ring
  static constexpr int part_row = WG * kCols + 4;
  static constexpr int part = BM * part_row * 4;
  static constexpr int total = 1024 + (stages * stage > part ? stages * stage : part);
  static_assert(stages >= 4 && consumer_regs <= 256, "launch does not fit");
};

// one arrival per consumer warp on a stage's `empty` barrier
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// byte J of u (an int8 with its sign bit flipped, i.e. q + 128) as the float q
template <int J>
__device__ __forceinline__ float byte_to_f32(uint32_t u) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | J)) - 8388736.0f;
}

// two floats that bf16 holds exactly (their low 16 bits are zero) as one bf16
// pair, the first in the lower half
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// wgmma m64nNk16 with A from registers for the N that sm90.cuh lacks (8, 16,
// 32), accumulating; the fragments are those of wgmma_rs_n64 there
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B)
      : "memory");
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B)
      : "memory");
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B)
      : "memory");
}

// D[64 x BM] += A B, A from registers, B = x K-major from shared memory
template <int BM>
__device__ __forceinline__ void mma_rs(float (&d)[BM / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (BM == 8)
    wgmma_rs_n8<0>(d, a, db);
  else if constexpr (BM == 16)
    wgmma_rs_n16<0>(d, a, db);
  else if constexpr (BM == 32)
    wgmma_rs_n32<0>(d, a, db);
  else if constexpr (BM == 64)
    wgmma_rs_n64<0>(d, a, db, 1);
  else
    wgmma_rs_n128<0>(d, a, db, 1);
}

// thread-block clusters: a barrier over every thread of the cluster (release
// and acquire), and a 16-byte load from the shared memory of CTA `rank`
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// 4 adjacent outputs of one row: the plain version's rounding points (sb: the
// scales rounded to bf16)
__device__ __forceinline__ void store4_bf16(bf16* dst, float v0, float v1, float v2, float v3,
                                            const float4& sb) {
  const uint2 w = make_uint2(pack_bf16(round_bf16(v0) * sb.x, round_bf16(v1) * sb.y),
                             pack_bf16(round_bf16(v2) * sb.z, round_bf16(v3) * sb.w));
  *reinterpret_cast<uint2*>(dst) = w;
}

__device__ __forceinline__ float4 scales_bf16(const float* s) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(s));
  return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
}

// The A registers of 32 of K (two k16 steps kk, both m64 tiles p) from the
// q box rows at `qs` (the thread's row 2 t of the half; off0, off1 its word's
// byte offsets in rows of swizzle phase 2 t and 2 t + 1). Tile p: a[0] is
// column 2 p at k 2 t, 2 t + 1, a[1] column 2 p + 1, a[2] and a[3] the same
// at k 2 t + 8, 2 t + 9.
__device__ __forceinline__ void convert_half(uint32_t (&a)[2][2][4], const unsigned char* qs,
                                             int off0, int off1) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const unsigned char* qr = qs + kk * 16 * 128;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(qr + off0) ^ 0x80808080u;
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(qr + 128 + off1) ^ 0x80808080u;
    const uint32_t w8 = *reinterpret_cast<const uint32_t*>(qr + 8 * 128 + off0) ^ 0x80808080u;
    const uint32_t w9 = *reinterpret_cast<const uint32_t*>(qr + 9 * 128 + off1) ^ 0x80808080u;
    a[kk][0][0] = pack_exact(byte_to_f32<0>(w0), byte_to_f32<0>(w1));
    a[kk][0][1] = pack_exact(byte_to_f32<1>(w0), byte_to_f32<1>(w1));
    a[kk][0][2] = pack_exact(byte_to_f32<0>(w8), byte_to_f32<0>(w9));
    a[kk][0][3] = pack_exact(byte_to_f32<1>(w8), byte_to_f32<1>(w9));
    a[kk][1][0] = pack_exact(byte_to_f32<2>(w0), byte_to_f32<2>(w1));
    a[kk][1][1] = pack_exact(byte_to_f32<3>(w0), byte_to_f32<3>(w1));
    a[kk][1][2] = pack_exact(byte_to_f32<2>(w8), byte_to_f32<2>(w9));
    a[kk][1][3] = pack_exact(byte_to_f32<3>(w8), byte_to_f32<3>(w9));
  }
}

// The products of 32 of K as one wgmma group: x's rows K-major at shared
// address `xb` (32 bytes a k16 step, 8-row groups 1024 bytes apart).
template <int BM>
__device__ __forceinline__ void issue_half(float (&acc)[2][BM / 2], const uint32_t (&a)[2][2][4],
                                           uint32_t xb) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const uint64_t db = smem_desc(xb + kk * 32, 1, 64);
    mma_rs<BM>(acc[0], a[kk][0], db);
    mma_rs<BM>(acc[1], a[kk][1], db);
  }
  wgmma_commit();
}

// grid (splits, n tiles x m tiles), tile y = n tile * mt + m tile; split z
// takes the K stages [z per, min((z + 1) per, ceil(K / 64))), every one
// non-empty. splits > 1: launched as clusters of (splits, 1, 1).
template <int BM>
__global__ void __launch_bounds__(Cfg<BM>::threads, Cfg<BM>::ctas)
    int8_mm_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_x, const float* __restrict__ s,
                         bf16* __restrict__ out, int M, int N, int K, int mt, int per) {
  using Sm = Cfg<BM>;
  constexpr int WG = Sm::WG;
  constexpr int S = Sm::stages;
  constexpr int kConsumers = Sm::consumers;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  unsigned char* const smb = align1024(smem_raw);
  const uint32_t base = smem_u32(smb);
  const int tid = threadIdx.x;
  const int split = blockIdx.x, splits = gridDim.x;
  const int m0 = (blockIdx.y % mt) * BM, n0 = (blockIdx.y / mt) * (WG * kCols);
  const int c_begin = split * per;
  const int count = min((K + kBK - 1) / kBK, c_begin + per) - c_begin;
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < S; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * WG);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer: one thread issues every load; all of them take part in
    // the cluster barriers of a split
    if constexpr (Sm::big) setmaxnreg_dec<Sm::producer_regs>();
    if (tid == kConsumers) {
      prefetch_map(&map_q);
      prefetch_map(&map_x);
      for (int i = 0; i < count; ++i) {
        const int st = i % S;
        if (i >= S) mbar_wait(&empty[st], ((i / S) & 1) ^ 1);
        const uint32_t at = base + st * Sm::stage;
        const int k0 = (c_begin + i) * kBK;
        mbar_expect_tx(&full[st], Sm::stage);
#pragma unroll
        for (int w = 0; w < WG; ++w) tma_2d(at + w * kQBox, &map_q, &full[st], n0 + w * kCols, k0);
        tma_2d(at + Sm::q, &map_x, &full[st], k0, m0);
      }
    }
    if (splits > 1) {
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // the consumers, from here to the end (the register budget that
  // setmaxnreg gives them holds in this region only). Thread: warpgroup c,
  // warp w, lane 4 g + t; its 4 columns of q are the warpgroup's columns
  // col4 .. col4 + 3 (A rows g, g + 8 of the two m64 tiles p: column col4 +
  // 2 p + h is row 16 w + g + 8 h of tile p)
  if constexpr (Sm::big) setmaxnreg_inc<Sm::consumer_regs>();
  const int c = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col4 = 4 * (8 * warp + g);
  float acc[2][BM / 2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int e = 0; e < BM / 2; ++e) acc[p][e] = 0.0f;
  fence_operand(acc[0]);
  fence_operand(acc[1]);
  // byte offsets of the thread's word in a swizzled 128-byte row of q whose
  // swizzle phase is 2 t (rows k, k + 8) or 2 t + 1 (rows k + 1, k + 9)
  const int chunk = col4 >> 4, in_chunk = col4 & 15;
  const int off0 = (((chunk ^ (2 * t)) & 7) << 4) + in_chunk;
  const int off1 = (((chunk ^ (2 * t + 1)) & 7) << 4) + in_chunk;
  // a stage in two halves of 32 of K, each converted into its own A
  // registers and issued as one group of 4 wgmma: one half's products run
  // while the next half is converted, and a half's registers are written
  // again only after its group is done (wgmma_wait<1> after the next
  // group's commit); a stage goes back to the producer once its second
  // half is done
  uint32_t a0[2][2][4], a1[2][2][4];
  for (int i = 0; i < count; ++i) {
    const int st = i % S;
    const uint32_t at = base + st * Sm::stage;
    mbar_wait(&full[st], (i / S) & 1);
    const unsigned char* qs = smb + st * Sm::stage + c * kQBox + 2 * t * 128;
    convert_half(a0, qs, off0, off1);
    issue_half<BM>(acc, a0, at + Sm::q);
    wgmma_wait<1>();  // the previous stage's second half is done
    if (i > 0) release(&empty[(i - 1) % S]);
    convert_half(a1, qs + 32 * 128, off0, off1);
    issue_half<BM>(acc, a1, at + Sm::q + 64);
    wgmma_wait<1>();  // this stage's first half is done: a0 is free
  }
  wgmma_wait<0>();
  fence_operand(acc[0]);
  fence_operand(acc[1]);
  if (count > 0) release(&empty[(count - 1) % S]);

  // accumulator fragment: acc[p][4 j + 2 h + e] is column col4 + 2 p + h of
  // the warpgroup, token row 8 j + 2 t + e of the tile
  const int n = n0 + c * kCols + col4;
  if (splits == 1) {
    if (n >= N) return;
    const float4 sb = scales_bf16(s + n);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t + e;
        if (m < M)
          store4_bf16(out + static_cast<size_t>(m) * N + n, acc[0][4 * j + e],
                      acc[0][4 * j + 2 + e], acc[1][4 * j + e], acc[1][4 * j + 2 + e], sb);
      }
    return;
  }

  // split K: partials into this CTA's shared memory (once every consumer is
  // past its last stage: the ring is free), then CTA z reduces 16-byte units
  // z kConsumers + tid, + splits kConsumers, ... of the tile over the cluster
  float* const part = reinterpret_cast<float*>(smb);
  named_sync(1, kConsumers);
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float4*>(part + (8 * j + 2 * t + e) * Sm::part_row + c * kCols + col4) =
          make_float4(acc[0][4 * j + e], acc[0][4 * j + 2 + e], acc[1][4 * j + e],
                      acc[1][4 * j + 2 + e]);
  cluster_sync();
  constexpr int kRowUnits = WG * kCols / 4;
  for (int u = split * kConsumers + tid; u < BM * kRowUnits; u += splits * kConsumers) {
    const int r = u / kRowUnits, col = 4 * (u % kRowUnits);
    const int m = m0 + r, nn = n0 + col;
    if (m >= M || nn >= N) continue;
    const uint32_t addr = base + (r * Sm::part_row + col) * 4;
    float4 v = ld_cluster_f4(addr, 0);
    for (int z = 1; z < splits; ++z) {
      const float4 w = ld_cluster_f4(addr, z);
      v.x += w.x, v.y += w.y, v.z += w.z, v.w += w.w;
    }
    store4_bf16(out + static_cast<size_t>(m) * N + nn, v.x, v.y, v.z, v.w, scales_bf16(s + nn));
  }
  cluster_sync();  // no CTA leaves while another reads its shared memory
}

// grid (ceil(N / 64), ceil(M / 64)), 256 threads of 4 x 4 outputs
__global__ void __launch_bounds__(kFThreads)
    int8_mm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ s, float* __restrict__ out, int M, int N,
                       int K) {
  __shared__ float xs[kFBK][kFBM + 4];
  __shared__ float qs[kFBK][kFBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kFBN, m0 = blockIdx.y * kFBM;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFBK) {
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
  const float4 sc = *reinterpret_cast<const float4*>(s + n);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    *reinterpret_cast<float4*>(out + (size_t)m * N + n) = make_float4(
        acc[i][0] * sc.x, acc[i][1] * sc.y, acc[i][2] * sc.z, acc[i][3] * sc.w);
  }
}

// A 2-D tensor map over a row-major [outer, inner] matrix of `bytes`-byte
// elements: boxes [box_outer][box_inner] with the 128-byte swizzle, zeros
// past the matrix.
bool map_2d(CUtensorMap* map, CUtensorMapDataType type, int bytes, const void* ptr,
            cuuint64_t inner, cuuint64_t outer, cuuint32_t box_inner, cuuint32_t box_outer) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t ones[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q's tensor maps by (pointer, N, K), direct-mapped: a map is a function of
// its key alone, so an entry that another weight displaced is encoded again
// and one left by a freed weight is still right for a new weight at its
// address. Calls from several threads take the lock.
struct QMap {
  const void* ptr = nullptr;
  int n = 0, k = 0;
  CUtensorMap map;
};
constexpr int kQMaps = 1024;
QMap g_qmaps[kQMaps];
std::mutex g_qmaps_mu;

bool q_map(CUtensorMap* map, const void* q, int N, int K) {
  const uint64_t key = reinterpret_cast<uint64_t>(q);
  QMap& e = g_qmaps[((key >> 8) * 0x9E3779B97F4A7C15ull) >> 54];
  std::lock_guard<std::mutex> lock(g_qmaps_mu);
  if (e.ptr != q || e.n != N || e.k != K) {
    if (!map_2d(&e.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, N, K, kCols, kBK)) {
      e.ptr = nullptr;
      return false;
    }
    e.ptr = q, e.n = N, e.k = K;
  }
  *map = e.map;
  return true;
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int BM>
cudaError_t launch_wgmma(const void* x, const void* q, const float* s, void* out, int M, int N,
                         int K, int splits, int per, cudaStream_t st) {
  using C = Cfg<BM>;
  const auto kernel = int8_mm_wgmma_kernel<BM>;
  constexpr int bytes = C::total;
  static const cudaError_t attr = opt_in(kernel, bytes);
  if (attr != cudaSuccess) return attr;
  CUtensorMap mq, mx;
  if (!q_map(&mq, q, N, K) ||
      !map_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, kBK, BM))
    return cudaErrorInvalidValue;
  const int mt = (M + BM - 1) / BM, nt = (N + C::WG * kCols - 1) / (C::WG * kCols);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, mt * nt);
  cfg.blockDim = dim3(C::threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, mq, mx, s, static_cast<bf16*>(out), M, N, K, mt, per);
}

cudaError_t launch_bf16(const void* x, const void* q, const float* s, void* out, int M, int N,
                        int K, int bm, int splits, int per, cudaStream_t st) {
  switch (bm) {
    case 8: return launch_wgmma<8>(x, q, s, out, M, N, K, splits, per, st);
    case 16: return launch_wgmma<16>(x, q, s, out, M, N, K, splits, per, st);
    case 32: return launch_wgmma<32>(x, q, s, out, M, N, K, splits, per, st);
    case 64: return launch_wgmma<64>(x, q, s, out, M, N, K, splits, per, st);
    case 128: return launch_wgmma<128>(x, q, s, out, M, N, K, splits, per, st);
    default: return cudaErrorInvalidValue;
  }
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

// x [M, K] (f32 or bf16), q int8 [K, N], s f32 [N], out [M, N] in x's dtype.
// plan (int8_matmul_plan's "code"): bits 0-11 per (K stages of 64 a split),
// 12-15 splits, 16-23 BM, 28 the dtype (0 f32, 1 bf16); the f32 body takes
// no split. The launch goes to `device` on `stream`; M == 0 launches
// nothing.
extern "C" int int8_matmul_launch(const void* x, const void* q, const void* s, void* out, int M,
                                  int N, int K, int plan, int device, void* stream) {
  const int per = plan & 0xFFF, splits = (plan >> 12) & 0xF, bm = (plan >> 16) & 0xFF,
            dtype = plan >> 28;
  const int stages = (K + kBK - 1) / kBK;
  if (M < 0 || N < 16 || N % 16 != 0 || K < 8 || K % 8 != 0 || dtype < 0 || dtype > 1 ||
      (dtype == 1 && (splits < 1 || splits > kMaxSplits || per < 1 ||
                      (splits - 1) * per >= stages || splits * per < stages)))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  CurrentDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(s);
  if (dtype == 1) return (int)launch_bf16(x, q, sc, out, M, N, K, bm, splits, per, st);
  const dim3 grid((N + kFBN - 1) / kFBN, (M + kFBM - 1) / kFBM);
  int8_mm_f32_kernel<<<grid, kFThreads, 0, st>>>(static_cast<const float*>(x),
                                                  static_cast<const int8_t*>(q), sc,
                                                  static_cast<float*>(out), M, N, K);
  return (int)cudaGetLastError();
}
