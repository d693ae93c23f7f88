// K8 for NVIDIA Hopper (sm_90a): the fused 3x3 conv (stride 1, pad 1) +
// BatchNorm-statistics unit of the port, forward and backward.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/resnet_unit.py:
//   forward   `_conv3_fwd_impl` -> `_conv3_fwd_kernel`   (conv3x3_bn_fwd)
//   backward  `_conv3_bwd_impl` -> `_conv3_bwd_kernel`   (conv3x3_bn_bwd)
// Function (NHWC, bf16 activations and weights, f32 accumulation):
//   xn  = bf16(relu(x a + b)), zero in the halo  (the Pallas kernels pad
//                                                  after the prologue)
//   y[q] = sum_t xn[q + s_t] w_t               forward, t = 3 di + dj
//   s1 = sum_q y[q], s2 = sum_q y[q]^2          from the f32 sums, before y
//                                                is rounded to bf16
// and from the saved forward output y:
//   dyc = bf16(dy + gs1 + 2 y gs2)          the statistics' cotangents folded in
//   dw[t] = sum_q xn[q]^T dyc[q - s_t]      f32
//   dxn[q] = sum_t dyc[q - s_t] w_t^T       the correlation with the flipped taps
//   du = dxn [u > 0], dx = bf16(du a), da = sum(du x), db = sum(du)
// where s_t = (di - 1, dj - 1) is tap t's offset and xn, dyc are zero
// outside the image. The forward reads xn shifted by +s_t, both products
// of the backward read dyc shifted by -s_t, each against an unshifted
// operand at the output position q.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at ResNet-50's
// three stride-1 3x3 shapes (batch 256: 56^2 x 64, 28^2 x 128, 14^2 x 256)
// each product does 29.6 G multiply-adds, ~0.06 ms of tensor-core time,
// about as long as moving its activations once: the forward's x and y take
// 0.061 ms at 56^2 x 64 (bytes bound it there, operations at the others),
// the backward's x, y, dy and dx twice that. The kernels they replace took
// 6-16x that: the first forms ran a generic row GEMM over 9 taps, which
// re-copied a shifted 128-row tile of x (or dyc) for every tap and
// channel-tile pair, re-applied the prologue to each copy, and multiplied
// with mma.sync; the backward's dw CTAs each owned one tap and streamed x and
// dyc nine times over.
//
// Design. A work item is a band: R whole image rows of one image (or a piece
// of Wp columns of them, for wide images), held in shared memory with one
// halo row above and below and one halo column on each side, so a band row
// has P = Wp + 2 positions. Every tap is then a flat shift of the band's
// positions, di P + dj slots into the forward's xn window and (2 - di) P +
// (2 - dj) into the backward's dyc window, with no per-row halo test. The
// two pad columns of each band row are computed and discarded (3.4% more
// work at W = 56, 12.5% at W = 14). A window is stored chunk-major
// ([8-channel chunk][position][16 bytes]): any 8 consecutive positions of a
// chunk are one contiguous 128-byte core matrix, so a tap's shifted operand
// is a plain (unswizzled) wgmma descriptor at any position, and every
// product reads both operands from shared memory: each band's wgmma steps
// issue back to back, with nothing in registers to wait for. A band arrives
// by TMA: a 5-D box [1, R + 2, P, 1, 8] of x or dyc per chunk (and a 4-D box
// [1, R, P, 64] of x, 128-byte swizzle, where x is wgmma's other operand),
// whose out-of-image rows and columns the hardware fills with zeros; one
// thread issues the next band's boxes while the CTA computes on this one,
// and an mbarrier says when they have landed. Grids are persistent: each
// CTA owns a channel tile and walks a contiguous range of bands
// (conv3_band_plan and group_range mirror the Python plan in
// ops/hopper/resnet_unit.py; the forward takes the plan at cin).
//   conv3_fwd_band_kernel one 64-wide cout tile of a band's positions per CTA
//                         (two warpgroups of two m64 tiles), K = 9 taps x cin
//                         in 64-wide chunks: x's window arrives raw and takes
//                         the prologue once per band and chunk, in shared
//                         memory, four slots a thread at a time; the slots
//                         outside the image keep TMA's zeros (relu(b) is not
//                         zero). wgmma takes the xn window shifted
//                         (K-major, plain) and w_t [cin chunk x cout tile]
//                         (MN-major, 128-byte swizzle: w9's own layout); at
//                         cin = 64 the whole w9 tile stays resident, above it
//                         each chunk rides with its window. Epilogue: y
//                         rounded and stored, and the s1/s2 partials summed
//                         from the f32 accumulators, for interior positions
//                         only (not the pad columns, not past a short band).
//   conv3_dyc_kernel      dyc, elementwise: read by both backward products,
//                         so it is written once instead of being recomputed
//                         in both.
//   conv3_dw_band_kernel  one 64 (cin) x 64 (cout) tile of all nine taps per
//                         CTA, the nine f32 accumulators in registers: three
//                         warpgroups, one tap row di each, three taps a
//                         warpgroup. Per band it reads x and dyc once and
//                         applies the prologue once, in shared memory, while
//                         the previous band's products run; per tap, wgmma
//                         takes xn^T (MN-major, 128-byte swizzle, shared by
//                         all nine taps) and dyc shifted (MN-major, plain).
//                         One [9, 64, 64] partial per CTA.
//   conv3_dx_band_kernel  one 64-wide cin tile of a band's positions per CTA
//                         (two warpgroups of two m64 tiles), K = 9 taps x
//                         cout in 64-wide chunks: wgmma takes dyc shifted
//                         (K-major, plain) and w_t (K-major, 128-byte
//                         swizzle); at cout = 64 the whole w9 tile stays
//                         resident, above it each chunk rides with its dyc
//                         window. Epilogue: x loaded into registers before
//                         the band's last products, the mask from u = x a +
//                         b, dx = du a, da/db partials per CTA.
//   conv3_reduce_kernel   out[c] = sum_g part[g][c] in a fixed order (s1/s2
//                         over the forward's CTAs, dw over the dw CTAs of a
//                         tile, da/db over the dx CTAs).
// No atomics: the results are deterministic.
//
// What bounds the forward as built (clock64 phase timers on an H100, per band
// at 56^2 x 64): the products take ~4.6k cycles, the tensor cores' own time,
// but a warpgroup that issues wgmma waits until the tensor cores have taken
// them, so the prologue of the next unit (~3k) and the epilogue (~2.3k) run
// after them rather than beside them. Giving the TMA and the prologue a
// warpgroup of their own did not help: with both operands read from shared
// memory, the products use most of its bandwidth and the prologue slowed to
// twice its time (PERF.md has the steps tried).
//
// Interface: plain C, loaded with ctypes. The caller allocates outputs and
// scratch, checks shapes, dtypes, devices, contiguity and 16-byte alignment,
// and picks the band shape; conv3x3_bn_fwd and conv3x3_bn_bwd return the
// first cudaError_t (or cudaErrorInvalidValue when a tensor map cannot be
// made).

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 64;                // channels of a tile: one 128-byte smem row
constexpr int kDwThreads = 384;       // 3 warpgroups
constexpr int kDxThreads = 256;       // 2 warpgroups (the forward's too)
constexpr int kDxMaxM = 256;          // band positions of a dx or forward CTA: 2 warpgroups x 2 m64 tiles
constexpr int kWElems = 9 * kC * kC;  // the nine 64 x 64 weight tiles of a chunk
// dynamic shared memory a block takes: the H100's 227 KB less room for the
// kernels' static shared memory (dx: its da/db reduction, a, b, barriers;
// the forward: its s1/s2 reduction, barriers)
constexpr int kSmemDynamic = 232448 - 5120;

// Band geometry (mirrors conv3_band_geometry / conv3_bands in resnet_unit.py).
struct Geo {
  int n, h, w;        // images
  int R, Wp, P;       // band rows, band columns, positions per band row (Wp + 2)
  int Mp, Md, V;      // positions dw sums per band (R P up to a multiple of 16)
                      // and dx and the forward compute (up to a multiple of
                      // 64, wgmma's M), window slots (Md + 2 P + 2)
  int bh, bw, bands;  // bands down an image, across it, in all
};

Geo make_geo(int n, int h, int w, int R, int Wp) {
  Geo g;
  g.n = n, g.h = h, g.w = w, g.R = R, g.Wp = Wp, g.P = Wp + 2;
  g.Mp = (R * g.P + 15) / 16 * 16;
  g.Md = (R * g.P + 63) / 64 * 64;
  g.V = g.Md + 2 * g.P + 2;
  g.bh = (h + R - 1) / R, g.bw = (w + Wp - 1) / Wp;
  g.bands = n * g.bh * g.bw;
  return g;
}

// Shared-memory layout from the 1024-byte aligned base (mirrors conv3_smem in
// resnet_unit.py):
//   dw: two stages of [Mp] xn rows, then the window.
//   dx and the forward: the weight tiles (one or two copies), then two
//   windows; the forward's is dx_smem at cin (its chunks run over cin).
// A window (dyc, or the forward's xn) is chunk-major: for each 8-channel
// chunk c, its V + 7 slots of 16 bytes, cbytes(g) apart (128-byte aligned).
// Slots 0-7 and those past the box are zero; the box (slot 8 on, 128-byte
// aligned) holds band position slot - 8. Any 8 consecutive slots of a chunk
// are one contiguous 128-byte core matrix, so a tap's shift is a
// descriptor's start address.
__host__ __device__ __forceinline__ int cbytes(const Geo& g) { return ((g.V + 7) * 16 + 127) / 128 * 128; }
__host__ __device__ __forceinline__ int up1024(int v) { return (v + 1023) / 1024 * 1024; }
// dw stage (bytes): [Mp] xn rows (128-byte swizzle), then the window
__host__ __device__ __forceinline__ int dw_stage_bytes(const Geo& g) {
  return up1024(g.Mp * 128 + 8 * cbytes(g));
}
int dw_smem(const Geo& g) { return 1024 + 2 * dw_stage_bytes(g); }
// c: the channels the units chunk (cout for dx, cin for the forward)
int dx_smem(const Geo& g, int c) {
  return 1024 + (c > kC ? 2 : 1) * kWElems * 2 + 2 * 8 * cbytes(g);
}

struct Band {
  int img, i0, rows, j0, cols;
};

// Band b: image-major, then down the image, then across it.
__device__ __forceinline__ Band band_rect(const Geo& g, int b) {
  const int per_img = g.bh * g.bw;
  Band r;
  r.img = b / per_img;
  const int rem = b - r.img * per_img;
  const int rb = rem / g.bw, cb = rem - rb * g.bw;
  r.i0 = rb * g.R;
  r.rows = min(g.R, g.h - r.i0);
  r.j0 = cb * g.Wp;
  r.cols = min(g.Wp, g.w - r.j0);
  return r;
}

// Band coordinates stepped through consecutive bands without a division
// (the thread that issues the TMA boxes walks its CTA's bands with one).
struct BandCursor {
  int img, rb, cb;
  __device__ __forceinline__ void start(const Geo& g, int b) {
    const int per_img = g.bh * g.bw;
    img = b / per_img;
    rb = (b - img * per_img) / g.bw;
    cb = b - img * per_img - rb * g.bw;
  }
  __device__ __forceinline__ void next(const Geo& g) {
    if (++cb == g.bw) {
      cb = 0;
      if (++rb == g.bh) rb = 0, ++img;
    }
  }
};

// The bands [b0, b1) of CTA `grp` of `groups`: contiguous, sizes differing by
// at most one.
__device__ __forceinline__ void group_range(int grp, int groups, int bands, int& b0, int& b1) {
  b0 = static_cast<int>(static_cast<long long>(grp) * bands / groups);
  b1 = static_cast<int>(static_cast<long long>(grp + 1) * bands / groups);
}

// Window slot v (of each chunk) holds dyc (or x, then xn) at band position
// v - 8 = rr P + cc, image (i0 - 1 + rr, j0 - 1 + cc): the box [1, R + 2, P,
// 1, 8] from (img, i0 - 1, j0 - 1) lands at slot 8, zero outside the image.
// Rows and columns past the band's halo (a short last band or piece) hold
// whatever the box brings: only outputs that are discarded, or multiplied by
// a zero xn, read them. (They lie outside the image, so the forward's
// prologue leaves them zero.)
//
// Output slot k is band position k + P (interior row k / P, column k % P - 1
// of the piece): its flat NHWC position, or -1 off the band's interior (a pad
// column, a row past the band, the rounding up to Mp or Md).
__device__ __forceinline__ long long interior_pos(const Geo& g, const Band& bd, int k) {
  const int r = k / g.P, cc = k - r * g.P;
  if (r >= bd.rows || cc < 1 || cc > bd.cols) return -1;
  return (static_cast<long long>(bd.img) * g.h + bd.i0 + r) * g.w + bd.j0 + cc - 1;
}

// Walks the slots s0, s0 + step, ... of a band as (row, column) of its
// P-wide grid without a division per step.
struct SlotWalk {
  int r, c, sr, sc, P;
  __device__ __forceinline__ SlotWalk(int s0, int step, int pitch) : P(pitch) {
    r = s0 / pitch, c = s0 - r * pitch;
    sr = step / pitch, sc = step - sr * pitch;
  }
  __device__ __forceinline__ void next() {
    r += sr, c += sc;
    if (c >= P) c -= P, ++r;
  }
};

// Output slot k under tap t = 3 di + dj reads window slot k + tap_slot(t):
// the backward's flipped tap, dyc at band position k + P - s_t ...
__device__ __forceinline__ int tap_slot(const Geo& g, int di, int dj) {
  return (2 - di) * g.P + (2 - dj) + 7;
}
// ... and the forward's, xn at band position k + P + s_t.
__device__ __forceinline__ int fwd_tap_slot(const Geo& g, int di, int dj) {
  return di * g.P + dj + 7;
}

// dx's products for one unit, for a warpgroup that owns NT m64 tiles from
// tile0: acc[i] += sum_t dyc_shifted(t) w_t^T over the 64-wide cout chunk,
// every operand from shared memory, so all 36 k16 steps issue back to back.
// A = dyc shifted by tap t (positions x cout chunk): the chunk-major window
// read as a K-major plain descriptor (8-row groups 128 bytes apart, the two
// 8-channel halves of k16 one chunk apart); B = w_t^T [cout chunk x cin
// tile], K-major with the 128-byte swizzle (8-row groups 1024 bytes apart,
// 32 bytes per 16 along K).
template <int NT>
__device__ __forceinline__ void dx_products(float (&acc)[2][32], uint32_t win_u, uint32_t wt_u,
                                            int tile0, const Geo& g) {
  const uint32_t cb = cbytes(g);
#pragma unroll 1
  for (int t = 0; t < 9; ++t) {
    const uint32_t a0 = win_u + (tile0 * 64 + tap_slot(g, t / 3, t % 3)) * 16;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kC / 16; ++ks) {
      const uint64_t desc_b = smem_desc(wt_u + t * kC * kC * 2 + ks * 32, 1, 64);
#pragma unroll
      for (int i = 0; i < NT; ++i)
        wgmma_ss<0, 0>(acc[i], smem_desc_plain(a0 + 2 * ks * cb + i * 64 * 16, cb / 16, 8),
                       desc_b);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
}

// The forward's products for one unit, for a warpgroup that owns NT m64
// tiles from tile0: acc[i] += sum_t xn_shifted(t) w_t over the 64-wide cin
// chunk, every operand from shared memory, issued without waiting (the
// caller waits after the next unit's prologue). A = xn shifted by tap t
// (positions x cin chunk): the chunk-major window read as a K-major plain
// descriptor, as dx_products reads dyc; B = w_t [cin chunk x cout tile] as
// w9 stores it, N contiguous: MN-major with the 128-byte swizzle (8-row
// groups along K 1024 bytes apart, one 64-wide atom along N).
template <int NT>
__device__ __forceinline__ void fwd_products(float (&acc)[2][32], uint32_t win_u, uint32_t wt_u,
                                             int tile0, const Geo& g) {
  const uint32_t cb = cbytes(g);
#pragma unroll 1
  for (int t = 0; t < 9; ++t) {
    const uint32_t a0 = win_u + (tile0 * 64 + fwd_tap_slot(g, t / 3, t % 3)) * 16;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kC / 16; ++ks) {
      const uint64_t desc_b = smem_desc(wt_u + (t * kC + ks * 16) * 128, 1, 64);
#pragma unroll
      for (int i = 0; i < NT; ++i)
        wgmma_ss<0, 1>(acc[i], smem_desc_plain(a0 + 2 * ks * cb + i * 64 * 16, cb / 16, 8),
                       desc_b);
    }
    wgmma_commit();
  }
}

struct Args {
  const bf16* x;      // [n, h, w, cin]
  const float* a;     // [cin]
  const float* b;
  bf16* y;            // forward: [n, h, w, cout]
  float* part_y;      // forward: [groups, 2, cout]: s1, s2
  bf16* dx;           // [n, h, w, cin]
  float* part_dw;     // [dw groups, 9, cin, cout]
  float* part_dx;     // [dx groups, 2, cin]: da, db
  int cin, cout, groups;
  Geo geo;
};

// Zero `elems` bf16 from p (16-byte aligned, a multiple of 8) with all threads.
__device__ __forceinline__ void zero_smem(bf16* p, int elems, int tid, int threads) {
  for (int i = tid; i < elems / 8; i += threads) reinterpret_cast<uint4*>(p)[i] = make_uint4(0, 0, 0, 0);
}

// y and the s1/s2 partials. Grid: (cout / 64) tiles x groups CTAs; CTA
// (tile, grp) walks its bands, each in cin / 64 chunks (a unit = one band,
// one chunk). map_x: boxes [1, R + 2, P, 1, 8] of x, one per 8-channel
// chunk; map_w: [9, 64, 64] of w9.
__global__ void __launch_bounds__(kDxThreads, 1)
    conv3_fwd_band_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w, Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[8][2][kC];
  __shared__ __align__(8) uint64_t full[2];
  bf16* const base = reinterpret_cast<bf16*>(align1024(smem));
  const Geo g = p.geo;
  const int nch = p.cin / kC;
  const int wstages = nch > 1 ? 2 : 1;
  // window s at wins + s * win_stride
  bf16* const wins = base + wstages * kWElems;
  const int cb = cbytes(g), win_stride = 8 * cb / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x / p.groups, grp = blockIdx.x % p.groups;
  const int co0 = tile * kC;
  int b0, b1;
  group_range(grp, p.groups, g.bands, b0, b1);

  zero_smem(wins, 2 * win_stride, tid, kDxThreads);
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
    prefetch_map(&map_x);
    prefetch_map(&map_w);
  }
  fence_proxy_async();
  __syncthreads();
  const int win_bytes = (g.R + 2) * g.P * kC * 2;
  // thread 0 issues the boxes of unit 0, 1, ... (band b0 + u / nch, cin
  // chunk u % nch) in turn
  BandCursor cur;
  cur.start(g, b0);
  int cur_kc = 0;
  auto issue = [&](int u, int s) {
    const bool with_w = nch > 1 || u == 0;
    const int i0 = cur.rb * g.R, j0 = cur.cb * g.Wp;
    mbar_expect_tx(&full[s], win_bytes + (with_w ? kWElems * 2 : 0));
    const uint32_t win = smem_u32(wins + s * win_stride);
#pragma unroll 1
    for (int c = 0; c < 8; ++c)
      tma_5d(win + c * cb + 128, &map_x, &full[s], 0, cur_kc * 8 + c, j0 - 1, i0 - 1, cur.img);
    // rows 64 t + ci of the weight stage: w9[t][kc * 64 + ci][co0 ..]
    if (with_w)
      tma_3d(smem_u32(base + (nch > 1 ? s : 0) * kWElems), &map_w, &full[s], co0, cur_kc * kC,
             0);
    if (++cur_kc == nch) cur_kc = 0, cur.next(g);
  };

  // the prologue of a unit's window in stage s: relu(x a + b) on the slots
  // whose position lies in the image, the band's halo included (a real
  // neighbour there); the slots outside the image keep the zeros TMA wrote.
  // Warp w transforms 8-channel chunk w, lane l the slots l, l + 32, ...: a
  // warp touches 512 contiguous bytes at a time.
  auto prologue = [&](int s, int band, int kc) {
    const Band bd = band_rect(g, band);
    const int c0 = kc * kC + warp * 8;
    float av[8], bv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) av[e] = __ldg(p.a + c0 + e), bv[e] = __ldg(p.b + c0 + e);
    unsigned char* const chunk =
        reinterpret_cast<unsigned char*>(wins + s * win_stride) + warp * cb + 128;
    const int slots = (g.R + 2) * g.P;
    SlotWalk wk(lane, 32, g.P);
    for (int q0 = lane; q0 < slots; q0 += 128) {
      bool in[4];
      uint4 v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e, wk.next()) {
        const int i = bd.i0 - 1 + wk.r, j = bd.j0 - 1 + wk.c;
        in[e] = q0 + 32 * e < slots && i >= 0 && i < g.h && j >= 0 && j < g.w;
        if (in[e]) v[e] = *reinterpret_cast<const uint4*>(chunk + (q0 + 32 * e) * 16);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!in[e]) continue;
        __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&v[e]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(x2[k]);
          x2[k] = __floats2bfloat162_rn(fmaxf(f.x * av[2 * k] + bv[2 * k], 0.f),
                                        fmaxf(f.y * av[2 * k + 1] + bv[2 * k + 1], 0.f));
        }
        *reinterpret_cast<uint4*>(chunk + (q0 + 32 * e) * 16) = v[e];
      }
    }
    fence_proxy_async();
  };

  // warpgroup wg = warp / 4 computes the band's m64 tiles 2 wg and 2 wg + 1
  // (y [positions x cout tile] = xn_shifted w_t), warp wl = warp % 4 holding
  // rows 16 wl .. 16 wl + 15 of each; lane 4 gq + t4 holds rows gq, gq + 8 of
  // those and channels 8 j + 2 t4, 8 j + 2 t4 + 1
  const int wg = warp >> 2, wl = warp & 3, gq = lane >> 2, t4 = lane & 3;
  const int mtiles = g.Md / 64;
  float s1[8][2], s2[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j][0] = s1[j][1] = s2[j][0] = s2[j][1] = 0.f;
  float acc[2][32];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;

  // one unit ahead: while unit u's products run on the tensor cores, its
  // successor's boxes land and get their prologue
  const int units = (b1 - b0) * nch;
  if (units > 0) {
    if (tid == 0) issue(0, 0);
    mbar_wait(&full[0], 0);
    prologue(0, b0, 0);
    __syncthreads();
  }
  for (int u = 0; u < units; ++u) {
    const int s = u & 1;
    // stage s ^ 1 was freed by the barrier that ended the previous unit
    if (tid == 0 && u + 1 < units) issue(u + 1, s ^ 1);
    const uint32_t win_u = smem_u32(wins + s * win_stride);
    const uint32_t wt_u = smem_u32(base + (nch > 1 ? s : 0) * kWElems);
    // the tile count is uniform over a warpgroup and tested outside the
    // pipelined products
    if (2 * wg + 1 < mtiles)
      fwd_products<2>(acc, win_u, wt_u, 2 * wg, g);
    else if (2 * wg < mtiles)
      fwd_products<1>(acc, win_u, wt_u, 2 * wg, g);
    if (u + 1 < units) {
      mbar_wait(&full[s ^ 1], ((u + 1) >> 1) & 1);
      prologue(s ^ 1, b0 + (u + 1) / nch, (u + 1) % nch);
    }
    wgmma_wait<0>();
    if (u % nch == nch - 1) {
      // the band's epilogue: interior positions only, the statistics from
      // the f32 sums
      const Band bd = band_rect(g, b0 + u / nch);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long pos = interior_pos(g, bd, (2 * wg + i) * 64 + wl * 16 + gq + half * 8);
          if (pos < 0) continue;
          bf16* const out = p.y + pos * p.cout + co0 + 2 * t4;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float v0 = acc[i][4 * j + 2 * half], v1 = acc[i][4 * j + 2 * half + 1];
            s1[j][0] += v0, s1[j][1] += v1;
            s2[j][0] += v0 * v0, s2[j][1] += v1 * v1;
            *reinterpret_cast<__nv_bfloat162*>(out + j * 8) = __floats2bfloat162_rn(v0, v1);
          }
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
      }
    }
    __syncthreads();  // every warp is done with stage s before it is refilled
  }

  // s1/s2 over the CTA's positions in a fixed order: the 8 row groups of a
  // warp by shuffles, then the 8 warps through shared memory
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s1[j][e] += __shfl_xor_sync(0xffffffffu, s1[j][e], o);
        s2[j][e] += __shfl_xor_sync(0xffffffffu, s2[j][e], o);
      }
  if (gq == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[warp][0][j * 8 + 2 * t4 + e] = s1[j][e];
        red[warp][1][j * 8 + 2 * t4 + e] = s2[j][e];
      }
  }
  __syncthreads();
  if (tid < 2 * kC) {
    const int which = tid / kC, c = tid % kC;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) sum += red[w][which][c];
    p.part_y[(static_cast<long long>(grp) * 2 + which) * p.cout + co0 + c] = sum;
  }
}

// dyc = bf16(dy + gs1 + 2 y gs2), 8 elements a thread.
__global__ void conv3_dyc_kernel(const bf16* dy, const bf16* y, const float* gs1,
                                 const float* gs2, bf16* dyc, long long total, int N) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 8;
  if (i >= total) return;
  const int c = static_cast<int>(i % N);
  uint4 dv = *reinterpret_cast<const uint4*>(dy + i);
  const uint4 yv = *reinterpret_cast<const uint4*>(y + i);
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(&dv);
  const __nv_bfloat162* yy = reinterpret_cast<const __nv_bfloat162*>(&yv);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 df = __bfloat1622float2(d[k]), yf = __bfloat1622float2(yy[k]);
    const int cc = c + 2 * k;
    d[k] = __floats2bfloat162_rn(df.x + gs1[cc] + 2.f * yf.x * gs2[cc],
                                 df.y + gs1[cc + 1] + 2.f * yf.y * gs2[cc + 1]);
  }
  *reinterpret_cast<uint4*>(dyc + i) = dv;
}

// dw partials. Grid: (cin / 64) (cout / 64) tiles x groups CTAs; CTA (tile,
// grp) sums its bands into part_dw[grp][t][ci tile][co tile] for all nine t.
// map_x: boxes [1, R, P, 64] of x; map_dyc: [1, R + 2, P, 1, 8] of dyc, one
// per 8-channel chunk.
__global__ void __launch_bounds__(kDwThreads, 1)
    conv3_dw_band_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_dyc, Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[2];
  bf16* const base = reinterpret_cast<bf16*>(align1024(smem));
  const Geo g = p.geo;
  const int stage = dw_stage_bytes(g) / 2, win_off = g.Mp * kC, cb = cbytes(g);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_ci = p.cin / kC;
  const int tile = blockIdx.x / p.groups, grp = blockIdx.x % p.groups;
  const int ci0 = (tile % tiles_ci) * kC, co0 = (tile / tiles_ci) * kC;
  int b0, b1;
  group_range(grp, p.groups, g.bands, b0, b1);
  // the prologue's rows: this thread transforms channels cc8..cc8 + 7 (the
  // stride over rows, kDwThreads / 8, keeps them fixed)
  const int cc8 = (tid & 7) * 8;
  float av[8], bv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) av[e] = p.a[ci0 + cc8 + e], bv[e] = p.b[ci0 + cc8 + e];

  zero_smem(base, 2 * stage, tid, kDwThreads);
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
    prefetch_map(&map_x);
    prefetch_map(&map_dyc);
  }
  fence_proxy_async();
  __syncthreads();
  const int box_bytes = (2 * g.R + 2) * g.P * kC * 2;
  // thread 0 issues the boxes of band b0, b0 + 1, ... in turn
  BandCursor cur;
  cur.start(g, b0);
  auto issue = [&](int s) {
    const uint32_t xs = smem_u32(base + s * stage);
    const int i0 = cur.rb * g.R, j0 = cur.cb * g.Wp;
    mbar_expect_tx(&full[s], box_bytes);
    tma_4d(xs, &map_x, &full[s], ci0, j0 - 1, i0, cur.img);
#pragma unroll 1
    for (int c = 0; c < 8; ++c)
      tma_5d(xs + win_off * 2 + c * cb + 128, &map_dyc, &full[s], 0, co0 / 8 + c, j0 - 1, i0 - 1,
             cur.img);
    cur.next(g);
  };

  // warpgroup di = warp / 4 owns taps 3 di .. 3 di + 2; per tap it computes
  // dw_t [cin tile x cout tile] = xn^T dyc_shifted, warp wl = warp % 4
  // holding cin rows 16 wl .. 16 wl + 15
  const int di = warp >> 2, wl = warp & 3;
  float acc[3][32];
#pragma unroll
  for (int dj = 0; dj < 3; ++dj)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[dj][e] = 0.f;

  // the prologue, once per band, on every xn row of stage s: relu(x a + b)
  // in the band's interior, zero in its pad columns, past its rows and in the
  // rounding up to Mp
  auto prologue = [&](int s, int band) {
    bf16* const xs = base + s * stage;
    const uint32_t xs_u = smem_u32(xs);
    const Band bd = band_rect(g, band);
    SlotWalk wk(tid >> 3, kDwThreads / 8, g.P);
    for (int k = tid >> 3; k < g.Mp; k += kDwThreads / 8, wk.next()) {
      uint4* const at = reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(xs) +
                                                 (swz(xs_u + k * 128, cc8) - xs_u));
      uint4 v = make_uint4(0, 0, 0, 0);
      if (wk.r < bd.rows && wk.c >= 1 && wk.c <= bd.cols) {
        v = *at;
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = __bfloat1622float2(e[q]);
          e[q] = __floats2bfloat162_rn(fmaxf(f.x * av[2 * q] + bv[2 * q], 0.f),
                                       fmaxf(f.y * av[2 * q + 1] + bv[2 * q + 1], 0.f));
        }
      }
      *at = v;
    }
    fence_proxy_async();
  };
  // the products of stage s, all issued at once: per tap, dw_t [cin tile x
  // cout tile] += xn^T dyc_shifted over the band's positions. A = xn^T, the
  // xn rows read MN-major (128-byte swizzle, 8-row groups 1024 bytes apart;
  // one 64-wide atom along M); B = dyc shifted by the tap, the chunk-major
  // window read MN-major without swizzle (8-row groups 128 bytes apart, the
  // 8-channel groups along N one chunk apart)
  auto products = [&](int s) {
    const uint32_t xs_u = smem_u32(base + s * stage), win_u = xs_u + win_off * 2;
    wgmma_fence();
    for (int k0 = 0; k0 < g.Mp; k0 += 16) {
      const uint64_t desc_a = smem_desc(xs_u + k0 * 128, 1, 64);
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
        wgmma_ss<1, 1>(acc[dj], desc_a,
                       smem_desc_plain(win_u + (k0 + tap_slot(g, di, dj)) * 16, 8, cb / 16));
    }
    wgmma_commit();
  };

  // one band ahead: while band u's products run on the tensor cores, its
  // successor's boxes land and get their prologue
  const int units = b1 - b0;
  if (units > 0) {
    if (tid == 0) issue(0);
    mbar_wait(&full[0], 0);
    prologue(0, b0);
    __syncthreads();
  }
  for (int u = 0; u < units; ++u) {
    const int s = u & 1;
    // stage s ^ 1 was freed by the barrier that ended the previous band
    if (tid == 0 && u + 1 < units) issue(s ^ 1);
    products(s);
    if (u + 1 < units) {
      mbar_wait(&full[s ^ 1], ((u + 1) >> 1) & 1);
      prologue(s ^ 1, b0 + u + 1);
    }
    wgmma_wait<0>();
    __syncthreads();  // band u's products and band u + 1's prologue are done
  }

  // acc[dj][4 j + e]: cin 16 wl + g (+ 8 for e >= 2), cout 8 j + 2 t (+ 1 for
  // odd e)
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
    float* const out = p.part_dw + (static_cast<long long>(grp) * 9 + 3 * di + dj) * p.cin * p.cout;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ci = ci0 + wl * 16 + gq + half * 8, co = co0 + j * 8 + 2 * t4;
        *reinterpret_cast<float2*>(out + static_cast<long long>(ci) * p.cout + co) =
            make_float2(acc[dj][4 * j + 2 * half], acc[dj][4 * j + 2 * half + 1]);
      }
  }
}

// dx, da/db partials. Grid: (cin / 64) tiles x groups CTAs; CTA (tile, grp)
// walks its bands, each in cout / 64 chunks (a unit = one band, one chunk).
// map_dyc: boxes [1, R + 2, P, 1, 8] of dyc, one per 8-channel chunk; map_w:
// [9, 64, 64] of w9.
__global__ void __launch_bounds__(kDxThreads, 1)
    conv3_dx_band_kernel(const __grid_constant__ CUtensorMap map_dyc,
                         const __grid_constant__ CUtensorMap map_w, Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[8][2][kC];
  __shared__ float s_ab[2][kC];
  __shared__ __align__(8) uint64_t full[2];
  bf16* const base = reinterpret_cast<bf16*>(align1024(smem));
  const Geo g = p.geo;
  const int nch = p.cout / kC;
  const int wstages = nch > 1 ? 2 : 1;
  // window s at wins + s * win_stride
  bf16* const wins = base + wstages * kWElems;
  const int cb = cbytes(g), win_stride = 8 * cb / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x / p.groups, grp = blockIdx.x % p.groups;
  const int ci0 = tile * kC;
  int b0, b1;
  group_range(grp, p.groups, g.bands, b0, b1);

  if (tid < 2 * kC) s_ab[tid / kC][tid % kC] = (tid < kC ? p.a : p.b)[ci0 + tid % kC];
  zero_smem(wins, 2 * win_stride, tid, kDxThreads);
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
    prefetch_map(&map_dyc);
    prefetch_map(&map_w);
  }
  fence_proxy_async();
  __syncthreads();
  const int win_bytes = (g.R + 2) * g.P * kC * 2;
  // thread 0 issues the boxes of unit 0, 1, ... (band b0 + u / nch, cout
  // chunk u % nch) in turn
  BandCursor cur;
  cur.start(g, b0);
  int cur_kc = 0;
  auto issue = [&](int u, int s) {
    const bool with_w = nch > 1 || u == 0;
    const int i0 = cur.rb * g.R, j0 = cur.cb * g.Wp;
    mbar_expect_tx(&full[s], win_bytes + (with_w ? kWElems * 2 : 0));
    const uint32_t win = smem_u32(wins + s * win_stride);
#pragma unroll 1
    for (int c = 0; c < 8; ++c)
      tma_5d(win + c * cb + 128, &map_dyc, &full[s], 0, cur_kc * 8 + c, j0 - 1, i0 - 1, cur.img);
    // rows 64 t + ci of the weight stage: w9[t][ci0 + ci][kc * 64 ..]
    if (with_w)
      tma_3d(smem_u32(base + (nch > 1 ? s : 0) * kWElems), &map_w, &full[s], cur_kc * kC, ci0,
             0);
    if (++cur_kc == nch) cur_kc = 0, cur.next(g);
  };

  // warpgroup wg = warp / 4 computes the band's m64 tiles 2 wg and 2 wg + 1
  // (dxn [positions x cin tile] = dyc_shifted w_t^T), warp wl = warp % 4
  // holding rows 16 wl .. 16 wl + 15 of each; lane 4 gq + t4 holds rows gq,
  // gq + 8 of those and channels 8 j + 2 t4, 8 j + 2 t4 + 1
  const int wg = warp >> 2, wl = warp & 3, gq = lane >> 2, t4 = lane & 3;
  const int mtiles = g.Md / 64;
  float da[8][2], db[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) da[j][0] = da[j][1] = db[j][0] = db[j][1] = 0.f;
  // the epilogue's x, loaded into registers before the band's last products
  // so that its latency hides behind them
  long long xpos[2][2];
  uint32_t xr[2][2][8];
  float acc[2][32];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;

  const int units = (b1 - b0) * nch;
  if (tid == 0 && units > 0) issue(0, 0);
  for (int u = 0; u < units; ++u) {
    const int s = u & 1;
    // stage s ^ 1 was freed by the barrier that ended the previous unit
    if (tid == 0 && u + 1 < units) issue(u + 1, s ^ 1);
    if (u % nch == nch - 1) {
      const Band bd = band_rect(g, b0 + u / nch);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int k = (2 * wg + i) * 64 + wl * 16 + gq + half * 8;
          const long long pos = k < g.Mp ? interior_pos(g, bd, k) : -1;
          xpos[i][half] = pos;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            xr[i][half][j] = pos < 0 ? 0u
                                     : __ldg(reinterpret_cast<const unsigned int*>(
                                           p.x + pos * p.cin + ci0 + j * 8 + 2 * t4));
        }
    }
    mbar_wait(&full[s], (u >> 1) & 1);
    const uint32_t win_u = smem_u32(wins + s * win_stride);
    const uint32_t wt_u = smem_u32(base + (nch > 1 ? s : 0) * kWElems);
    // the tile count is uniform over a warpgroup and tested outside the
    // pipelined products
    if (2 * wg + 1 < mtiles)
      dx_products<2>(acc, win_u, wt_u, 2 * wg, g);
    else if (2 * wg < mtiles)
      dx_products<1>(acc, win_u, wt_u, 2 * wg, g);
    if (u % nch == nch - 1) {
      // the band's epilogue: interior positions only
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long pos = xpos[i][half];
          if (pos < 0) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = j * 8 + 2 * t4;
            const uint32_t xw = xr[i][half][j];
            const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xw));
            const float a0 = s_ab[0][c], a1 = s_ab[0][c + 1];
            const float du0 = xv.x * a0 + s_ab[1][c] > 0.f ? acc[i][4 * j + 2 * half] : 0.f;
            const float du1 = xv.y * a1 + s_ab[1][c + 1] > 0.f ? acc[i][4 * j + 2 * half + 1] : 0.f;
            da[j][0] += du0 * xv.x, da[j][1] += du1 * xv.y;
            db[j][0] += du0, db[j][1] += du1;
            *reinterpret_cast<__nv_bfloat162*>(p.dx + pos * p.cin + ci0 + c) =
                __floats2bfloat162_rn(du0 * a0, du1 * a1);
          }
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
      }
    }
    __syncthreads();  // every warp is done with stage s before it is refilled
  }

  // da/db over the CTA's positions in a fixed order: the 8 row groups of a
  // warp by shuffles, then the 8 warps through shared memory
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        da[j][e] += __shfl_xor_sync(0xffffffffu, da[j][e], o);
        db[j][e] += __shfl_xor_sync(0xffffffffu, db[j][e], o);
      }
  if (gq == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[warp][0][j * 8 + 2 * t4 + e] = da[j][e];
        red[warp][1][j * 8 + 2 * t4 + e] = db[j][e];
      }
  }
  __syncthreads();
  if (tid < 2 * kC) {
    const int which = tid / kC, c = tid % kC;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) sum += red[w][which][c];
    p.part_dx[(static_cast<long long>(grp) * 2 + which) * p.cin + ci0 + c] = sum;
  }
}

// out[c] = sum_{t < T} part[t][c] over C = 4 C4 columns, in a fixed order: a
// thread sums four adjacent columns over the rows t = ty, ty + 8, ... in turn,
// then the 8 row groups' sums are added in order. Block (32, 8).
__global__ void conv3_reduce_kernel(const float4* part, float4* out, int T, long long C4) {
  __shared__ float4 s[8][32];
  const long long c = static_cast<long long>(blockIdx.x) * 32 + threadIdx.x;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < C4)
    for (int t = threadIdx.y; t < T; t += 8) {
      const float4 v = part[static_cast<long long>(t) * C4 + c];
      acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
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

int reduce(const float* part, float* out, int T, long long C, cudaStream_t st) {
  const long long C4 = C / 4;  // C is a multiple of 128
  conv3_reduce_kernel<<<static_cast<unsigned>((C4 + 31) / 32), dim3(32, 8), 0, st>>>(
      reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(out), T, C4);
  return static_cast<int>(cudaGetLastError());
}

#define C3_TRY(expr)          \
  do {                        \
    const int rc_ = (expr);   \
    if (rc_ != 0) return rc_; \
  } while (0)

}  // namespace

// K8 forward. x [n, h, w, cin], w9 [9, cin, cout] bf16; a, b [cin] f32.
// Scratch: part [groups, 2, cout] f32. Outputs: y [n, h, w, cout] bf16,
// stats [2, cout] f32 (s1, s2). Bands of R rows x Wp columns; groups CTAs
// per cout tile share the bands.
extern "C" int conv3x3_bn_fwd(const void* x, const void* w9, const float* a, const float* b,
                              void* y, float* part, float* stats, int n, int h, int wd, int cin,
                              int cout, int R, int Wp, int groups, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a == nullptr || b == nullptr || n < 1 || h < 1 || wd < 1 || cin < kC || cin % kC != 0 ||
      cout < kC || cout % kC != 0 || R < 1 || R > h || Wp < 1 || Wp > wd || groups < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo g = make_geo(n, h, wd, R, Wp);
  const int smem = dx_smem(g, cin);
  // TMA boxes hold at most 256 elements a side
  if (g.Md > kDxMaxM || g.P > 256 || R + 2 > 256 || smem > kSmemDynamic)
    return static_cast<int>(cudaErrorInvalidValue);
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      conv3_fwd_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDynamic));
  C3_TRY(attr);

  CUtensorMap map_x, map_w;
  // x as [n, h, w, cin / 8, 8]: one box per 8-channel chunk
  const cuuint64_t dims_x[5] = {8, static_cast<cuuint64_t>(cin / 8), static_cast<cuuint64_t>(wd),
                                static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
  const cuuint64_t dims_w[3] = {static_cast<cuuint64_t>(cout), static_cast<cuuint64_t>(cin), 9};
  const cuuint32_t box_x[5] = {8, 1, static_cast<cuuint32_t>(g.P), static_cast<cuuint32_t>(R + 2),
                               1};
  const cuuint32_t box_w[3] = {kC, kC, 9};
  if (!make_map(&map_x, x, 5, dims_x, box_x, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&map_w, w9, 3, dims_w, box_w, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);

  Args p{};
  p.x = static_cast<const bf16*>(x);
  p.a = a, p.b = b;
  p.y = static_cast<bf16*>(y);
  p.part_y = part;
  p.cin = cin, p.cout = cout, p.groups = groups;
  p.geo = g;
  conv3_fwd_band_kernel<<<(cout / kC) * groups, kDxThreads, smem, st>>>(map_x, map_w, p);
  C3_TRY(static_cast<int>(cudaGetLastError()));
  return reduce(part, stats, groups, 2LL * cout, st);
}

// K8 backward. x [n, h, w, cin], w9 [9, cin, cout], y, dy [n, h, w, cout] bf16;
// a, b [cin], gs1, gs2 [cout] f32. Scratch: dyc [n, h, w, cout] bf16, part_dw
// [dw_groups, 9, cin, cout] f32, part_dx [dx_groups, 2, cin] f32. Outputs: dx
// [n, h, w, cin] bf16, dw [9, cin, cout] f32, dadb [2, cin] f32 (da, db).
// Bands of R rows x Wp columns; dw_groups CTAs per (cin, cout) tile and
// dx_groups per cin tile share the bands.
extern "C" int conv3x3_bn_bwd(const void* x, const void* w9, const float* a, const float* b,
                              const void* y, const void* dy, const float* gs1, const float* gs2,
                              void* dyc, void* dx, float* part_dw, float* part_dx, float* dw,
                              float* dadb, int n, int h, int wd, int cin, int cout, int R, int Wp,
                              int dw_groups, int dx_groups, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a == nullptr || b == nullptr || y == nullptr || n < 1 || h < 1 || wd < 1 ||
      cin < kC || cin % kC != 0 || cout < kC || cout % kC != 0 || R < 1 || R > h || Wp < 1 ||
      Wp > wd || dw_groups < 1 || dx_groups < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo g = make_geo(n, h, wd, R, Wp);
  const int smem_dw = dw_smem(g), smem_dx = dx_smem(g, cout);
  // TMA boxes hold at most 256 elements a side
  if (g.Md > kDxMaxM || g.P > 256 || R + 2 > 256 || smem_dw > kSmemDynamic ||
      smem_dx > kSmemDynamic)
    return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB, dynamic shared memory is opted into, once per kernel
  static const int attr_dw = static_cast<int>(cudaFuncSetAttribute(
      conv3_dw_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDynamic));
  static const int attr_dx = static_cast<int>(cudaFuncSetAttribute(
      conv3_dx_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDynamic));
  C3_TRY(attr_dw);
  C3_TRY(attr_dx);

  CUtensorMap map_x, map_dyc, map_w;
  const cuuint64_t dims_x[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(wd),
                                static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
  // dyc as [n, h, w, cout / 8, 8]: one box per 8-channel chunk
  const cuuint64_t dims_y[5] = {8, static_cast<cuuint64_t>(cout / 8), static_cast<cuuint64_t>(wd),
                                static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
  const cuuint64_t dims_w[3] = {static_cast<cuuint64_t>(cout), static_cast<cuuint64_t>(cin), 9};
  const cuuint32_t box_x[4] = {kC, static_cast<cuuint32_t>(g.P), static_cast<cuuint32_t>(R), 1};
  const cuuint32_t box_y[5] = {8, 1, static_cast<cuuint32_t>(g.P), static_cast<cuuint32_t>(R + 2),
                               1};
  const cuuint32_t box_w[3] = {kC, kC, 9};
  if (!make_map(&map_x, x, 4, dims_x, box_x, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&map_dyc, dyc, 5, dims_y, box_y, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&map_w, w9, 3, dims_w, box_w, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);

  // 1. dyc
  const long long total = static_cast<long long>(n) * h * wd * cout;
  conv3_dyc_kernel<<<static_cast<unsigned>((total / 8 + 255) / 256), 256, 0, st>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(y), gs1, gs2,
      static_cast<bf16*>(dyc), total, cout);
  C3_TRY(static_cast<int>(cudaGetLastError()));

  Args p{};
  p.x = static_cast<const bf16*>(x);
  p.a = a, p.b = b;
  p.dx = static_cast<bf16*>(dx);
  p.part_dw = part_dw, p.part_dx = part_dx;
  p.cin = cin, p.cout = cout;
  p.geo = g;
  // 2. dw partials
  p.groups = dw_groups;
  conv3_dw_band_kernel<<<(cin / kC) * (cout / kC) * dw_groups, kDwThreads, smem_dw, st>>>(
      map_x, map_dyc, p);
  C3_TRY(static_cast<int>(cudaGetLastError()));
  // 3. dx and the da/db partials
  p.groups = dx_groups;
  conv3_dx_band_kernel<<<(cin / kC) * dx_groups, kDxThreads, smem_dx, st>>>(map_dyc, map_w, p);
  C3_TRY(static_cast<int>(cudaGetLastError()));
  // 4. the sums of the partials
  C3_TRY(reduce(part_dw, dw, dw_groups, 9LL * cin * cout, st));
  return reduce(part_dx, dadb, dx_groups, 2LL * cin, st);
}
