// Ragged paged attention for NVIDIA Hopper (sm_90a): kernel K5 of the port.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// (`paged_attend_pallas` -> `_kernel`). One call serves a ragged batch: row
// b's chunk of s queries starts at absolute position positions[b], and query
// row r sees pool columns col <= positions[b] + r, clipped to the table width.
// K/V are read in place out of the [num_blocks, block_size, kv, d] pool through
// the row's block table; no contiguous copy of a sequence's context is made.
// GQA stays packed: the g = h / kv query heads of one KV head share every K/V
// load. Idle decode slots read scratch block 0 at position 0: column 0 is
// always visible, so every row's softmax has mass and its output is finite.
//
// Work split (flash decoding). A q tile is up to kMaxQ / g rows of one batch
// row with all g heads of one KV head: nq <= kMaxQ query vectors. Its causal
// horizon, min(pos + r0 + rows, table width) columns, is cut into spans of W
// columns. A work item is (q tile, span, KV head), for spans inside the
// horizon only. The split kernel (`paged_attend_kernel_cc` or `_tc`) runs a
// persistent grid of as many CTAs as the card holds at once; each CTA derives
// the item list from positions itself (the host never reads them) and walks
// its share (WorkList). Per item it runs an online softmax over the span and
// writes a partial (o normalised, lse in base 2) in f32 to scratch the
// wrapper allocates; an item whose tile has one span writes the output
// directly. The merge kernel (`paged_attend_kernel_merge`) combines a row's
// partials in span order, o = sum 2^(lse_i - max) o_i / sum 2^(lse_i - max)
// (the identity of paddle_tpu/distributed/fleet/context_parallel.py:199-202),
// with no atomics, so two runs give equal bits. A span with no visible column
// for a row (the early rows of a prefill tile) gives it lse = -1e30, weight 0.
// W is the narrowest of 128, 256 and 512 whose items fit in one round of
// resident CTAs, else 512 (WorkList::init): few items (a prefill chunk, GQA
// decode) are cut finer so that no CTA carries a long chain of stages, many
// (long MHA decode rows) coarser so that fewer partials are written and
// merged. Measured on an H100 against fixed W of 64-512 (`chip_smoke.py
// --k5`), this choice was the fastest, or within 1% of it, at every case for
// the body the wrapper takes.
//
// Two bodies, fixed by dtype and shape (the wrapper's `_tensor_cores`):
//  - CUDA cores (`cc`): every f32 call, and bf16/f16 calls with s * g < 8
//    (MHA decode). Decode does ~1 flop per byte of K/V, far below the ~295
//    the card needs to be bound by operations, so the tensor cores would gain
//    nothing; the body is built to move bytes. The queries sit in registers;
//    L = d * size / 16 lanes cover one key row with 16-byte loads straight
//    from device memory into registers (no shared-memory staging, no
//    widening copy); the dot products reduce with __shfl_xor_sync; each lane
//    accumulates its slice of d for PV. kUnroll key rows per warp slot are
//    loaded per step, and the next step's rows are in flight while this step
//    computes. More than QB query vectors (an f32 prefill tile) loop over the
//    span once per group of QB.
//  - Tensor cores (`tc`): bf16/f16 with s * g >= 8 (GQA decode, prefill).
//    S = Q K^T and O += P V run through mma.sync m16n8k16 with Q fragments
//    in registers and K/V fragments from shared memory through ldmatrix;
//    64-key stages of K and V (and the tile's Q) arrive by cp.async, 16 bytes
//    a thread gathered through the block table, in their own type, kStages
//    deep. P enters the second product as a hi + lo pair of 16-bit values, so
//    P V keeps ~16 bits of P: the plain version's f32 within 1e-3 (one
//    rounding of P to bf16 would miss it on short rows). With fewer than 64
//    query vectors, warps that would hold no rows take every other (or every
//    fourth) 16-key block of a stage, and hand their states to the group's
//    first warp; otherwise each warp stores its 16 rows from its fragments.
// Both keep f32 softmax state (running max m, sum l, accumulator) in base 2
// (scores pre-scaled by scale * log2 e). The item's block-table entries are
// staged in shared memory once.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py):
// decode is bound by bytes, every visible K/V byte read once: 8 rows at full
// depth (537 MB) run at ~88% of 3.35 TB/s, 8 rows at mixed depths (110 MB,
// one 4096-deep) at ~68%, where the deep row's spans and the merge set the
// tail. Prefill at s = 128 is ~2-4 us of bytes and ~0.1 us of tensor-core work
// but takes 12-21 us: a chain of dependent device-memory round trips per item
// (positions, block table, Q and the first stage, the stages, the store)
// bounds it, with only tens of items to overlap them. TMA was not tried: a
// page of one head is bs rows of d values strided by kv * d, one small box per
// page and head, and cp.async of 16 bytes a thread gathers any block size.
//
// Interface: plain C, loaded with ctypes. Returns the cudaError_t of the
// launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxQ = 64;          // query vectors (rows x group heads) per CTA
constexpr int kKc = 64;            // keys per tensor-core stage
constexpr int kStages = 2;         // tensor-core stages in flight
constexpr int kUnroll = 4;         // CUDA-core key steps loaded before use
constexpr int kMaxSpanPages = 1040;  // block-table entries of a span: W / bs + 1 <= 1025
constexpr int kMergeWarps = 8;

struct Params {
  const void* q;
  const void* kbuf;
  const void* vbuf;
  const int* tables;
  const int* positions;
  float* out;
  float* o_part;    // [spans][total_q][d]
  float* lse_part;  // [spans][total_q]
  int* span_cols;   // the span the split kernel chose, for the merge
  int B, s, h, kv, g, bs, max_blocks, q_rows, total_q;
  int split_cols;    // the span W; 0: the split kernel chooses it
  int resident;      // CTAs of the split kernel the card holds at once
  float scale_log2;  // softmax scale * log2(e)
};

// One work item: a q tile of one (batch row, KV head) and one span of its
// columns.
struct Tile {
  int b, kh, r0, nq, pos, c_begin, c_end, page0, span;
  bool direct;  // the tile has one span: write the output, no partial
};

// Columns the q tile of batch row b starting at row r0 sees, and the spans
// they make: the split kernels and the merge agree on these.
__device__ __forceinline__ int tile_cols(const Params& p, int b, int r0) {
  const int rows = min(p.q_rows, p.s - r0);
  return min(p.positions[b] + r0 + rows, p.max_blocks * p.bs);
}

__device__ __forceinline__ int tile_spans(const Params& p, int b, int r0, int w) {
  return (tile_cols(p, b, r0) + w - 1) / w;
}

// The split kernels' work list. Item = j * kv + kh, where j counts the spans
// of q tile 0, then of tile 1, ... (tile z = b * ntiles + r0 / q_rows); the
// list holds only spans inside their tile's horizon, so no CTA is launched
// for nothing. A persistent CTA takes items blockIdx.x, + gridDim.x, ...; its
// j never decreases, so it finds each item's tile by walking forward.
//
// The span W, unless the caller fixed it, is the narrowest of 128, 256, 512
// whose items fit in one round of the card's resident CTAs, else the widest:
// few items (a prefill chunk, GQA decode) are cut finer, so that no CTA
// carries a long chain of stages, and many (long MHA decode rows) coarser,
// so that fewer partials are written and merged. Every CTA derives the same W
// from positions; CTA 0 stores it for the merge.
__host__ __device__ constexpr int span_choice(int c) { return 128 << c; }  // 128, 256, 512

struct WorkList {
  int ntiles, w, total, item, z, base, cnt;

  __device__ int spans_of(const Params& p, int zz) const {
    return tile_spans(p, zz / ntiles, (zz % ntiles) * p.q_rows, w);
  }

  // W and the list's length, summed by the whole CTA over the tiles for each
  // candidate W (red: 3 x kWarps ints of shared memory).
  __device__ void init(const Params& p, int* red) {
    ntiles = (p.s + p.q_rows - 1) / p.q_rows;
    int cand[3], items[3] = {0, 0, 0};
#pragma unroll
    for (int c = 0; c < 3; ++c) cand[c] = p.split_cols ? p.split_cols : span_choice(c);
    for (int zz = threadIdx.x; zz < p.B * ntiles; zz += kThreads) {
      const int cols = tile_cols(p, zz / ntiles, (zz % ntiles) * p.q_rows);
#pragma unroll
      for (int c = 0; c < 3; ++c) items[c] += (cols + cand[c] - 1) / cand[c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) items[c] += __shfl_xor_sync(0xffffffffu, items[c], o);
      if ((threadIdx.x & 31) == 0) red[c * kWarps + (threadIdx.x >> 5)] = items[c];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      items[c] = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) items[c] += red[c * kWarps + k];
      items[c] *= p.kv;
    }
    int pick = 2;
    for (int c = 2; c >= 0; --c)
      if (items[c] <= p.resident) pick = c;
    w = cand[pick];
    total = items[pick];
    if (p.split_cols == 0 && blockIdx.x == 0 && threadIdx.x == 0 && p.span_cols)
      *p.span_cols = w;
    item = blockIdx.x - gridDim.x;
    z = 0;
    base = 0;
    cnt = spans_of(p, 0);
  }

  // Moves to the CTA's next item: fills t and stages the span's block-table
  // entries in sTab. False (for the whole CTA alike) when the list is done.
  __device__ bool next(const Params& p, Tile& t, int* sTab) {
    item += gridDim.x;
    if (item >= total) return false;
    const int j = item / p.kv;
    while (j >= base + cnt) {
      base += cnt;
      cnt = spans_of(p, ++z);
    }
    t.kh = item - j * p.kv;
    t.span = j - base;
    t.direct = cnt == 1;
    t.b = z / ntiles;
    t.r0 = (z % ntiles) * p.q_rows;
    t.nq = min(p.q_rows, p.s - t.r0) * p.g;
    t.pos = p.positions[t.b];
    const int ncols = tile_cols(p, t.b, t.r0);
    t.c_begin = t.span * w;
    t.c_end = min(t.c_begin + w, ncols);
    t.page0 = t.c_begin / p.bs;
    const int npages = (t.c_end - 1) / p.bs - t.page0 + 1;
    const int* row = p.tables + (size_t)t.b * p.max_blocks + t.page0;
    __syncthreads();  // the previous item is done with sTab and shared memory
    for (int i = threadIdx.x; i < npages; i += kThreads) sTab[i] = row[i];
    __syncthreads();
    return true;
  }
};

// Element offset of column `col`, head kh, lane slice `lane_off` in the pool.
__device__ __forceinline__ size_t pool_offset(const Params& p, const Tile& t, const int* sTab,
                                              int col, int d, int lane_off) {
  const int pg = col / p.bs;
  const int blk = sTab[pg - t.page0];
  return ((size_t)blk * p.bs + (col - pg * p.bs)) * ((size_t)p.kv * d) + (size_t)t.kh * d +
         lane_off;
}

// Combine the kWarps warps' softmax states of query vectors qi0 .. qi0 + QB - 1
// (warp w's state of vector qq: m/l at sm_m/sm_l[w * QB + qq], the
// accumulator at sm_o[(w * QB + qq) * D ..]), summed in warp order, and store
// them: the output when the tile has one span, else this span's partial.
template <int D, int QB>
__device__ void store_rows(const Params& p, const Tile& t, const float* sm_m, const float* sm_l,
                           const float* sm_o, int qi0) {
  for (int idx = threadIdx.x; idx < QB * D; idx += kThreads) {
    const int dd = idx % D, qq = idx / D;
    const int qi = qi0 + qq;
    if (qi >= t.nq) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * QB + qq]);
    const float mu = mx == -INFINITY ? 0.f : mx;
    float acc = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = exp2f(sm_m[w * QB + qq] - mu);
      acc += sm_o[(w * QB + qq) * D + dd] * e;
      l += sm_l[w * QB + qq] * e;
    }
    const int r = qi / p.g, hg = qi - r * p.g;
    const size_t qv = ((size_t)t.b * p.s + t.r0 + r) * p.h + (size_t)t.kh * p.g + hg;
    if (t.direct) {
      p.out[qv * D + dd] = acc / fmaxf(l, 1e-30f);
    } else {
      const size_t at = (size_t)t.span * p.total_q + qv;
      p.o_part[at * D + dd] = l > 0.f ? acc / l : 0.f;
      if (dd == 0) p.lse_part[at] = l > 0.f ? mu + log2f(l) : -1e30f;
    }
  }
}

// 16 bytes of T as floats.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int n = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
};

template <>
struct Vec16<__half> {
  static constexpr int n = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
};

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// ----------------------------------------------------------------------------
// CUDA-core body
// ----------------------------------------------------------------------------

// One work item of the CUDA-core body. sm_o/sm_m/sm_l: the warps' states,
// [kWarps][QB][D], [kWarps][QB] and [kWarps][QB].
template <typename T, int D, int QB>
__device__ void cc_item(const Params& p, const Tile& t, const int* sTab, float* sm_o,
                        float* sm_m, float* sm_l) {
  constexpr int VEC = Vec16<T>::n;
  constexpr int L = D / VEC;          // lanes per key row
  constexpr int KPW = 32 / L;         // key rows per warp and step
  constexpr int KSTEP = kWarps * KPW * kUnroll;
  static_assert(L >= 1 && L <= 32 && 32 % L == 0, "head_dim / vector width");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = lane / L, li = lane % L;
  const T* q = static_cast<const T*>(p.q);
  const T* K = static_cast<const T*>(p.kbuf);
  const T* V = static_cast<const T*>(p.vbuf);
  for (int qg = 0; qg < t.nq; qg += QB) {
    float qf[QB][VEC], acc[QB][VEC], m[QB], l[QB];
    int lim[QB];
#pragma unroll
    for (int qq = 0; qq < QB; ++qq) {
      const int qi = qg + qq;
      m[qq] = -INFINITY;
      l[qq] = 0.f;
#pragma unroll
      for (int k = 0; k < VEC; ++k) qf[qq][k] = acc[qq][k] = 0.f;
      lim[qq] = -1;
      if (qi < t.nq) {
        const int r = qi / p.g, hg = qi - r * p.g;
        const size_t src =
            (((size_t)t.b * p.s + t.r0 + r) * p.h + (size_t)t.kh * p.g + hg) * D + li * VEC;
        Vec16<T>::unpack(ldg16(q + src), qf[qq]);
#pragma unroll
        for (int k = 0; k < VEC; ++k) qf[qq][k] *= p.scale_log2;
        lim[qq] = t.pos + t.r0 + r;
      }
    }

    // this lane's key rows of the step at c0: kUnroll rows of K and V
    auto fetch = [&](int c0, uint4 (&kr)[kUnroll], uint4 (&vr)[kUnroll], int (&col)[kUnroll]) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        col[u] = c0 + (u * kWarps + warp) * KPW + j;
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (col[u] < t.c_end) {
          const size_t off = pool_offset(p, t, sTab, col[u], D, li * VEC);
          kr[u] = ldg16(K + off);
          vr[u] = ldg16(V + off);
        }
      }
    };
    uint4 kr[kUnroll], vr[kUnroll];
    int col[kUnroll];
    fetch(t.c_begin, kr, vr, col);
    for (int c0 = t.c_begin; c0 < t.c_end; c0 += KSTEP) {
      // the next step's rows are in flight while this step computes
      uint4 kn[kUnroll], vn[kUnroll];
      int cn[kUnroll];
      fetch(c0 + KSTEP, kn, vn, cn);
      float sc[QB][kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kf[VEC];
        Vec16<T>::unpack(kr[u], kf);
#pragma unroll
        for (int qq = 0; qq < QB; ++qq) {
          float d = 0.f;
#pragma unroll
          for (int k = 0; k < VEC; ++k) d = fmaf(qf[qq][k], kf[k], d);
          sc[qq][u] = d;
        }
      }
#pragma unroll
      for (int qq = 0; qq < QB; ++qq)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int o = L / 2; o > 0; o >>= 1)
            sc[qq][u] += __shfl_xor_sync(0xffffffffu, sc[qq][u], o);
      float mu[QB];
#pragma unroll
      for (int qq = 0; qq < QB; ++qq) {
        float mx = -INFINITY;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool ok = col[u] < t.c_end && col[u] <= lim[qq];
          sc[qq][u] = ok ? sc[qq][u] : -INFINITY;
          mx = fmaxf(mx, sc[qq][u]);
        }
        const float mn = fmaxf(m[qq], mx);
        mu[qq] = mn == -INFINITY ? 0.f : mn;
        const float alpha = exp2f(m[qq] - mu[qq]);
        m[qq] = mn;
        l[qq] *= alpha;
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[qq][k] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float vf[VEC];
        Vec16<T>::unpack(vr[u], vf);
#pragma unroll
        for (int qq = 0; qq < QB; ++qq) {
          const float pr = exp2f(sc[qq][u] - mu[qq]);
          l[qq] += pr;
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[qq][k] = fmaf(pr, vf[k], acc[qq][k]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        kr[u] = kn[u];
        vr[u] = vn[u];
        col[u] = cn[u];
      }
    }

    // merge the KPW key slots of the warp (lanes li, li + L, ...)
#pragma unroll
    for (int o = L; o < 32; o <<= 1) {
#pragma unroll
      for (int qq = 0; qq < QB; ++qq) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[qq], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[qq], o);
        const float mn = fmaxf(m[qq], mo);
        const float mu = mn == -INFINITY ? 0.f : mn;
        const float ea = exp2f(m[qq] - mu), eb = exp2f(mo - mu);
        l[qq] = l[qq] * ea + lo * eb;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[qq][k], o);
          acc[qq][k] = acc[qq][k] * ea + ao * eb;
        }
        m[qq] = mn;
      }
    }
    if (j == 0) {
#pragma unroll
      for (int qq = 0; qq < QB; ++qq) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) sm_o[(warp * QB + qq) * D + li * VEC + k] = acc[qq][k];
        if (li == 0) {
          sm_m[warp * QB + qq] = m[qq];
          sm_l[warp * QB + qq] = l[qq];
        }
      }
    }
    __syncthreads();
    store_rows<D, QB>(p, t, sm_m, sm_l, sm_o, qg);
    __syncthreads();  // the state is read before the next group writes it
  }
}

template <typename T, int D, int QB>
__global__ void __launch_bounds__(kThreads) paged_attend_kernel_cc(Params p) {
  __shared__ int sTab[kMaxSpanPages];
  __shared__ int sRed[3 * kWarps];
  extern __shared__ __align__(16) float smem_cc[];
  float* sm_o = smem_cc;                        // [kWarps][QB][D]
  float* sm_m = sm_o + kWarps * QB * D;         // [kWarps][QB]
  float* sm_l = sm_m + kWarps * QB;
  WorkList work;
  work.init(p, sRed);
  Tile t;
  while (work.next(p, t, sTab)) cc_item<T, D, QB>(p, t, sTab, sm_o, sm_m, sm_l);
}


// ----------------------------------------------------------------------------
// Tensor-core body
// ----------------------------------------------------------------------------
//
// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * gq + tq. An A fragment
// (16 x 16, row-major) is 4 registers of two 16-bit values: rows gq and gq + 8,
// columns 2tq, 2tq + 1 and 2tq + 8, 2tq + 9. A B fragment (16 x 8, k x n) is 2
// registers: k = 2tq, 2tq + 1 and 2tq + 8, 2tq + 9 of column n = gq. A C
// fragment (16 x 8 f32) is c0, c1 at row gq, columns 2tq, 2tq + 1, and c2, c3
// at row gq + 8. The C fragments of two neighbouring 8-key tiles of S are,
// packed, the A fragment of P for the P V product.

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  __device__ static void run(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // (x, y) rounded to a pair, and the pair of what the rounding left over
  __device__ static void split(float x, float y, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&r);
  }
};

template <>
struct Mma<__half> {
  __device__ static void run(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static void split(float x, float y, uint32_t& hi, uint32_t& lo) {
    const __half2 h = __floats2half2_rn(x, y);
    const float2 hf = __half22float2(h);
    const __half2 r = __floats2half2_rn(x - hf.x, y - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&r);
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__host__ __device__ constexpr int tc_pitch() { return D + 8; }  // 16-byte rows, ldmatrix without conflicts

template <int D>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  // sQ [kMaxQ][P], sK and sV [kStages][kKc][P], all 16-bit
  return (size_t)(kMaxQ + 2 * kStages * kKc) * tc_pitch<D>() * 2;
}

// One work item of the tensor-core body: sQ [kMaxQ][P], sK and sV
// [kStages][kKc][P] of shared memory.
template <typename T, int D>
__device__ void tc_item(const Params& p, const Tile& t, const int* sTab, T* sQ, T* sK, T* sV) {
  constexpr int P = tc_pitch<D>();
  constexpr int kTileElems = kKc * P;
  constexpr int kSeg = D / 8;  // 16-byte segments of a row
  static_assert((size_t)kWarps * 16 * (D + 8) * 4 <= (size_t)kStages * kTileElems * 2,
                "the combine state must fit over the K stages");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const T* K = static_cast<const T*>(p.kbuf);
  const T* V = static_cast<const T*>(p.vbuf);
  const int ntk = (t.c_end - t.c_begin + kKc - 1) / kKc;

  auto copy_stage = [&](int it) {
    T* dk = sK + (it % kStages) * kTileElems;
    T* dv = sV + (it % kStages) * kTileElems;
    for (int idx = threadIdx.x; idx < kKc * kSeg; idx += kThreads) {
      const int row = idx / kSeg, seg = idx % kSeg;
      const int col = t.c_begin + it * kKc + row;
      const bool ok = col < t.c_end;
      const size_t off = ok ? pool_offset(p, t, sTab, col, D, seg * 8) : 0;
      cp_async16(dk + row * P + seg * 8, K + off, ok);
      cp_async16(dv + row * P + seg * 8, V + off, ok);
    }
  };
  // the tile's queries (rows past nq zero) join the first stage's copies
  const T* q = static_cast<const T*>(p.q);
  for (int idx = threadIdx.x; idx < kMaxQ * kSeg; idx += kThreads) {
    const int qi = idx / kSeg, seg = idx % kSeg;
    const bool ok = qi < t.nq;
    size_t src = 0;
    if (ok) {
      const int r = qi / p.g, hg = qi - r * p.g;
      src = (((size_t)t.b * p.s + t.r0 + r) * p.h + (size_t)t.kh * p.g + hg) * D + seg * 8;
    }
    cp_async16(sQ + qi * P + seg * 8, q + src, ok);
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntk) copy_stage(st);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();

  // warps per 16-row group: with fewer rows, the spare warps split the keys
  const int mt = (t.nq + 15) / 16;
  const int ngroups = mt == 1 ? 1 : (mt == 2 ? 2 : 4);
  const int ksplit = kWarps / ngroups;
  const int grp = warp / ksplit, kl = warp % ksplit;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldsm_x4(qf[kc], sQ + (grp * 16 + (lane & 15)) * P + kc * 16 + (lane >> 4) * 8);
  int lim[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = grp * 16 + gq + 8 * hh;
    lim[hh] = qi < t.nq ? t.pos + t.r0 + qi / p.g : -1;
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this lane's columns

  for (int it = 0; it < ntk; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage it landed for all; stage it - 1 is free to refill
    if (it + kStages - 1 < ntk) copy_stage(it + kStages - 1);
    cp_async_commit();
    const T* tK = sK + (it % kStages) * kTileElems;
    const T* tV = sV + (it % kStages) * kTileElems;
    for (int sb = kl; sb < kKc / 16; sb += ksplit) {
      const int cb = t.c_begin + it * kKc + sb * 16;
      if (cb >= t.c_end) break;
      // S in two accumulator sets (even and odd kc): half the mma chain
      float sc[2][4], sc2[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = sc2[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t bf[4];
        ldsm_x4(bf, tK + (sb * 16 + (lane >> 4) * 8 + (lane & 7)) * P + kc * 16 +
                        ((lane >> 3) & 1) * 8);
        float(&acc)[2][4] = (kc & 1) ? sc2 : sc;
        Mma<T>::run(acc[0], qf[kc], bf[0], bf[1]);
        Mma<T>::run(acc[1], qf[kc], bf[2], bf[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] += sc2[n][e];
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = cb + n * 8 + 2 * tq + (e & 1);
          const bool ok = col < t.c_end && col <= lim[e >> 1];
          sc[n][e] = ok ? sc[n][e] * p.scale_log2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
        }
      float mu[2], alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float mn = fmaxf(m[hh], quad_max(mx[hh]));
        mu[hh] = mn == -INFINITY ? 0.f : mn;
        alpha[hh] = exp2f(m[hh] - mu[hh]);
        m[hh] = mn;
        l[hh] *= alpha[hh];
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = exp2f(sc[n][e] - mu[e >> 1]);
          l[e >> 1] += sc[n][e];
        }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= alpha[0], o[n][1] *= alpha[0];
        o[n][2] *= alpha[1], o[n][3] *= alpha[1];
      }
      uint32_t ahi[4], alo[4];
      Mma<T>::split(sc[0][0], sc[0][1], ahi[0], alo[0]);
      Mma<T>::split(sc[0][2], sc[0][3], ahi[1], alo[1]);
      Mma<T>::split(sc[1][0], sc[1][1], ahi[2], alo[2]);
      Mma<T>::split(sc[1][2], sc[1][3], ahi[3], alo[3]);
      // all hi products, then all lo products: D / 8 mma between the two
      // that add into one accumulator
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        const uint32_t(&a)[4] = pass ? alo : ahi;
#pragma unroll
        for (int n = 0; n < D / 8; n += 2) {
          uint32_t bv[4];
          ldsm_x4_t(bv, tV + (sb * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * P + n * 8 +
                            (lane >> 4) * 8);
          Mma<T>::run(o[n], a, bv[0], bv[1]);
          Mma<T>::run(o[n + 1], a, bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = quad_sum(l[hh]);
  if (ksplit > 1) {
    // the warps of a row group hand their states to its first warp, which
    // folds them in, in warp order, in the fragment layout
    constexpr int kPo = D + 8;  // float2 stores of a fragment: 2-way banks at most
    float* sm_o = reinterpret_cast<float*>(sK);  // [kWarps][16][kPo]
    float* sm_m = reinterpret_cast<float*>(sV);  // [kWarps][16]
    float* sm_l = sm_m + kWarps * 16;
    __syncthreads();  // every warp is done with the stages: reuse them
    if (kl != 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rr = warp * 16 + gq + 8 * hh;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<float2*>(sm_o + rr * kPo + n * 8 + 2 * tq) =
              make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
        if (tq == 0) {
          sm_m[rr] = m[hh];
          sm_l[rr] = l[hh];
        }
      }
    }
    __syncthreads();
    if (kl != 0) return;
    for (int w = 1; w < ksplit; ++w) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rr = (warp + w) * 16 + gq + 8 * hh;
        const float mo = sm_m[rr];
        const float mn = fmaxf(m[hh], mo);
        const float mu = mn == -INFINITY ? 0.f : mn;
        const float ea = exp2f(m[hh] - mu), eb = exp2f(mo - mu);
        l[hh] = l[hh] * ea + sm_l[rr] * eb;
        m[hh] = mn;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const float2 v = *reinterpret_cast<const float2*>(sm_o + rr * kPo + n * 8 + 2 * tq);
          o[n][2 * hh] = o[n][2 * hh] * ea + v.x * eb;
          o[n][2 * hh + 1] = o[n][2 * hh + 1] * ea + v.y * eb;
        }
      }
    }
  }
  // each row straight from the fragments: the output, or this span's partial
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = grp * 16 + gq + 8 * hh;
    if (qi >= t.nq) continue;
    const int r = qi / p.g, hg = qi - r * p.g;
    const size_t qv = ((size_t)t.b * p.s + t.r0 + r) * p.h + (size_t)t.kh * p.g + hg;
    float* dst;
    float inv;
    if (t.direct) {
      dst = p.out + qv * D;
      inv = 1.f / fmaxf(l[hh], 1e-30f);
    } else {
      const size_t at = (size_t)t.span * p.total_q + qv;
      dst = p.o_part + at * D;
      inv = l[hh] > 0.f ? 1.f / l[hh] : 0.f;
      if (tq == 0) p.lse_part[at] = l[hh] > 0.f ? m[hh] + log2f(l[hh]) : -1e30f;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dst + n * 8 + 2 * tq) =
          make_float2(o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_attend_kernel_tc(Params p) {
  constexpr int P = tc_pitch<D>();
  __shared__ int sTab[kMaxSpanPages];
  __shared__ int sRed[3 * kWarps];
  extern __shared__ __align__(128) char smem_tc[];
  T* sQ = reinterpret_cast<T*>(smem_tc);
  T* sK = sQ + kMaxQ * P;
  T* sV = sK + kStages * kKc * P;
  WorkList work;
  work.init(p, sRed);
  Tile t;
  while (work.next(p, t, sTab)) tc_item<T, D>(p, t, sTab, sQ, sK, sV);
}

// ----------------------------------------------------------------------------
// Merge: one warp per query vector, spans summed in order
// ----------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(32 * kMergeWarps) paged_attend_kernel_merge(Params p) {
  constexpr int E = D / 32;
  const int qv = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (qv >= p.total_q) return;
  const int r = (qv / p.h) % p.s;
  const int b = qv / (p.h * p.s);
  const int w = p.split_cols ? p.split_cols : *p.span_cols;
  const int nsp = tile_spans(p, b, (r / p.q_rows) * p.q_rows, w);
  if (nsp <= 1) return;  // written directly by the split kernel
  float mx = -INFINITY;
  for (int i = lane; i < nsp; i += 32) mx = fmaxf(mx, p.lse_part[(size_t)i * p.total_q + qv]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float acc[E], l = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  // no load depends on the sums: 16 spans' partials are read at once
#pragma unroll 16
  for (int i = 0; i < nsp; ++i) {
    const size_t at = (size_t)i * p.total_q + qv;
    const float w = exp2f(p.lse_part[at] - mx);
    const float* src = p.o_part + at * D + lane * E;
    l += w;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = fmaf(w, src[e], acc[e]);
  }
  float* dst = p.out + (size_t)qv * D + lane * E;
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e] = acc[e] / l;
}

// Launches split kernel `Kernel` with `smem` bytes of dynamic shared memory
// on a persistent grid: as many CTAs as the card holds at once (found once per
// kernel and device, with the shared-memory opt-in), or fewer when the call
// has fewer items than that.
template <auto Kernel>
cudaError_t launch_split(size_t smem, long long max_items, Params p, cudaStream_t stream) {
  static int resident[64];  // per device; 0 until found
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    // static and dynamic shared memory together above 48 KB need the opt-in
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    resident[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  p.resident = resident[dev];
  const int grid = (int)(max_items < p.resident ? max_items : p.resident);
  Kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Params& p, int tensor_cores, cudaStream_t stream) {
  // spans of the widest tile at the narrowest W the kernel may take
  const int ntiles = (p.s + p.q_rows - 1) / p.q_rows;
  const int w_min = p.split_cols ? p.split_cols : span_choice(0);
  const int spans = (p.max_blocks * p.bs + w_min - 1) / w_min;
  const long long max_items = (long long)p.kv * p.B * ntiles * spans;
  cudaError_t err;
  if (tensor_cores) {
    if constexpr (sizeof(T) == 2)
      err = launch_split<paged_attend_kernel_tc<T, D>>(tc_smem_bytes<D>(), max_items, p, stream);
    else
      return cudaErrorInvalidValue;  // f32 has no tensor-core body
  } else if (p.s * p.g == 1) {
    err = launch_split<paged_attend_kernel_cc<T, D, 1>>(
        (size_t)kWarps * 1 * (D + 2) * sizeof(float), max_items, p, stream);
  } else {
    err = launch_split<paged_attend_kernel_cc<T, D, 4>>(
        (size_t)kWarps * 4 * (D + 2) * sizeof(float), max_items, p, stream);
  }
  if (err != cudaSuccess || spans == 1) return err;
  paged_attend_kernel_merge<D>
      <<<(p.total_q + kMergeWarps - 1) / kMergeWarps, 32 * kMergeWarps, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int d, int tensor_cores, cudaStream_t stream) {
  if (d == 64) return launch<T, 64>(p, tensor_cores, stream);
  if (d == 128) return launch<T, 128>(p, tensor_cores, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q and the pool share it).
// tensor_cores: 1 for the tensor-core body (bfloat16/float16 only), 0 for the
// CUDA-core body. split_cols: the span W, a multiple of 64 up to 1024, or 0
// for the kernel's own choice (128, 256 or 512, WorkList). scratch: f32 partials of
// spans * B * s * h * (d + 1) elements and one int after them, spans =
// ceil(max_blocks * bs / W) at W = split_cols or 128; unused (may be null)
// when spans == 1. The caller checks shapes: h % kv == 0, h / kv <= 64, d in
// {64, 128}, all tensors contiguous on the current device.
extern "C" int paged_attend_launch(const void* q, const void* kbuf, const void* vbuf,
                                   const void* tables, const void* positions, void* out,
                                   void* scratch, int B, int s, int h, int kv, int d, int bs,
                                   int max_blocks, int dtype, float scale, int split_cols,
                                   int tensor_cores, void* stream) {
  if (B <= 0 || s <= 0 || kv <= 0 || h % kv != 0 || h / kv > kMaxQ || bs <= 0 ||
      max_blocks <= 0 || split_cols < 0 || split_cols % kKc != 0 ||
      split_cols + 1 > kMaxSpanPages || (tensor_cores && dtype == 0))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.kbuf = kbuf;
  p.vbuf = vbuf;
  p.tables = static_cast<const int*>(tables);
  p.positions = static_cast<const int*>(positions);
  p.out = static_cast<float*>(out);
  const int w_min = split_cols ? split_cols : span_choice(0);
  const size_t parts = (size_t)((max_blocks * bs + w_min - 1) / w_min) * B * s * h;
  p.o_part = static_cast<float*>(scratch);
  p.lse_part = p.o_part ? p.o_part + parts * d : nullptr;
  p.span_cols = p.o_part ? reinterpret_cast<int*>(p.lse_part + parts) : nullptr;
  p.B = B;
  p.s = s;
  p.h = h;
  p.kv = kv;
  p.g = h / kv;
  p.bs = bs;
  p.max_blocks = max_blocks;
  p.q_rows = kMaxQ / p.g;
  p.split_cols = split_cols;
  p.resident = 0;
  p.total_q = B * s * h;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_d<float>(p, d, 0, st);
    case 1:
      return (int)dispatch_d<__nv_bfloat16>(p, d, tensor_cores, st);
    case 2:
      return (int)dispatch_d<__half>(p, d, tensor_cores, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
