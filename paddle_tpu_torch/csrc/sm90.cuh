// Hopper (sm_90a) building blocks shared by the port's CUDA sources: the
// 128-byte swizzle, wgmma (operands from shared memory, or A from
// registers) and its descriptors, mbarriers, TMA tile loads, register
// rebalancing between warpgroups, and the driver's tensor-map encoder.
// Included by conv3x3_bn.cu (K8), flash_attention.cu (K1-K4) and
// resnet_unit.cu (K7); each library gets its own copy (everything here has
// internal linkage).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The 128-byte swizzle of TMA and wgmma: in a tile of 128-byte rows the
// 16-byte chunk c of the row at shared address `row` sits at chunk c ^ (row /
// 128 mod 8). It is a function of the address, so the prologue computes it
// from the address, and tiles that TMA writes with it or wgmma reads with it
// start on a 1024-byte boundary.
__device__ __forceinline__ uint32_t swz(uint32_t row, int col) {
  return row + ((((col >> 3) ^ (row >> 7)) & 7) << 4);
}

// The element type of a wgmma's 16-bit operands: bf16 by default, fp16 on
// request (the f32 accumulator is the same). The instruction text differs
// in the type only, so each product's text is a macro of it.
template <typename E>
constexpr bool kIsF16 = false;
template <>
constexpr bool kIsF16<__half> = true;

#define SM90_ACC32 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SM90_ACC64 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define SM90_SS_N64(T) "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." T "." T " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, %35, %36;\n" \
      "}\n"
#define SM90_RS_N64(T) "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." T "." T " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n" \
      "}\n"
#define SM90_SS_N128(T) "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." T "." T " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, %67, %68;\n" \
      "}\n"
#define SM90_RS_N128(T) "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." T "." T " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n" \
      "}\n"

// wgmma (sm_90a): D[64 x 64] (f32) += A[64 x 16] B[16 x 64], bf16 (or, with
// E = __half, fp16) operands
// from shared memory through descriptors (scale_d = 0: D = A B); TRANS_A = 1
// reads A MN-major (M contiguous), TRANS_B = 1 reads B MN-major (N
// contiguous), 0 K-major. The accumulator fragment: lane 4 g + t of warp w
// of the warpgroup holds rows 16 w + g (d[4 j], d[4 j + 1]) and 16 w + g + 8
// (d[4 j + 2], d[4 j + 3]) at columns 8 j + 2 t, 8 j + 2 t + 1.
template <int TRANS_A, int TRANS_B, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  if constexpr (kIsF16<E>)
    asm volatile(SM90_SS_N64("f16")
                 : SM90_ACC32
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B)
                 : "memory");
  else
    asm volatile(SM90_SS_N64("bf16")
                 : SM90_ACC32
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B)
                 : "memory");
}

// the same with scale_d = 1 (accumulate), as K8's kernels call it
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  wgmma_ss_n64<TRANS_A, TRANS_B>(d, desc_a, desc_b, 1);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory writes of the generic proxy (st.shared) made visible to the
// async proxy, which TMA writes and wgmma reads with.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma descriptor for a tile of 128-byte rows with the 128-byte swizzle
// (layout type 1) starting at shared address `addr` (at a swizzle atom, or 32
// bytes per 16 along K into one for K-major); lbo and sbo in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

// A wgmma descriptor without swizzle (layout type 0): 8 x 16-byte core
// matrices of 128 contiguous bytes; lbo and sbo in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32);
}

// mbarriers: a stage's barrier completes when its TMA boxes have landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// TMA tile loads into shared memory, completing on `bar`; coordinates are
// innermost first and may lie outside the tensor (those elements are zero).
__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_5d(uint32_t dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// A TMA tile store from shared memory (after a fence.proxy.async by the
// threads that wrote it); the stores of a thread form bulk groups, and the
// shared memory may be written again once its group has been read.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The dynamic shared memory from its first 1024-byte boundary.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The same products at other widths. wgmma_ss_n128: D[64 x 128] += A B,
// both from shared memory (accumulator fragment as above, j < 16).
// wgmma_rs_nN: D[64 x N] += A B with A[64 x 16] from registers: warp w of
// the warpgroup passes rows 16 w + g and 16 w + g + 8 of A, lane 4 g + t
// holding a[0] = (row g, columns 2 t, 2 t + 1), a[1] = (row g + 8, the
// same), a[2] = (row g, 2 t + 8, 2 t + 9), a[3] = (row g + 8, the same),
// the lower column in the lower half: the accumulator of the previous
// product, columns 16 k .. 16 k + 15, packed pairwise to bf16, is such an
// A (d[8 k + 2 i], d[8 k + 2 i + 1] -> a[i]).
template <int TRANS_B, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  if constexpr (kIsF16<E>)
    asm volatile(SM90_RS_N64("f16")
                 : SM90_ACC32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
                   "n"(TRANS_B)
                 : "memory");
  else
    asm volatile(SM90_RS_N64("bf16")
                 : SM90_ACC32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
                   "n"(TRANS_B)
                 : "memory");
}

template <int TRANS_A, int TRANS_B, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  if constexpr (kIsF16<E>)
    asm volatile(SM90_SS_N128("f16")
                 : SM90_ACC64
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B)
                 : "memory");
  else
    asm volatile(SM90_SS_N128("bf16")
                 : SM90_ACC64
                 : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B)
                 : "memory");
}

template <int TRANS_B, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  if constexpr (kIsF16<E>)
    asm volatile(SM90_RS_N128("f16")
                 : SM90_ACC64
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
                   "n"(TRANS_B)
                 : "memory");
  else
    asm volatile(SM90_RS_N128("bf16")
                 : SM90_ACC64
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
                   "n"(TRANS_B)
                 : "memory");
}

// Keeps the compiler from moving an accumulator's registers across the
// issue of an asynchronous wgmma and its wait.
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two floats rounded to bf16 (fp16) and packed, the lower in the lower
// half: a register of a wgmma A fragment, or a pair to store.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsF16<E>)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

// Named barriers 1.. (0 is __syncthreads): wait until n threads have
// arrived (the waiting ones included), or arrive without waiting.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// One arrival on an mbarrier (a consumer releasing a stage).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Register rebalancing between the warpgroups of a warp-specialised
// kernel; every warp of the warpgroup executes it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// cuTensorMapEncodeTiled, fetched through the CUDA runtime's entry-point
// query (the library links the runtime alone).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first, dense), zeros
// outside the tensor.
bool make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
              const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  cuuint64_t strides[4];
  cuuint64_t s = dims[0] * 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = s, s *= dims[i + 1];
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
             box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
