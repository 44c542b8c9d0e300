// Hopper (sm_90a) building blocks of the port's warp-specialised kernels
// (flash_attention_fwd_sm90.cu, flash_attention_bwd_sm90.cu,
// fused_xent_sm90.cu):
// tensor-memory-accelerator (TMA) copies completed on an mbarrier, the
// mbarrier ring of a producer warp and its consumer warpgroups,
// setmaxnreg, and warpgroup matrix products (wgmma) with their
// shared-memory descriptors; the attention kernels' tile geometry, operand
// descriptors, in-register softmax and accumulator epilogue; on the host,
// tiled tensor maps encoded through cudaGetDriverEntryPoint (no -lcuda).
//
// Every product, fragment and tensor map takes its element type E, bf16 or
// f16: the two share every shape, descriptor, swizzle and transpose bit
// (both are 2 bytes); only the PTX operand type (.bf16 or .f16), the
// rounding of f32 into a fragment (pack_rn) and the TMA data type differ.
//
// Shared-memory tiles are written by TMA with a 128-byte swizzle (rows of
// 64 elements) or a 64-byte one (rows of 32), from a base aligned to
// 1024 bytes, and read by wgmma through descriptors of the same swizzle:
//   K-major (the reduction dimension contiguous in a row): the stride
//     byte offset is 8 rows (one 8-row group to the next); a 16-wide k
//     step adds 32 bytes to the start address.
//   MN-major (rows are the reduction dimension, the M or N columns
//     contiguous): the stride byte offset is 8 rows; a 16-deep k step adds
//     16 rows; the leading byte offset steps from one swizzle atom (64
//     columns at 128 B, 32 at 64 B) to the next.
#pragma once

#include <math.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// device: barriers and copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrive, and expect `bytes` more from copies completing on the barrier
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
    }
}

// TMA: copy the box at coordinates (c0 innermost .. c3) of a 4-D tensor
// map into shared memory; the bytes complete on `bar`. Out-of-bounds
// elements are filled with zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// TMA: copy the box at coordinates (c0 innermost, c1) of a 2-D tensor map
// into shared memory; the bytes complete on `bar`. Out-of-bounds elements
// are filled with zeros (and still count towards the bytes).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
}

// TMA: copy a shared-memory box to coordinates (c0 .. c3) of a 4-D tensor
// map, in this thread's bulk group; rows outside the tensor are not
// written. Shared-memory writes of other threads must be made visible to
// the copy first (fence_proxy_async, then a barrier).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0, int c1, int c2,
                                             int c3) {
    asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                     reinterpret_cast<uint64_t>(map)),
                 "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
                 : "memory");
}
// TMA: copy a shared-memory box to coordinates (c0 innermost, c1) of a
// 2-D tensor map, or add it element by element to what is there (f32:
// one add an element, in the memory system), in this thread's bulk group;
// what lies outside the tensor is not written. As tma_store_4d, other
// threads' shared-memory writes must be made visible to the copy first.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
    asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                     reinterpret_cast<uint64_t>(map)),
                 "r"(smem_u32(src)), "r"(c0), "r"(c1)
                 : "memory");
}
__device__ __forceinline__ void tma_add_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
    asm volatile("cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                     reinterpret_cast<uint64_t>(map)),
                 "r"(smem_u32(src)), "r"(c0), "r"(c1)
                 : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// wait until this thread's bulk copies have read their shared memory
__device__ __forceinline__ void bulk_wait_read0() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
// order this thread's shared-memory writes before later TMA (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Named barrier `id` (1-15) over n threads
__device__ __forceinline__ void named_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Store four 8 x 8 matrices of 16-bit elements to shared memory: register i of lane
// (g, t) holds row g, columns 2t and 2t + 1 of matrix i (the accumulator
// fragment layout); lanes 8i .. 8i + 7 give the addresses of matrix i's rows.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r0), "r"(r1),
                 "r"(r2), "r"(r3)
                 : "memory");
}

// Registers per thread of the calling warpgroup (a multiple of 8 in 24..256)
template <int N>
__device__ __forceinline__ void regs_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// device: warpgroup matrix products
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and swizzle (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint32_t swizzle) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin registers that an in-flight wgmma reads or writes: the compiler
// may not move their uses across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x in one special-function instruction (2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// d[64 x 64] (+)= A . B^T, A and B K-major E (bf16 or f16) in shared memory
#define ODTP_WGMMA_SS_N64(TY) \
    asm volatile( \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
            "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
            : "l"(desc_a), "l"(desc_b), "r"(accumulate))
template <typename E>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    static_assert(kHalfWidth<E>, "bf16 or f16");
    if constexpr (kF16<E>) {
        ODTP_WGMMA_SS_N64("f16");
    } else {
        ODTP_WGMMA_SS_N64("bf16");
    }
}
#undef ODTP_WGMMA_SS_N64

// d[64 x 128] (+)= A . B^T, A and B K-major E in shared memory; d0
// holds columns 0-63 and d1 columns 64-127, each in the m64n64 layout
#define ODTP_WGMMA_SS_N128(TY) \
    asm volatile( \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
            "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
            : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), \
              "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]), \
              "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]), \
              "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]), \
              "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]), \
              "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]), \
              "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]), \
              "+f"(d0[28]), "+f"(d0[29]), "+f"(d0[30]), "+f"(d0[31]), \
              "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]), \
              "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]), \
              "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]), \
              "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]), \
              "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]), \
              "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]), "+f"(d1[23]), \
              "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]), \
              "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31]) \
            : "l"(desc_a), "l"(desc_b), "r"(accumulate))
template <typename E>
__device__ __forceinline__ void wgmma_ss_n128(float (&d0)[32], float (&d1)[32], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
    static_assert(kHalfWidth<E>, "bf16 or f16");
    if constexpr (kF16<E>) {
        ODTP_WGMMA_SS_N128("f16");
    } else {
        ODTP_WGMMA_SS_N128("bf16");
    }
}
#undef ODTP_WGMMA_SS_N128

// d[64 x 256] (+)= A . B, A and B E in shared memory, each K-major
// (TA, TB 0) or MN-major (1, the transpose bit): the register layout of
// m64n64 repeated for every 64 columns (d[4 nb + e] for 8-column block nb)
#define ODTP_WGMMA_SS_N256(TY) \
    asm volatile( \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" \
            "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " \
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n}\n" \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
              "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
              "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
              "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
              "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
              "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
              "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
              "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
              "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
              "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
              "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
              "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
              "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
              "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
              "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
              "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
              "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
              "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
              "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
            : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB))
template <typename E, int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    static_assert(kHalfWidth<E>, "bf16 or f16");
    if constexpr (kF16<E>) {
        ODTP_WGMMA_SS_N256("f16");
    } else {
        ODTP_WGMMA_SS_N256("bf16");
    }
}
#undef ODTP_WGMMA_SS_N256

// d[64 x 64] += A . B, A of E in registers (the m64k16 fragment), B
// MN-major E in shared memory (the transpose bit set)
#define ODTP_WGMMA_RS_N64(TY) \
    asm volatile( \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
            "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
template <typename E>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
    static_assert(kHalfWidth<E>, "bf16 or f16");
    if constexpr (kF16<E>) {
        ODTP_WGMMA_RS_N64("f16");
    } else {
        ODTP_WGMMA_RS_N64("bf16");
    }
}
#undef ODTP_WGMMA_RS_N64

// d[64 x 32] += A . B, A of E in registers (the m64k16 fragment), B
// MN-major E in shared memory (the transpose bit set)
#define ODTP_WGMMA_RS_N32(TY) \
    asm volatile( \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
            "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
template <typename E>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
    static_assert(kHalfWidth<E>, "bf16 or f16");
    if constexpr (kF16<E>) {
        ODTP_WGMMA_RS_N32("f16");
    } else {
        ODTP_WGMMA_RS_N32("bf16");
    }
}
#undef ODTP_WGMMA_RS_N32

// ---------------------------------------------------------------------------
// device: the tiles, operands and epilogue of the attention kernels
// ---------------------------------------------------------------------------

constexpr int kTile = 64;   // rows of a streamed tile, and of a warpgroup's share
constexpr int kOwn = 128;   // rows a CTA owns: two consumer warpgroups
constexpr int kCtaThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

// Shared tiles at head dim D: kBlk column blocks of kCb elements, each block
// rows x kRowBytes, swizzled (kSwz: 1 = 128 B, 2 = 64 B).
template <int D>
struct Geo {
    static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
    static constexpr int kCb = D >= 64 ? 64 : 32;
    static constexpr int kBlk = D / kCb;
    static constexpr int kRowBytes = kCb * 2;
    static constexpr uint32_t kSwz = kCb == 64 ? 1 : 2;
    static constexpr int kStages = D <= 64 ? 3 : 2;
    static constexpr int kN = kCb;  // width of each output product (one column block)
};

// K-major operand (the reduction over D along each row): rows r0 .. r0+63
// of a `rows`-row tile at `tile`, columns 16 ks .. 16 ks + 15.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int r0, int ks) {
    using G = Geo<D>;
    const int col = ks * 16;
    const uint32_t addr = tile + (col / G::kCb) * rows * G::kRowBytes + r0 * G::kRowBytes + (col % G::kCb) * 2;
    return smem_desc(addr, 16, 8 * G::kRowBytes, G::kSwz);
}
// MN-major B operand (the reduction along the tile's rows): rows 16 kk ..
// 16 kk + 15 of a `rows`-row tile, column block blk as the N columns.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int blk, int kk) {
    using G = Geo<D>;
    const uint32_t addr = tile + blk * rows * G::kRowBytes + kk * 16 * G::kRowBytes;
    return smem_desc(addr, rows * G::kRowBytes, 8 * G::kRowBytes, G::kSwz);
}

template <typename E, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b) {
    if constexpr (N == 64) wgmma_rs_n64<E>(d, a, desc_b);
    else wgmma_rs_n32<E>(d, a, desc_b);
}

// Round a 64 x 64 f32 accumulator into the four A fragments of E of its
// 16-wide k steps (columns 16 kk .. 16 kk + 15: blocks 2 kk and 2 kk + 1).
template <typename E>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4], const float (&c)[32]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[kk][i] = pack_rn<E>(c[8 * kk + 2 * i], c[8 * kk + 2 * i + 1]);
    }
}

// Entries of a warpgroup's 64 x 64 score tile where dead(nb, e) holds
// become -inf (e indexes the four entries of column block nb), so that
// they drop out of a row max and 2^x makes them exactly 0.
template <typename Dead>
__device__ __forceinline__ void mask_tile(float (&x)[32], Dead dead) {
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[4 * nb + e] = dead(nb, e) ? -INFINITY : x[4 * nb + e];
    }
}

// p = 2^(x scale_log2 - l(nb, e)) over a 64 x 64 score tile in place: an
// FFMA and an ex2 an entry (-inf, a masked score, gives 0 for finite l)
template <typename L>
__device__ __forceinline__ void exp2_tile(float (&x)[32], float scale_log2, L l) {
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[4 * nb + e] = exp2_approx(fmaf(x[4 * nb + e], scale_log2, -l(nb, e)));
    }
}

// exp2_tile, after masking a tile that `masked` marks (one that crosses
// the diagonal or T): the common, unmasked tile tests nothing
template <typename L, typename Dead>
__device__ __forceinline__ void exp_tile(float (&x)[32], float scale_log2, bool masked, L l, Dead dead) {
    if (masked) mask_tile(x, dead);
    exp2_tile(x, scale_log2, l);
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&c)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) c[i] = 0.0f;
}

// Write a warpgroup's 64 x D accumulator (kBlk blocks of kN columns) to
// rows row0 + .. of a [B, T, heads, D] tensor at `base` (row stride rs),
// times mul, keeping rows < T.
template <int D, typename TO>
__device__ __forceinline__ void store_acc(TO* base, size_t rs, int row0, int T_,
                                          const float (&c)[Geo<D>::kBlk][Geo<D>::kN / 2], float mul) {
    using G = Geo<D>;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int blk = 0; blk < G::kBlk; ++blk) {
#pragma unroll
        for (int nb = 0; nb < G::kN / 8; ++nb) {
            const int col = blk * G::kCb + nb * 8 + 2 * t;
            const float* e = &c[blk][4 * nb];
            if (r0 < T_) store2(base + (size_t)r0 * rs + col, e[0] * mul, e[1] * mul);
            if (r1 < T_) store2(base + (size_t)r1 * rs + col, e[2] * mul, e[3] * mul);
        }
    }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
    return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~(uintptr_t)1023);
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

// The card's SM count, read once per device: a driver query on every
// launch would lengthen the host-bound stretches of a step
inline cudaError_t sm_count(int* sms) {
    static std::atomic<int> counts[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    int n = counts[dev].load(std::memory_order_acquire);
    if (n == 0) {
        if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
        counts[dev].store(n, std::memory_order_release);
    }
    *sms = n;
    return cudaSuccess;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, resolved once through the CUDA runtime
inline EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = []() -> EncodeTiledFn {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q) !=
            cudaSuccess)
            return nullptr;
#else
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess)
            return nullptr;
#endif
        return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
    }();
    return fn;
}

// The TMA data type of E
template <typename E>
constexpr CUtensorMapDataType kMapType = kF16<E> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// An E (bf16 or f16) [B, T, heads, D] tensor, boxes of `rows` rows of one
// head and `cols` (64 or 32) columns, swizzled to match the wgmma
// descriptors; rows past T read as zeros.
template <typename E>
inline cudaError_t rows_map(CUtensorMap* map, const void* base, int B, int T, int heads, int D, int rows, int cols) {
    static_assert(kHalfWidth<E>, "bf16 or f16: 2-byte elements");
    EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2, (cuuint64_t)T * heads * D * 2};
    const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUresult r = fn(map, kMapType<E>, 4, const_cast<void*>(base), dims, strides, box,
                          elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A row-major [rows, cols] matrix of `type` (elements of `elt` bytes),
// boxes of box_rows rows and box_cols columns (one 128-byte swizzle row:
// 64 bf16 or f16, or 32 f32), swizzled to match the wgmma descriptors and the
// epilogues' shared tiles; what lies past the matrix reads as zeros.
inline cudaError_t matrix_map(CUtensorMap* map, CUtensorMapDataType type, int elt, const void* base, int rows,
                              int cols, int box_rows, int box_cols) {
    EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * elt};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}
template <typename E>
inline cudaError_t elt_matrix_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows, int box_cols) {
    static_assert(kHalfWidth<E>, "bf16 or f16: 2-byte elements");
    return matrix_map(map, kMapType<E>, 2, base, rows, cols, box_rows, box_cols);
}

}  // namespace
