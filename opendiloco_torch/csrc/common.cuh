// Helpers shared by the port's hand-written Hopper kernels
// (flash_attention.cu, fused_xent.cu): asynchronous 16-byte copies into
// shared memory, the bf16 tensor-core product, quad reductions over the
// four lanes that share an accumulator row, paired stores, and the
// one-time opt-in to a block's full shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;
constexpr size_t kSmemMax = 232448;  // opt-in shared memory of one block
constexpr float kNegInf = -1e30f;    // the TPU kernels' finite -inf
constexpr unsigned kFull = 0xffffffffu;

// two neighbouring elements from f32
__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool valid) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
    const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// c += a . b on the tensor cores: a 16 x 16 bf16 A fragment, a 16 x 8 B
// fragment, f32 accumulators in mma.sync's layout
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// max and sum over the 4 lanes that share a row
__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
    return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(kFull, x, 1);
    return x + __shfl_xor_sync(kFull, x, 2);
}

// Raise a kernel's dynamic shared memory limit once per device.
template <auto Kernel>
cudaError_t allow_smem(size_t smem) {
    static std::atomic<bool> done[kMaxDevices];
    if (smem > kSmemMax) return cudaErrorInvalidValue;
    if (smem <= 48 * 1024) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(true, std::memory_order_release);
    return err;
}

}  // namespace
