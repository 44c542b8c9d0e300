// The attention backward's preprocess: delta = rowsum(dO * O) in f32,
// [B, T, H, D] -> [B, H, T], which both backward routes (B2a and B2b in
// flash_attention.cu and flash_attention_bwd_sm90.cu) read. The JAX
// package computes it in XLA outside Pallas (opendiloco_tpu/ops/
// flash_attention.py _delta, :280): no pallas_call is replaced.
//
// Takes f32, bf16 and f16, D a multiple of 8 up to 128, any B, T and H; dO, O
// contiguous and 16-byte aligned (the wrapper checks).
//
// Bound on this card (3.35 TB/s): it reads dO and O once and writes delta
// once, at the 1b head geometry (B 8, T 1024, 32 x 64, bf16) 67 MB, 0.020
// ms; its 2 B T H D flops are nothing beside that. Bound by bytes.
//
// Design: a group of G lanes (G the power of two at or above the row's
// 16-byte chunks: 8 for bf16 or f16 at D 64) takes one row, one 16-byte load of
// dO and of O a lane. Groups walk the rows in delta's order (b, h, t), so
// a warp's lanes write neighbouring floats and each group reads whole
// 128-byte lines. Each lane sums its chunk in f32 in element order, then
// the group adds by xor shuffles: a fixed order, so results repeat bit for
// bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// sum of the products of one 16-byte chunk of each operand, in order
__device__ __forceinline__ float dot_chunk(const uint4& x, const uint4& y, float) {
    const float* a = reinterpret_cast<const float*>(&x);
    const float* b = reinterpret_cast<const float*>(&y);
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) s = fmaf(a[i], b[i], s);
    return s;
}
__device__ __forceinline__ float dot_chunk(const uint4& x, const uint4& y, __nv_bfloat16) {
    const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 fa = __bfloat1622float2(a[i]), fb = __bfloat1622float2(b[i]);
        s = fmaf(fa.x, fb.x, s);
        s = fmaf(fa.y, fb.y, s);
    }
    return s;
}
__device__ __forceinline__ float dot_chunk(const uint4& x, const uint4& y, __half) {
    const __half2* a = reinterpret_cast<const __half2*>(&x);
    const __half2* b = reinterpret_cast<const __half2*>(&y);
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 fa = __half22float2(a[i]), fb = __half22float2(b[i]);
        s = fmaf(fa.x, fb.x, s);
        s = fmaf(fa.y, fb.y, s);
    }
    return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                                                         float* __restrict__ delta, int T_, int H, int D,
                                                         long long rows, int group_log2) {
    constexpr int kVec = 16 / sizeof(T);  // elements of one 16-byte chunk
    const int gl = threadIdx.x & ((1 << group_log2) - 1);
    const long long idx = ((long long)blockIdx.x * kThreads + threadIdx.x) >> group_log2;  // (b, h, t)
    float acc = 0.0f;
    if (idx < rows && gl * kVec < D) {
        const int t = (int)(idx % T_);
        const long long bh = idx / T_;
        const int h = (int)(bh % H);
        const long long b = bh / H;
        const size_t off = (((size_t)b * T_ + t) * H + h) * D + (size_t)gl * kVec;
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(dout + off));
        const uint4 y = __ldg(reinterpret_cast<const uint4*>(out + off));
        acc = dot_chunk(x, y, T());
    }
    for (int o = (1 << group_log2) >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
    if (gl == 0 && idx < rows) delta[idx] = acc;
}

template <typename T>
int run(const void* dout, const void* out, void* delta, int B, int T_, int H, int D, void* stream) {
    if (B < 1 || T_ < 1 || H < 1 || D < 8 || D > 128 || D % 8 != 0) return (int)cudaErrorInvalidValue;
    const int chunks = D * (int)sizeof(T) / 16;
    int group_log2 = 0;
    while ((1 << group_log2) < chunks) ++group_log2;
    const long long rows = (long long)B * H * T_;
    const long long blocks = (rows * (1 << group_log2) + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    delta_kernel<T><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(dout), static_cast<const T*>(out), static_cast<float*>(delta), T_, H, D, rows,
        group_log2);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int flash_attention_delta_f32(const void* dout, const void* out, void* delta, int B, int T, int H, int D,
                              void* stream) {
    return run<float>(dout, out, delta, B, T, H, D, stream);
}

int flash_attention_delta_bf16(const void* dout, const void* out, void* delta, int B, int T, int H, int D,
                               void* stream) {
    return run<__nv_bfloat16>(dout, out, delta, B, T, H, D, stream);
}

int flash_attention_delta_f16(const void* dout, const void* out, void* delta, int B, int T, int H, int D,
                              void* stream) {
    return run<__half>(dout, out, delta, B, T, H, D, stream);
}

}  // extern "C"
