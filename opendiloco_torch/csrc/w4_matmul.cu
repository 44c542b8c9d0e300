// Fused blockwise-4-bit dequant-matmul for Hopper (sm_90a), the first
// design: out = x @ W with W held packed, dequantized in registers and
// never written to device memory. f32 takes it (the identity probe below
// needs its f32 products); bf16 takes w4_matmul_sm90.cu (tensor cores,
// K split across blocks), and reaches this kernel only where
// ops/decode_kernels.py is asked for route="w4_matmul".
//
// Replaces: opendiloco_tpu/ops/decode_kernels.py w4_matmul (_w4_kernel,
// launched by pl.pallas_call at :561).
//
// W [K, N] is the serve plane's packed layout (PackedW4): element (k, n) has
// flat index f = k * N + n, sits in byte f / 2 of q (low nibble when f is
// even) and has scale s[f / 4096], an fp16 bit pattern. Its value is
//   (nib - 8) * (__half2float(s) / 7)
// in f32, in that order, rounded to x's dtype; products accumulate in f32
// and the output is written in x's dtype. With x = I in f32 the result is
// bit for bit dequant_w4 (every partial sum is +0 or the one weight).
//
// Layouts: x [M, K] (f32 or bf16), q [K * N / 2] uint8, s [ceil(K * N / 4096)]
// 16-bit, out [M, N]. N must be even, so a column pair shares one byte and
// one scale (4096 is even).
//
// Design. A block covers a strip of 64 columns: lane p of every warp owns
// column pair p of the strip, one packed byte per row of W. Sixteen warps
// split the rows of W (warp w takes rows w, w + 16, ...) and each thread
// keeps 8 x 2 f32 accumulators, one per row of its tile of 8 rows of x.
// The block stages that tile in shared memory 1024 columns of K at a time,
// laid out [k][8] so one row of W meets its 8 values of x in two 16-byte
// broadcast loads. A warp loads the bytes and scales of 16 rows of W
// before it uses them, so 16 loads are in flight per thread. The warps'
// partial sums are added in a fixed order through shared memory, so results
// repeat from run to run. A second grid axis walks tiles of M, so a prefill
// bucket (M up to 1024) runs too; the packed stream is read once per tile
// of M.
//
// Bound on this card: at decode (M = 8) the packed bytes + scales + x + out
// over 3.35 TB/s (about 22 MB per layer at the 1b shape: 0.5 byte per
// weight is the whole point of w4); at prefill the 2 * M * K * N operations.
// Known weaknesses: at decode the time goes to issuing the per-weight
// dequant (scale load, an IEEE divide by 7, two conversions and roundings:
// tens of instructions per byte) on the N / 64 SMs the grid occupies (4
// for the 256-wide k/v projections, 32 for the 2048-wide ones), not to
// moving bytes; one byte is loaded per thread per row of W. For bf16,
// w4_matmul_sm90.cu answers each of these (16-byte staged copies, one
// factor per row of K, K split across blocks, tensor cores at prefill);
// f32 keeps this design.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPairs = 32;          // column pairs per block: one per lane
constexpr int kWarps = 16;          // warps splitting the rows of W
constexpr int kThreads = kWarps * 32;
constexpr int kM = 8;               // rows of x per block
constexpr int kChunk = 1024;        // rows of W (columns of x) staged at a time
constexpr int kUnroll = 16;         // rows of W loaded before they are used
static_assert(kWarps * kM * 2 * kPairs <= kChunk * kM, "partial sums reuse the x tile");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// a dequantized weight rounded to the matmul dtype, as the TPU kernel's
// astype(x.dtype) does before the product
template <typename T>
__device__ __forceinline__ float round_to(float w) { return to_f32(from_f32<T>(w)); }

// one row of W (its packed byte and fp16 scale bits) times the tile's 8
// values of x (xr, 16-byte aligned), into the thread's accumulators
template <typename T>
__device__ __forceinline__ void fma_row(const float* xr, uint32_t byte, uint16_t sbits,
                                        float (&acc)[kM][2]) {
    const float sc = __half2float(__ushort_as_half(sbits)) / 7.f;
    const float w0 = round_to<T>((float)((int)(byte & 0x0F) - 8) * sc);
    const float w1 = round_to<T>((float)((int)(byte >> 4) - 8) * sc);
    const float4 xa = *reinterpret_cast<const float4*>(xr);
    const float4 xb = *reinterpret_cast<const float4*>(xr + 4);
    const float xv[kM] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int i = 0; i < kM; ++i) {
        acc[i][0] = fmaf(xv[i], w0, acc[i][0]);
        acc[i][1] = fmaf(xv[i], w1, acc[i][1]);
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
w4_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                 const uint16_t* __restrict__ s, T* __restrict__ out, int M, int K, int N) {
    // the x tile [kChunk][kM] during the K loop, then the warps' partial
    // sums [kWarps][kM][2 * kPairs]
    __shared__ __align__(16) float smem[kChunk * kM];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int m0 = blockIdx.y * kM;
    const int col0 = blockIdx.x * 2 * kPairs;
    const int n = col0 + 2 * lane;  // this thread's even column
    const bool live = n < N;

    float acc[kM][2];
#pragma unroll
    for (int i = 0; i < kM; ++i) acc[i][0] = acc[i][1] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kChunk) {
        const int kend = min(kChunk, K - k0);
        __syncthreads();  // previous x tile fully consumed
        for (int i = tid; i < kM * kChunk; i += kThreads) {
            const int kk = i / kM, mm = i % kM;
            const int m = m0 + mm;
            smem[i] = (m < M && kk < kend) ? to_f32(x[(size_t)m * K + k0 + kk]) : 0.f;
        }
        __syncthreads();
        if (live) {
            int kk = warp;
            for (; kk + (kUnroll - 1) * kWarps < kend; kk += kUnroll * kWarps) {
                uint32_t b[kUnroll];
                uint16_t sb[kUnroll];
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    const size_t f = (size_t)(k0 + kk + u * kWarps) * N + n;  // even: low nibble
                    b[u] = q[f >> 1];
                    sb[u] = s[f >> 12];
                }
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) fma_row<T>(smem + (kk + u * kWarps) * kM, b[u], sb[u], acc);
            }
            for (; kk < kend; kk += kWarps) {
                const size_t f = (size_t)(k0 + kk) * N + n;
                fma_row<T>(smem + kk * kM, q[f >> 1], s[f >> 12], acc);
            }
        }
    }

    __syncthreads();  // the x tile is dead: its memory takes the partial sums
    float* red = smem;
#pragma unroll
    for (int i = 0; i < kM; ++i) {
        red[(warp * kM + i) * 2 * kPairs + 2 * lane] = acc[i][0];
        red[(warp * kM + i) * 2 * kPairs + 2 * lane + 1] = acc[i][1];
    }
    __syncthreads();
    for (int i = tid; i < kM * 2 * kPairs; i += kThreads) {
        const int mm = i / (2 * kPairs), c = i % (2 * kPairs);
        const int m = m0 + mm, col = col0 + c;
        if (m >= M || col >= N) continue;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += red[(w * kM + mm) * 2 * kPairs + c];
        out[(size_t)m * N + col] = from_f32<T>(sum);
    }
}

template <typename T>
int launch(const void* x, const void* q, const void* s, void* out, int M, int K, int N,
           void* stream) {
    if (M < 1 || K < 1 || N < 2 || N % 2 || (M + kM - 1) / kM > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + 2 * kPairs - 1) / (2 * kPairs), (M + kM - 1) / kM);
    w4_matmul_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const uint8_t*)q, (const uint16_t*)s, (T*)out, M, K, N);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int w4_matmul_f32(const void* x, const void* q, const void* s, void* out, int M, int K, int N,
                  void* stream) {
    return launch<float>(x, q, s, out, M, K, N, stream);
}

int w4_matmul_bf16(const void* x, const void* q, const void* s, void* out, int M, int K, int N,
                   void* stream) {
    return launch<__nv_bfloat16>(x, q, s, out, M, K, N, stream);
}

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
