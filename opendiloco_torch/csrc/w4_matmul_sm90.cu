// Fused blockwise-4-bit dequant-matmul in bf16 for Hopper (sm_90a), on the
// tensor cores with K split across blocks: out = x @ W with W held packed,
// dequantized into mma.sync fragments and never written to memory.
//
// Replaces: opendiloco_tpu/ops/decode_kernels.py w4_matmul (pl.pallas_call
// at :561, kernel body _w4_kernel :468), for bf16; w4_matmul.cu keeps the
// first design, which ops/decode_kernels.py routes f32 to.
//
// W [K, N] is the serve plane's packed layout (PackedW4), as the loader
// installs it: element (k, n) has flat index f = k N + n, sits in byte
// f / 2 of q (low nibble when f is even) and has scale s[f / 4096], an
// fp16 bit pattern. Its value is (nib - 8) * (__half2float(s) / 7) in f32,
// rounded to bf16 (dequant_w4's bits); products accumulate in f32 and the
// output is rounded to bf16 once. x [M, K] and out [M, N] bf16, row-major;
// K a multiple of 8 and N of 64 (ops/decode_kernels.py routes other shapes
// to the first design).
//
// Bound on this card (3.35 TB/s, 989 TFLOP/s bf16): at decode (M 8) the
// packed bytes, 0.5 a weight, plus the scales, x and out: 22.6 MB and
// 0.00675 ms for one config_1b layer's seven matmuls; at prefill (M 1024)
// the 2 M K N operations, 0.0917 ms a layer.
//
// Design.
// 1. A block owns a tile of 64 columns x 16 MI rows of x (MI 1-4, from M)
//    over one split of K, with W warps (8 at decode, MI 1; else 4), each
//    taking one 16-row step of K a stage. The packed rows of its columns
//    (32 bytes a row) and the x rows go through a 4-stage ring of 16-byte
//    cp.async copies, 16 W rows of K a stage, zero filled past K and M; the
//    factors (3. below) are computed while the first stages are in flight.
// 2. The weights go straight from the packed bytes into mma.sync m16n8k16
//    B fragments (bf16 in, f32 accumulate). Lane (g, t) of a warp reads one
//    32-bit word, the 8 nibbles of columns 8g .. 8g + 7, from each of the 4
//    rows of K its fragments hold (2t, 2t + 1, 2t + 8, 2t + 9), so nibble j
//    feeds n8 block j, whose column g stands for physical column 8g + j.
//    No byte is read twice and none is wasted; the accumulator's columns
//    come out permuted, and lane (g, t) holds the 16 consecutive columns
//    16t .. 16t + 15 of its rows. x's A fragments come by ldmatrix.
// 3. Dequant. A column tile's 64 columns of one row of K share one 4096
//    element scale block (N and the tile start are multiples of 64), so the
//    block's factor half2float(s) / 7 is computed once a row of K, IEEE
//    divide and all, into shared memory before the loop. A nibble becomes
//    the exact float nib - 8 with one OR into the exponent of 2^23 and one
//    subtraction, then one multiply by the factor and a paired
//    round-to-nearest into bf16: the bits of dequant_w4, with no divide,
//    no integer conversion and no table in the inner loop. (A 16-entry
//    bf16 table a scale block, looked up by nibble, needs one shared-memory
//    load a weight, a quarter of the ALU's rate on this card; the
//    arithmetic above is four ALU instructions a weight from registers.)
// 4. K is split across blocks: ops/decode_kernels.py w4_splits picks the
//    count from M, K, N and the SM count alone, enough blocks for twice the
//    SMs but at most 8 splits (1 where the tiles already fill the card
//    twice, as at prefill; past 8 splits the partials and their ordered sum
//    cost more than the added blocks gain, as timed), and split z takes the
//    16-row steps ksteps z / S .. ksteps (z + 1) / S - 1. The warps' sums
//    are added in warp order through shared memory. With one split the block writes out;
//    otherwise it writes its f32 partial into part [S][M][N], and the last
//    block of the tile to finish (an integer ticket in counters, which
//    that block puts back to 0) adds the S partials in split order and
//    writes out. The floating-point sums never go through atomics, so the
//    bits repeat from run to run.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBN = 64;              // columns of a tile
constexpr int kStages = 4;
constexpr int kQRow = kBN / 2 + 16;  // bytes of a packed row in shared memory (+16: no bank conflicts)
constexpr int kRedRow = kBN + 4;     // floats of a row of the warps' sums

// MI 16-row slices of x a block owns, W warps (one 16-row step of K each a
// stage); decode (MI 1) takes 8 warps, the rest 4
template <int MI, int W>
struct Cfg {
    static constexpr int kThreads = 32 * W;
    static constexpr int kRows = 16 * MI;            // rows of x a block owns
    static constexpr int kBK = 16 * W;               // rows of K a stage
    static constexpr int kXRow = kBK * 2 + 16;       // bytes of an x row in shared memory (+16: ldmatrix conflict-free)
    static constexpr int kStageQ = kBK * kQRow;
    static constexpr int kStage = kStageQ + kRows * kXRow;
    static constexpr int kRing = kStages * kStage;
    static constexpr int kRed = W * kRows * kRedRow * 4;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// nibble j of w as the exact float nib - 8: 2^23 + nib, less 2^23 + 8
__device__ __forceinline__ float nib_f32(uint32_t w, int j) {
    return __uint_as_float(0x4B000000u | ((w >> (4 * j)) & 0xFu)) - 8388616.0f;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void add4(float4& v, const float4& u) { v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w; }

template <int MI, int W>
__global__ void __launch_bounds__(Cfg<MI, W>::kThreads)
    w4_matmul_sm90_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                          const uint16_t* __restrict__ s, __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                          int* __restrict__ counters, int M, int K, int N, int splits) {
    using C = Cfg<MI, W>;
    constexpr int kBK = C::kBK, kThreads = C::kThreads;
    extern __shared__ __align__(16) uint8_t smem[];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * C::kRows, z = blockIdx.z;
    const int ksteps = (K + 15) / 16;
    const int a = (int)((long long)ksteps * z / splits), b = (int)((long long)ksteps * (z + 1) / splits);
    const int k_begin = 16 * a, k_end = min(K, 16 * b);
    const int nst = (b - a + W - 1) / W;
    float* fac = reinterpret_cast<float*>(smem + C::kRing);  // the factor of each row of the split

    auto load = [&](int j) {
        uint8_t* st = smem + (j % kStages) * C::kStage;
        const int kr0 = k_begin + j * kBK;
        for (int i = tid; i < kBK * 2; i += kThreads) {  // packed bytes: kBK rows x 2 chunks of 16
            const int r = i >> 1, c = i & 1, k = kr0 + r;
            const bool ok = k < k_end;
            cp_async16(st + r * kQRow + 16 * c, ok ? q + (size_t)k * (N / 2) + n0 / 2 + 16 * c : q, ok);
        }
        for (int i = tid; i < C::kRows * 2 * W; i += kThreads) {  // x: kRows rows x 2W chunks of 8 bf16
            const int r = i / (2 * W), c = i % (2 * W), m = m0 + r, k = kr0 + 8 * c;
            const bool ok = m < M && k < k_end;
            cp_async16(st + C::kStageQ + r * C::kXRow + 16 * c, ok ? x + (size_t)m * K + k : x, ok);
        }
    };

    float acc[MI][8][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;

#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
        if (j < nst) load(j);
        cp_async_commit();
    }
    // the factors, while the first stages are in flight: one scale a row of
    // K for the tile's 64 columns; 0 past K
    for (int r = tid; r < nst * kBK; r += kThreads) {
        const int k = k_begin + r;
        fac[r] = k < k_end ? __half2float(__ushort_as_half(s[((size_t)k * N + n0) >> 12])) / 7.f : 0.f;
    }
    for (int j = 0; j < nst; ++j) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // stage j has landed (and the factors), every warp is done with stage j - 1
        if (j + kStages - 1 < nst) load(j + kStages - 1);
        cp_async_commit();
        if (a + j * W + warp >= b) continue;  // past the split's last step
        const uint8_t* st = smem + (j % kStages) * C::kStage;
        const int kk = 16 * warp;  // this warp's rows of the stage
        uint32_t w[4];
        float f[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = kk + 2 * t + (i & 1) + 8 * (i >> 1);
            w[i] = *reinterpret_cast<const uint32_t*>(st + r * kQRow + 4 * g);
            f[i] = fac[j * kBK + r];
        }
        uint32_t bf[8][2];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            bf[n][0] = bf16x2(nib_f32(w[0], n) * f[0], nib_f32(w[1], n) * f[1]);
            bf[n][1] = bf16x2(nib_f32(w[2], n) * f[2], nib_f32(w[3], n) * f[3]);
        }
        const uint32_t xs = static_cast<uint32_t>(__cvta_generic_to_shared(st + C::kStageQ));
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
            uint32_t af[4];
            ldsm_x4(af, xs + (mi * 16 + (lane & 15)) * C::kXRow + (kk + (lane >> 4) * 8) * 2);
#pragma unroll
            for (int n = 0; n < 8; ++n) mma16816(acc[mi][n], af, bf[n]);
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring and the factors are free

    // the warps' sums, in warp order: lane (g, t) holds rows g and g + 8 of
    // each 16-row slice at columns 16t + n (entries 0, 2) and 16t + 8 + n (1, 3)
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = mi * 16 + g + 8 * (e >> 1), col = 16 * t + 8 * (e & 1) + n;
                red[(warp * C::kRows + row) * kRedRow + col] = acc[mi][n][e];
            }
        }
    }
    __syncthreads();
    const size_t MN = (size_t)M * N;
    for (int i = tid; i < C::kRows * kBN / 4; i += kThreads) {
        const int row = i / (kBN / 4), col = 4 * (i % (kBN / 4)), m = m0 + row;
        if (m >= M) continue;
        float4 v = *reinterpret_cast<const float4*>(red + row * kRedRow + col);
#pragma unroll
        for (int wp = 1; wp < W; ++wp) add4(v, *reinterpret_cast<const float4*>(red + (wp * C::kRows + row) * kRedRow + col));
        const size_t o = (size_t)m * N + n0 + col;
        if (splits == 1) {
            store2(out + o, v.x, v.y);
            store2(out + o + 2, v.z, v.w);
        } else {
            *reinterpret_cast<float4*>(part + z * MN + o) = v;
        }
    }
    if (splits == 1) return;

    // the last block of the tile to finish adds the splits in order (the
    // flag sits in the sums' buffer, read by every thread before the barrier)
    int* last = reinterpret_cast<int*>(smem);
    __threadfence();  // this block's partial is visible to every block
    __syncthreads();
    int* ticket = counters + blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) *last = atomicAdd(ticket, 1) == splits - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    for (int i = tid; i < C::kRows * kBN / 4; i += kThreads) {
        const int row = i / (kBN / 4), col = 4 * (i % (kBN / 4)), m = m0 + row;
        if (m >= M) continue;
        const float* p = part + (size_t)m * N + n0 + col;
        float4 v = __ldcg(reinterpret_cast<const float4*>(p));
        int sp = 1;
        for (; sp + 8 <= splits; sp += 8) {  // 8 loads in flight, added in split order
            float4 u[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) u[k] = __ldcg(reinterpret_cast<const float4*>(p + (sp + k) * MN));
#pragma unroll
            for (int k = 0; k < 8; ++k) add4(v, u[k]);
        }
        for (; sp < splits; ++sp) add4(v, __ldcg(reinterpret_cast<const float4*>(p + sp * MN)));
        __nv_bfloat16* o = out + (size_t)m * N + n0 + col;
        store2(o, v.x, v.y);
        store2(o + 2, v.z, v.w);
    }
    if (tid == 0) *ticket = 0;  // ready for the next launch on this stream
}

template <int MI, int W>
int run(const void* x, const void* q, const void* s, void* out, void* part, void* counters, int M, int K, int N,
        int splits, cudaStream_t st) {
    using C = Cfg<MI, W>;
    const int ksteps = (K + 15) / 16;
    const int nst_max = ((ksteps + splits - 1) / splits + W - 1) / W;
    const size_t smem = max((size_t)C::kRing + (size_t)nst_max * C::kBK * 4, (size_t)C::kRed);
    cudaError_t err = allow_smem<w4_matmul_sm90_kernel<MI, W>>(smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(N / kBN, (M + C::kRows - 1) / C::kRows, splits);
    w4_matmul_sm90_kernel<MI, W><<<grid, C::kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q), static_cast<const uint16_t*>(s),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(part), static_cast<int*>(counters), M, K, N, splits);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// mi: the 16-row slices of x a block owns (1-4); part: f32 [splits][M][N]
// when splits > 1; counters: one int a (row tile, column tile), all 0
int w4_matmul_sm90_bf16(const void* x, const void* q, const void* s, void* out, void* part, void* counters, int M,
                        int K, int N, int mi, int splits, void* stream) {
    if (M < 1 || K < 8 || K % 8 || N < kBN || N % kBN || splits < 1 || splits > (K + 15) / 16 ||
        (M + 16 * mi - 1) / (16 * mi) > 65535 || splits > 65535)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (mi) {
        case 1: return run<1, 8>(x, q, s, out, part, counters, M, K, N, splits, st);
        case 2: return run<2, 4>(x, q, s, out, part, counters, M, K, N, splits, st);
        case 3: return run<3, 4>(x, q, s, out, part, counters, M, K, N, splits, st);
        case 4: return run<4, 4>(x, q, s, out, part, counters, M, K, N, splits, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
