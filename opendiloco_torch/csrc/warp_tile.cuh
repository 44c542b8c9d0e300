// Tiles shared by the port's attention kernels (flash_attention.cu,
// spec_tail_attention.cu). A block is 4 warps and owns 64 rows, 16 a
// warp; it walks 64-row tiles of the other side, copied into shared
// memory with cp.async. A warp multiplies its 16-row tile by a shared
// tile on the tensor cores in bf16 or f16 (mma.sync.m16n8k16), or with f32
// FMAs in the same accumulator layout for f32, and rounds a score tile
// into shared memory before the product with V.
#pragma once

#include "common.cuh"

namespace {

constexpr int kRows = 64;  // rows a block owns
constexpr int kCols = 64;  // rows of each tile of the other side
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// row stride in shared memory: the padded width plus 16 bytes, so that
// rows start on different banks
template <typename T>
__host__ __device__ __forceinline__ int smem_ld(int width) { return width + 16 / (int)sizeof(T); }
__host__ __device__ __forceinline__ int padded_d(int D) { return (D + 15) & ~15; }

// Copy rows r0 .. r0 + 63 of one head of a [B, T, heads, D] tensor into a
// shared tile [64][ld]; rows at or past T are zero-filled.
template <typename T>
__device__ __forceinline__ void stage_rows(T* sm, int ld, const T* base, size_t row_stride, int r0,
                                           int T_, int D) {
    constexpr int kVec = 16 / sizeof(T);
    const int chunks = D / kVec;
    for (int c = threadIdx.x; c < kCols * chunks; c += kThreads) {
        const int r = c / chunks, col = (c % chunks) * kVec;
        const int t = r0 + r;
        const bool ok = t < T_;
        cp_async16(sm + r * ld + col, base + (ok ? (size_t)t * row_stride + col : 0), ok);
    }
}

// Zero the padding columns D .. Dp - 1 of `rows` consecutive tile rows.
template <typename T>
__device__ __forceinline__ void zero_pad_cols(T* sm, int ld, int rows, int D, int Dp) {
    const int w = Dp - D;
    if (w == 0) return;
    for (int i = threadIdx.x; i < rows * w; i += kThreads) {
        sm[(i / w) * ld + D + i % w] = T(0.0f);
    }
}

// ---------------------------------------------------------------------------
// warp tile product: C[16][8 * nb_n] += A[16][K] . B[K][8 * nb_n]
//
// A is row-major in shared memory (lda). B is read through one of two
// layouts: kNK, element (k, n) at B[n * ldb + k] (B stored transposed);
// otherwise at B[k * ldb + n]. C is held in mma.sync's accumulator
// layout: lane (g = lane / 4, t = lane % 4) holds, for each 8-column
// block nb, rows g and g + 8 at columns nb * 8 + 2t and + 1, as
// c[nb][0..3] = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
// K is a multiple of 16.
// ---------------------------------------------------------------------------

// two neighbouring 16-bit elements as one fragment register
template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}
template <typename T>
__device__ __forceinline__ uint32_t pack2(T lo, T hi) {
    return (uint32_t)*reinterpret_cast<const uint16_t*>(&lo) | ((uint32_t)*reinterpret_cast<const uint16_t*>(&hi) << 16);
}

// bf16 or f16 operands: mma.sync of that type
template <int NB, bool kNK, typename T, std::enable_if_t<kHalfWidth<T>, int> = 0>
__device__ __forceinline__ void warp_mma(float (&c)[NB][4], int nb_n, const T* A, int lda, const T* B, int ldb,
                                         int K) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    for (int k0 = 0; k0 < K; k0 += 16) {
        uint32_t a[4];
        a[0] = ld32(A + g * lda + k0 + 2 * t);
        a[1] = ld32(A + (g + 8) * lda + k0 + 2 * t);
        a[2] = ld32(A + g * lda + k0 + 2 * t + 8);
        a[3] = ld32(A + (g + 8) * lda + k0 + 2 * t + 8);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
            if (nb < nb_n) {
                const int n = nb * 8 + g;
                uint32_t b[2];
                if (kNK) {
                    b[0] = ld32(B + n * ldb + k0 + 2 * t);
                    b[1] = ld32(B + n * ldb + k0 + 2 * t + 8);
                } else {
                    b[0] = pack2(B[(k0 + 2 * t) * ldb + n], B[(k0 + 2 * t + 1) * ldb + n]);
                    b[1] = pack2(B[(k0 + 2 * t + 8) * ldb + n], B[(k0 + 2 * t + 9) * ldb + n]);
                }
                mma16816<T>(c[nb], a, b);
            }
        }
    }
}

template <int NB, bool kNK>
__device__ __forceinline__ void warp_mma(float (&c)[NB][4], int nb_n, const float* A, int lda,
                                         const float* B, int ldb, int K) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    for (int k = 0; k < K; ++k) {
        const float a0 = A[g * lda + k], a1 = A[(g + 8) * lda + k];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
            if (nb < nb_n) {
                const int n = nb * 8 + 2 * t;
                float b0, b1;
                if (kNK) {
                    b0 = B[n * ldb + k];
                    b1 = B[(n + 1) * ldb + k];
                } else {
                    b0 = B[k * ldb + n];
                    b1 = B[k * ldb + n + 1];
                }
                c[nb][0] = fmaf(a0, b0, c[nb][0]);
                c[nb][1] = fmaf(a0, b1, c[nb][1]);
                c[nb][2] = fmaf(a1, b0, c[nb][2]);
                c[nb][3] = fmaf(a1, b1, c[nb][3]);
            }
        }
    }
}

template <int NB>
__device__ __forceinline__ void zero(float (&c)[NB][4]) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) c[nb][0] = c[nb][1] = c[nb][2] = c[nb][3] = 0.0f;
}

// Write a warp's 16 x 8 NB f32 tile, rounded to T, into its shared tile.
template <typename T, int NB>
__device__ __forceinline__ void tile_to_smem(T* sm, int ld, const float (&c)[NB][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
        store2(sm + g * ld + nb * 8 + 2 * t, c[nb][0], c[nb][1]);
        store2(sm + (g + 8) * ld + nb * 8 + 2 * t, c[nb][2], c[nb][3]);
    }
}

}  // namespace
