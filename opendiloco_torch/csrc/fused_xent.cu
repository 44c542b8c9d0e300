// Fused lm-head + cross-entropy for Hopper (sm_90a): the forward kernel and
// the three kernels of the backward, the first design (mma.sync). f32
// takes these; bf16 takes fused_xent_sm90.cu (wgmma and TMA), and reaches
// these only where ops/fused_xent.py is asked for route="fused_xent".
//
// Replaces (opendiloco_tpu/ops/fused_xent.py):
//   B3  _fwd       (pl.pallas_call at :139, kernel body _fwd_kernel :85)
//   B4a _bwd_impl  (pl.pallas_call at :254, kernel body _dh_kernel :195)
//   B4b _bwd_impl  (pl.pallas_call at :276, kernel body _dw_kernel :219)
// with _recompute_dlog (:174), the part both backward bodies share, as a
// kernel of its own.
//
// Computes, for h [N, D], the head w [D, V] and labels [N] (int64, -100 =
// ignored), with s = h.w from operands in their own dtype and f32
// accumulation:
//   fwd   nll [N] and lse [N] f32: lse = m + log(l) by an online
//         log-sum-exp over vocab tiles, so s is never stored; the target
//         logit is gathered on the way; nll = (lse - s[label]) * mask, 0
//         where the label is -100. Columns >= V are masked.
//   dlog  for one chunk of rows: dlog = g * (exp(s - lse) - onehot),
//         rounded to h's dtype and stored [rows, V] (g is the upstream
//         gradient, already masked).
//   dh    dh_chunk = dlog . w^T, f32 accumulation, written in h's dtype.
//   dw    dw (+)= h_chunk^T . dlog in f32; the first chunk writes, later
//         chunks add in chunk order, so dw sums in a fixed order.
// All four take f32 and bf16, any N, D and V that are multiples of 8
// (16-byte rows); contiguous row-major operands.
//
// Design. The TPU kernels keep a [block_n, D] f32 dh tile and a [D,
// block_v] f32 dw tile in VMEM (about 75 MB at D 2048); on Hopper one
// 128-row dh tile at D 2048 alone is 1 MB of f32, beyond an SM's registers
// and shared memory. So the backward runs over chunks of rows (the wrapper
// walks them): dlog recomputes s once and writes the chunk's dlog in h's
// dtype (131 MB at 2048 rows and V 32000 in bf16), then two GEMMs give
// dh_chunk and add the chunk's share of dw. That is 3 products per row
// where the JAX grid does 4, and the logits of the whole batch never
// exist. Every kernel is one tiled GEMM main loop: a block of 8 warps owns
// a 128 x 128 output tile (a warp 64 x 32), K advances 32 at a time
// through a 3-stage cp.async ring in shared memory (16 bytes a copy,
// zero-filled past the edges), and the bf16 instance feeds mma.sync
// m16n8k16 (bf16 in, f32 accumulate) from ldmatrix (.trans where the
// operand is stored with M or N contiguous); the f32 instance computes the
// same accumulator positions with f32 FMAs. The forward walks the vocab
// tiles of its split with one running (m, l, target) per row and warp;
// the four column warps merge in order at the end, and when the vocab is
// split across blocks (to fill the SMs) a second small kernel merges the
// splits in order. No atomics anywhere: results repeat bit for bit.
//
// Bound on this card at the 1b training shape (N 8184, D 2048, V 32000,
// bf16; 989 TFLOP/s, 3.35 TB/s): one product h.w is 1.073 TFLOP, 1.085 ms,
// against 165 MB of operands (0.049 ms), so every kernel here is bound by
// its operations: fwd 1 product, dlog 1, dh 1, dw 1 (3.25 ms for the
// backward). chip_smoke.py computes each bound from the shapes it runs.
// This first version issues mma.sync from shared memory and does not
// reach the bound; wgmma, TMA and warp specialisation are left for later.
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "fused_xent_merge.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;  // block tile and K step
constexpr int kStages = 3;
constexpr int kThreads = 256;                  // 8 warps: 2 along M, 4 along N
constexpr int kWM = 64, kWN = 32;              // warp tile
constexpr int kMI = kWM / 16, kNI = kWN / 8;   // m16 and n8 tiles of a warp
constexpr int kColWarps = kBN / kWN;

template <typename T>
__host__ __device__ constexpr int vec() { return 16 / (int)sizeof(T); }

// A tile of an operand in shared memory: stored [mn][k] when K is the
// contiguous dimension (KMAJ), else [k][mn]; rows padded by 16 bytes so
// that ldmatrix's eight row addresses fall on distinct banks.
template <typename T, bool KMAJ, int MN>
struct Tile {
    static constexpr int rows = KMAJ ? MN : kBK;
    static constexpr int cols = KMAJ ? kBK : MN;
    static constexpr int ld = cols + vec<T>();
    static constexpr int elems = rows * ld;
};

template <typename T, bool AK, bool BK>
__host__ __device__ constexpr size_t stage_elems() {
    return (size_t)Tile<T, AK, kBM>::elems + Tile<T, BK, kBN>::elems;
}
template <typename T, bool AK, bool BK>
__host__ __device__ constexpr size_t smem_bytes() {
    return sizeof(T) * kStages * stage_elems<T, AK, BK>();
}

// Copy rows r0 .. r0 + ROWS - 1, columns c0 .. c0 + COLS - 1 of a row-major
// [R, C] matrix (row stride ldg) into a shared tile [ROWS][COLS + pad];
// whatever lies past R or C is zero-filled (C is a multiple of vec<T>()).
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* s, const T* g, size_t ldg, int r0, int c0, int R, int C) {
    constexpr int V = vec<T>(), CH = COLS / V, LD = COLS + V;
    for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
        const int r = i / CH, c = (i % CH) * V;
        const int gr = r0 + r, gc = c0 + c;
        const bool ok = gr < R && gc < C;
        cp_async16(s + r * LD + c, ok ? g + (size_t)gr * ldg + gc : g, ok);
    }
}

// Stage K step k0 of A (logically [M, K]) and B (logically [K, N]) for the
// output tile at (m0, n0). AK: A stored [M][K] (lda = its row stride),
// else [K][M]; BK: B stored [N][K], else [K][N].
template <typename T, bool AK, bool BK>
__device__ __forceinline__ void load_stage(T* st, const T* A, int lda, const T* B, int ldb, int m0, int n0,
                                           int k0, int M, int N, int K) {
    T* sA = st;
    T* sB = st + Tile<T, AK, kBM>::elems;
    if (AK) load_tile<T, kBM, kBK>(sA, A, lda, m0, k0, M, K);
    else load_tile<T, kBK, kBM>(sA, A, lda, k0, m0, K, M);
    if (BK) load_tile<T, kBN, kBK>(sB, B, ldb, n0, k0, N, K);
    else load_tile<T, kBK, kBN>(sB, B, ldb, k0, n0, K, N);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

using Acc = float[kMI][kNI][4];

// acc += the warp's 64 x 32 share of one staged K step. The accumulator
// layout is mma.sync's: lane (g = lane / 4, t = lane % 4) holds, for m16
// tile mi and n8 tile ni, rows g and g + 8 at columns 2t and 2t + 1 as
// acc[mi][ni][0..3] = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
template <typename T, bool AK, bool BK>
__device__ __forceinline__ void compute_stage(const T* st, Acc& acc, int wm, int wn) {
    constexpr int LDA = Tile<T, AK, kBM>::ld, LDB = Tile<T, BK, kBN>::ld;
    const T* sA = st;
    const T* sB = st + Tile<T, AK, kBM>::elems;
    const int lane = threadIdx.x & 31;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
            uint32_t a[kMI][4], b[kNI][2];
#pragma unroll
            for (int mi = 0; mi < kMI; ++mi) {
                const int rb = wm * kWM + mi * 16;
                if (AK) {
                    ldsm_x4(a[mi], sA + (rb + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
                } else {
                    ldsm_x4_trans(a[mi], sA + (kk + (lane & 7) + (lane >> 4) * 8) * LDA + rb + ((lane >> 3) & 1) * 8);
                }
            }
#pragma unroll
            for (int nj = 0; nj < kNI / 2; ++nj) {
                const int nb = wn * kWN + nj * 16;
                uint32_t r[4];
                if (BK) {
                    ldsm_x4(r, sB + (nb + (lane & 7) + (lane >> 4) * 8) * LDB + kk + ((lane >> 3) & 1) * 8);
                } else {
                    ldsm_x4_trans(r, sB + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + nb + (lane >> 4) * 8);
                }
                b[2 * nj][0] = r[0];
                b[2 * nj][1] = r[1];
                b[2 * nj + 1][0] = r[2];
                b[2 * nj + 1][1] = r[3];
            }
#pragma unroll
            for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
                for (int ni = 0; ni < kNI; ++ni) mma16816(acc[mi][ni], a[mi], b[ni]);
            }
        }
    } else {
        const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
        for (int k = 0; k < kBK; ++k) {
            float a0[kMI], a1[kMI], b0[kNI], b1[kNI];
#pragma unroll
            for (int mi = 0; mi < kMI; ++mi) {
                const int m = wm * kWM + mi * 16 + g;
                a0[mi] = AK ? sA[m * LDA + k] : sA[k * LDA + m];
                a1[mi] = AK ? sA[(m + 8) * LDA + k] : sA[k * LDA + m + 8];
            }
#pragma unroll
            for (int ni = 0; ni < kNI; ++ni) {
                const int n = wn * kWN + ni * 8 + 2 * t;
                b0[ni] = BK ? sB[n * LDB + k] : sB[k * LDB + n];
                b1[ni] = BK ? sB[(n + 1) * LDB + k] : sB[k * LDB + n + 1];
            }
#pragma unroll
            for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
                for (int ni = 0; ni < kNI; ++ni) {
                    acc[mi][ni][0] = fmaf(a0[mi], b0[ni], acc[mi][ni][0]);
                    acc[mi][ni][1] = fmaf(a0[mi], b1[ni], acc[mi][ni][1]);
                    acc[mi][ni][2] = fmaf(a1[mi], b0[ni], acc[mi][ni][2]);
                    acc[mi][ni][3] = fmaf(a1[mi], b1[ni], acc[mi][ni][3]);
                }
            }
        }
    }
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.0f;
}

// The main loop shared by every kernel: `tiles` output tiles of the block
// in turn, each over `nk` K steps, as one stream of tiles * nk stages
// through the cp.async ring (so the ring keeps filling across tiles).
// load(i, stage) stages step i; epi(tile, acc) runs after a tile's last
// step, and acc is zeroed after it.
template <typename T, bool AK, bool BK, typename Load, typename Epi>
__device__ __forceinline__ void main_loop(T* smem, int tiles, int nk, Load load, Epi epi) {
    constexpr size_t SE = stage_elems<T, AK, BK>();
    const int warp = threadIdx.x >> 5, wm = warp / kColWarps, wn = warp % kColWarps;
    const int steps = tiles * nk;
    Acc acc;
    zero(acc);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < steps) load(s, smem + s * SE);
        cp_async_commit();
    }
    for (int i = 0; i < steps; ++i) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // step i has landed, and every warp is done with step i - 1
        const int nx = i + kStages - 1;
        if (nx < steps) load(nx, smem + (nx % kStages) * SE);
        cp_async_commit();
        compute_stage<T, AK, BK>(smem + (i % kStages) * SE, acc, wm, wn);
        if (i % nk == nk - 1) {
            epi(i / nk, acc);
            zero(acc);
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the caller
}

// ---------------------------------------------------------------------------
// B3: forward. Block (128-row tile, vocab split). Writes nll and lse, or,
// when the vocab is split over several blocks, the split's (m, l, target)
// per row for xent_merge_kernel.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    xent_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w, const long long* __restrict__ labels,
               float* __restrict__ nll, float* __restrict__ lse, float* __restrict__ part, int N, int D, int V,
               int splits) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);
    const int m0 = blockIdx.x * kBM, split = blockIdx.y;
    const int nvt = (V + kBN - 1) / kBN, nk = (D + kBK - 1) / kBK;
    const int vt0 = (int)((long long)nvt * split / splits), vt1 = (int)((long long)nvt * (split + 1) / splits);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const int wm = warp / kColWarps, wn = warp % kColWarps;

    float m[kMI][2], l[kMI][2], tgt[kMI][2];
    long long lbl[kMI][2];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int row = m0 + wm * kWM + mi * 16 + g + 8 * hh;
            m[mi][hh] = kNegInf;
            l[mi][hh] = 0.0f;
            tgt[mi][hh] = 0.0f;
            lbl[mi][hh] = row < N ? labels[row] : kIgnore;
        }
    }

    auto load = [&](int i, T* st) {
        const int vt = vt0 + i / nk, ks = i % nk;
        load_stage<T, true, false>(st, h, D, w, V, m0, vt * kBN, ks * kBK, N, V, D);
    };
    auto epi = [&](int tile, Acc& acc) {
        const int cb = (vt0 + tile) * kBN + wn * kWN;
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                float mx = kNegInf;
#pragma unroll
                for (int ni = 0; ni < kNI; ++ni) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = cb + ni * 8 + 2 * t4 + e;
                        const float x = acc[mi][ni][2 * hh + e];
                        if (col < V) {
                            mx = fmaxf(mx, x);
                            if (col == lbl[mi][hh]) tgt[mi][hh] += x;
                        }
                    }
                }
                const float m_new = fmaxf(m[mi][hh], quad_max(mx));
                float s = 0.0f;
#pragma unroll
                for (int ni = 0; ni < kNI; ++ni) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = cb + ni * 8 + 2 * t4 + e;
                        if (col < V) s += expf(acc[mi][ni][2 * hh + e] - m_new);
                    }
                }
                l[mi][hh] = l[mi][hh] * expf(m[mi][hh] - m_new) + quad_sum(s);
                m[mi][hh] = m_new;
            }
        }
    };
    main_loop<T, true, false>(smem, vt1 - vt0, nk, load, epi);

    // merge the four column warps of each row, in order
    float* sm = reinterpret_cast<float*>(smem_raw);  // [3][kColWarps][kBM]
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const float tg = quad_sum(tgt[mi][hh]);
            if (t4 == 0) {
                const int r = wm * kWM + mi * 16 + g + 8 * hh;
                sm[(0 * kColWarps + wn) * kBM + r] = m[mi][hh];
                sm[(1 * kColWarps + wn) * kBM + r] = l[mi][hh];
                sm[(2 * kColWarps + wn) * kBM + r] = tg;
            }
        }
    }
    __syncthreads();
    const int r = threadIdx.x, row = m0 + r;
    if (r < kBM && row < N) {
        float M = kNegInf;
        for (int c = 0; c < kColWarps; ++c) M = fmaxf(M, sm[c * kBM + r]);
        float L = 0.0f, TG = 0.0f;
        for (int c = 0; c < kColWarps; ++c) {
            L += sm[(kColWarps + c) * kBM + r] * expf(sm[c * kBM + r] - M);
            TG += sm[(2 * kColWarps + c) * kBM + r];
        }
        if (splits == 1) {
            const float ls = M + logf(L);
            lse[row] = ls;
            nll[row] = (ls - TG) * (labels[row] != kIgnore ? 1.0f : 0.0f);
        } else {
            part[((size_t)0 * splits + split) * N + row] = M;
            part[((size_t)1 * splits + split) * N + row] = L;
            part[((size_t)2 * splits + split) * N + row] = TG;
        }
    }
}

// ---------------------------------------------------------------------------
// B4, part 1: dlog for one chunk of rows. Block (128-row tile, 128-column
// vocab tile).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    xent_dlog_kernel(const T* __restrict__ h, const T* __restrict__ w, const long long* __restrict__ labels,
                const float* __restrict__ lse, const float* __restrict__ gup, T* __restrict__ dlog, int N, int D,
                int V) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);
    const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const int wm = warp / kColWarps, wn = warp % kColWarps;
    auto load = [&](int i, T* st) { load_stage<T, true, false>(st, h, D, w, V, m0, n0, i * kBK, N, V, D); };
    auto epi = [&](int, Acc& acc) {
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int row = m0 + wm * kWM + mi * 16 + g + 8 * hh;
                if (row >= N) continue;
                const float ls = lse[row], gr = gup[row];
                const long long lb = labels[row];
#pragma unroll
                for (int ni = 0; ni < kNI; ++ni) {
                    const int col = n0 + wn * kWN + ni * 8 + 2 * t4;  // V is even: col < V covers col + 1
                    if (col >= V) continue;
                    const float d0 = gr * (expf(acc[mi][ni][2 * hh] - ls) - (col == lb ? 1.0f : 0.0f));
                    const float d1 = gr * (expf(acc[mi][ni][2 * hh + 1] - ls) - (col + 1 == lb ? 1.0f : 0.0f));
                    store2(dlog + (size_t)row * V + col, d0, d1);
                }
            }
        }
    };
    main_loop<T, true, false>(smem, 1, (D + kBK - 1) / kBK, load, epi);
}

// ---------------------------------------------------------------------------
// B4a and B4b: C [M, N] (+)= A . B. Block (128-row tile, 128-column tile).
// dh: A = dlog [M rows][K = V] (AK), B = w read as [N = D][K = V] (BK).
// dw: A = h^T, h stored [K = rows][M = D]; B = dlog [K = rows][N = V].
// ---------------------------------------------------------------------------

template <typename T, typename TO, bool AK, bool BK>
__global__ void __launch_bounds__(kThreads, 1)
    xent_gemm_kernel(const T* __restrict__ A, int lda, const T* __restrict__ B, int ldb, TO* __restrict__ C, int M,
                int N, int K, int accumulate) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);
    const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const int wm = warp / kColWarps, wn = warp % kColWarps;
    auto load = [&](int i, T* st) { load_stage<T, AK, BK>(st, A, lda, B, ldb, m0, n0, i * kBK, M, N, K); };
    auto epi = [&](int, Acc& acc) {
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int row = m0 + wm * kWM + mi * 16 + g + 8 * hh;
                if (row >= M) continue;
#pragma unroll
                for (int ni = 0; ni < kNI; ++ni) {
                    const int col = n0 + wn * kWN + ni * 8 + 2 * t4;  // N is even
                    if (col >= N) continue;
                    TO* p = C + (size_t)row * N + col;
                    float c0 = acc[mi][ni][2 * hh], c1 = acc[mi][ni][2 * hh + 1];
                    if constexpr (std::is_same<TO, float>::value) {
                        if (accumulate) {
                            const float2 old = *reinterpret_cast<const float2*>(p);
                            c0 = old.x + c0;
                            c1 = old.y + c1;
                        }
                    }
                    store2(p, c0, c1);
                }
            }
        }
    };
    main_loop<T, AK, BK>(smem, 1, (K + kBK - 1) / kBK, load, epi);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

bool bad_dims(int N, int D, int V) { return N < 1 || D < 8 || V < 8 || D % 8 != 0 || V % 8 != 0; }

template <typename T>
int fwd_entry(const void* h, const void* w, const void* labels, void* nll, void* lse, void* part, int N, int D,
              int V, int splits, cudaStream_t st) {
    if (bad_dims(N, D, V) || splits < 1 || splits > (V + kBN - 1) / kBN) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes<T, true, false>();
    cudaError_t err = allow_smem<xent_fwd_kernel<T>>(smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + kBM - 1) / kBM, splits);
    xent_fwd_kernel<T><<<grid, kThreads, smem, st>>>(static_cast<const T*>(h), static_cast<const T*>(w),
                                                static_cast<const long long*>(labels), static_cast<float*>(nll),
                                                static_cast<float*>(lse), static_cast<float*>(part), N, D, V,
                                                splits);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    return (int)launch_xent_merge(part, labels, nll, lse, N, splits, st);
}

template <typename T>
int dlog_entry(const void* h, const void* w, const void* labels, const void* lse, const void* g, void* dlog, int N,
               int D, int V, cudaStream_t st) {
    if (bad_dims(N, D, V) || (V + kBN - 1) / kBN > 65535) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes<T, true, false>();
    cudaError_t err = allow_smem<xent_dlog_kernel<T>>(smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + kBM - 1) / kBM, (V + kBN - 1) / kBN);
    xent_dlog_kernel<T><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(h), static_cast<const T*>(w), static_cast<const long long*>(labels),
        static_cast<const float*>(lse), static_cast<const float*>(g), static_cast<T*>(dlog), N, D, V);
    return (int)cudaGetLastError();
}

template <typename T, typename TO, bool AK, bool BK>
int gemm_entry(const void* A, int lda, const void* B, int ldb, void* C, int M, int N, int K, int accumulate,
               cudaStream_t st) {
    if (M < 1 || N < 1 || K < 1 || (N + kBN - 1) / kBN > 65535) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes<T, AK, BK>();
    cudaError_t err = allow_smem<xent_gemm_kernel<T, TO, AK, BK>>(smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
    xent_gemm_kernel<T, TO, AK, BK><<<grid, kThreads, smem, st>>>(static_cast<const T*>(A), lda,
                                                              static_cast<const T*>(B), ldb, static_cast<TO*>(C),
                                                              M, N, K, accumulate);
    return (int)cudaGetLastError();
}

// dh [N, D] (h's dtype) = dlog [N, V] . w^T, w [D, V]
template <typename T>
int dh_entry(const void* dlog, const void* w, void* dh, int N, int D, int V, cudaStream_t st) {
    if (bad_dims(N, D, V)) return (int)cudaErrorInvalidValue;
    return gemm_entry<T, T, true, true>(dlog, V, w, V, dh, N, D, V, 0, st);
}

// dw [D, V] f32 (+)= h^T . dlog, h [N, D], dlog [N, V]
template <typename T>
int dw_entry(const void* h, const void* dlog, void* dw, int N, int D, int V, int accumulate, cudaStream_t st) {
    if (bad_dims(N, D, V)) return (int)cudaErrorInvalidValue;
    return gemm_entry<T, float, false, false>(h, D, dlog, V, dw, D, V, N, accumulate, st);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int fused_xent_fwd_f32(const void* h, const void* w, const void* labels, void* nll, void* lse, void* part, int N,
                       int D, int V, int splits, void* stream) {
    return fwd_entry<float>(h, w, labels, nll, lse, part, N, D, V, splits, static_cast<cudaStream_t>(stream));
}
int fused_xent_fwd_bf16(const void* h, const void* w, const void* labels, void* nll, void* lse, void* part, int N,
                        int D, int V, int splits, void* stream) {
    return fwd_entry<__nv_bfloat16>(h, w, labels, nll, lse, part, N, D, V, splits,
                                    static_cast<cudaStream_t>(stream));
}

int fused_xent_dlog_f32(const void* h, const void* w, const void* labels, const void* lse, const void* g,
                        void* dlog, int N, int D, int V, void* stream) {
    return dlog_entry<float>(h, w, labels, lse, g, dlog, N, D, V, static_cast<cudaStream_t>(stream));
}
int fused_xent_dlog_bf16(const void* h, const void* w, const void* labels, const void* lse, const void* g,
                         void* dlog, int N, int D, int V, void* stream) {
    return dlog_entry<__nv_bfloat16>(h, w, labels, lse, g, dlog, N, D, V, static_cast<cudaStream_t>(stream));
}

int fused_xent_dh_f32(const void* dlog, const void* w, void* dh, int N, int D, int V, void* stream) {
    return dh_entry<float>(dlog, w, dh, N, D, V, static_cast<cudaStream_t>(stream));
}
int fused_xent_dh_bf16(const void* dlog, const void* w, void* dh, int N, int D, int V, void* stream) {
    return dh_entry<__nv_bfloat16>(dlog, w, dh, N, D, V, static_cast<cudaStream_t>(stream));
}

int fused_xent_dw_f32(const void* h, const void* dlog, void* dw, int N, int D, int V, int accumulate,
                      void* stream) {
    return dw_entry<float>(h, dlog, dw, N, D, V, accumulate, static_cast<cudaStream_t>(stream));
}
int fused_xent_dw_bf16(const void* h, const void* dlog, void* dw, int N, int D, int V, int accumulate,
                       void* stream) {
    return dw_entry<__nv_bfloat16>(h, dlog, dw, N, D, V, accumulate, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
