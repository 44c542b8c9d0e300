// The fused cross-entropy's four passes in bf16 or f16 for Hopper (sm_90a), with
// warpgroup matrix products (wgmma), TMA copies and an mbarrier ring:
//   fwd  (B3: replaces opendiloco_tpu/ops/fused_xent.py _fwd, pl.pallas_call
//         at :139, kernel body _fwd_kernel :85)
//   dlog (replaces the same file's _recompute_dlog :174, inside _dh_kernel
//         :195 and _dw_kernel :219)
//   dh   (B4a: replaces _bwd_impl, pl.pallas_call at :254, kernel body
//         _dh_kernel :195; with dlog, the TPU kernel's body)
//   dw   (B4b: replaces _bwd_impl's pl.pallas_call at :276, kernel body
//         _dw_kernel :219)
// fused_xent.cu keeps the first design of all four (mma.sync), which
// ops/fused_xent.py routes f32 to. Each kernel is one template over the
// element type E (bf16 or f16: the same tiles, descriptors and swizzles;
// sm90.cuh), exported as *_bf16 and *_f16.
//
// fwd computes, for h [N, D], w [D, V] and labels [N] (int64, -100 =
// ignored), nll [N] and lse [N] in f32: lse by an online log-sum-exp over
// the vocab tiles, so the logits are never stored; nll = (lse - s[label])
// * mask. The backward passes compute, for one chunk of rows, h [M, D],
// w, labels [M], lse [M] f32 and the masked upstream gradient
// g [M] f32, with s = h.w from E operands and f32 accumulation:
//   dlog [M, V] = g * (exp(s - lse) - onehot), rounded to E;
//   dh [M, D] = dlog . w^T, f32 accumulation, rounded to E;
//   dw [D, V] f32 = h^T . dlog summed over the chunk's M rows, written by
//     the first chunk and added to the f32 dw by each later one.
// Columns past V (dlog, dw) and D (dh) and rows past M (D for dw) are
// neither computed into the outputs nor stored. Any M; D and V multiples of 8 (16-byte rows,
// as TMA needs); contiguous row-major operands, 16-byte aligned.
//
// Why dlog stays a pass of its own (the TPU kernel recomputes it inside
// its dh body): a dh output tile [rows x D] sums over all of V while a
// dlog tile [rows x V-tile] sums over all of D, and one 128-row f32 dh
// tile at D 2048 is 1 MB, beyond an SM's registers and shared memory; a
// fold would recompute the logits once per D tile.
//
// Bound on this card (989 TFLOP/s bf16 and f16 alike, 3.35 TB/s; chip_smoke.py
// xent_work): at one 2048-row chunk of the 1b training shape (D 2048,
// V 32000) each pass is one product, 0.268 TFLOP, 0.2714 ms, against
// 131 MB of dlog and 131 MB of w (0.04-0.08 ms): bound by operations. dw
// also reads and writes the 262 MB f32 dw once a chunk: 0.198 ms of bytes
// in all, still below its 0.2714 ms of products, but the epilogue (a
// 128 x 256 f32 read-add-write a tile, 256 KB) is a third of its work.
//
// B3 at the 1b training shape (N 8184, D 2048, V 32000) is one product
// of 1.073 TFLOP, 1.085 ms, against 33.5 MB of h and 131 MB of w
// (0.049 ms): bound by operations too.
//
// Design (one main loop, gemm_sm90, for all four):
// 1. Persistent CTAs, one an SM, each walking output tiles of 128 rows x
//    256 columns (two consumer warpgroups of 64 rows, each one m64n256k16
//    wgmma a 16-deep step, 128 f32 accumulators a thread; 128-column tiles
//    were slower for both passes on the card, PERF.md section 6).
//    Tiles go m fastest: the 16 row tiles of a chunk share each column
//    tile of B, so at any moment the CTAs read a few of B's column tiles
//    (w, 131 MB, streams through the 50 MB L2 about once) and all of A
//    (h, 8 MB at the 1b shape, stays in L2).
// 2. One producer thread keeps a ring of 4 stages (64-deep slices of A and
//    B, 48 KB) in flight by TMA with mbarriers; the ring runs on across
//    tiles, so the next tile's loads overlap this tile's epilogue.
//    setmaxnreg lowers the producer's registers and raises the consumers'.
//    TMA's zero fill past the edges replaces the ragged-tile code.
// 3. Operands from shared memory through wgmma descriptors over tiles TMA
//    wrote with a 128-byte swizzle: A (h for dlog, dlog for dh) K-major;
//    B K-major for dh (w's rows are D, V contiguous: the reduction) and
//    MN-major for dlog (w's V columns contiguous) through the transpose
//    bit. dw takes both operands MN-major: A = h^T (h [M][D], D
//    contiguous) and B = dlog ([M][V]); A's 64 rows of a warpgroup are one
//    swizzle atom, loaded as their own TMA box. Each consumer keeps one wgmma group in flight and hands a stage
//    back as soon as the group that read it has finished.
// 4. Epilogues on the accumulator registers, stored straight from them
//    (two elements a store): dlog takes exp by ex2.approx on s log2 e -
//    lse log2 e (one FFMA and one MUFU an entry) where the first design
//    keeps expf; measured on the card (chip_smoke.py phase 9), its worst
//    bf16 element sits at 0.957 of the element-wise limit (the ragged
//    1b chunk), max abs error 3.0e-8, the same as the first design's:
//    both are one bf16 ulp from the plain version where the f32 value
//    sits at a rounding boundary. dh rounds to bf16.
// 5. dw's epilogue. K is a chunk's rows (2048), so the f32 read-add-write
//    of a tile costs about half of its products. Each warpgroup stages
//    64 x 32 f32 subtiles in two swizzled shared buffers and hands each
//    to one TMA store (first chunk) or reduce-add (later chunks), so the
//    add runs in the memory system while the warpgroup fills the next
//    subtile and then starts the next tile, whose loads the producer has
//    kept in flight. Measured against 16-byte read-add-write stores
//    straight from the accumulators (the loads of 4 column blocks in
//    flight at a time; it spilled about 300 bytes to the stack) in turns
//    by chip_smoke.py phase 9 on an H100 at 700 W: 0.4457-0.4625 ms a
//    1b chunk against 0.7129-0.7270 ms, so only the TMA epilogue is kept
//    (PERF.md section 6).
// 6. B3's epilogue keeps a running (m, l, target) a row across the vocab
//    tiles of its unit (xent_fwd_sm90_kernel), so the tile's 256 logits
//    never leave the registers. The vocab is split across CTAs: a unit is
//    (split, 128-row tile), and ops/fused_xent.py fwd_sm90_splits picks
//    the split count from N, V and the SM count alone, the smallest that
//    minimises the vocab tiles the busiest CTA walks (ceil(units / SMs)
//    units of ceil(vocab tiles / splits) each). At the 1b shape that is
//    125 splits of one vocab tile each: 8000 units, 61 for the busiest of
//    132 CTAs against 60.6 on average (2 splits of 62-63 tiles, one unit
//    a CTA, would leave 4 SMs idle and take 63). Units go row tile
//    fastest (SplitWalk), so the 132 CTAs at work at any moment hold two
//    or three vocab tiles over all 64 row tiles: they read two or three
//    of w's 1 MB column tiles at a time (w streams through L2 about once)
//    and all of h (33.5 MB, kept in the 50 MB L2 across the walk). A unit
//    of several tiles carries its (m, l, target) across them.
//    The splits' (m, l, target) are merged in split order by
//    xent_merge_kernel (fused_xent_merge.cuh), as the first design does.
// No atomics and no split-K: every output element is summed by one CTA
// in K order, and dw gets one store or add per element and chunk, the
// chunks in launch order, so results repeat bit for bit.
#include <math.h>

#include "common.cuh"
#include "fused_xent_merge.cuh"
#include "sm90.cuh"

namespace {

constexpr int kBM = 128;  // rows of an output tile: two consumer warpgroups
constexpr int kBN = 256;  // columns of an output tile
constexpr int kBK = 64;   // depth of a stage: one 128-byte swizzle row of 16-bit elements
constexpr int kStages = 4;
constexpr int kStageA = kBM * kBK * 2;           // 16 KB
constexpr int kStageBytes = kStageA + kBN * kBK * 2;  // + 32 KB of B
constexpr int kBarOffset = kStages * kStageBytes;     // full[], empty[]
constexpr size_t kSmemBytes = kBarOffset + 2 * kStages * 8 + 1024;  // + alignment slack

// The output tiles of a CTA's walk for dlog, dh and dw: tile i = blockIdx.x,
// + gridDim.x, ..., m fastest. walk(f) calls f(m0, n0, tag) for each in
// turn (tag 0).
struct Raster {
    int mt, nt;  // row tiles, column tiles
    template <typename F>
    __device__ __forceinline__ void walk(F f) const {
        for (int i = blockIdx.x; i < mt * nt; i += gridDim.x) f((i % mt) * kBM, (i / mt) * kBN, 0);
    }
};

// B3's walk. The vocab tiles are cut into `splits` contiguous ranges,
// split p holding tiles nvt p / splits .. nvt (p + 1) / splits - 1 (never
// empty: splits <= nvt). A unit is (split p, row tile m), numbered p mt +
// m (m fastest), and CTA c takes units c, c + gridDim.x, ...; within a unit
// it walks the split's vocab tiles in order, so the CTAs that run at one
// moment share the column tiles of w that they read. tag: bit 0 the
// unit's first tile, bit 1 its last, bits 2.. the split.
struct SplitWalk {
    int mt, nvt, splits;
    __device__ __forceinline__ int vt0(int p) const { return (int)((long long)nvt * p / splits); }
    template <typename F>
    __device__ __forceinline__ void walk(F f) const {
        for (int u = blockIdx.x; u < mt * splits; u += gridDim.x) {
            const int p = u / mt, a = vt0(p), b = vt0(p + 1);
            for (int vt = a; vt < b; ++vt)
                f((u % mt) * kBM, vt * kBN, (vt == a ? 1 : 0) | (vt == b - 1 ? 2 : 0) | (p << 2));
        }
    }
};

// C[M, N] = A . B over K, A [M][K] (K-major, !A_MN) or [K][M] (MN-major,
// A_MN), B [N][K] (K-major, !B_MN) or [K][N] (MN-major, B_MN), E in, f32
// accumulators, over the output tiles of the walk r (Raster or
// SplitWalk); epi(row0, n0, tag, acc) runs on each consumer warpgroup's
// 64 x kBN accumulator (rows row0 .. row0 + 63) after the tile's last
// step. Launched with kCtaThreads threads.
template <typename E, bool A_MN, bool B_MN, typename Walk, typename Epi>
__device__ __forceinline__ void gemm_sm90(const CUtensorMap* ma, const CUtensorMap* mb, Walk r, int K, Epi epi) {
    constexpr int kSt = kStages;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* sm = align1024(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + kBarOffset);
    uint64_t* empty = full + kSt;
    const int nk = (K + kBK - 1) / kBK;

    if (threadIdx.x == 0) {
        for (int s = 0; s < kSt; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, 8);  // one lane per consumer warp
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (threadIdx.x < 128) {
        // producer warpgroup: thread 0 issues, the rest leave
        regs_dec<kProducerRegs>();
        if (threadIdx.x != 0) return;
        int ring = 0;
        r.walk([&](int m0, int n0, int) {
            for (int kb = 0; kb < nk; ++kb, ++ring) {
                const int s = ring % kSt;
                uint8_t* st = sm + s * kStageBytes;
                mbar_wait(empty + s, ((ring / kSt) & 1) ^ 1);
                mbar_arrive_expect_tx(full + s, kStageBytes);
                if constexpr (A_MN) {
                    // kBM / 64 row blocks, each [64 k rows][64 rows of C]:
                    // one per consumer warpgroup
                    for (int j = 0; j < kBM / 64; ++j)
                        tma_load_2d(st + j * kBK * 128, ma, full + s, m0 + j * 64, kb * kBK);
                } else {
                    tma_load_2d(st, ma, full + s, kb * kBK, m0);
                }
                if constexpr (B_MN) {
                    // kBN / 64 column blocks, each [64 k rows][64 columns]
                    for (int j = 0; j < kBN / 64; ++j)
                        tma_load_2d(st + kStageA + j * kBK * 128, mb, full + s, n0 + j * 64, kb * kBK);
                } else {
                    tma_load_2d(st + kStageA, mb, full + s, kb * kBK, n0);
                }
            }
        });
        return;
    }

    regs_inc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x & 31;
    float acc[kBN / 2];
    zero_acc(acc);  // each tile's first wgmma overwrites it (scale-d 0)
    int ring = 0;
    auto release = [&](int pos) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + pos % kSt);
    };
    r.walk([&](int m0, int n0, int tag) {
        for (int kb = 0; kb < nk; ++kb, ++ring) {
            const int s = ring % kSt;
            const uint32_t sa = smem_u32(sm + s * kStageBytes), sb = sa + kStageA;
            mbar_wait(full + s, (ring / kSt) & 1);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < kBK / 16; ++ks) {
                // MN-major: 16 k rows on, the next 64 columns 64 rows of
                // 128 B further (LBO), 8 k rows 1024 B (SBO); A's 64 rows
                // of a warpgroup are one such block
                const uint64_t da = A_MN ? smem_desc(sa + cw * kBK * 128 + ks * 16 * 128, kBK * 128, 1024, 1)
                                         : smem_desc(sa + cw * 64 * 128 + ks * 32, 16, 1024, 1);
                const uint64_t db = B_MN ? smem_desc(sb + ks * 16 * 128, kBK * 128, 1024, 1)
                                         : smem_desc(sb + ks * 32, 16, 1024, 1);
                wgmma_ss_n256<E, A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db, kb > 0 || ks > 0);
            }
            wgmma_commit();
            wgmma_wait<1>();  // the group of step kb - 1 is done: its stage is free
            if (kb > 0) release(ring - 1);
        }
        wgmma_wait<0>();
        fence_regs(acc);
        release(ring - 1);
        epi(m0 + cw * 64, n0, tag, acc);
    });
}

// Rows g and g + 8 of a warp's 16-row share, column pair 2t, 2t + 1 of
// each 8-column block nb: acc[4 nb + 0, 1] row g, acc[4 nb + 2, 3] row g + 8.
struct Frag {
    int r0, t2;
    __device__ __forceinline__ Frag(int row0) {
        const int tid = threadIdx.x & 127, lane = tid & 31;
        r0 = row0 + (tid >> 5) * 16 + (lane >> 2);
        t2 = 2 * (lane & 3);
    }
};

template <typename E>
__global__ void __launch_bounds__(kCtaThreads, 1)
    xent_dlog_sm90_kernel(const __grid_constant__ CUtensorMap mh, const __grid_constant__ CUtensorMap mw,
                          const long long* __restrict__ labels, const float* __restrict__ lse,
                          const float* __restrict__ gup, E* __restrict__ dlog, int M, int D, int V) {
    const Raster r{(M + kBM - 1) / kBM, (V + kBN - 1) / kBN};
    gemm_sm90<E, false, true>(&mh, &mw, r, D, [&](int row0, int n0, int, float(&acc)[kBN / 2]) {
        const Frag f(row0);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int row = f.r0 + 8 * hh;
            if (row >= M) continue;
            const float l2 = lse[row] * kLog2e, gr = gup[row];
            const long long lb = labels[row];
            E* dst = dlog + (size_t)row * V;
#pragma unroll
            for (int nb = 0; nb < kBN / 8; ++nb) {
                const int col = n0 + nb * 8 + f.t2;  // V is even: col < V covers col + 1
                if (col < V) {
                    const float p0 = exp2_approx(fmaf(acc[4 * nb + 2 * hh], kLog2e, -l2));
                    const float p1 = exp2_approx(fmaf(acc[4 * nb + 2 * hh + 1], kLog2e, -l2));
                    store2(dst + col, gr * (p0 - (col == lb ? 1.0f : 0.0f)),
                           gr * (p1 - (col + 1 == lb ? 1.0f : 0.0f)));
                }
            }
        }
    });
}

// B3: per-row nll and lse of s = h . w over the vocab tiles of the CTA's
// units (SplitWalk). A (h) K-major, B (w) MN-major, as dlog reads them. The
// epilogue keeps a running (m, l, target) for the thread's two rows (g
// and g + 8 of its warp's 16) across the unit's vocab tiles: the tile's
// row max by a quad shuffle, l rescaled by 2^((m - m') log2 e) and added
// the quad sum of 2^(s log2 e - m' log2 e) (ex2.approx, as dlog), and the
// target logit taken where the column equals the label. At the unit's
// last tile it writes nll and lse (one split) or the split's (m, l,
// target) into part [3][splits][N] for xent_merge_kernel. Columns past V
// (zero filled by TMA) are left out of the max and the sum; rows past N
// are computed on zeros and not written.
template <typename E>
__global__ void __launch_bounds__(kCtaThreads, 1)
    xent_fwd_sm90_kernel(const __grid_constant__ CUtensorMap mh, const __grid_constant__ CUtensorMap mw,
                         const long long* __restrict__ labels, float* __restrict__ nll, float* __restrict__ lse,
                         float* __restrict__ part, int N, int D, int V, int splits) {
    const SplitWalk wk{(N + kBM - 1) / kBM, (V + kBN - 1) / kBN, splits};
    float m[2], l[2], tg[2];
    long long lb[2];
    gemm_sm90<E, false, true>(&mh, &mw, wk, D, [&](int row0, int n0, int tag, float(&acc)[kBN / 2]) {
        const Frag f(row0);
        const bool full = n0 + kBN <= V;  // no column past V in this tile
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int row = f.r0 + 8 * hh;
            if (tag & 1) {
                m[hh] = kNegInf;
                l[hh] = 0.0f;
                tg[hh] = 0.0f;
                lb[hh] = row < N ? labels[row] : kIgnore;
            }
            float mx = kNegInf;
#pragma unroll
            for (int nb = 0; nb < kBN / 8; ++nb) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float x = acc[4 * nb + 2 * hh + e];
                    mx = full || n0 + nb * 8 + f.t2 + e < V ? fmaxf(mx, x) : mx;
                }
            }
            const float mn = fmaxf(m[hh], quad_max(mx));
            const float ml2 = mn * kLog2e;
            float sum = 0.0f;
#pragma unroll
            for (int nb = 0; nb < kBN / 8; ++nb) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float p = exp2_approx(fmaf(acc[4 * nb + 2 * hh + e], kLog2e, -ml2));
                    sum += full || n0 + nb * 8 + f.t2 + e < V ? p : 0.0f;
                }
            }
            l[hh] = l[hh] * exp2_approx((m[hh] - mn) * kLog2e) + quad_sum(sum);
            m[hh] = mn;
            const long long d = lb[hh] - n0;
            if (d >= 0 && d < kBN) {  // the label's column lies in this tile: one lane holds it
#pragma unroll
                for (int nb = 0; nb < kBN / 8; ++nb) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) tg[hh] += nb * 8 + f.t2 + e == d ? acc[4 * nb + 2 * hh + e] : 0.0f;
                }
            }
            if (tag & 2) {
                const float t = quad_sum(tg[hh]);
                if ((threadIdx.x & 3) == 0 && row < N) {
                    if (splits == 1) {
                        const float ls = m[hh] + logf(l[hh]);
                        lse[row] = ls;
                        nll[row] = (ls - t) * (lb[hh] != kIgnore ? 1.0f : 0.0f);
                    } else {
                        const int p = tag >> 2;
                        part[((size_t)0 * splits + p) * N + row] = m[hh];
                        part[((size_t)1 * splits + p) * N + row] = l[hh];
                        part[((size_t)2 * splits + p) * N + row] = t;
                    }
                }
            }
        }
    });
}

template <typename E>
__global__ void __launch_bounds__(kCtaThreads, 1)
    xent_dh_sm90_kernel(const __grid_constant__ CUtensorMap mdl, const __grid_constant__ CUtensorMap mw,
                        E* __restrict__ dh, int M, int D, int V) {
    const Raster r{(M + kBM - 1) / kBM, (D + kBN - 1) / kBN};
    gemm_sm90<E, false, false>(&mdl, &mw, r, V, [&](int row0, int n0, int, float(&acc)[kBN / 2]) {
        const Frag f(row0);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int row = f.r0 + 8 * hh;
            if (row >= M) continue;
            E* dst = dh + (size_t)row * D;
#pragma unroll
            for (int nb = 0; nb < kBN / 8; ++nb) {
                const int col = n0 + nb * 8 + f.t2;
                if (col < D) store2(dst + col, acc[4 * nb + 2 * hh], acc[4 * nb + 2 * hh + 1]);
            }
        }
    });
}

// dw's epilogue through TMA: each consumer warpgroup stages its 64 x kBN
// accumulator as kBN / kEpiCols subtiles of 64 rows x 32 f32 columns (one
// 128-byte swizzle row, 8 KB) in two shared buffers of its own, past the
// ring and its barriers, and hands each to one TMA store (the first chunk)
// or reduce-add (later chunks) while it fills the other.
constexpr int kEpiCols = 32;
constexpr int kEpiBytes = 64 * kEpiCols * 4;
constexpr int kEpiOffset = kBarOffset + 1024;
constexpr size_t kDwSmemBytes = kEpiOffset + 4 * kEpiBytes + 1024;  // + alignment slack
static_assert(kDwSmemBytes <= kSmemMax, "dw's ring and epilogue buffers fit one SM");

// dw [D, V] f32 (+)= h^T . dlog over the chunk's M rows: C = A . B with A =
// h^T (MN-major: h [M][D], D contiguous) and B = dlog (MN-major: [M][V]), K
// = M, stored or added through the TMA epilogue above.
template <typename E>
__global__ void __launch_bounds__(kCtaThreads, 1)
    xent_dw_sm90_kernel(const __grid_constant__ CUtensorMap mh, const __grid_constant__ CUtensorMap mdl,
                        const __grid_constant__ CUtensorMap mdw, int M, int D, int V, int accumulate) {
    const Raster r{(D + kBM - 1) / kBM, (V + kBN - 1) / kBN};
    gemm_sm90<E, true, true>(&mh, &mdl, r, M, [&](int row0, int n0, int, float(&acc)[kBN / 2]) {
        const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
        extern __shared__ uint8_t smem_raw[];
        const int cw = threadIdx.x / 128 - 1;
        uint8_t* bufs = align1024(smem_raw) + kEpiOffset + cw * 2 * kEpiBytes;
#pragma unroll
        for (int j = 0; j < kBN / kEpiCols; ++j) {
            // the buffer's last copy (subtile j - 2) finished reading it
            // before the barrier of subtile j - 1
            uint8_t* buf = bufs + (j & 1) * kEpiBytes;
#pragma unroll
            for (int i = 0; i < kEpiCols / 8; ++i) {
                const int nb = j * (kEpiCols / 8) + i;
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    // row rr, columns 8 i + 2t, + 1: 16-byte chunk 2 i + t / 2
                    // of the 128-byte row, swizzled by the row's index mod 8
                    const int rr = warp * 16 + g + 8 * hh;
                    const int chunk = (2 * i + (t >> 1)) ^ (rr & 7);
                    *reinterpret_cast<float2*>(buf + rr * 128 + chunk * 16 + (t & 1) * 8) =
                        make_float2(acc[4 * nb + 2 * hh], acc[4 * nb + 2 * hh + 1]);
                }
            }
            fence_proxy_async();
            if (tid == 0) bulk_wait_read0();  // subtile j - 1 has left the other buffer
            named_sync(1 + cw, 128);
            if (tid == 0) {
                if (accumulate) {
                    tma_add_2d(&mdw, buf, n0 + j * kEpiCols, row0);
                } else {
                    tma_store_2d(&mdw, buf, n0 + j * kEpiCols, row0);
                }
                bulk_commit();
            }
        }
    });
    if (threadIdx.x >= 128 && (threadIdx.x & 127) == 0) bulk_wait_read0();  // before the CTA's shared memory goes
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

bool bad_dims(int M, int D, int V) { return M < 1 || D < 8 || V < 8 || D % 8 != 0 || V % 8 != 0; }

// one persistent CTA an SM
inline cudaError_t grid_size(int tiles, int* grid) {
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
    *grid = min(tiles, sms);
    return err;
}

template <typename E>
int fwd_run(const void* h, const void* w, const void* labels, void* nll, void* lse, void* part, int N, int D,
            int V, int splits, cudaStream_t st) {
    const int mt = (N + kBM - 1) / kBM, nvt = (V + kBN - 1) / kBN;
    if (splits < 1 || splits > nvt) return (int)cudaErrorInvalidValue;
    CUtensorMap mh, mw;
    cudaError_t err;
    if ((err = elt_matrix_map<E>(&mh, h, N, D, kBM, kBK)) != cudaSuccess) return (int)err;
    if ((err = elt_matrix_map<E>(&mw, w, D, V, kBK, 64)) != cudaSuccess) return (int)err;
    if ((err = allow_smem<xent_fwd_sm90_kernel<E>>(kSmemBytes)) != cudaSuccess) return (int)err;
    int grid = 0;
    if ((err = grid_size(mt * splits, &grid)) != cudaSuccess) return (int)err;
    xent_fwd_sm90_kernel<E><<<grid, kCtaThreads, kSmemBytes, st>>>(
        mh, mw, static_cast<const long long*>(labels), static_cast<float*>(nll), static_cast<float*>(lse),
        static_cast<float*>(part), N, D, V, splits);
    if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return (int)err;
    return (int)launch_xent_merge(part, labels, nll, lse, N, splits, st);
}

template <typename E>
int dlog_run(const void* h, const void* w, const void* labels, const void* lse, const void* g, void* dlog, int M,
             int D, int V, cudaStream_t st) {
    CUtensorMap mh, mw;
    cudaError_t err;
    if ((err = elt_matrix_map<E>(&mh, h, M, D, kBM, kBK)) != cudaSuccess) return (int)err;
    if ((err = elt_matrix_map<E>(&mw, w, D, V, kBK, 64)) != cudaSuccess) return (int)err;
    if ((err = allow_smem<xent_dlog_sm90_kernel<E>>(kSmemBytes)) != cudaSuccess) return (int)err;
    int grid = 0;
    if ((err = grid_size((M + kBM - 1) / kBM * ((V + kBN - 1) / kBN), &grid)) != cudaSuccess) return (int)err;
    xent_dlog_sm90_kernel<E><<<grid, kCtaThreads, kSmemBytes, st>>>(
        mh, mw, static_cast<const long long*>(labels), static_cast<const float*>(lse), static_cast<const float*>(g),
        static_cast<E*>(dlog), M, D, V);
    return (int)cudaGetLastError();
}

template <typename E>
int dh_run(const void* dlog, const void* w, void* dh, int M, int D, int V, cudaStream_t st) {
    CUtensorMap mdl, mw;
    cudaError_t err;
    if ((err = elt_matrix_map<E>(&mdl, dlog, M, V, kBM, kBK)) != cudaSuccess) return (int)err;
    if ((err = elt_matrix_map<E>(&mw, w, D, V, kBN, kBK)) != cudaSuccess) return (int)err;
    if ((err = allow_smem<xent_dh_sm90_kernel<E>>(kSmemBytes)) != cudaSuccess) return (int)err;
    int grid = 0;
    if ((err = grid_size((M + kBM - 1) / kBM * ((D + kBN - 1) / kBN), &grid)) != cudaSuccess) return (int)err;
    xent_dh_sm90_kernel<E><<<grid, kCtaThreads, kSmemBytes, st>>>(mdl, mw, static_cast<E*>(dh), M, D, V);
    return (int)cudaGetLastError();
}

template <typename E>
int dw_run(const void* h, const void* dlog, void* dw, int M, int D, int V, int accumulate, cudaStream_t st) {
    CUtensorMap mh, mdl, mdw;
    cudaError_t err;
    if ((err = elt_matrix_map<E>(&mh, h, M, D, kBK, 64)) != cudaSuccess) return (int)err;
    if ((err = elt_matrix_map<E>(&mdl, dlog, M, V, kBK, 64)) != cudaSuccess) return (int)err;
    if ((err = matrix_map(&mdw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dw, D, V, 64, kEpiCols)) != cudaSuccess)
        return (int)err;
    if ((err = allow_smem<xent_dw_sm90_kernel<E>>(kDwSmemBytes)) != cudaSuccess) return (int)err;
    int grid = 0;
    if ((err = grid_size((D + kBM - 1) / kBM * ((V + kBN - 1) / kBN), &grid)) != cudaSuccess) return (int)err;
    xent_dw_sm90_kernel<E><<<grid, kCtaThreads, kDwSmemBytes, st>>>(mh, mdl, mdw, M, D, V, accumulate);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int fused_xent_fwd_sm90_bf16(const void* h, const void* w, const void* labels, void* nll, void* lse, void* part,
                             int N, int D, int V, int splits, void* stream) {
    if (bad_dims(N, D, V)) return (int)cudaErrorInvalidValue;
    return fwd_run<__nv_bfloat16>(h, w, labels, nll, lse, part, N, D, V, splits, static_cast<cudaStream_t>(stream));
}
int fused_xent_fwd_sm90_f16(const void* h, const void* w, const void* labels, void* nll, void* lse, void* part,
                            int N, int D, int V, int splits, void* stream) {
    if (bad_dims(N, D, V)) return (int)cudaErrorInvalidValue;
    return fwd_run<__half>(h, w, labels, nll, lse, part, N, D, V, splits, static_cast<cudaStream_t>(stream));
}

int fused_xent_dlog_sm90_bf16(const void* h, const void* w, const void* labels, const void* lse, const void* g,
                              void* dlog, int N, int D, int V, void* stream) {
    if (bad_dims(N, D, V)) return (int)cudaErrorInvalidValue;
    return dlog_run<__nv_bfloat16>(h, w, labels, lse, g, dlog, N, D, V, static_cast<cudaStream_t>(stream));
}
int fused_xent_dlog_sm90_f16(const void* h, const void* w, const void* labels, const void* lse, const void* g,
                             void* dlog, int N, int D, int V, void* stream) {
    if (bad_dims(N, D, V)) return (int)cudaErrorInvalidValue;
    return dlog_run<__half>(h, w, labels, lse, g, dlog, N, D, V, static_cast<cudaStream_t>(stream));
}

int fused_xent_dh_sm90_bf16(const void* dlog, const void* w, void* dh, int N, int D, int V, void* stream) {
    if (bad_dims(N, D, V)) return (int)cudaErrorInvalidValue;
    return dh_run<__nv_bfloat16>(dlog, w, dh, N, D, V, static_cast<cudaStream_t>(stream));
}
int fused_xent_dh_sm90_f16(const void* dlog, const void* w, void* dh, int N, int D, int V, void* stream) {
    if (bad_dims(N, D, V)) return (int)cudaErrorInvalidValue;
    return dh_run<__half>(dlog, w, dh, N, D, V, static_cast<cudaStream_t>(stream));
}

int fused_xent_dw_sm90_bf16(const void* h, const void* dlog, void* dw, int N, int D, int V, int accumulate,
                            void* stream) {
    if (bad_dims(N, D, V)) return (int)cudaErrorInvalidValue;
    return dw_run<__nv_bfloat16>(h, dlog, dw, N, D, V, accumulate, static_cast<cudaStream_t>(stream));
}
int fused_xent_dw_sm90_f16(const void* h, const void* dlog, void* dw, int N, int D, int V, int accumulate,
                           void* stream) {
    if (bad_dims(N, D, V)) return (int)cudaErrorInvalidValue;
    return dw_run<__half>(h, dlog, dw, N, D, V, accumulate, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
