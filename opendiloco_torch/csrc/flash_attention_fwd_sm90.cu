// The forward of training attention in bf16 or f16 for Hopper (sm_90a), with
// warpgroup matrix products (wgmma), TMA copies and an mbarrier ring:
//   B1 out, lse (replaces opendiloco_tpu/ops/flash_attention.py _fwd,
//               pl.pallas_call at :136, kernel body _fwd_kernel :53)
// flash_attention.cu keeps the first design (mma.sync), which
// ops/flash_attention.py routes f32 and the other head dims to. Each
// kernel is one template over the element type E (bf16 or f16: the same
// tiles, descriptors and swizzles; sm90.cuh), exported as *_bf16 and *_f16.
//
// Computes what that kernel computes, for q-head h reading kv-head
// h / rep: s = scale * q.k^T in f32, keys after the query masked when
// causal, an online softmax with f32 statistics, p rounded to E before
// p.v, out = acc / l in E and lse = m + log(l) in f32 (natural log, as
// flash_attention_bwd_sm90.cu reads it). Layouts are the port's, read and
// written in place by TMA: q, out [B, T, H, D]; k, v [B, T, Hkv, D]; lse
// [B, H, T]. D is 32, 64 or 128; any T and rep; causal or full.
//
// Bound on this card (989 TFLOP/s bf16 and f16 alike, 3.35 TB/s; chip_smoke.py
// flash_work): at the 1b head geometry (B 8, T 1024, 32 q over 4 kv heads
// x 64, causal) two products over the causal pairs, 34.4 GFLOP, 0.0348
// ms, against 76 MB moved (0.023 ms): bound by operations. At the 150m
// training shape (16 x 64 heads, MHA) 17.2 GFLOP (0.0174 ms) against
// 68 MB (0.0202 ms): bound by bytes. At D 64 the softmax's exponentials
// (one ex2 an entry, 16 an SM a clock) take as long as the products.
//
// Design (FA3's forward, on the helpers of sm90.cuh):
// 1. Persistent CTAs, one an SM: CTA c takes q tiles c, c + grid, ... in
//    an order that puts the heaviest first when causal (the last q tiles
//    see the most kv tiles). A q tile is 128 rows of one head: two
//    consumer warpgroups of 64 rows. One producer thread loads each
//    tile's Q by TMA, then streams its 128-row K and V tiles through a
//    ring of 4 stages (2 at D 128) with mbarriers, with zero fill past T;
//    the ring runs on across q tiles, so the next tile's loads overlap
//    this tile's last products and epilogue. setmaxnreg lowers the
//    producer's registers and raises the consumers'.
// 2. S = Q.K^T is an SS wgmma m64n128k16 (K-major operands from the
//    swizzled tiles); O += P.V an RS wgmma (m64n64k16, m64n32k16 at
//    D 32) with P rounded in place from the f32 S accumulator into E A
//    fragments and V read MN-major through the descriptor's transpose bit.
// 3. Softmax in the log2 domain: one FFMA (scale log2 e) and one
//    ex2.approx an entry; row maxima by quad shuffles; each thread keeps
//    its partial row sums, reduced across the quad once, in the epilogue.
//    Only tiles that cross the diagonal or T test the mask; masked scores
//    are -inf, so p is exactly 0. O is rescaled by 2^(m_old - m_new).
// 4. Each warpgroup issues kv tile j + 1's Q.K^T together with tile j's
//    P.V and runs tile j + 1's softmax while P.V is in flight (FA3's
//    intra-warpgroup pipelining); the stage is released once P.V is done.
// 5. Epilogue: O / l in E by stmatrix into the warpgroup's swizzled
//    out tile, then one TMA store (rows past T clipped by the tensor map);
//    lse = (m + log2 l) ln 2. Each output row belongs to one warpgroup and
//    is summed in kv-tile order with no atomics: results repeat bit for
//    bit, which remat (B1 reruns in the backward) and checkpoint resume
//    need.
// Measured on the card against this design and left out, each slower or
// no faster: 64-row kv tiles; a grid of one CTA a q tile; three consumer
// warpgroups (spills); the two warpgroups taking turns to issue; Q
// double-buffered; K and V on separate barriers and skipping the fully
// masked half of a diagonal tile (both make ptxas serialize the wgmmas);
// tree-shaped row reductions; a snake order of q tiles; a share of the
// exponentials on the FMA pipe by polynomial (the softmax is bound by
// issue and latency, not by the ex2 unit).
#include <math.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int kBN = 128;  // rows of a kv tile
constexpr float kLn2 = 0.6931471805599453f;

struct FwdArgs {
    void* out;
    float* lse;
    int B, T, H, Hkv, causal;
    float scale;
};

template <int D>
struct FwdSmem {
    static constexpr int kStages = D <= 64 ? 4 : 2;
    static constexpr int kQ = kOwn * D * 2;  // Q of one q tile
    static constexpr int kKT = kBN * D * 2;  // K or V, one stage
    static constexpr int Q = 0, K = kQ, V = K + kStages * kKT;
    static constexpr int O = V + kStages * kKT;  // out, 64 rows a warpgroup
    static constexpr int Bar = O + kOwn * D * 2;  // full[], empty[], q full, q empty
    static constexpr int kBytes = Bar + (2 * kStages + 2) * 8 + 1024;  // + alignment slack
};

// Q tile i of the grid's order: (128 q rows, q head, batch), descending
// when causal, with its kv tiles up to the diagonal when causal.
struct Tile {
    int q0, h, b, nk;
};
__device__ __forceinline__ Tile tile_at(int i, const FwdArgs& a) {
    const int per = a.H * a.B;
    const int nqt = (a.T + kOwn - 1) / kOwn;
    Tile t;
    t.q0 = (a.causal ? nqt - 1 - i / per : i / per) * kOwn;
    t.h = (i % per) % a.H;
    t.b = (i % per) / a.H;
    const int kend = a.causal ? min(a.T, t.q0 + kOwn) : a.T;
    t.nk = (kend + kBN - 1) / kBN;
    return t;
}

template <typename E, int D>
__global__ void __launch_bounds__(kCtaThreads, 1)
    fwd_sm90_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo, FwdArgs a,
                    int ntiles) {
    using G = Geo<D>;
    using S = FwdSmem<D>;
    constexpr int kSt = S::kStages;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* sm = align1024(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::Bar);
    uint64_t* empty = full + kSt;
    uint64_t* qfull = empty + kSt;
    uint64_t* qempty = qfull + 1;
    const int T_ = a.T, rep = a.H / a.Hkv;

    if (threadIdx.x == 0) {
        for (int s = 0; s < kSt; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, 8);  // one lane per consumer warp
        }
        mbar_init(qfull, 1);
        mbar_init(qempty, 8);
        mbar_fence_init();
    }
    __syncthreads();

    if (threadIdx.x < 128) {
        // producer warpgroup: thread 0 issues, the rest leave
        regs_dec<kProducerRegs>();
        if (threadIdx.x != 0) return;
        int ring = 0;  // kv tiles streamed so far, over all of this CTA's q tiles
        for (int i = blockIdx.x, n = 0; i < ntiles; i += gridDim.x, ++n) {
            const Tile tl = tile_at(i, a);
            const int hk = tl.h / rep;
            mbar_wait(qempty, (n & 1) ^ 1);  // the consumers are done with the last Q
            mbar_arrive_expect_tx(qfull, S::kQ);
            for (int blk = 0; blk < G::kBlk; ++blk)
                tma_load_4d(sm + S::Q + blk * kOwn * G::kRowBytes, &mq, qfull, blk * G::kCb, tl.h, tl.q0, tl.b);
            for (int j = 0; j < tl.nk; ++j, ++ring) {
                const int s = ring % kSt;
                mbar_wait(empty + s, ((ring / kSt) & 1) ^ 1);
                mbar_arrive_expect_tx(full + s, 2 * S::kKT);
                for (int blk = 0; blk < G::kBlk; ++blk) {
                    tma_load_4d(sm + S::K + s * S::kKT + blk * kBN * G::kRowBytes, &mk, full + s, blk * G::kCb,
                                hk, j * kBN, tl.b);
                    tma_load_4d(sm + S::V + s * S::kKT + blk * kBN * G::kRowBytes, &mv, full + s, blk * G::kCb,
                                hk, j * kBN, tl.b);
                }
            }
        }
        return;
    }

    // consumer warpgroups
    regs_inc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const float scale_log2 = a.scale * kLog2e;
    const uint32_t sQ = smem_u32(sm + S::Q);
    uint8_t* so = sm + S::O + cw * kTile * D * 2;  // this warpgroup's out tile

    float o[G::kBlk][G::kN / 2];
    // running row max of s scale log2 e, and this thread's share of the row sum
    float m[2], l[2];
    float sc[2][32];       // scores of the kv tile in flight (two halves of 64 columns), then its p
    uint32_t pa[2][4][4];  // p of the previous kv tile, the A operand of its P.V
    float corr[2];
    int ring = 0;  // as the producer's
    int wq0 = 0, row[2] = {0, 0};

    auto warp_arrive = [&](uint64_t* bar) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);  // this warp is done with it
    };
    auto stage = [&](int j) { return (ring + j) % kSt; };
    auto wait_full = [&](int j) { mbar_wait(full + stage(j), ((ring + j) / kSt) & 1); };
    auto scores = [&](int j) {
        const uint32_t sK = smem_u32(sm + S::K + stage(j) * S::kKT);
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
            wgmma_ss_n128<E>(sc[0], sc[1], desc_k<D>(sQ, kOwn, cw * kTile, ks), desc_k<D>(sK, kBN, 0, ks), ks > 0);
        wgmma_commit();
    };
    auto pv = [&](int j) {
        const uint32_t sV = smem_u32(sm + S::V + stage(j) * S::kKT);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
            for (int blk = 0; blk < G::kBlk; ++blk)
                wgmma_rs<E, G::kN>(o[blk], pa[kk / 4][kk % 4], desc_mn<D>(sV, kBN, blk, kk));
        }
        wgmma_commit();
    };
    auto fence_scores = [&]() {
        fence_regs(sc[0]);
        fence_regs(sc[1]);
    };
    // Online softmax of kv tile j's scores in sc, in place: p, the new row
    // max and sums, and corr, the factor that rescales O to the new max.
    auto softmax = [&](int j) {
        const int c0 = j * kBN;
        // only a tile that crosses the diagonal or T tests the mask, before the row max
        if ((a.causal && c0 + kBN - 1 > wq0) || c0 + kBN > T_) {
#pragma unroll
            for (int hv = 0; hv < 2; ++hv) {
                mask_tile(sc[hv], [&](int nb, int e) {
                    const int col = c0 + hv * 64 + nb * 8 + 2 * t + (e & 1);
                    return (a.causal && col > row[e >> 1]) || col >= T_;
                });
            }
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int hv = 0; hv < 2; ++hv) {
#pragma unroll
            for (int k = 0; k < 32; ++k) mx[(k >> 1) & 1] = fmaxf(mx[(k >> 1) & 1], sc[hv][k]);
        }
        float sub[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float mn = fmaxf(m[i], quad_max(mx[i]) * scale_log2);
            sub[i] = mn == -INFINITY ? 0.0f : mn;  // a row with no live key yet
            corr[i] = exp2_approx(m[i] - sub[i]);
            m[i] = mn;
        }
        float rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int hv = 0; hv < 2; ++hv) {
            exp2_tile(sc[hv], scale_log2, [&](int, int e) { return sub[e >> 1]; });
#pragma unroll
            for (int k = 0; k < 32; ++k) rs[(k >> 1) & 1] += sc[hv][k];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
    };
    auto to_p = [&]() {
        to_a_frags<E>(pa[0], sc[0]);
        to_a_frags<E>(pa[1], sc[1]);
    };

    for (int i = blockIdx.x, n = 0; i < ntiles; i += gridDim.x, ++n) {
        const Tile tl = tile_at(i, a);
        wq0 = tl.q0 + cw * kTile;  // this warpgroup's first q row
        row[0] = wq0 + warp * 16 + g;
        row[1] = row[0] + 8;
        const bool active = wq0 < T_;
        // kv tiles this warpgroup computes: up to its diagonal when causal
        const int nkw = !active ? 0 : a.causal ? min(tl.nk, (wq0 + kTile - 1) / kBN + 1) : tl.nk;
#pragma unroll
        for (int blk = 0; blk < G::kBlk; ++blk) zero_acc(o[blk]);
        m[0] = m[1] = -INFINITY;
        l[0] = l[1] = 0.0f;

        mbar_wait(qfull, n & 1);
        if (nkw > 0) {
            wait_full(0);
            wgmma_fence();
            scores(0);
            wgmma_wait<0>();
            fence_scores();
            if (nkw == 1) warp_arrive(qempty);  // the last read of Q is done
            softmax(0);  // O is still zero: no rescale
            to_p();
            for (int j = 1; j < nkw; ++j) {
                wait_full(j);
                wgmma_fence();
                scores(j);
                pv(j - 1);
                wgmma_wait<1>();  // S of kv tile j is in; P.V of tile j - 1 may still run
                fence_scores();
                if (j == nkw - 1) warp_arrive(qempty);
                softmax(j);
                wgmma_wait<0>();
#pragma unroll
                for (int blk = 0; blk < G::kBlk; ++blk) fence_regs(o[blk]);
#pragma unroll
                for (int kk = 0; kk < 8; ++kk) fence_regs(pa[kk / 4][kk % 4]);
                warp_arrive(empty + stage(j - 1));
#pragma unroll
                for (int blk = 0; blk < G::kBlk; ++blk) {
#pragma unroll
                    for (int k = 0; k < G::kN / 2; ++k) o[blk][k] *= corr[(k >> 1) & 1];
                }
                to_p();
            }
            wgmma_fence();
            pv(nkw - 1);
            wgmma_wait<0>();
#pragma unroll
            for (int blk = 0; blk < G::kBlk; ++blk) fence_regs(o[blk]);
            warp_arrive(empty + stage(nkw - 1));
        } else {
            warp_arrive(qempty);
        }
        // kv tiles past this warpgroup's diagonal (or all, past T): hand the stages back
        for (int j = nkw; j < tl.nk; ++j) {
            wait_full(j);
            warp_arrive(empty + stage(j));
        }
        ring += tl.nk;
        if (!active) continue;

        float inv[2], lse[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float ls = quad_sum(l[r]);
            const float lsafe = ls == 0.0f ? 1.0f : ls;
            inv[r] = 1.0f / lsafe;
            lse[r] = (m[r] + log2f(lsafe)) * kLn2;
        }
        // O / l in E into the swizzled out tile (stmatrix: lanes 8i ..
        // 8i + 7 address the rows of matrix i, the 8 x 8 block of column
        // block nb + i / 2, rows 8 (i % 2) on), then one TMA store
        if (tid == 0) bulk_wait_read0();  // the last q tile's store has read the out tile
        named_sync(1 + cw, 128);
        const int mi = lane >> 3, sr = warp * 16 + (mi & 1) * 8 + (lane & 7);
        const int swz = G::kSwz == 1 ? (sr & 7) : ((sr >> 1) & 3);  // 128- or 64-byte swizzle of row sr
#pragma unroll
        for (int blk = 0; blk < G::kBlk; ++blk) {
#pragma unroll
            for (int nb = 0; nb < G::kN / 8; nb += 2) {
                const float* e = &o[blk][4 * nb];
                const int chunk = (nb + (mi >> 1)) ^ swz;
                stmatrix_x4(smem_u32(so + blk * kTile * G::kRowBytes + sr * G::kRowBytes + chunk * 16),
                            pack_rn<E>(e[0] * inv[0], e[1] * inv[0]), pack_rn<E>(e[2] * inv[1], e[3] * inv[1]),
                            pack_rn<E>(e[4] * inv[0], e[5] * inv[0]), pack_rn<E>(e[6] * inv[1], e[7] * inv[1]));
            }
        }
        fence_proxy_async();
        named_sync(1 + cw, 128);
        if (tid == 0) {
            for (int blk = 0; blk < G::kBlk; ++blk)
                tma_store_4d(&mo, so + blk * kTile * G::kRowBytes, blk * G::kCb, tl.h, wq0, tl.b);
            bulk_commit();
        }
        if (t == 0) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                if (row[r] < T_) a.lse[((size_t)tl.b * a.H + tl.h) * T_ + row[r]] = lse[r];
            }
        }
    }
    if (tid == 0) bulk_wait_read0();  // the out tile stays until the last store has read it
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename E, int D>
cudaError_t run(const void* q, const void* k, const void* v, const FwdArgs& a, cudaStream_t st) {
    constexpr int cb = Geo<D>::kCb;
    CUtensorMap mq, mk, mv, mo;
    cudaError_t err;
    if ((err = rows_map<E>(&mq, q, a.B, a.T, a.H, D, kOwn, cb)) != cudaSuccess) return err;
    if ((err = rows_map<E>(&mk, k, a.B, a.T, a.Hkv, D, kBN, cb)) != cudaSuccess) return err;
    if ((err = rows_map<E>(&mv, v, a.B, a.T, a.Hkv, D, kBN, cb)) != cudaSuccess) return err;
    if ((err = rows_map<E>(&mo, a.out, a.B, a.T, a.H, D, kTile, cb)) != cudaSuccess) return err;
    constexpr size_t smem = FwdSmem<D>::kBytes;
    if ((err = allow_smem<fwd_sm90_kernel<E, D>>(smem)) != cudaSuccess) return err;
    int sms = 0;  // one persistent CTA an SM
    if ((err = sm_count(&sms)) != cudaSuccess) return err;
    const int ntiles = (a.T + kOwn - 1) / kOwn * a.H * a.B;
    fwd_sm90_kernel<E, D><<<min(ntiles, sms), kCtaThreads, smem, st>>>(mq, mk, mv, mo, a, ntiles);
    return cudaGetLastError();
}

template <typename E>
int entry(const void* q, const void* k, const void* v, void* out, void* lse, int B, int T, int H, int Hkv, int D,
          int causal, float scale, void* stream) {
    if (B < 1 || T < 1 || Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
    const FwdArgs a{out, static_cast<float*>(lse), B, T, H, Hkv, causal, scale};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 32: return (int)run<E, 32>(q, k, v, a, st);
        case 64: return (int)run<E, 64>(q, k, v, a, st);
        case 128: return (int)run<E, 128>(q, k, v, a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int flash_attention_fwd_sm90_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B, int T,
                                  int H, int Hkv, int D, int causal, float scale, void* stream) {
    return entry<__nv_bfloat16>(q, k, v, out, lse, B, T, H, Hkv, D, causal, scale, stream);
}

int flash_attention_fwd_sm90_f16(const void* q, const void* k, const void* v, void* out, void* lse, int B, int T,
                                 int H, int Hkv, int D, int causal, float scale, void* stream) {
    return entry<__half>(q, k, v, out, lse, B, T, H, Hkv, D, causal, scale, stream);
}

}  // extern "C"
