// The backward of training attention in bf16 or f16 for Hopper (sm_90a), with
// warpgroup matrix products (wgmma), TMA copies and an mbarrier ring:
//   B2a dq      (replaces opendiloco_tpu/ops/flash_attention.py _bwd_impl,
//                pl.pallas_call at :320, kernel body _dq_kernel :175)
//   B2b dk, dv  (the same _bwd_impl, pl.pallas_call at :363, kernel body
//                _dkv_kernel :223)
// flash_attention.cu keeps the first design of both (mma.sync), which
// ops/flash_attention.py routes f32 and the other head dims to. Each
// kernel is one template over the element type E (bf16 or f16; sm90.cuh)
// and the output type TO (E, or f32 under grad_f32), exported as *_bf16
// and *_f16.
//
// Computes what those kernels compute, for q-head h reading kv-head
// h / rep, with s = scale * q.k^T in f32 and keys after the query masked
// when causal: p = exp(s - lse), dp = dO.v^T, ds = p * (dp - delta);
//   B2a  dq = scale * sum_k ds . k, ds rounded to E;
//   B2b  dv = sum p^T . dO (p rounded to E), dk = scale * sum ds^T . q
//        (ds rounded to E), each summed over the rep q-heads of the
//        kv head and every q tile in a fixed order.
// Scores, statistics and accumulators are f32; outputs E, or f32 under
// grad_f32. Layouts are the port's, read in place by TMA: q, dO, dq
// [B, T, H, D]; k, v, dk, dv [B, T, Hkv, D]; lse, delta [B, H, T] f32.
// D is 32, 64 or 128; any T and rep.
//
// Bound on this card (989 TFLOP/s bf16 and f16 alike, 3.35 TB/s; chip_smoke.py
// flash_work): at the 150m training shape (B 8, T 1024, 16 x 64 heads,
// causal) B2a does 3 products over the causal pairs, 25.8 GFLOP, 0.0261
// ms, and moves 84 MB (0.025 ms); B2b does 4, 34.4 GFLOP, 0.0348 ms, and
// moves 101 MB (0.030 ms). At the 1b head geometry (32 q over 4 kv heads)
// B2a does 51.6 GFLOP (0.0522 ms) and moves 111 MB (0.033 ms), B2b 68.7
// GFLOP (0.0695 ms) and 86 MB (0.026 ms). Both are bound by operations.
//
// Design, against what held the first design back:
// 1. Products are wgmma (m64n64k16, and m64n32k16 at D 32), the only
//    instruction that reaches Hopper's tensor-core rate; mma.sync does not.
// 2. Operands come from shared memory through wgmma descriptors over
//    tiles TMA wrote with the matching swizzle (128 B at D 64, two 64-col
//    halves at D 128, 64 B at D 32): no per-thread fragment loads. The
//    products whose B operand has the reduction along its rows (ds.k in
//    B2a, p^T.dO and ds^T.q in B2b) read it MN-major through the
//    descriptor's transpose bit.
// 3. p and ds never leave registers: the f32 accumulator is rounded in
//    place into the E A fragment of the next wgmma (A from registers).
// 4. A CTA owns 128 rows (two consumer warpgroups of 64) and one producer
//    warp feeds a 2-3 stage ring of 64-row tiles by TMA (one mbarrier
//    for full and one for empty per stage), with the producer's registers
//    lowered and the consumers' raised by setmaxnreg. TMA's zero fill of
//    rows past T replaces the ragged-tail code. B2b's producer also stages
//    each q tile's lse and delta, loaded two tiles ahead. When causal, the
//    heaviest CTAs launch first: the 1-D grid maps its lowest block
//    indices to the last q tiles (B2a) and the first kv tiles (B2b) of
//    every head, so the longest CTAs start in the first wave and the short
//    ones fill the tail. B2b overlaps a tile's two register-A products
//    with the next tile's two score products; B2a, with one such product,
//    ran slower so (measured on the card) and waits for it instead.
//    The softmax is an FFMA and one ex2.approx an entry; only the tiles
//    that cross the diagonal or T test the mask. (Also measured, and
//    left out for gaining under 5%: A from registers for s and dp, the two
//    warpgroups taking turns to issue, 128-wide score tiles, more stages.)
// 5. The split stays: B2a and B2b each recompute s and dp (7 products
//    where a fused backward does 5) so that every output element is owned
//    by one CTA and summed in a fixed order. No atomics: results repeat
//    bit for bit, which checkpoint resume needs.
#include <math.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

struct BwdArgs {
    const float* lse;
    const float* delta;
    void* out0;  // dq (B2a) or dk (B2b)
    void* out1;  // dv (B2b)
    int B, T, H, Hkv, causal;
    float scale;
};

// ---------------------------------------------------------------------------
// B2b: dk, dv. CTA (128 kv rows, kv head, batch); the producer streams the
// (q, dO) tiles of the rep q heads, from the diagonal on when causal.
// ---------------------------------------------------------------------------

template <int D>
struct DkvSmem {
    using G = Geo<D>;
    static constexpr int kKV = kOwn * D * 2;   // K or V, resident
    static constexpr int kQT = kTile * D * 2;  // Q or dO, one stage
    static constexpr int K = 0, V = kKV, Q = 2 * kKV, O = Q + G::kStages * kQT;
    static constexpr int L = O + G::kStages * kQT;  // lse, kTile f32 a stage
    static constexpr int Dl = L + G::kStages * kTile * 4;
    static constexpr int Bar = Dl + G::kStages * kTile * 4;  // full[], empty[], resident
    static constexpr int kBytes = Bar + (2 * G::kStages + 1) * 8 + 1024;  // + alignment slack
};

template <typename E, int D, typename TO>
__global__ void __launch_bounds__(kCtaThreads, 1)
    dkv_sm90_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mo,
                    const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv, BwdArgs a) {
    using G = Geo<D>;
    using S = DkvSmem<D>;
    constexpr int kSt = G::kStages;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* sm = align1024(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::Bar);
    uint64_t* empty = full + kSt;
    uint64_t* res = empty + kSt;
    float* sL = reinterpret_cast<float*>(sm + S::L);
    float* sD = reinterpret_cast<float*>(sm + S::Dl);

    const int T_ = a.T, rep = a.H / a.Hkv;
    const int per = a.Hkv * a.B;
    const int kt = blockIdx.x / per;  // ascending: the first kv tiles see the most q tiles
    const int hk = (blockIdx.x % per) % a.Hkv, b = (blockIdx.x % per) / a.Hkv;
    const int k0 = kt * kOwn;
    const int nq = (T_ + kTile - 1) / kTile;
    const int j0 = a.causal ? k0 / kTile : 0;  // first q tile at or after the diagonal
    const int per_head = nq - j0;
    const int n_it = rep * per_head;

    if (threadIdx.x == 0) {
        for (int s = 0; s < kSt; ++s) {
            mbar_init(full + s, 32);  // the producer warp's lanes (lane 0 with the TMA bytes)
            mbar_init(empty + s, 8);  // one lane per consumer warp
        }
        mbar_init(res, 1);
        mbar_fence_init();
    }
    __syncthreads();

    if (threadIdx.x < 128) {
        // producer warpgroup: warp 0 issues, warps 1-3 leave
        regs_dec<kProducerRegs>();
        if (threadIdx.x >= 32) return;
        const int lane = threadIdx.x;
        if (lane == 0) {
            mbar_arrive_expect_tx(res, 2 * S::kKV);
            for (int blk = 0; blk < G::kBlk; ++blk) {
                tma_load_4d(sm + S::K + blk * kOwn * G::kRowBytes, &mk, res, blk * G::kCb, hk, k0, b);
                tma_load_4d(sm + S::V + blk * kOwn * G::kRowBytes, &mv, res, blk * G::kCb, hk, k0, b);
            }
        }
        // lse and delta of tile `it`, lanes holding rows lane and lane + 32,
        // loaded two tiles ahead so their latency stays off the ring
        auto fetch = [&](int it, float (&v)[4]) {
            if (it >= n_it) return;
            const int h = hk * rep + it / per_head, q0 = (j0 + it % per_head) * kTile;
            const size_t li = ((size_t)b * a.H + h) * T_;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int r = q0 + lane + 32 * i;
                v[i] = r < T_ ? a.lse[li + r] * kLog2e : 0.0f;
                v[2 + i] = r < T_ ? a.delta[li + r] : 0.0f;
            }
        };
        float ld[2][4];
        fetch(0, ld[0]);
        fetch(1, ld[1]);
        for (int it = 0; it < n_it; ++it) {
            const int s = it % kSt;
            float cur[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                cur[i] = ld[0][i];
                ld[0][i] = ld[1][i];
            }
            fetch(it + 2, ld[1]);
            mbar_wait(empty + s, ((it / kSt) & 1) ^ 1);
            const int h = hk * rep + it / per_head, q0 = (j0 + it % per_head) * kTile;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                sL[s * kTile + lane + 32 * i] = cur[i];
                sD[s * kTile + lane + 32 * i] = cur[2 + i];
            }
            if (lane == 0) {
                mbar_arrive_expect_tx(full + s, 2 * S::kQT);
                for (int blk = 0; blk < G::kBlk; ++blk) {
                    tma_load_4d(sm + S::Q + s * S::kQT + blk * kTile * G::kRowBytes, &mq, full + s,
                                blk * G::kCb, h, q0, b);
                    tma_load_4d(sm + S::O + s * S::kQT + blk * kTile * G::kRowBytes, &mo, full + s,
                                blk * G::kCb, h, q0, b);
                }
            } else {
                mbar_arrive(full + s);
            }
        }
        return;
    }

    // consumer warpgroups
    regs_inc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int wk0 = k0 + cw * kTile;  // this warpgroup's first kv row
    const bool active = wk0 < T_;
    const float scale_log2 = a.scale * kLog2e;
    const uint32_t sK = smem_u32(sm + S::K), sV = smem_u32(sm + S::V);

    float dk[G::kBlk][G::kN / 2], dv[G::kBlk][G::kN / 2];
#pragma unroll
    for (int blk = 0; blk < G::kBlk; ++blk) {
        zero_acc(dk[blk]);
        zero_acc(dv[blk]);
    }
    mbar_wait(res, 0);

    // The loop overlaps tile it's p^T.dO and ds^T.q products with tile
    // it + 1's s^T and dp^T: stage `pend` is released once they completed.
    uint32_t pa[4][4], da[4][4];  // A fragments of the products in flight
    int pend = -1;
    auto release = [&](int stage) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + stage);  // this warp is done with the stage
    };
    auto retire = [&]() {  // tile it - 1's dk/dv products have completed
#pragma unroll
        for (int blk = 0; blk < G::kBlk; ++blk) {
            fence_regs(dv[blk]);
            fence_regs(dk[blk]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            fence_regs(pa[kk]);
            fence_regs(da[kk]);
        }
        release(pend);
        pend = -1;
    };
    for (int it = 0; it < n_it; ++it) {
        const int s = it % kSt;
        mbar_wait(full + s, (it / kSt) & 1);
        const int q0 = (j0 + it % per_head) * kTile;
        if (!active || (a.causal && q0 + kTile - 1 < wk0)) {
            if (pend >= 0) {
                wgmma_wait<0>();
                retire();
            }
            release(s);
            continue;
        }
        const uint32_t sQ = smem_u32(sm + S::Q + s * S::kQT), sO = smem_u32(sm + S::O + s * S::kQT);
        float st[32], dpt[32];  // s^T and dp^T: rows are kv rows, columns q rows
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
            wgmma_ss_n64<E>(st, desc_k<D>(sK, kOwn, cw * kTile, ks), desc_k<D>(sQ, kTile, 0, ks), ks > 0);
        wgmma_commit();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
            wgmma_ss_n64<E>(dpt, desc_k<D>(sV, kOwn, cw * kTile, ks), desc_k<D>(sO, kTile, 0, ks), ks > 0);
        wgmma_commit();
        if (pend >= 0) {
            wgmma_wait<2>();
            retire();
        }

        const float* cL = sL + s * kTile;
        const float* cD = sD + s * kTile;
        const bool mask = (a.causal && q0 < wk0 + kTile) || q0 + kTile > T_;
        const int kr0 = wk0 + warp * 16 + g;
        wgmma_wait<1>();
        fence_regs(st);
        // p^T: columns are q rows, masked where q < k or q >= T
        exp_tile(
            st, scale_log2, mask, [&](int nb, int e) { return cL[nb * 8 + 2 * t + (e & 1)]; },
            [&](int nb, int e) {
                const int q = q0 + nb * 8 + 2 * t + (e & 1);
                return (a.causal && q < kr0 + 8 * (e >> 1)) || q >= T_;
            });
        wgmma_wait<0>();
        fence_regs(dpt);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = nb * 8 + 2 * t + (e & 1);
                dpt[4 * nb + e] = st[4 * nb + e] * (dpt[4 * nb + e] - cD[c]);
            }
        }
        to_a_frags<E>(pa, st);   // p^T rounded to dO's dtype
        to_a_frags<E>(da, dpt);  // ds^T rounded to q's dtype
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int blk = 0; blk < G::kBlk; ++blk) {
                wgmma_rs<E, G::kN>(dv[blk], pa[kk], desc_mn<D>(sO, kTile, blk, kk));
                wgmma_rs<E, G::kN>(dk[blk], da[kk], desc_mn<D>(sQ, kTile, blk, kk));
            }
        }
        wgmma_commit();
        pend = s;
    }
    if (pend >= 0) {
        wgmma_wait<0>();
        retire();
    }
    if (!active) return;
    const size_t ks_ = (size_t)a.Hkv * D;
    const size_t off = (size_t)b * T_ * ks_ + (size_t)hk * D;
    store_acc<D>(static_cast<TO*>(a.out0) + off, ks_, wk0, T_, dk, a.scale);
    store_acc<D>(static_cast<TO*>(a.out1) + off, ks_, wk0, T_, dv, 1.0f);
}

// ---------------------------------------------------------------------------
// B2a: dq. CTA (128 q rows, q head, batch); the producer streams the (k, v)
// tiles of the kv head, up to the diagonal when causal.
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
    using G = Geo<D>;
    static constexpr int kQ = kOwn * D * 2;    // Q or dO, resident
    static constexpr int kKT = kTile * D * 2;  // K or V, one stage
    static constexpr int Q = 0, O = kQ, K = 2 * kQ, V = K + G::kStages * kKT;
    static constexpr int Bar = V + G::kStages * kKT;
    static constexpr int kBytes = Bar + (2 * G::kStages + 1) * 8 + 1024;
};

template <typename E, int D, typename TO>
__global__ void __launch_bounds__(kCtaThreads, 1)
    dq_sm90_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mo,
                   const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv, BwdArgs a) {
    using G = Geo<D>;
    using S = DqSmem<D>;
    constexpr int kSt = G::kStages;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* sm = align1024(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::Bar);
    uint64_t* empty = full + kSt;
    uint64_t* res = empty + kSt;

    const int T_ = a.T, rep = a.H / a.Hkv;
    const int per = a.H * a.B;
    const int nqt = (T_ + kOwn - 1) / kOwn;
    // descending when causal: the last q tiles, which see the most kv tiles, first
    const int qt = a.causal ? nqt - 1 - (int)(blockIdx.x / per) : (int)(blockIdx.x / per);
    const int h = (blockIdx.x % per) % a.H, b = (blockIdx.x % per) / a.H;
    const int hk = h / rep;
    const int q0 = qt * kOwn;
    const int kend = a.causal ? min(T_, q0 + kOwn) : T_;
    const int nk = (kend + kTile - 1) / kTile;

    if (threadIdx.x == 0) {
        for (int s = 0; s < kSt; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, 8);
        }
        mbar_init(res, 1);
        mbar_fence_init();
    }
    __syncthreads();

    if (threadIdx.x < 128) {
        regs_dec<kProducerRegs>();
        if (threadIdx.x != 0) return;
        mbar_arrive_expect_tx(res, 2 * S::kQ);
        for (int blk = 0; blk < G::kBlk; ++blk) {
            tma_load_4d(sm + S::Q + blk * kOwn * G::kRowBytes, &mq, res, blk * G::kCb, h, q0, b);
            tma_load_4d(sm + S::O + blk * kOwn * G::kRowBytes, &mo, res, blk * G::kCb, h, q0, b);
        }
        for (int it = 0; it < nk; ++it) {
            const int s = it % kSt;
            mbar_wait(empty + s, ((it / kSt) & 1) ^ 1);
            mbar_arrive_expect_tx(full + s, 2 * S::kKT);
            for (int blk = 0; blk < G::kBlk; ++blk) {
                tma_load_4d(sm + S::K + s * S::kKT + blk * kTile * G::kRowBytes, &mk, full + s, blk * G::kCb,
                            hk, it * kTile, b);
                tma_load_4d(sm + S::V + s * S::kKT + blk * kTile * G::kRowBytes, &mv, full + s, blk * G::kCb,
                            hk, it * kTile, b);
            }
        }
        return;
    }

    regs_inc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int wq0 = q0 + cw * kTile;  // this warpgroup's first q row
    const bool active = wq0 < T_;
    const float scale_log2 = a.scale * kLog2e;
    const int row[2] = {wq0 + warp * 16 + g, wq0 + warp * 16 + g + 8};
    float l2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const size_t j = ((size_t)b * a.H + h) * T_ + row[i];
        l2[i] = row[i] < T_ ? a.lse[j] * kLog2e : 0.0f;
        dl[i] = row[i] < T_ ? a.delta[j] : 0.0f;
    }
    const uint32_t sQ = smem_u32(sm + S::Q), sO = smem_u32(sm + S::O);

    float dq[G::kBlk][G::kN / 2];
#pragma unroll
    for (int blk = 0; blk < G::kBlk; ++blk) zero_acc(dq[blk]);
    mbar_wait(res, 0);

    for (int it = 0; it < nk; ++it) {
        const int s = it % kSt;
        mbar_wait(full + s, (it / kSt) & 1);
        const int c0 = it * kTile;
        if (active && !(a.causal && c0 > wq0 + kTile - 1)) {
            const uint32_t sK = smem_u32(sm + S::K + s * S::kKT), sV = smem_u32(sm + S::V + s * S::kKT);
            float sc[32], dp[32];  // s and dp: rows are q rows, columns kv rows
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks)
                wgmma_ss_n64<E>(sc, desc_k<D>(sQ, kOwn, cw * kTile, ks), desc_k<D>(sK, kTile, 0, ks), ks > 0);
            wgmma_commit();
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks)
                wgmma_ss_n64<E>(dp, desc_k<D>(sO, kOwn, cw * kTile, ks), desc_k<D>(sV, kTile, 0, ks), ks > 0);
            wgmma_commit();

            const bool mask = (a.causal && c0 + kTile - 1 > wq0) || c0 + kTile > T_;
            wgmma_wait<1>();
            fence_regs(sc);
            // p: columns are kv rows, masked where k > q or k >= T
            exp_tile(
                sc, scale_log2, mask, [&](int, int e) { return l2[e >> 1]; },
                [&](int nb, int e) {
                    const int col = c0 + nb * 8 + 2 * t + (e & 1);
                    return (a.causal && col > row[e >> 1]) || col >= T_;
                });
            wgmma_wait<0>();
            fence_regs(dp);
#pragma unroll
            for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
                for (int e = 0; e < 4; ++e) dp[4 * nb + e] = sc[4 * nb + e] * (dp[4 * nb + e] - dl[e >> 1]);
            }
            uint32_t da[4][4];
            to_a_frags<E>(da, dp);  // ds rounded to k's dtype
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
                for (int blk = 0; blk < G::kBlk; ++blk)
                    wgmma_rs<E, G::kN>(dq[blk], da[kk], desc_mn<D>(sK, kTile, blk, kk));
            }
            wgmma_commit();
            wgmma_wait<0>();
#pragma unroll
            for (int blk = 0; blk < G::kBlk; ++blk) fence_regs(dq[blk]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);  // this warp is done with stage s
    }
    if (!active) return;
    const size_t qs = (size_t)a.H * D;
    store_acc<D>(static_cast<TO*>(a.out0) + (size_t)b * T_ * qs + (size_t)h * D, qs, wq0, T_, dq, a.scale);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename E, int D, typename TO>
cudaError_t run(bool dq_side, const void* q, const void* k, const void* v, const void* dout, const BwdArgs& a,
                cudaStream_t st) {
    constexpr int cb = Geo<D>::kCb;
    // B2a keeps 128 q rows resident and streams 64-row k/v tiles; B2b the reverse
    const int qrows = dq_side ? kOwn : kTile, kvrows = dq_side ? kTile : kOwn;
    CUtensorMap mq, mo, mk, mv;
    cudaError_t err;
    if ((err = rows_map<E>(&mq, q, a.B, a.T, a.H, D, qrows, cb)) != cudaSuccess) return err;
    if ((err = rows_map<E>(&mo, dout, a.B, a.T, a.H, D, qrows, cb)) != cudaSuccess) return err;
    if ((err = rows_map<E>(&mk, k, a.B, a.T, a.Hkv, D, kvrows, cb)) != cudaSuccess) return err;
    if ((err = rows_map<E>(&mv, v, a.B, a.T, a.Hkv, D, kvrows, cb)) != cudaSuccess) return err;
    const int tiles = (a.T + kOwn - 1) / kOwn;
    if (dq_side) {
        constexpr size_t smem = DqSmem<D>::kBytes;
        if ((err = allow_smem<dq_sm90_kernel<E, D, TO>>(smem)) != cudaSuccess) return err;
        dq_sm90_kernel<E, D, TO><<<tiles * a.H * a.B, kCtaThreads, smem, st>>>(mq, mo, mk, mv, a);
    } else {
        constexpr size_t smem = DkvSmem<D>::kBytes;
        if ((err = allow_smem<dkv_sm90_kernel<E, D, TO>>(smem)) != cudaSuccess) return err;
        dkv_sm90_kernel<E, D, TO><<<tiles * a.Hkv * a.B, kCtaThreads, smem, st>>>(mq, mo, mk, mv, a);
    }
    return cudaGetLastError();
}

template <typename E, typename TO>
cudaError_t run_d(bool dq_side, int D, const void* q, const void* k, const void* v, const void* dout,
                  const BwdArgs& a, cudaStream_t st) {
    switch (D) {
        case 32: return run<E, 32, TO>(dq_side, q, k, v, dout, a, st);
        case 64: return run<E, 64, TO>(dq_side, q, k, v, dout, a, st);
        case 128: return run<E, 128, TO>(dq_side, q, k, v, dout, a, st);
        default: return cudaErrorInvalidValue;
    }
}

template <typename E>
int entry(bool dq_side, const void* q, const void* k, const void* v, const void* dout, const void* lse,
          const void* delta, void* out0, void* out1, int B, int T, int H, int Hkv, int D, int causal, float scale,
          int grad_f32, void* stream) {
    if (B < 1 || T < 1 || Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
    const BwdArgs a{static_cast<const float*>(lse), static_cast<const float*>(delta), out0, out1, B, T, H, Hkv,
                    causal, scale};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (int)(grad_f32 ? run_d<E, float>(dq_side, D, q, k, v, dout, a, st)
                          : run_d<E, E>(dq_side, D, q, k, v, dout, a, st));
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int flash_attention_dq_sm90_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int T, int H, int Hkv, int D, int causal,
                                 float scale, int grad_f32, void* stream) {
    return entry<__nv_bfloat16>(true, q, k, v, dout, lse, delta, dq, nullptr, B, T, H, Hkv, D, causal, scale,
                                grad_f32, stream);
}

int flash_attention_dkv_sm90_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int B, int T, int H,
                                  int Hkv, int D, int causal, float scale, int grad_f32, void* stream) {
    return entry<__nv_bfloat16>(false, q, k, v, dout, lse, delta, dk, dv, B, T, H, Hkv, D, causal, scale, grad_f32,
                                stream);
}

int flash_attention_dq_sm90_f16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int T, int H, int Hkv, int D, int causal,
                                float scale, int grad_f32, void* stream) {
    return entry<__half>(true, q, k, v, dout, lse, delta, dq, nullptr, B, T, H, Hkv, D, causal, scale, grad_f32,
                         stream);
}

int flash_attention_dkv_sm90_f16(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int B, int T, int H,
                                 int Hkv, int D, int causal, float scale, int grad_f32, void* stream) {
    return entry<__half>(false, q, k, v, dout, lse, delta, dk, dv, B, T, H, Hkv, D, causal, scale, grad_f32, stream);
}

}  // extern "C"
