// Speculative tail attention (B7) and paged decode attention (B6) for
// Hopper (sm_90a), one split-ring kernel and one merge kernel.
// B7: Kq query tokens per slot over that slot's ring KV page and then over
// the tail's own K/V, in one softmax: the attention of the draft, verify
// and continued-prefill (prefix reuse) passes. B6 (the kPrefix instance):
// one query token per slot over the ring alone, the plain decode step.
//
// Replaces: opendiloco_tpu/ops/decode_kernels.py spec_tail_attention_fused
// (_spec_tail_kernel :265, launched by pl.pallas_call at :438), and the
// same file's paged_decode_attention (_decode_attn_kernel :112, launched by
// pl.pallas_call at :241). Both TPU kernels carry (m, l, acc) in scratch
// across a sequential ring grid axis; here that carry becomes partials per
// ring split and a merge pass.
//
// Computes, for slot s, query token i at tail position j = q_start + i and
// query head h reading kv head h / rep:
//   out[s, i, h] = softmax_c(q[s, i, h] . key_c * D^-0.5) . value_c
// over the ring rows t and then the tail rows c of the slot, where
//   ring row t is live iff (t < lens[s] or lens[s] >= T) and it is not
//     evicted: with disp = (t - lens[s]) mod T (taken non-negative),
//     evicted iff disp <= j and lens[s] + disp >= T, i.e. the ring write of
//     tail token disp <= j would already have replaced it;
//   tail row c is live iff c <= j (causal within the tail).
// Masked entries add exactly 0: their score is -inf, so p = exp(-inf - m)
// = 0, whatever order the tiles come in (the TPU kernel's finite -1e30
// relies on the tail coming last to wipe a fully masked ring block).
// B6 is the same function with Kq = 1, no tail and another ring mask:
//   ring row t is live iff t <= lens[s] or lens[s] >= T (the decode
//     token's own row was written before the step; no eviction rule),
// so its live rows are exactly the prefix 0 .. min(lens, T - 1).
// Scores, running maxima, sums and accumulators are f32; p is rounded to
// v's dtype before p.v, l sums the f32 p; out = acc / (l == 0 ? 1 : l) in
// q's dtype.
//
// Layouts are the JAX package's, read in place with no transpose:
//   q, out [S, Kq, H, D] (B6: [S, H, D]); cache k/v [S, T, Kh, D]; tail k/v
//   [S, Kt, Kh, D]; lens [S] int32. All contiguous.
// Takes f32, bf16 and f16, any rep = H / Kh, D a multiple of 8 up to 128 (B6
// above 128 stays on its first design, paged_decode_attention.cu: the
// route rule is ops/decode_kernels.py _decode_route).
//
// Bound on this card: the bytes of the live ring and tail K/V (each read
// once per slot and kv head), q and out over 3.35 TB/s; at the draft shape
// (S 8, T 1024, Kq 1, Kt 4, 32 heads over 4, D 64, bf16, the ragged lens
// chip_smoke.py times) 3.9 MB, 1.2 us, and at most 8 x 1028 x 256
// operations per (slot, kv head), far below the tensor cores' rate.
// B6 at the decode shape (S 8, T 1024, Kh 4, rep 8, D 64, bf16, phase 2's
// lens, 3777 live rows): 3.9 MB, 1.17 us, bound by bytes likewise.
// chip_smoke.py computes each bound from the shapes it runs.
//
// Why B6 is an instance of this kernel (kPrefix, a template flag) and not a
// kernel of its own: at config_1b its decode shape is B7's draft shape
// without the 4-row tail, and the two differ only in the ring mask. One
// source keeps one split rule, one packing and one merge for both; B7's
// instances compile as before (kPrefix false folds away).
//
// Design. The query rows of one (slot, kv head) are its Kq x rep (token,
// head) pairs, token-major: row i * rep + r lies at q[s, i, kvh * rep + r].
// The grid is query tiles x ring splits x Kh x S (x holds tile and split).
// 1. Ring splits. The wrapper cuts the ring into `splits` chunks of
//    `chunk` rows from the static shape (ops/decode_kernels.py
//    spec_tail_splits: S, T, Kh, Kq rep and the SM count), enough to fill
//    the card where the query tiles alone do not: at the draft and verify
//    shapes 32 (slot, kv head) pairs become 256 blocks of 128 ring rows.
//    B6 at config_1b's decode shape takes the same 8 splits (rows = rep =
//    8), where its first design ran the longest slot's ring on one of 32
//    blocks (about 3% of the card's bandwidth).
//    Each block walks its split's live rows in 64-row tiles (cp.async, one
//    tile ahead); the last split of B7 also walks the tail up to its last
//    query's position. lens stays on the device: a split whose rows all
//    lie past the live length, or are all evicted for the block's queries
//    (decided from the split's first row and length alone; a block-wide
//    vote over its rows, a barrier before the first load, slowed the
//    whole kernel on the card), loads nothing and writes m = -inf, l = 0,
//    as does, through -inf scores, one whose rows are dead for each query
//    in other ways. With splits > 1 each block writes its unnormalised
//    partial (m, l, acc) in f32, and spec_tail_merge_kernel combines the
//    splits of each row in split order, taking 0 from a split with
//    m = -inf (never (-inf) - (-inf)); every B7 query sees tail row 0 and
//    every B6 slot its ring row 0 (lens >= 0), so the merged maximum is
//    finite. B6's merges are the same kernel, counted under their own
//    name (paged_decode_attention_merge). With one split (the suffix
//    shapes, whose query tiles fill the card) the block writes out
//    directly and no merge is launched.
// 2. Packed rows. A block is 4 warps, each multiplying a 16-row query
//    slice on the tensor cores (mma.sync bf16 or f16; f32 FMAs in the same layout
//    for f32). When Kq rep is at most 16 (the draft: 8) or 32, the block
//    holds one or two query slices, and the 4 / slices warps of a slice
//    split each 64-row key tile between them (16 or 32 keys a warp) with
//    their own running (m, l, acc), merged in the block in warp order at
//    the end. So no warp idles at decode shapes, and a block owns 16, 32
//    or 64 rows: the wrapper decides how many (ops/decode_kernels.py
//    spec_tail_rows_per_block, which also sizes the splits) and passes the
//    count, on which the entry point picks the kernel. (The other way, a block shrunk to the warps with rows,
//    would leave the tile loads to one warp.)
// 3. p.v reads V by ldmatrix.trans in bf16 and f16 (four 8 x 8 blocks a load)
//    rather than the first design's scalar loads.
// No atomics: every sum runs in a fixed order, so results repeat bit for
// bit. Suffix shapes reread the live ring once per query tile (from L2).
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "warp_tile.cuh"

namespace {

struct Dims {
    int T, Kq, Kt, H, Kh, D, q_start;
    int splits, chunk;  // split p holds ring rows [p chunk, (p + 1) chunk); the last also the tail
    float scale;
};

// key rows per warp of a 64-row tile, by the number of warps that share a
// query slice (KP): 64, 32 or 16
template <int KP>
__host__ __device__ constexpr int key_rows() { return kCols / KP; }

// f32 values a lane keeps for the block's warp merge: acc, then m and l
template <int NBD>
__host__ __device__ constexpr int red_floats() { return NBD * 4 + 4; }

template <typename T, int NBD>
__host__ __device__ __forceinline__ size_t spec_smem(int D) {
    const int ld = smem_ld<T>(padded_d(D)), ldp = smem_ld<T>(kCols);
    const size_t tiles = sizeof(T) * ((size_t)(kRows + 4 * kCols) * ld + (size_t)kWarps * 16 * ldp);
    const size_t red = sizeof(T) * (size_t)kRows * ld + sizeof(float) * 3 * 32 * red_floats<NBD>();
    return tiles > red ? tiles : red;
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

// o[16][8 nbd] += P[16][K] . V[K][8 nbd]: P a warp's tile in shared memory
// (row stride ldp), V row-major with row stride ldv. bf16 and f16 read V by
// ldmatrix.trans (matrix i of a load: k rows 8 (i & 1) on, n columns
// 8 (i >> 1) on); f32 takes warp_tile.cuh's FMA product.
template <int NBD, typename T>
__device__ __forceinline__ void pv_product(float (&o)[NBD][4], int nbd, const T* P, int ldp, const T* V, int ldv,
                                           int K) {
    if constexpr (kHalfWidth<T>) {
        const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, mi = lane >> 3;
        for (int k0 = 0; k0 < K; k0 += 16) {
            uint32_t a[4];
            a[0] = ld32(P + g * ldp + k0 + 2 * t);
            a[1] = ld32(P + (g + 8) * ldp + k0 + 2 * t);
            a[2] = ld32(P + g * ldp + k0 + 2 * t + 8);
            a[3] = ld32(P + (g + 8) * ldp + k0 + 2 * t + 8);
            const T* row = V + (k0 + (mi & 1) * 8 + (lane & 7)) * ldv + (mi >> 1) * 8;
#pragma unroll
            for (int nb = 0; nb < NBD; nb += 2) {
                if (nb < nbd) {
                    // an odd last block (D 40, 56, ...) reads its pair from
                    // the zeroed padding columns below the padded width
                    uint32_t r[4];
                    ldsm_x4_trans(r, row + nb * 8);
                    const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
                    mma16816<T>(o[nb], a, b0);
                    if (nb + 1 < nbd) mma16816<T>(o[nb + 1], a, b1);
                }
            }
        }
    } else {
        warp_mma<NBD, false>(o, nbd, P, ldp, V, ldv, K);
    }
}

// Block (query tile * splits + split, kv head, slot). KP warps share each
// 16-row query slice and split its key tiles; the block owns 64 / KP rows.
// kPrefix: paged decode attention (B6), one query a slot over ring rows
// 0 .. lens (all of them when lens >= T), with no tail and no eviction.
template <typename T, int NBD, int KP, bool kPrefix>
__global__ void __launch_bounds__(kThreads)
spec_tail_kernel(const T* __restrict__ q, const T* __restrict__ ck, const T* __restrict__ cv,
                 const T* __restrict__ tk, const T* __restrict__ tv, const int* __restrict__ lens,
                 T* __restrict__ out, float* __restrict__ part_ml, float* __restrict__ part_acc, Dims d) {
    constexpr int kKw = key_rows<KP>(), kNbk = kKw / 8, kRowsB = kRows / KP;
    extern __shared__ __align__(16) unsigned char smem[];
    const int D = d.D, Dp = padded_d(D), nbd = D / 8;
    const int ld = smem_ld<T>(Dp), ldp = smem_ld<T>(kCols);
    T* sQ = reinterpret_cast<T*>(smem);
    T* sK = sQ + kRows * ld;      // 2 buffers
    T* sV = sK + 2 * kCols * ld;  // 2 buffers
    T* sP = sV + 2 * kCols * ld;  // one 16 x kKw tile per warp

    const int split = blockIdx.x % d.splits, kvh = blockIdx.y, s = blockIdx.z;
    const int row0 = blockIdx.x / d.splits * kRowsB;
    const int rep = d.H / d.Kh, R = d.Kq * rep;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const int qs = warp / KP, ks = warp % KP;  // query slice, key share
    const size_t kst = (size_t)d.Kh * D;  // elements between K/V rows
    const size_t qst = (size_t)d.H * D;   // elements between query tokens
    const size_t qbase = (size_t)s * d.Kq * qst + (size_t)kvh * rep * D;
    const T* kring = ck + (size_t)s * d.T * kst + (size_t)kvh * D;
    const T* vring = cv + (size_t)s * d.T * kst + (size_t)kvh * D;
    const T* ktail = kPrefix ? nullptr : tk + (size_t)s * d.Kt * kst + (size_t)kvh * D;
    const T* vtail = kPrefix ? nullptr : tv + (size_t)s * d.Kt * kst + (size_t)kvh * D;

    const int len = lens[s];
    // ring rows 0 .. live - 1 hold the slot's tokens before the tail (B7),
    // or rows 0 .. lens, the decode token's own row included (B6)
    const int live = len >= d.T ? d.T : max(kPrefix ? len + 1 : len, 0);
    const int lmod = (len % d.T + d.T) % d.T;  // C++ % keeps the dividend's sign
    // this split's live ring rows: [r_lo, r_hi)
    const int r_lo = split * d.chunk, r_hi = min(r_lo + d.chunk, live);
    // rows evicted for the block's first query (the smallest j) are
    // evicted for all of its queries: those with disp in [max(0, T - len),
    // j]. A split whose live rows all have such a disp (taken without a
    // wrap of disp past T - 1) loads nothing.
    const int n_live = r_hi - r_lo, d0 = ((r_lo - lmod) % d.T + d.T) % d.T;
    const bool evicted = !kPrefix && n_live > 0 && d0 >= max(0, d.T - len) &&
                         d0 + n_live - 1 <= min(d.q_start + row0 / rep, d.T - 1);
    const int nr = n_live > 0 && !evicted ? (n_live + kCols - 1) / kCols : 0;
    // the last split takes the tail; rows past the block's last query
    // position are masked for all of its rows: neither loaded nor computed
    const int last_row = min(row0 + kRowsB, R) - 1;
    const int tail_rows = !kPrefix && split == d.splits - 1 ? min(d.Kt, d.q_start + last_row / rep + 1) : 0;
    const int nt = (tail_rows + kCols - 1) / kCols;
    const int n_it = nr + nt;  // 0 for a split with no live ring row

    auto stage = [&](int it, int buf) {
        const bool ring = it < nr;
        const int r0 = ring ? r_lo + it * kCols : (it - nr) * kCols, bound = ring ? r_hi : tail_rows;
        stage_rows(sK + buf * kCols * ld, ld, ring ? kring : ktail, kst, r0, bound, D);
        stage_rows(sV + buf * kCols * ld, ld, ring ? vring : vtail, kst, r0, bound, D);
    };
    if (n_it > 0) {
        zero_pad_cols(sQ, ld, kRows + 4 * kCols, D, Dp);
        constexpr int kVec = 16 / sizeof(T);
        const int chunks = D / kVec;
        for (int c = threadIdx.x; c < kRowsB * chunks; c += kThreads) {
            const int r = c / chunks, col = (c % chunks) * kVec, row = row0 + r;
            const bool ok = row < R;
            const size_t src = ok ? qbase + (size_t)(row / rep) * qst + (size_t)(row % rep) * D + col : 0;
            cp_async16(sQ + r * ld + col, q + src, ok);
        }
        stage(0, 0);
        cp_async_commit();
    }

    float o[NBD][4];
    zero(o);
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    const int row[2] = {row0 + qs * 16 + g, row0 + qs * 16 + g + 8};
    const int j[2] = {d.q_start + row[0] / rep, d.q_start + row[1] / rep};
    T* myP = sP + warp * 16 * ldp;
    const T* myQ = sQ + qs * 16 * ld;

    for (int it = 0; it < n_it; ++it) {
        const int buf = it & 1;
        if (it + 1 < n_it) {
            stage(it + 1, buf ^ 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const T* cK = sK + (buf * kCols + ks * kKw) * ld;
        const T* cV = sV + (buf * kCols + ks * kKw) * ld;

        float sc[kNbk][4];
        zero(sc);
        warp_mma<kNbk, true>(sc, kNbk, myQ, ld, cK, ld, Dp);
        const bool ring = it < nr;
        const int k0 = (ring ? r_lo + it * kCols : (it - nr) * kCols) + ks * kKw;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int nb = 0; nb < kNbk; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = k0 + nb * 8 + 2 * t4 + (e & 1), jj = j[e >> 1];
                bool ok;
                if (kPrefix) {
                    ok = c < r_hi;
                } else if (ring) {
                    int disp = c - lmod;
                    if (disp < 0) disp += d.T;
                    ok = c < r_hi && !(disp <= jj && len + disp >= d.T);
                } else {
                    ok = c < tail_rows && c <= jj;
                }
                const float x = ok ? d.scale * sc[nb][e] : -INFINITY;
                sc[nb][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        }
        float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = quad_max(mx[i]);  // finite: m starts at -1e30
            corr[i] = expf(m[i] - mx[i]);
        }
#pragma unroll
        for (int nb = 0; nb < kNbk; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = expf(sc[nb][e] - mx[e >> 1]);  // exactly 0 where masked
                sc[nb][e] = p;
                rs[e >> 1] += p;
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            l[i] = l[i] * corr[i] + quad_sum(rs[i]);
            m[i] = mx[i];
        }
#pragma unroll
        for (int nb = 0; nb < NBD; ++nb) {
            o[nb][0] *= corr[0];
            o[nb][1] *= corr[0];
            o[nb][2] *= corr[1];
            o[nb][3] *= corr[1];
        }
        tile_to_smem(myP, ldp, sc);  // p rounded to v's dtype
        __syncwarp();
        pv_product<NBD>(o, nbd, myP, ldp, cV, ld, kKw);
        __syncthreads();  // every warp is done with buf before it is refilled
    }

    if constexpr (KP > 1) {
        // the KP warps of a query slice merge in warp order: warps 1 .. KP - 1
        // of the slice hand their (acc, m, l) to its warp 0 through shared
        // memory (past sQ; the tiles are free after the loop's last barrier)
        constexpr int kF = red_floats<NBD>();
        float* red = reinterpret_cast<float*>(sQ + kRows * ld);
        __syncthreads();
        if (ks > 0) {
            float* p = red + ((qs * (KP - 1) + ks - 1) * 32 + lane) * kF;
#pragma unroll
            for (int nb = 0; nb < NBD; ++nb) {
#pragma unroll
                for (int e = 0; e < 4; ++e) p[nb * 4 + e] = o[nb][e];
            }
            p[NBD * 4] = m[0];
            p[NBD * 4 + 1] = m[1];
            p[NBD * 4 + 2] = l[0];
            p[NBD * 4 + 3] = l[1];
        }
        __syncthreads();
        if (ks > 0) return;
        for (int k = 1; k < KP; ++k) {
            const float* p = red + ((qs * (KP - 1) + k - 1) * 32 + lane) * kF;
            float a[2], b[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                // m >= -1e30 on both sides: the factors are finite
                const float mk = p[NBD * 4 + i], mn = fmaxf(m[i], mk);
                a[i] = expf(m[i] - mn);
                b[i] = expf(mk - mn);
                l[i] = l[i] * a[i] + p[NBD * 4 + 2 + i] * b[i];
                m[i] = mn;
            }
#pragma unroll
            for (int nb = 0; nb < NBD; ++nb) {
#pragma unroll
                for (int e = 0; e < 4; ++e) o[nb][e] = o[nb][e] * a[e >> 1] + p[nb * 4 + e] * b[e >> 1];
            }
        }
    }

    // (slot, kv head, split, row) of the partials: [S, Kh, splits, R]
    const size_t pbase = (((size_t)s * d.Kh + kvh) * d.splits + split) * R;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        if (row[i] >= R) continue;
        if (d.splits == 1) {
            // every real query sees its own tail row, so l > 0; the guard
            // mirrors the TPU kernel's finish
            const float li = l[i] == 0.0f ? 1.0f : l[i];
            T* dst = out + qbase + (size_t)(row[i] / rep) * qst + (size_t)(row[i] % rep) * D;
#pragma unroll
            for (int nb = 0; nb < NBD; ++nb) {
                if (nb < nbd) store2(dst + nb * 8 + 2 * t4, o[nb][2 * i] / li, o[nb][2 * i + 1] / li);
            }
        } else {
            const size_t pi = pbase + row[i];
            if (t4 == 0) {
                // a split with no live entry: l = 0, and m = -inf for the merge
                part_ml[2 * pi] = l[i] == 0.0f ? -INFINITY : m[i];
                part_ml[2 * pi + 1] = l[i];
            }
            float* dst = part_acc + pi * D;
#pragma unroll
            for (int nb = 0; nb < NBD; ++nb) {
                if (nb < nbd) store2(dst + nb * 8 + 2 * t4, o[nb][2 * i], o[nb][2 * i + 1]);
            }
        }
    }
}

// The splits of each (slot, kv head, row), merged in split order: thread
// per two neighbouring columns. A split with m = -inf (no live entry)
// adds exactly 0.
template <typename T>
__global__ void __launch_bounds__(256)
spec_tail_merge_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc, T* __restrict__ out,
                       int S, int Kq, int H, int Kh, int D, int splits) {
    const int rep = H / Kh, R = Kq * rep, half = D / 2;
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (size_t)S * Kh * R * half) return;
    const int c = (int)(idx % half) * 2;
    size_t rest = idx / half;
    const int row = (int)(rest % R);
    rest /= R;
    const int kvh = (int)(rest % Kh), s = (int)(rest / Kh);
    const size_t base = ((size_t)s * Kh + kvh) * splits * R + row;  // split p at base + p R
    float M = -INFINITY;
    for (int p = 0; p < splits; ++p) M = fmaxf(M, part_ml[2 * (base + (size_t)p * R)]);
    float L = 0.0f, a0 = 0.0f, a1 = 0.0f;
    for (int p = 0; p < splits; ++p) {
        const size_t pi = base + (size_t)p * R;
        const float mp = part_ml[2 * pi];
        const float w = mp == -INFINITY ? 0.0f : expf(mp - M);
        L += part_ml[2 * pi + 1] * w;
        const float2 a = *reinterpret_cast<const float2*>(part_acc + pi * D + c);
        a0 += a.x * w;
        a1 += a.y * w;
    }
    const float li = L == 0.0f ? 1.0f : L;
    T* dst = out + (((size_t)s * Kq + row / rep) * H + (size_t)kvh * rep + row % rep) * D + c;
    store2(dst, a0 / li, a1 / li);
}

template <typename T, int NBD, int KP, bool kPrefix>
cudaError_t run(const void* q, const void* ck, const void* cv, const void* tk, const void* tv,
                const void* lens, void* out, void* part_ml, void* part_acc, int S, Dims d, cudaStream_t st) {
    const size_t smem = spec_smem<T, NBD>(d.D);
    cudaError_t err = allow_smem<spec_tail_kernel<T, NBD, KP, kPrefix>>(smem);
    if (err != cudaSuccess) return err;
    const int rows = d.Kq * (d.H / d.Kh), per = kRows / KP;
    const long long x = (long long)((rows + per - 1) / per) * d.splits;
    if (x > 0x7fffffffLL) return cudaErrorInvalidValue;
    dim3 grid((unsigned)x, d.Kh, S);
    spec_tail_kernel<T, NBD, KP, kPrefix><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv),
        static_cast<const T*>(tk), static_cast<const T*>(tv), static_cast<const int*>(lens),
        static_cast<T*>(out), static_cast<float*>(part_ml), static_cast<float*>(part_acc), d);
    return cudaGetLastError();
}

// rows_per_block 16, 32 or 64: 4, 2 or 1 warps share each query slice
template <typename T, int NBD, bool kPrefix>
cudaError_t run_kp(const void* q, const void* ck, const void* cv, const void* tk, const void* tv,
                   const void* lens, void* out, void* part_ml, void* part_acc, int S, Dims d, int rows_per_block,
                   cudaStream_t st) {
    if (rows_per_block == 16) return run<T, NBD, 4, kPrefix>(q, ck, cv, tk, tv, lens, out, part_ml, part_acc, S, d, st);
    if (rows_per_block == 32) return run<T, NBD, 2, kPrefix>(q, ck, cv, tk, tv, lens, out, part_ml, part_acc, S, d, st);
    if (rows_per_block == 64) return run<T, NBD, 1, kPrefix>(q, ck, cv, tk, tv, lens, out, part_ml, part_acc, S, d, st);
    return cudaErrorInvalidValue;
}

bool bad_dims(int S, int T_, int Kq, int Kt, int H, int Kh, int D) {
    return S < 1 || S > 65535 || T_ < 1 || Kq < 1 || Kt < 1 || Kh < 1 || Kh > 65535 || H % Kh != 0 || D < 8 ||
           D > 128 || D % 8 != 0 || (long long)Kq * (H / Kh) > 0x7fffffffLL;
}

template <typename T>
int entry(const void* q, const void* ck, const void* cv, const void* tk, const void* tv, const void* lens,
          void* out, void* part_ml, void* part_acc, int S, int T_, int Kq, int Kt, int H, int Kh, int D,
          int q_start, int splits, int chunk, int rows_per_block, float scale, void* stream) {
    // every split holds at least one ring row, and together they cover T
    if (bad_dims(S, T_, Kq, Kt, H, Kh, D) || q_start < 0 || splits < 1 || chunk < 1 ||
        (long long)(splits - 1) * chunk >= T_ || (long long)splits * chunk < T_ ||
        (splits > 1 && (part_ml == nullptr || part_acc == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    const Dims d{T_, Kq, Kt, H, Kh, D, q_start, splits, chunk, scale};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (int)(D <= 64 ? run_kp<T, 8, false>(q, ck, cv, tk, tv, lens, out, part_ml, part_acc, S, d, rows_per_block,
                                               st)
                         : run_kp<T, 16, false>(q, ck, cv, tk, tv, lens, out, part_ml, part_acc, S, d, rows_per_block,
                                                st));
}

// B6: q, out [S, H, D] (B7's layouts at Kq 1), the ring k/v [S, T, Kh, D];
// no tail
template <typename T>
int decode_entry(const void* q, const void* k, const void* v, const void* lens, void* out, void* part_ml,
                 void* part_acc, int S, int T_, int H, int Kh, int D, int splits, int chunk, int rows_per_block,
                 float scale, void* stream) {
    if (bad_dims(S, T_, 1, 1, H, Kh, D) || splits < 1 || chunk < 1 || (long long)(splits - 1) * chunk >= T_ ||
        (long long)splits * chunk < T_ || (splits > 1 && (part_ml == nullptr || part_acc == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    const Dims d{T_, 1, 0, H, Kh, D, 0, splits, chunk, scale};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (int)(D <= 64 ? run_kp<T, 8, true>(q, k, v, nullptr, nullptr, lens, out, part_ml, part_acc, S, d,
                                              rows_per_block, st)
                         : run_kp<T, 16, true>(q, k, v, nullptr, nullptr, lens, out, part_ml, part_acc, S, d,
                                               rows_per_block, st));
}

template <typename T>
int merge_entry(const void* part_ml, const void* part_acc, void* out, int S, int Kq, int H, int Kh, int D,
                int splits, void* stream) {
    if (bad_dims(S, 1, Kq, 1, H, Kh, D) || splits < 1) return (int)cudaErrorInvalidValue;
    const size_t n = (size_t)S * Kh * Kq * (H / Kh) * (D / 2);
    const size_t blocks = (n + 255) / 256;
    if (blocks > 0x7fffffffULL) return (int)cudaErrorInvalidValue;
    spec_tail_merge_kernel<T><<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(part_ml), static_cast<const float*>(part_acc), static_cast<T*>(out), S, Kq, H,
        Kh, D, splits);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int spec_tail_attention_f32(const void* q, const void* ck, const void* cv, const void* tk, const void* tv,
                            const void* lens, void* out, void* part_ml, void* part_acc, int S, int T, int Kq,
                            int Kt, int H, int Kh, int D, int q_start, int splits, int chunk, int rows_per_block,
                            float scale, void* stream) {
    return entry<float>(q, ck, cv, tk, tv, lens, out, part_ml, part_acc, S, T, Kq, Kt, H, Kh, D, q_start, splits,
                        chunk, rows_per_block, scale, stream);
}

int spec_tail_attention_bf16(const void* q, const void* ck, const void* cv, const void* tk, const void* tv,
                             const void* lens, void* out, void* part_ml, void* part_acc, int S, int T, int Kq,
                             int Kt, int H, int Kh, int D, int q_start, int splits, int chunk, int rows_per_block,
                             float scale, void* stream) {
    return entry<__nv_bfloat16>(q, ck, cv, tk, tv, lens, out, part_ml, part_acc, S, T, Kq, Kt, H, Kh, D, q_start,
                                splits, chunk, rows_per_block, scale, stream);
}

int spec_tail_attention_f16(const void* q, const void* ck, const void* cv, const void* tk, const void* tv,
                            const void* lens, void* out, void* part_ml, void* part_acc, int S, int T, int Kq,
                            int Kt, int H, int Kh, int D, int q_start, int splits, int chunk, int rows_per_block,
                            float scale, void* stream) {
    return entry<__half>(q, ck, cv, tk, tv, lens, out, part_ml, part_acc, S, T, Kq, Kt, H, Kh, D, q_start, splits,
                         chunk, rows_per_block, scale, stream);
}

int paged_decode_split_f32(const void* q, const void* k, const void* v, const void* lens, void* out, void* part_ml,
                           void* part_acc, int S, int T, int H, int Kh, int D, int splits, int chunk,
                           int rows_per_block, float scale, void* stream) {
    return decode_entry<float>(q, k, v, lens, out, part_ml, part_acc, S, T, H, Kh, D, splits, chunk, rows_per_block,
                               scale, stream);
}

int paged_decode_split_bf16(const void* q, const void* k, const void* v, const void* lens, void* out, void* part_ml,
                            void* part_acc, int S, int T, int H, int Kh, int D, int splits, int chunk,
                            int rows_per_block, float scale, void* stream) {
    return decode_entry<__nv_bfloat16>(q, k, v, lens, out, part_ml, part_acc, S, T, H, Kh, D, splits, chunk,
                                       rows_per_block, scale, stream);
}

int paged_decode_split_f16(const void* q, const void* k, const void* v, const void* lens, void* out, void* part_ml,
                           void* part_acc, int S, int T, int H, int Kh, int D, int splits, int chunk,
                           int rows_per_block, float scale, void* stream) {
    return decode_entry<__half>(q, k, v, lens, out, part_ml, part_acc, S, T, H, Kh, D, splits, chunk, rows_per_block,
                                scale, stream);
}

int spec_tail_attention_merge_f32(const void* part_ml, const void* part_acc, void* out, int S, int Kq, int H,
                                  int Kh, int D, int splits, void* stream) {
    return merge_entry<float>(part_ml, part_acc, out, S, Kq, H, Kh, D, splits, stream);
}

int spec_tail_attention_merge_bf16(const void* part_ml, const void* part_acc, void* out, int S, int Kq, int H,
                                   int Kh, int D, int splits, void* stream) {
    return merge_entry<__nv_bfloat16>(part_ml, part_acc, out, S, Kq, H, Kh, D, splits, stream);
}

int spec_tail_attention_merge_f16(const void* part_ml, const void* part_acc, void* out, int S, int Kq, int H,
                                  int Kh, int D, int splits, void* stream) {
    return merge_entry<__half>(part_ml, part_acc, out, S, Kq, H, Kh, D, splits, stream);
}

}  // extern "C"
