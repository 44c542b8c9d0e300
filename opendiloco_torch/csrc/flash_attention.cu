// Flash attention for Hopper (sm_90a): the forward kernel and the two
// backward kernels of training attention, causal or full, GQA-aware.
//
// Replaces (opendiloco_tpu/ops/flash_attention.py):
//   B1  _fwd        (pl.pallas_call at :136, kernel body _fwd_kernel :53)
//   B2a _bwd_impl   (pl.pallas_call at :320, kernel body _dq_kernel :175)
//   B2b _bwd_impl   (pl.pallas_call at :363, kernel body _dkv_kernel :223)
//
// Computes, for q-head h reading kv-head h / rep, s = scale * q.k^T in f32
// with keys after the query masked to -1e30 when causal:
//   B1   out = softmax(s) . v and lse = m + log(l), by an online softmax;
//        p is rounded to v's dtype before p.v, l sums the f32 p.
//   B2a  dq = scale * sum_k ds . k, with p = exp(s - lse),
//        ds = p * (dO.v^T - delta) rounded to k's dtype.
//   B2b  dv = sum p^T . dO (p rounded to dO's dtype) and
//        dk = scale * sum ds^T . q (ds rounded to q's dtype), each summed
//        over the rep q-heads of the kv head and every q tile.
// Scores, softmax statistics and accumulators are f32; outputs are in the
// input dtype, or f32 for the gradients when grad_f32 is set.
//
// Layouts are the port's, read in place with no transpose:
//   q, out, dO, dq [B, T, H, D]; k, v, dk, dv [B, T, Hkv, D];
//   lse, delta [B, H, T] f32. All contiguous.
// Takes f32, bf16 and f16, any rep = H / Hkv, D a multiple of 8 up to 128 and
// any T (the tail tile is zero-filled and masked).
//
// Design. A block is 4 warps and owns 64 rows: 64 q rows of one head (B1,
// B2a) or 64 k rows of one kv head (B2b); each warp owns 16 of them. The
// block walks 64-row tiles of the other side, copied into shared memory
// with cp.async (16 bytes a copy, zero-filled past T) one tile ahead of
// the tile being computed (double buffering). Causal blocks stop at the
// diagonal: B1 and B2a take k tiles up to their last q row, B2b starts at
// the q tile of its first k row. Every product is a warp-level 16 x n
// tile product from shared memory: the bf16 and f16 instances issue
// mma.sync.m16n8k16 (bf16 or f16 in, f32 accumulate) on the tensor cores, the
// f32 instance computes the same fragment positions with f32 FMAs. p and
// ds go through a per-warp shared tile, rounded to the operand dtype,
// before their products. B2b accumulates dk and dv in registers over the
// rep heads and the q tiles in a fixed order: no atomics, so results
// repeat bit for bit from run to run (remat reruns B1 and must reproduce
// the forward).
//
// Bound on this card at the training shape (mb 8, T 1024, 16 heads x 64,
// causal, bf16; 3.35 TB/s and 989 TFLOP/s): B1 moves q, k, v and out,
// 67 MB, 0.020 ms, and does 2 causal products, 17.2 GFLOP, 0.017 ms, so
// it is bound by bytes (0.020 ms); B2a moves 84 MB (0.025 ms) and does 3
// products, 25.8 GFLOP (0.026 ms); B2b moves 101 MB (0.030 ms) and does
// 4, 34.4 GFLOP (0.035 ms): both bound by operations. chip_smoke.py
// computes each bound from the shapes it runs. This first version issues
// mma.sync from shared memory with 64-row tiles and does not reach the
// bound; B2a and B2b each recompute s and dO.v^T (7 tile products where
// one fused backward does 5). wgmma, TMA, warp specialisation and a
// fused backward are left for later changes.
#include <math.h>

#include "common.cuh"
#include "warp_tile.cuh"

namespace {

// Write a warp's [16][8 * nb_n] accumulator rows (absolute rows row0 + r,
// kept where < T_) to a [B, T, heads, D] tensor, times `mul`.
template <typename TO, int NB>
__device__ __forceinline__ void store_rows(TO* base, size_t row_stride, int row0, int T_, int nb_n,
                                           const float (&c)[NB][4], float mul0, float mul1) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
        if (nb < nb_n) {
            const int col = nb * 8 + 2 * t;
            if (r0 < T_) store2(base + (size_t)r0 * row_stride + col, c[nb][0] * mul0, c[nb][1] * mul0);
            if (r1 < T_) store2(base + (size_t)r1 * row_stride + col, c[nb][2] * mul1, c[nb][3] * mul1);
        }
    }
}

struct Dims {
    int T, H, Hkv, D, causal;
    float scale;
};

template <typename T>
__host__ __device__ __forceinline__ size_t fwd_smem(int D) {
    const int ld = smem_ld<T>(padded_d(D)), ldp = smem_ld<T>(kCols);
    return sizeof(T) * ((size_t)(kRows + 4 * kCols) * ld + (size_t)kWarps * 16 * ldp);
}
template <typename T>
__host__ __device__ __forceinline__ size_t dq_smem(int D) {
    const int ld = smem_ld<T>(padded_d(D)), ldp = smem_ld<T>(kCols);
    return sizeof(T) * ((size_t)(2 * kRows + 4 * kCols) * ld + (size_t)kWarps * 16 * ldp);
}
template <typename T>
__host__ __device__ __forceinline__ size_t dkv_smem(int D) {
    return dq_smem<T>(D) + sizeof(float) * 4 * kCols;
}

// ---------------------------------------------------------------------------
// B1: forward. Block (q tile, q head, batch).
// ---------------------------------------------------------------------------

template <typename T, int NBD>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                                       const T* __restrict__ v, T* __restrict__ out,
                                                       float* __restrict__ lse, Dims d) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int T_ = d.T, D = d.D, Dp = padded_d(D), nbd = D / 8;
    const int ld = smem_ld<T>(Dp), ldp = smem_ld<T>(kCols);
    T* sQ = reinterpret_cast<T*>(smem);
    T* sK = sQ + kRows * ld;      // 2 buffers
    T* sV = sK + 2 * kCols * ld;  // 2 buffers
    T* sP = sV + 2 * kCols * ld;  // one 16 x 64 tile per warp

    const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (d.H / d.Hkv);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const size_t qs = (size_t)d.H * D, ks = (size_t)d.Hkv * D;
    const T* qb = q + (size_t)b * T_ * qs + (size_t)h * D;
    const T* kb = k + (size_t)b * T_ * ks + (size_t)hk * D;
    const T* vb = v + (size_t)b * T_ * ks + (size_t)hk * D;

    zero_pad_cols(sQ, ld, kRows + 4 * kCols, D, Dp);
    const int kend = d.causal ? min(T_, q0 + kRows) : T_;
    const int nk = (kend + kCols - 1) / kCols;
    stage_rows(sQ, ld, qb, qs, q0, T_, D);
    stage_rows(sK, ld, kb, ks, 0, T_, D);
    stage_rows(sV, ld, vb, ks, 0, T_, D);
    cp_async_commit();

    float o[NBD][4];
    zero(o);
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
    T* myP = sP + warp * 16 * ldp;
    const T* myQ = sQ + warp * 16 * ld;

    for (int it = 0; it < nk; ++it) {
        const int buf = it & 1;
        if (it + 1 < nk) {
            stage_rows(sK + (buf ^ 1) * kCols * ld, ld, kb, ks, (it + 1) * kCols, T_, D);
            stage_rows(sV + (buf ^ 1) * kCols * ld, ld, vb, ks, (it + 1) * kCols, T_, D);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const T* cK = sK + buf * kCols * ld;
        const T* cV = sV + buf * kCols * ld;

        float s[8][4];
        zero(s);
        warp_mma<8, true>(s, 8, myQ, ld, cK, ld, Dp);
        const int k0 = it * kCols;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = k0 + nb * 8 + 2 * t4 + (e & 1), r = row[e >> 1];
                float x = d.scale * s[nb][e];
                if ((d.causal && col > r) || col >= T_) x = kNegInf;
                s[nb][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        }
        float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = quad_max(mx[i]);
            corr[i] = expf(m[i] - mx[i]);
        }
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = expf(s[nb][e] - mx[e >> 1]);
                s[nb][e] = p;
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
        tile_to_smem(myP, ldp, s);  // p rounded to v's dtype
        __syncwarp();
        warp_mma<NBD, false>(o, nbd, myP, ldp, cV, ld, kCols);
        __syncthreads();  // every warp is done with buf before it is refilled
    }

    float ls[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) ls[i] = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int nb = 0; nb < NBD; ++nb) {
        if (nb < nbd) {
            const int col = nb * 8 + 2 * t4;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                if (row[i] < T_) {
                    store2(out + (size_t)b * T_ * qs + (size_t)row[i] * qs + (size_t)h * D + col,
                           o[nb][2 * i] / ls[i], o[nb][2 * i + 1] / ls[i]);
                }
            }
        }
    }
    if (t4 == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            if (row[i] < T_) lse[((size_t)b * d.H + h) * T_ + row[i]] = m[i] + logf(ls[i]);
        }
    }
}

// ---------------------------------------------------------------------------
// B2a: dq. Block (q tile, q head, batch).
// ---------------------------------------------------------------------------

template <typename T, typename TO, int NBD>
__global__ void __launch_bounds__(kThreads) dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                                      const T* __restrict__ v, const T* __restrict__ dout,
                                                      const float* __restrict__ lse,
                                                      const float* __restrict__ delta, TO* __restrict__ dq,
                                                      Dims d) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int T_ = d.T, D = d.D, Dp = padded_d(D), nbd = D / 8;
    const int ld = smem_ld<T>(Dp), ldp = smem_ld<T>(kCols);
    T* sQ = reinterpret_cast<T*>(smem);
    T* sO = sQ + kRows * ld;      // dO
    T* sK = sO + kRows * ld;      // 2 buffers
    T* sV = sK + 2 * kCols * ld;  // 2 buffers
    T* sS = sV + 2 * kCols * ld;  // one 16 x 64 ds tile per warp

    const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (d.H / d.Hkv);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const size_t qs = (size_t)d.H * D, ks = (size_t)d.Hkv * D;
    const size_t qoff = (size_t)b * T_ * qs + (size_t)h * D;
    const T* kb = k + (size_t)b * T_ * ks + (size_t)hk * D;
    const T* vb = v + (size_t)b * T_ * ks + (size_t)hk * D;

    zero_pad_cols(sQ, ld, 2 * kRows + 4 * kCols, D, Dp);
    const int kend = d.causal ? min(T_, q0 + kRows) : T_;
    const int nk = (kend + kCols - 1) / kCols;
    stage_rows(sQ, ld, q + qoff, qs, q0, T_, D);
    stage_rows(sO, ld, dout + qoff, qs, q0, T_, D);
    stage_rows(sK, ld, kb, ks, 0, T_, D);
    stage_rows(sV, ld, vb, ks, 0, T_, D);
    cp_async_commit();

    const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const size_t j = ((size_t)b * d.H + h) * T_ + row[i];
        lse_r[i] = row[i] < T_ ? lse[j] : 0.0f;
        delta_r[i] = row[i] < T_ ? delta[j] : 0.0f;
    }
    float acc[NBD][4];
    zero(acc);
    T* myS = sS + warp * 16 * ldp;

    for (int it = 0; it < nk; ++it) {
        const int buf = it & 1;
        if (it + 1 < nk) {
            stage_rows(sK + (buf ^ 1) * kCols * ld, ld, kb, ks, (it + 1) * kCols, T_, D);
            stage_rows(sV + (buf ^ 1) * kCols * ld, ld, vb, ks, (it + 1) * kCols, T_, D);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const T* cK = sK + buf * kCols * ld;
        const T* cV = sV + buf * kCols * ld;

        float s[8][4], dp[8][4];
        zero(s);
        zero(dp);
        warp_mma<8, true>(s, 8, sQ + warp * 16 * ld, ld, cK, ld, Dp);
        warp_mma<8, true>(dp, 8, sO + warp * 16 * ld, ld, cV, ld, Dp);
        const int k0 = it * kCols;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = k0 + nb * 8 + 2 * t4 + (e & 1), i = e >> 1;
                float x = d.scale * s[nb][e];
                if ((d.causal && col > row[i]) || col >= T_) x = kNegInf;
                const float p = expf(x - lse_r[i]);
                s[nb][e] = p * (dp[nb][e] - delta_r[i]);
            }
        }
        tile_to_smem(myS, ldp, s);  // ds rounded to k's dtype
        __syncwarp();
        warp_mma<NBD, false>(acc, nbd, myS, ldp, cK, ld, kCols);
        __syncthreads();
    }
    store_rows(dq + qoff, qs, q0 + warp * 16, T_, nbd, acc, d.scale, d.scale);
}

// ---------------------------------------------------------------------------
// B2b: dk and dv. Block (k tile, kv head, batch); walks the rep q heads of
// the kv head and, for each, the q tiles from the diagonal on.
// ---------------------------------------------------------------------------

template <typename T, typename TO, int NBD>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                                       const T* __restrict__ v, const T* __restrict__ dout,
                                                       const float* __restrict__ lse,
                                                       const float* __restrict__ delta, TO* __restrict__ dk,
                                                       TO* __restrict__ dv, Dims d) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int T_ = d.T, D = d.D, Dp = padded_d(D), nbd = D / 8;
    const int ld = smem_ld<T>(Dp), ldp = smem_ld<T>(kCols);
    T* sK = reinterpret_cast<T*>(smem);
    T* sV = sK + kRows * ld;
    T* sQ = sV + kRows * ld;      // 2 buffers
    T* sO = sQ + 2 * kCols * ld;  // dO, 2 buffers
    T* sS = sO + 2 * kCols * ld;  // one 16 x 64 tile per warp
    float* sL = reinterpret_cast<float*>(sS + kWarps * 16 * ldp);  // lse, 2 buffers
    float* sD = sL + 2 * kCols;                                     // delta, 2 buffers

    const int k0 = blockIdx.x * kRows, hk = blockIdx.y, b = blockIdx.z;
    const int rep = d.H / d.Hkv;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const size_t qs = (size_t)d.H * D, ks = (size_t)d.Hkv * D;
    const size_t koff = (size_t)b * T_ * ks + (size_t)hk * D;

    zero_pad_cols(sK, ld, 2 * kRows + 4 * kCols, D, Dp);
    stage_rows(sK, ld, k + koff, ks, k0, T_, D);
    stage_rows(sV, ld, v + koff, ks, k0, T_, D);

    const int nq = (T_ + kCols - 1) / kCols;
    const int j0 = d.causal ? k0 / kCols : 0;  // first q tile at or after the diagonal
    const int per_head = nq - j0;
    const int n_it = rep * per_head;

    // stage q tile `it` (head hk * rep + it / per_head, tile j0 + it % per_head)
    auto stage = [&](int it, int buf) {
        const int h = hk * rep + it / per_head, j = j0 + it % per_head;
        const size_t qoff = (size_t)b * T_ * qs + (size_t)h * D;
        stage_rows(sQ + buf * kCols * ld, ld, q + qoff, qs, j * kCols, T_, D);
        stage_rows(sO + buf * kCols * ld, ld, dout + qoff, qs, j * kCols, T_, D);
        const int i = threadIdx.x & (kCols - 1), r = j * kCols + i;
        const size_t li = ((size_t)b * d.H + h) * T_ + r;
        if (threadIdx.x < kCols) sL[buf * kCols + i] = r < T_ ? lse[li] : 0.0f;
        else if (threadIdx.x < 2 * kCols) sD[buf * kCols + i] = r < T_ ? delta[li] : 0.0f;
    };
    if (n_it > 0) stage(0, 0);
    cp_async_commit();

    const int krow[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
    float dk_acc[NBD][4], dv_acc[NBD][4];
    zero(dk_acc);
    zero(dv_acc);
    T* myS = sS + warp * 16 * ldp;
    const T* myK = sK + warp * 16 * ld;
    const T* myV = sV + warp * 16 * ld;

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
        const T* cQ = sQ + buf * kCols * ld;
        const T* cO = sO + buf * kCols * ld;
        const float* cL = sL + buf * kCols;
        const float* cD = sD + buf * kCols;
        const int qc0 = (j0 + it % per_head) * kCols;

        float st[8][4], dpt[8][4];  // s^T and (dO.v^T)^T: rows are k rows
        zero(st);
        zero(dpt);
        warp_mma<8, true>(st, 8, myK, ld, cQ, ld, Dp);
        warp_mma<8, true>(dpt, 8, myV, ld, cO, ld, Dp);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = nb * 8 + 2 * t4 + (e & 1), qcol = qc0 + c;
                float x = d.scale * st[nb][e];
                if ((d.causal && qcol < krow[e >> 1]) || qcol >= T_) x = kNegInf;
                const float p = expf(x - cL[c]);
                st[nb][e] = p;
                dpt[nb][e] = p * (dpt[nb][e] - cD[c]);
            }
        }
        tile_to_smem(myS, ldp, st);  // p^T rounded to dO's dtype
        __syncwarp();
        warp_mma<NBD, false>(dv_acc, nbd, myS, ldp, cO, ld, kCols);
        __syncwarp();
        tile_to_smem(myS, ldp, dpt);  // ds^T rounded to q's dtype
        __syncwarp();
        warp_mma<NBD, false>(dk_acc, nbd, myS, ldp, cQ, ld, kCols);
        __syncthreads();
    }
    store_rows(dk + koff, ks, k0 + warp * 16, T_, nbd, dk_acc, d.scale, d.scale);
    store_rows(dv + koff, ks, k0 + warp * 16, T_, nbd, dv_acc, 1.0f, 1.0f);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

bool bad_dims(int B, int T, int H, int Hkv, int D) {
    return B < 1 || T < 1 || Hkv < 1 || H % Hkv != 0 || D < 8 || D > 128 || D % 8 != 0 || H > 65535 ||
           Hkv > 65535 || B > 65535;
}

template <typename T, int NBD>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, Dims d,
                    cudaStream_t st) {
    const size_t smem = fwd_smem<T>(d.D);
    cudaError_t err = allow_smem<fwd_kernel<T, NBD>>(smem);
    if (err != cudaSuccess) return err;
    dim3 grid((d.T + kRows - 1) / kRows, d.H, B);
    fwd_kernel<T, NBD><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<float*>(lse), d);
    return cudaGetLastError();
}

template <typename T, typename TO, int NBD>
cudaError_t run_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, void* dq, void* dk, void* dv, int B, Dims d, cudaStream_t st) {
    const T* q_ = static_cast<const T*>(q);
    const T* k_ = static_cast<const T*>(k);
    const T* v_ = static_cast<const T*>(v);
    const T* o_ = static_cast<const T*>(dout);
    const float* l_ = static_cast<const float*>(lse);
    const float* de_ = static_cast<const float*>(delta);
    if (dq != nullptr) {
        const size_t smem = dq_smem<T>(d.D);
        cudaError_t err = allow_smem<dq_kernel<T, TO, NBD>>(smem);
        if (err != cudaSuccess) return err;
        dim3 grid((d.T + kRows - 1) / kRows, d.H, B);
        dq_kernel<T, TO, NBD><<<grid, kThreads, smem, st>>>(q_, k_, v_, o_, l_, de_, static_cast<TO*>(dq), d);
    } else {
        const size_t smem = dkv_smem<T>(d.D);
        cudaError_t err = allow_smem<dkv_kernel<T, TO, NBD>>(smem);
        if (err != cudaSuccess) return err;
        dim3 grid((d.T + kRows - 1) / kRows, d.Hkv, B);
        dkv_kernel<T, TO, NBD><<<grid, kThreads, smem, st>>>(q_, k_, v_, o_, l_, de_, static_cast<TO*>(dk),
                                                              static_cast<TO*>(dv), d);
    }
    return cudaGetLastError();
}

template <typename T>
int fwd_entry(const void* q, const void* k, const void* v, void* out, void* lse, int B, int T_, int H,
              int Hkv, int D, int causal, float scale, void* stream) {
    if (bad_dims(B, T_, H, Hkv, D)) return (int)cudaErrorInvalidValue;
    const Dims d{T_, H, Hkv, D, causal, scale};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (int)(D <= 64 ? run_fwd<T, 8>(q, k, v, out, lse, B, d, st)
                         : run_fwd<T, 16>(q, k, v, out, lse, B, d, st));
}

template <typename T>
int bwd_entry(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, void* dk, void* dv, int B, int T_, int H, int Hkv, int D,
              int causal, float scale, int grad_f32, void* stream) {
    if (bad_dims(B, T_, H, Hkv, D)) return (int)cudaErrorInvalidValue;
    const Dims d{T_, H, Hkv, D, causal, scale};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (grad_f32) {
        err = D <= 64 ? run_bwd<T, float, 8>(q, k, v, dout, lse, delta, dq, dk, dv, B, d, st)
                      : run_bwd<T, float, 16>(q, k, v, dout, lse, delta, dq, dk, dv, B, d, st);
    } else {
        err = D <= 64 ? run_bwd<T, T, 8>(q, k, v, dout, lse, delta, dq, dk, dv, B, d, st)
                      : run_bwd<T, T, 16>(q, k, v, dout, lse, delta, dq, dk, dv, B, d, st);
    }
    return (int)err;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse, int B, int T,
                            int H, int Hkv, int D, int causal, float scale, void* stream) {
    return fwd_entry<float>(q, k, v, out, lse, B, T, H, Hkv, D, causal, scale, stream);
}

int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B, int T,
                             int H, int Hkv, int D, int causal, float scale, void* stream) {
    return fwd_entry<__nv_bfloat16>(q, k, v, out, lse, B, T, H, Hkv, D, causal, scale, stream);
}

int flash_attention_fwd_f16(const void* q, const void* k, const void* v, void* out, void* lse, int B, int T,
                            int H, int Hkv, int D, int causal, float scale, void* stream) {
    return fwd_entry<__half>(q, k, v, out, lse, B, T, H, Hkv, D, causal, scale, stream);
}

int flash_attention_dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                           const void* delta, void* dq, int B, int T, int H, int Hkv, int D, int causal,
                           float scale, int grad_f32, void* stream) {
    return bwd_entry<float>(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, T, H, Hkv, D, causal, scale,
                            grad_f32, stream);
}

int flash_attention_dq_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int T, int H, int Hkv, int D, int causal,
                            float scale, int grad_f32, void* stream) {
    return bwd_entry<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, T, H, Hkv, D, causal,
                                    scale, grad_f32, stream);
}

int flash_attention_dq_f16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                           const void* delta, void* dq, int B, int T, int H, int Hkv, int D, int causal,
                           float scale, int grad_f32, void* stream) {
    return bwd_entry<__half>(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, T, H, Hkv, D, causal, scale,
                             grad_f32, stream);
}

int flash_attention_dkv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B, int T, int H, int Hkv, int D,
                            int causal, float scale, int grad_f32, void* stream) {
    return bwd_entry<float>(q, k, v, dout, lse, delta, nullptr, dk, dv, B, T, H, Hkv, D, causal, scale,
                            grad_f32, stream);
}

int flash_attention_dkv_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B, int T, int H, int Hkv, int D,
                             int causal, float scale, int grad_f32, void* stream) {
    return bwd_entry<__nv_bfloat16>(q, k, v, dout, lse, delta, nullptr, dk, dv, B, T, H, Hkv, D, causal,
                                    scale, grad_f32, stream);
}

int flash_attention_dkv_f16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B, int T, int H, int Hkv, int D,
                            int causal, float scale, int grad_f32, void* stream) {
    return bwd_entry<__half>(q, k, v, dout, lse, delta, nullptr, dk, dv, B, T, H, Hkv, D, causal, scale,
                             grad_f32, stream);
}

}  // extern "C"
