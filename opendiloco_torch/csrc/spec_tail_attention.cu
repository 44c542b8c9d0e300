// Speculative tail attention for Hopper (sm_90a): Kq query tokens per slot
// over that slot's ring KV page and then over the tail's own K/V, in one
// online softmax. The attention of the draft, verify and continued-prefill
// (prefix reuse) passes.
//
// Replaces: opendiloco_tpu/ops/decode_kernels.py spec_tail_attention_fused
// (_spec_tail_kernel :265, launched by pl.pallas_call at :438).
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
// Scores, running maxima, sums and accumulators are f32; p is rounded to
// v's dtype before p.v, l sums the f32 p; out = acc / l in q's dtype.
//
// Layouts are the JAX package's, read in place with no transpose:
//   q, out [S, Kq, H, D]; cache k/v [S, T, Kh, D]; tail k/v [S, Kt, Kh, D];
//   lens [S] int32. All contiguous.
// Takes f32 and bf16, any rep = H / Kh, D a multiple of 8 up to 128.
//
// Design. The query rows of one (slot, kv head) are its Kq x rep (token,
// head) pairs, token-major: row i * rep + r lies at q[s, i, kvh * rep + r].
// A block of 4 warps owns 64 of them (grid: query tiles x Kh x S), so the
// TPU kernel's whole [rep, Kq, D] accumulator (2 MB of f32 at the suffix
// shape, Kq 1024 and rep 8) is cut into tiles that fit an SM; at S 1 the
// query tiles are also what fill the card. The block walks 64-row tiles of
// the ring up to its live length (rows past it are neither loaded nor
// computed), then tiles of the tail up to its last query's position (tiles
// wholly above the causal diagonal are skipped), each copied into shared
// memory with cp.async one tile ahead of the one being computed. Products
// are flash_attention.cu's (warp_tile.cuh): mma.sync bf16 on the tensor
// cores, f32 FMAs in the same layout for f32.
//
// Bound on this card: the bytes of the live ring and tail K/V (each read
// once per slot and kv head), q and out over 3.35 TB/s; at the verify
// shape (S 8, T 1024, Kq = Kt = 5, 32 heads over 4, D 64, bf16) a full
// ring is 8.4 MB, 2.5 us, and its 4 * 40 * 1029 * 64 operations per
// (slot, kv head) are far below the tensor cores' rate. chip_smoke.py
// computes each bound from the shapes it runs. Known weaknesses, left for
// a later change: at the verify and draft shapes the grid is S * Kh = 32
// blocks on 132 SMs, each walking its whole live ring, and only 40 (verify)
// or 8 (draft) of a block's 64 query rows are real; splitting the ring
// across blocks with a second reduction pass would fill the card. At the
// suffix shape each query tile rereads the live ring (from L2).
#include <math.h>

#include "common.cuh"
#include "warp_tile.cuh"

namespace {

struct Dims {
    int T, Kq, Kt, H, Kh, D, q_start;
    float scale;
};

template <typename T>
__host__ __device__ __forceinline__ size_t spec_smem(int D) {
    const int ld = smem_ld<T>(padded_d(D)), ldp = smem_ld<T>(kCols);
    return sizeof(T) * ((size_t)(kRows + 4 * kCols) * ld + (size_t)kWarps * 16 * ldp);
}

// Block (query tile, kv head, slot).
template <typename T, int NBD>
__global__ void __launch_bounds__(kThreads)
spec_tail_kernel(const T* __restrict__ q, const T* __restrict__ ck, const T* __restrict__ cv,
                 const T* __restrict__ tk, const T* __restrict__ tv, const int* __restrict__ lens,
                 T* __restrict__ out, Dims d) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int D = d.D, Dp = padded_d(D), nbd = D / 8;
    const int ld = smem_ld<T>(Dp), ldp = smem_ld<T>(kCols);
    T* sQ = reinterpret_cast<T*>(smem);
    T* sK = sQ + kRows * ld;      // 2 buffers
    T* sV = sK + 2 * kCols * ld;  // 2 buffers
    T* sP = sV + 2 * kCols * ld;  // one 16 x 64 tile per warp

    const int row0 = blockIdx.x * kRows, kvh = blockIdx.y, s = blockIdx.z;
    const int rep = d.H / d.Kh, R = d.Kq * rep;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const size_t ks = (size_t)d.Kh * D;  // elements between K/V rows
    const size_t qs = (size_t)d.H * D;   // elements between query tokens
    const size_t qbase = (size_t)s * d.Kq * qs + (size_t)kvh * rep * D;
    const T* kring = ck + (size_t)s * d.T * ks + (size_t)kvh * D;
    const T* vring = cv + (size_t)s * d.T * ks + (size_t)kvh * D;
    const T* ktail = tk + (size_t)s * d.Kt * ks + (size_t)kvh * D;
    const T* vtail = tv + (size_t)s * d.Kt * ks + (size_t)kvh * D;

    const int len = lens[s];
    // ring rows 0 .. live - 1 hold the slot's tokens before the tail
    const int live = len >= d.T ? d.T : max(len, 0);
    const int lmod = (len % d.T + d.T) % d.T;  // C++ % keeps the dividend's sign
    // tail rows past the block's last query position are masked for all of
    // its rows: neither loaded nor computed
    const int last_row = min(row0 + kRows, R) - 1;
    const int tail_rows = min(d.Kt, d.q_start + last_row / rep + 1);
    const int nr = (live + kCols - 1) / kCols, nt = (tail_rows + kCols - 1) / kCols;
    const int n_it = nr + nt;  // >= 1: every query sees tail row 0

    zero_pad_cols(sQ, ld, kRows + 4 * kCols, D, Dp);
    {
        constexpr int kVec = 16 / sizeof(T);
        const int chunks = D / kVec;
        for (int c = threadIdx.x; c < kRows * chunks; c += kThreads) {
            const int r = c / chunks, col = (c % chunks) * kVec, row = row0 + r;
            const bool ok = row < R;
            const size_t src = ok ? qbase + (size_t)(row / rep) * qs + (size_t)(row % rep) * D + col : 0;
            cp_async16(sQ + r * ld + col, q + src, ok);
        }
    }
    auto stage = [&](int it, int buf) {
        const bool ring = it < nr;
        const int r0 = (ring ? it : it - nr) * kCols, bound = ring ? live : tail_rows;
        stage_rows(sK + buf * kCols * ld, ld, ring ? kring : ktail, ks, r0, bound, D);
        stage_rows(sV + buf * kCols * ld, ld, ring ? vring : vtail, ks, r0, bound, D);
    };
    stage(0, 0);
    cp_async_commit();

    float o[NBD][4];
    zero(o);
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    const int row[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
    const int j[2] = {d.q_start + row[0] / rep, d.q_start + row[1] / rep};
    T* myP = sP + warp * 16 * ldp;
    const T* myQ = sQ + warp * 16 * ld;

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
        const T* cK = sK + buf * kCols * ld;
        const T* cV = sV + buf * kCols * ld;

        float sc[8][4];
        zero(sc);
        warp_mma<8, true>(sc, 8, myQ, ld, cK, ld, Dp);
        const bool ring = it < nr;
        const int k0 = (ring ? it : it - nr) * kCols;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = k0 + nb * 8 + 2 * t4 + (e & 1), jj = j[e >> 1];
                bool ok;
                if (ring) {
                    int disp = c - lmod;
                    if (disp < 0) disp += d.T;
                    ok = c < live && !(disp <= jj && len + disp >= d.T);
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
        for (int nb = 0; nb < 8; ++nb) {
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
        warp_mma<NBD, false>(o, nbd, myP, ldp, cV, ld, kCols);
        __syncthreads();  // every warp is done with buf before it is refilled
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        if (row[i] >= R) continue;
        // every real query sees its own tail row, so l > 0; the guard
        // mirrors the TPU kernel's finish
        const float li = l[i] == 0.0f ? 1.0f : l[i];
        T* dst = out + qbase + (size_t)(row[i] / rep) * qs + (size_t)(row[i] % rep) * D;
#pragma unroll
        for (int nb = 0; nb < NBD; ++nb) {
            if (nb < nbd) {
                const int col = nb * 8 + 2 * t4;
                store2(dst + col, o[nb][2 * i] / li, o[nb][2 * i + 1] / li);
            }
        }
    }
}

template <typename T, int NBD>
cudaError_t run(const void* q, const void* ck, const void* cv, const void* tk, const void* tv,
                const void* lens, void* out, int S, Dims d, cudaStream_t st) {
    const size_t smem = spec_smem<T>(d.D);
    cudaError_t err = allow_smem<spec_tail_kernel<T, NBD>>(smem);
    if (err != cudaSuccess) return err;
    const int rows = d.Kq * (d.H / d.Kh);
    dim3 grid((rows + kRows - 1) / kRows, d.Kh, S);
    spec_tail_kernel<T, NBD><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv),
        static_cast<const T*>(tk), static_cast<const T*>(tv), static_cast<const int*>(lens),
        static_cast<T*>(out), d);
    return cudaGetLastError();
}

template <typename T>
int entry(const void* q, const void* ck, const void* cv, const void* tk, const void* tv, const void* lens,
          void* out, int S, int T_, int Kq, int Kt, int H, int Kh, int D, int q_start, float scale,
          void* stream) {
    if (S < 1 || S > 65535 || T_ < 1 || Kq < 1 || Kt < 1 || Kh < 1 || Kh > 65535 || H % Kh != 0 ||
        D < 8 || D > 128 || D % 8 != 0 || q_start < 0) {
        return (int)cudaErrorInvalidValue;
    }
    const Dims d{T_, Kq, Kt, H, Kh, D, q_start, scale};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (int)(D <= 64 ? run<T, 8>(q, ck, cv, tk, tv, lens, out, S, d, st)
                         : run<T, 16>(q, ck, cv, tk, tv, lens, out, S, d, st));
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int spec_tail_attention_f32(const void* q, const void* ck, const void* cv, const void* tk, const void* tv,
                            const void* lens, void* out, int S, int T, int Kq, int Kt, int H, int Kh, int D,
                            int q_start, float scale, void* stream) {
    return entry<float>(q, ck, cv, tk, tv, lens, out, S, T, Kq, Kt, H, Kh, D, q_start, scale, stream);
}

int spec_tail_attention_bf16(const void* q, const void* ck, const void* cv, const void* tk, const void* tv,
                             const void* lens, void* out, int S, int T, int Kq, int Kt, int H, int Kh, int D,
                             int q_start, float scale, void* stream) {
    return entry<__nv_bfloat16>(q, ck, cv, tk, tv, lens, out, S, T, Kq, Kt, H, Kh, D, q_start, scale,
                                stream);
}

}  // extern "C"
