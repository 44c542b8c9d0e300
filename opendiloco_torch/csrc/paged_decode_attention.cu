// Paged decode attention for Hopper (sm_90a), the first design: one query
// token per slot over that slot's ring KV page. Since the split-ring
// redesign (spec_tail_attention.cu, its kPrefix instance) it runs only
// where that kernel does not go: head dims 136 .. 256
// (ops/decode_kernels.py _decode_route). At the 1b decode shape (D 64) it
// took 0.0392 ms against the split kernel's 0.0094 (PERF.md section 6).
//
// Replaces: opendiloco_tpu/ops/decode_kernels.py paged_decode_attention
// (_decode_attn_kernel :112, launched by pl.pallas_call at :241).
//
// Computes, for every slot s and query head h (kv head h / rep):
//   out[s, h] = softmax_t(q[s, h] . k[s, t, h / rep] * D^-0.5) . v[s, t, h / rep]
// over the live ring rows t, where row t is live iff t <= lens[s] or
// lens[s] >= T. Scores, running maxima, running sums and accumulators are
// f32; p is rounded to the cache dtype before p.v, as the TPU kernel does;
// the output is acc / (l == 0 ? 1 : l) in q's dtype.
//
// Layouts are the JAX package's, read directly with no transpose:
//   q [S, H, D], k/v [S, T, Kh, D], lens [S] int32, out [S, H, D].
//
// Design. One block per (slot, kv head). The block reads its slot's lens
// from device memory (the TPU kernel's scalar prefetch) and loads the rep
// query rows of its kv head once into shared memory. The live rows
// 0 .. min(lens, T-1) are exactly a prefix of the ring; the block's warps
// take 32-row tiles of it in turn, so no row past the live length is ever
// read, and dead rows cost neither bytes nor arithmetic. Each warp copies
// its next tile's K and V rows into its own shared memory with cp.async
// (16 bytes a copy) while it computes the current one, so no loop waits on
// device memory. Within a tile lane j owns ring row j: it scores its row
// against 8 query rows at a time, the warp reduces max and sum with
// shuffles, and then each lane accumulates p.v for its own pair of columns
// over the tile's rows. Each warp keeps its own online softmax (m, l, acc
// in shared memory); the block combines the warps' partial results once at
// the end, in a fixed order, so results repeat from run to run.
//
// Bound on this card: the bytes of live K/V + q + out over 3.35 TB/s; the
// 4 * rep * D f32 operations per live row are far below the card's rate,
// but they all run on the one SM of their (slot, kv head): the grid is
// S * Kh blocks (32 at the 1b serving shape) on 132 SMs, and each lane
// scores its row with scalar FMAs. The redesign cuts the ring into splits
// across blocks from the static shape, packs the rep query rows of a kv
// head onto the tensor cores (mma.sync) and merges the splits' partials in
// a second kernel (spec_tail_attention.cu): 8 splits, 256 blocks at the
// 1b serving shape.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kMaxWarps = 8;
constexpr int kTile = 32;   // ring rows per warp step: one per lane
constexpr int kGroup = 8;   // query rows scored together, in registers
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemMax = 232448;  // opt-in shared memory of one block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

// one 16-byte load of T, widened to f32
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
    constexpr int n = 16 / sizeof(T);
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < n; ++i) dst[i] = to_f32(e[i]);
}

// two neighbouring elements, widened to f32
__device__ __forceinline__ void load2(const float* src, float& a, float& b) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    a = t.x;
    b = t.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* src, float& a, float& b) {
    const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(src);
    a = __low2float(t);
    b = __high2float(t);
}
__device__ __forceinline__ void load2(const __half* src, float& a, float& b) {
    const __half2 t = *reinterpret_cast<const __half2*>(src);
    a = __low2float(t);
    b = __high2float(t);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
    return x;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// One warp's shared memory: two tile buffers, each K [kTile][ldk] and
// V [kTile][D] in the cache dtype (K rows padded by 16 bytes so that the
// lanes reading different rows hit different banks), then its softmax
// state in f32: acc [rep][D], p [kTile][rep], corr, m and l [rep] each.
__host__ __device__ __forceinline__ int k_stride(int D, int elt) { return D + 16 / elt; }
__host__ __device__ __forceinline__ size_t tile_bytes(int D, int elt) {
    return (size_t)kTile * (k_stride(D, elt) + D) * elt;
}
__host__ __device__ __forceinline__ size_t warp_bytes(int rep, int D, int elt) {
    const size_t state = (size_t)rep * (D + kTile + 3);
    return 2 * tile_bytes(D, elt) + sizeof(float) * ((state + 3) / 4 * 4);
}

struct WarpState {
    float *acc, *p, *corr, *m, *l;
};

__device__ __forceinline__ WarpState warp_state(unsigned char* base, int rep, int D, int elt) {
    WarpState st;
    st.acc = reinterpret_cast<float*>(base + 2 * tile_bytes(D, elt));
    st.p = st.acc + rep * D;
    st.corr = st.p + kTile * rep;
    st.m = st.corr + rep;
    st.l = st.m + rep;
    return st;
}

// start copying ring rows t0 .. t0 + rows - 1 of K and V into one buffer
template <typename T>
__device__ __forceinline__ void stage_tile(unsigned char* buf, const T* kpage, const T* vpage,
                                           int t0, int rows, int D, size_t row_stride, int lane) {
    constexpr int kVec = 16 / sizeof(T);
    const int ldk = k_stride(D, sizeof(T));
    T* ks = reinterpret_cast<T*>(buf);
    T* vs = ks + kTile * ldk;
    const int chunks = D / kVec;  // 16-byte copies per row
    for (int c = lane; c < rows * chunks; c += 32) {
        const int r = c / chunks, col = (c % chunks) * kVec;
        const size_t g = (size_t)(t0 + r) * row_stride + col;
        cp_async16(ks + r * ldk + col, kpage + g);
        cp_async16(vs + r * D + col, vpage + g);
    }
    cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const int* __restrict__ lens,
                              T* __restrict__ out, int ring, int H, int Kh, int D,
                              float scale) {
    constexpr int kVec = 16 / sizeof(T);
    const int slot = blockIdx.x, kvh = blockIdx.y;
    const int rep = H / Kh;
    const int nwarps = blockDim.x / 32;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    extern __shared__ __align__(16) unsigned char smem[];
    float* q_s = reinterpret_cast<float*>(smem);  // [rep][D]
    unsigned char* warps_base = smem + sizeof(float) * rep * D;
    const size_t wb = warp_bytes(rep, D, sizeof(T));
    unsigned char* mine = warps_base + warp * wb;
    const WarpState own = warp_state(mine, rep, D, sizeof(T));
    float* acc_w = own.acc;
    float* p_w = own.p;
    float* corr_w = own.corr;
    float* m_w = own.m;
    float* l_w = own.l;
    const int ldk = k_stride(D, sizeof(T));

    const int len = lens[slot];
    // rows 0 .. min(len, T-1) are exactly the live rows of this slot
    const int live = min(len, ring - 1) + 1;

    const size_t head0 = ((size_t)slot * H + (size_t)kvh * rep) * D;
    for (int c = tid; c < rep * D / kVec; c += blockDim.x) load16(q + head0 + c * kVec, q_s + c * kVec);
    for (int i = lane; i < rep * D; i += 32) acc_w[i] = 0.f;
    for (int i = lane; i < rep; i += 32) {
        m_w[i] = -INFINITY;
        l_w[i] = 0.f;
    }

    const size_t row_stride = (size_t)Kh * D;  // elements between ring rows
    const size_t page = (size_t)slot * ring * row_stride + (size_t)kvh * D;
    const T* kpage = k + page;
    const T* vpage = v + page;
    const int step = nwarps * kTile;
    int t0 = warp * kTile;
    if (t0 < live) stage_tile(mine, kpage, vpage, t0, min(kTile, live - t0), D, row_stride, lane);
    __syncthreads();  // q_s complete

    for (int it = 0; t0 < live; t0 += step, ++it) {
        const int rows = min(kTile, live - t0);
        const int next = t0 + step;
        if (next < live) {
            stage_tile(mine + ((it + 1) & 1) * tile_bytes(D, sizeof(T)), kpage, vpage, next,
                       min(kTile, live - next), D, row_stride, lane);
            cp_async_wait<1>();  // this tile's copies are done, the next one's may fly
        } else {
            cp_async_wait<0>();
        }
        __syncwarp();  // every lane's copies of this tile are visible
        const T* ks = reinterpret_cast<const T*>(mine + (it & 1) * tile_bytes(D, sizeof(T)));
        const T* vs = ks + kTile * ldk;
        const bool valid = lane < rows;
        // a lane past the tile's rows scores a stale row and is masked out
        const T* krow = ks + lane * ldk;
        for (int r0 = 0; r0 < rep; r0 += kGroup) {
            const int g = min(kGroup, rep - r0);  // the same on every lane
            float s[kGroup];
#pragma unroll
            for (int i = 0; i < kGroup; ++i) s[i] = 0.f;
            for (int d0 = 0; d0 < D; d0 += kVec) {
                float kv[kVec];
                load16(krow + d0, kv);
#pragma unroll
                for (int i = 0; i < kGroup; ++i) {
                    if (i < g) {
                        const float4* qr = reinterpret_cast<const float4*>(q_s + (r0 + i) * D + d0);
#pragma unroll
                        for (int e = 0; e < kVec / 4; ++e) {
                            const float4 qv = qr[e];
                            s[i] = fmaf(qv.x, kv[4 * e], s[i]);
                            s[i] = fmaf(qv.y, kv[4 * e + 1], s[i]);
                            s[i] = fmaf(qv.z, kv[4 * e + 2], s[i]);
                            s[i] = fmaf(qv.w, kv[4 * e + 3], s[i]);
                        }
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < kGroup; ++i) {
                if (i < g) {
                    const int r = r0 + i;
                    const float sc = valid ? s[i] * scale : -INFINITY;
                    const float m_old = m_w[r];
                    // lane 0 always holds a live row, so m_new is finite
                    const float m_new = fmaxf(m_old, warp_max(sc));
                    const float p = valid ? expf(sc - m_new) : 0.f;
                    const float psum = warp_sum(p);
                    // p rounded to the cache dtype before p.v, as the TPU kernel does
                    p_w[lane * rep + r] = to_f32(from_f32<T>(p));
                    __syncwarp();  // every lane has read m_w[r]
                    if (lane == 0) {
                        const float corr = expf(m_old - m_new);  // 0 on the first tile
                        corr_w[r] = corr;
                        m_w[r] = m_new;
                        l_w[r] = l_w[r] * corr + psum;
                    }
                }
            }
        }
        __syncwarp();  // p_w and corr_w complete
        for (int c = 2 * lane; c < D; c += 64) {
            for (int r0 = 0; r0 < rep; r0 += kGroup) {
                const int g = min(kGroup, rep - r0);
                float a0[kGroup], a1[kGroup];
#pragma unroll
                for (int i = 0; i < kGroup; ++i) {
                    if (i < g) {
                        const float corr = corr_w[r0 + i];
                        a0[i] = acc_w[(r0 + i) * D + c] * corr;
                        a1[i] = acc_w[(r0 + i) * D + c + 1] * corr;
                    }
                }
                for (int j = 0; j < rows; ++j) {
                    float v0, v1;
                    load2(vs + j * D + c, v0, v1);
                    const float* pj = p_w + j * rep + r0;
#pragma unroll
                    for (int i = 0; i < kGroup; ++i) {
                        if (i < g) {
                            a0[i] = fmaf(pj[i], v0, a0[i]);
                            a1[i] = fmaf(pj[i], v1, a1[i]);
                        }
                    }
                }
#pragma unroll
                for (int i = 0; i < kGroup; ++i) {
                    if (i < g) {
                        acc_w[(r0 + i) * D + c] = a0[i];
                        acc_w[(r0 + i) * D + c + 1] = a1[i];
                    }
                }
            }
        }
        __syncwarp();  // this buffer, p_w and corr_w are rewritten two tiles on
    }
    __syncthreads();

    // combine the warps' partial softmaxes; a warp that saw no row has
    // m = -inf, l = 0, acc = 0 and weighs exp(-inf) = 0
    for (int i = tid; i < rep * D; i += blockDim.x) {
        const int r = i / D;
        float m = -INFINITY;
        for (int w = 0; w < nwarps; ++w) m = fmaxf(m, warp_state(warps_base + w * wb, rep, D, sizeof(T)).m[r]);
        float l = 0.f, a = 0.f;
        for (int w = 0; w < nwarps; ++w) {
            const WarpState st = warp_state(warps_base + w * wb, rep, D, sizeof(T));
            const float f = expf(st.m[r] - m);
            l = fmaf(st.l[r], f, l);
            a = fmaf(st.acc[i], f, a);
        }
        out[head0 + i] = from_f32<T>(a / (l == 0.f ? 1.f : l));
    }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lens, void* out, int S,
           int ring, int H, int Kh, int D, float scale, void* stream) {
    if (S < 1 || ring < 1 || Kh < 1 || H % Kh || D % 8 || D > 256) return (int)cudaErrorInvalidValue;
    const int rep = H / Kh;
    // as many warps as the ring has tiles, up to kMaxWarps, and as shared
    // memory allows
    const int tiles = (ring + kTile - 1) / kTile;
    int warps = tiles < kMaxWarps ? tiles : kMaxWarps;
    const size_t base = sizeof(float) * (size_t)rep * D;
    const size_t per_warp = warp_bytes(rep, D, sizeof(T));
    while (warps > 1 && base + warps * per_warp > kSmemMax) --warps;
    const size_t smem = base + warps * per_warp;
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    auto kern = paged_decode_attention_kernel<T>;
    if (smem > 48 * 1024) {
        // opt in to the whole of kSmemMax once per device and instance: a
        // driver call on every launch would lengthen the host-bound step
        static std::atomic<bool> opted_in[kMaxDevices];
        int dev = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e != cudaSuccess) return (int)e;
        if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
        if (!opted_in[dev].load(std::memory_order_acquire)) {
            e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
            if (e != cudaSuccess) return (int)e;
            opted_in[dev].store(true, std::memory_order_release);
        }
    }
    kern<<<dim3(S, Kh), warps * 32, smem, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)lens, (T*)out, ring, H, Kh, D,
        scale);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int paged_decode_attention_f32(const void* q, const void* k, const void* v, const void* lens,
                               void* out, int S, int ring, int H, int Kh, int D, float scale,
                               void* stream) {
    return launch<float>(q, k, v, lens, out, S, ring, H, Kh, D, scale, stream);
}

int paged_decode_attention_bf16(const void* q, const void* k, const void* v, const void* lens,
                                void* out, int S, int ring, int H, int Kh, int D, float scale,
                                void* stream) {
    return launch<__nv_bfloat16>(q, k, v, lens, out, S, ring, H, Kh, D, scale, stream);
}

int paged_decode_attention_f16(const void* q, const void* k, const void* v, const void* lens,
                               void* out, int S, int ring, int H, int Kh, int D, float scale,
                               void* stream) {
    return launch<__half>(q, k, v, lens, out, S, ring, H, Kh, D, scale, stream);
}

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
