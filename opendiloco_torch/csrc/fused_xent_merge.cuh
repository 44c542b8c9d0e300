// The vocab-split merge of the fused cross-entropy forward (B3), shared by
// both of its designs (fused_xent.cu, fused_xent_sm90.cu): when the vocab
// is split across blocks, each split leaves its running (m, l, target) per
// row in part [3][splits][N], and this kernel merges the splits of each
// row in split order, so results repeat bit for bit.
#pragma once

#include <math.h>

#include "common.cuh"

namespace {

constexpr long long kIgnore = -100;

__global__ void xent_merge_kernel(const float* __restrict__ part, const long long* __restrict__ labels,
                                  float* __restrict__ nll, float* __restrict__ lse, int N, int splits) {
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= N) return;
    float M = kNegInf;
    for (int s = 0; s < splits; ++s) M = fmaxf(M, part[(size_t)s * N + row]);
    float L = 0.0f, TG = 0.0f;
    for (int s = 0; s < splits; ++s) {
        L += part[((size_t)splits + s) * N + row] * expf(part[(size_t)s * N + row] - M);
        TG += part[((size_t)2 * splits + s) * N + row];
    }
    const float ls = M + logf(L);
    lse[row] = ls;
    nll[row] = (ls - TG) * (labels[row] != kIgnore ? 1.0f : 0.0f);
}

inline cudaError_t launch_xent_merge(const void* part, const void* labels, void* nll, void* lse, int N, int splits,
                                     cudaStream_t st) {
    xent_merge_kernel<<<(N + 255) / 256, 256, 0, st>>>(static_cast<const float*>(part),
                                                      static_cast<const long long*>(labels),
                                                      static_cast<float*>(nll), static_cast<float*>(lse), N, splits);
    return cudaGetLastError();
}

}  // namespace
