// Single-query target attention, forward, f32, for sm_90a.
//
// Replaces the Pallas TPU kernel fuxictr_tpu/ops/pallas_kernels.py:
// flash_target_attention (body _flash_kernel). For each row n of N:
//
//     out[n] = sum_l softmax_l(s[n, l]) * v[n, l],
//     s[n, l] = mask[n, l] > 0 ? (q[n] . k[n, l]) / scale : -1e9
//
// which is what _xla_target_attention computes and what SIM's two
// MultiHeadTargetAttention calls compute per forward (N = B*H rows, L = 99
// and 100, D = 64 at the repo's full SIM width).
//
// Bound: memory. Each row reads L*D floats of k and of v and does 4*L*D
// flops on them, one flop per byte, far below the H100's
// flops-per-byte ridge. The design therefore reads k and v exactly once,
// in order, and keeps the [N, L] scores out of device memory: one thread
// block per row streams L in tiles of TILE_L positions; warps compute the
// tile's scores with coalesced loads of k rows and shuffle reductions into
// shared memory; an f32 online softmax (running max, denominator) rescales
// a per-thread slice of the numerator acc[D] while threads read v rows
// coalesced along D.
//
// L is never padded. The running max starts at -inf, so a row whose mask
// is all zero gets weights exp(-1e9 - (-1e9)) = 1 at every real position
// and returns the mean of v over L, as the XLA path and the model do (the
// Pallas kernel, padding L to its tile, divides by the padded length).
//
// wgmma, TMA and bf16 inputs are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileL = 64;
constexpr int kMaxD = kThreads;
constexpr float kMasked = -1.0e9f;

__global__ void __launch_bounds__(kThreads)
target_attention_fwd_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ mask,
                            float* __restrict__ out,
                            int L, int D, float scale) {
    __shared__ float q_s[kMaxD];
    __shared__ float s_s[kTileL];
    __shared__ float p_s[kTileL];
    __shared__ float red_s[kThreads];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const size_t row = blockIdx.x;
    const float* k_row = k + row * L * D;
    const float* v_row = v + row * L * D;
    const float* m_row = mask + row * L;

    // numerator slice of this thread: column d over positions j = g mod G
    const int G = kThreads / D;
    const int g = tid / D;
    const int d = tid - g * D;
    const bool acc_active = g < G;

    if (tid < D) q_s[tid] = q[row * D + tid];
    __syncthreads();

    float m_run = -INFINITY;
    float l_run = 0.0f;
    float acc = 0.0f;

    for (int t0 = 0; t0 < L; t0 += kTileL) {
        const int tl = min(kTileL, L - t0);
        // scores of this tile: one warp per position
        for (int j = warp; j < tl; j += kWarps) {
            const float* k_l = k_row + (size_t)(t0 + j) * D;
            float part = 0.0f;
            for (int e = lane; e < D; e += 32) part += q_s[e] * k_l[e];
            for (int off = 16; off > 0; off >>= 1)
                part += __shfl_xor_sync(0xffffffffu, part, off);
            if (lane == 0)
                s_s[j] = m_row[t0 + j] > 0.0f ? part / scale : kMasked;
        }
        __syncthreads();
        float m_tile = -INFINITY;
        for (int j = 0; j < tl; ++j) m_tile = fmaxf(m_tile, s_s[j]);
        const float m_new = fmaxf(m_run, m_tile);
        const float corr = __expf(m_run - m_new);
        if (tid < tl) p_s[tid] = expf(s_s[tid] - m_new);
        __syncthreads();
        float p_sum = 0.0f;
        for (int j = 0; j < tl; ++j) p_sum += p_s[j];
        l_run = l_run * corr + p_sum;
        if (acc_active) {
            float a = acc * corr;
            for (int j = g; j < tl; j += G)
                a += p_s[j] * v_row[(size_t)(t0 + j) * D + d];
            acc = a;
        }
        m_run = m_new;
    }

    // sum the G partial numerators of each column
    red_s[tid] = acc_active ? acc : 0.0f;
    __syncthreads();
    if (tid < D) {
        float total = 0.0f;
        for (int i = 0; i < G; ++i) total += red_s[i * D + tid];
        out[row * D + tid] = total / l_run;
    }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t). Pointers are device pointers to
// contiguous f32 arrays: q [N, D], k and v [N, L, D], mask [N, L],
// out [N, D]. Requires N >= 1, L >= 1 and 1 <= D <= kMaxD; the Python
// wrapper (target_attention_cuda) checks them. Returns the
// cudaGetLastError() code of the launch (0 on success).
int target_attention_fwd_f32(const float* q, const float* k, const float* v,
                             const float* mask, float* out, int N, int L,
                             int D, float scale, void* stream) {
    target_attention_fwd_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
        q, k, v, mask, out, L, D, scale);
    return (int)cudaGetLastError();
}

const char* target_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
