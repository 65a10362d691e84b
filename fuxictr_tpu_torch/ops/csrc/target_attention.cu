// Single-query target attention, forward, f32 and bf16, for sm_90a.
//
// Replaces the Pallas TPU kernel fuxictr_tpu/ops/pallas_kernels.py:
// flash_target_attention (body _flash_kernel). For each row n of N:
//
//     out[n] = sum_l softmax_l(s[n, l]) * v[n, l],
//     s[n, l] = mask[n, l] > 0 ? (q[n] . k[n, l]) / scale : -1e9
//
// which is what _xla_target_attention computes and what SIM's two
// MultiHeadTargetAttention calls compute per forward (N = B*H rows, L = 99
// and 100, D = 64 at the repo's full SIM width). q, k, v and out are f32
// or bf16 (one type for all four); the mask is f32; every sum, the scores
// and the softmax are f32 whatever the input type, as in the Pallas body.
//
// Bound: bytes. A row's k and v are its own (L*D each, 12.8 KB in bf16 and
// 25.6 KB in f32 at SIM's shapes), read once and used for 4*L*D flops: one
// flop per byte in f32, two in bf16, far below the card's ridge. No tensor
// cores: each row is a product with M = 1 against a B that no other row
// shares, and wgmma needs 64 rows sharing one B tile.
//
// Design, for keeping enough bytes in flight (about 25 KB per SM at
// 3.35 TB/s and a microsecond of latency):
// - persistent blocks, as many as fit on the card (occupancy x SMs), each
//   walking rows blockIdx.x, +gridDim.x, ... in tiles of up to T positions
//   (a whole SIM row is one tile: 51.2 KB of k and v in f32);
// - a ring of kStages shared-memory stages. One thread fetches a tile's q, k
//   and v with 1-D TMA bulk copies (cp.async.bulk) completed on the stage's
//   two mbarriers (q and k on one, v on the other, so that the scores start
//   while v lands); each thread fetches its own positions of the mask with
//   4-byte cp.async. The next kStages-1 tiles are in flight while one is
//   reduced;
// - no serial loop over a tile: `split` threads per position take q.k with
//   16-byte shared-memory reads (chunks rotated by position so that a warp
//   hits distinct banks) and a shuffle; every warp takes the tile's max and
//   sum with shuffles; thread groups read v rows along D in 16-byte chunks,
//   and the groups are summed once per row with shuffles and one shared
//   pass;
// - the online rescale (running max, denominator) only matters across the
//   tiles of a long row (L = 2048); a row of one tile is one pass.
// Bulk copies need 16-byte aligned addresses and sizes. Where D*itemsize is
// not a multiple of 16 (D % 4 != 0 in f32, D % 8 != 0 in bf16) or a base
// pointer is not 16-byte aligned, the kernel's kBulk=false form loads the
// tile with plain loads instead, padding each row of the stage to Dp
// columns with zeros so that the same 16-byte reads apply.
//
// L is never padded. The running max starts at -inf, so a row whose mask
// is all zero gets weights exp(-1e9 - (-1e9)) = 1 at every real position
// and returns the mean of v over L, as the XLA path and the model do (the
// Pallas kernel, padding L to its tile, divides by the padded length).
//
// Training. The forward's training entry points (`..._fwd_stats_...`) also
// write each row's running max m and denominator l, two f32 values: a
// single log-sum-exp would not do, since in f32 -1e9 + log L rounds back
// to -1e9 and a fully masked row would get p = 1 instead of 1/L. The
// backward (`..._bwd_...`), which the Pallas kernel lacks (JAX trains
// _xla_target_attention through XLA's autodiff), takes q, k, v, mask, out,
// dout and those statistics and writes, per row and position l,
//
//     p_l  = exp(s_l - m) / l,                  dv_l = p_l * dout,
//     ds_l = mask > 0 ? p_l * (dout.v_l - dout.out) : 0,
//     dk_l = ds_l / scale * q,                  dq = sum_l ds_l / scale * k_l,
//
// the gradient JAX's autodiff gives (the `where` on the mask gates it; a
// fully masked row gets dv = dout / L and dq = dk = 0). Sums in f32, each
// output rounded once. Bound: bytes again (k, v read, dk, dv written: four
// L*D rows per row against ~9*L*D flops). The statistics make it one pass
// over the row whatever L. Design, for bytes in flight at few registers:
// - 16-byte loads of k and v and 16-byte stores of dk and dv, a group of
//   lanes per position sized to the row's chunks (templated on the group
//   size, so no register holds a column that is not there), several
//   positions per warp, and their q.k and dout.v summed together over the
//   group with xor shuffles;
// - registers as the ring: each warp loads the next step's positions
//   before it sums the current ones;
// - one 128-thread block per row, eight blocks per SM: SIM's 1024 rows
//   are one wave on 132 SMs;
// - no atomics: dq is summed over a lane's positions, then the warp's
//   groups, then the block's warps, each in a fixed order, so two launches
//   give the same bits;
// - a plain-access form (element loads and stores into the same chunks)
//   for rows or bases that are not 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

namespace {

// Two stages of up to 56 KB of k and v: a whole SIM row per stage, two
// blocks per SM in f32 and four in bf16. (A sweep of 2 x 56 KB to 8 x 13 KB
// on the H100 found no faster ring at SIM's shapes; smaller tiles pay the
// per-tile barriers and rescale more often.)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
constexpr int kStageBytes = 56 * 1024;   // k and v of one tile
constexpr int kMaxPasses = 4;            // score passes over a tile
constexpr int kMaxTile = kThreads * kMaxPasses;
constexpr float kMasked = -1.0e9f;

// Offsets into the dynamic shared memory, the same on host and device:
// mbarriers, then the stages (q, k tile, v tile; each row Dp wide), the
// stages' mask tiles, the tile's scores and the per-row reduction rows.
// `split` threads share each position's q.k: the largest power of two
// that divides the row's 16-byte chunks and leaves a thread per share.
struct Layout {
    int tile, dp, chunks, split, red_rows;
    int stage_bytes, stages_off, mask_off, scores_off, red_off, bytes;

    __host__ __device__ Layout(int tile_, int dp_, int itemsize) {
        tile = tile_;
        dp = dp_;
        chunks = dp * itemsize / 16;
        split = 1;
        while (split < 32 && chunks % (2 * split) == 0
               && 2 * split * tile <= kThreads)
            split *= 2;
        red_rows = (32 % chunks == 0) ? kWarps : kThreads / chunks;
        stage_bytes = (dp + 2 * tile * dp) * itemsize;
        stages_off = 128;                  // 2 * kStages mbarriers first
        mask_off = stages_off + kStages * stage_bytes;
        scores_off = mask_off + kStages * tile * 4;
        red_off = scores_off + tile * 4;
        bytes = red_off + red_rows * dp * 4;
    }
};

// 16 bytes of T: `n` values, unpacked to f32 and packed back (rounded
// once, to nearest even, in bf16); `load_part` and `store_part` move the
// first `count` of them with plain element accesses (the rest read as 0).
template <typename T> struct Vec;

template <> struct Vec<float> {
    static constexpr int n = 4;
    __device__ static void unpack(const uint4& u, float (&x)[4]) {
        x[0] = __uint_as_float(u.x); x[1] = __uint_as_float(u.y);
        x[2] = __uint_as_float(u.z); x[3] = __uint_as_float(u.w);
    }
    __device__ static uint4 pack(const float (&x)[4]) {
        return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                          __float_as_uint(x[2]), __float_as_uint(x[3]));
    }
    __device__ static uint4 load_part(const float* p, int count) {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
            w[e] = e < count ? __float_as_uint(p[e]) : 0u;
        return make_uint4(w[0], w[1], w[2], w[3]);
    }
    __device__ static void store_part(float* p, int count, const uint4& u) {
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (e < count) p[e] = __uint_as_float(w[e]);
    }
    __device__ static void load(const float* p, float (&x)[4]) {
        unpack(*reinterpret_cast<const uint4*>(p), x);
    }
    __device__ static float from(float x) { return x; }
    __device__ static float to(float x) { return x; }
};

template <> struct Vec<__nv_bfloat16> {
    static constexpr int n = 8;
    // value 2i is the low half of word i
    __device__ static void unpack(const uint4& u, float (&x)[8]) {
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            x[2 * i] = __uint_as_float(w[i] << 16);
            x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
    __device__ static uint32_t bits(float x) {
        return __bfloat16_as_ushort(__float2bfloat16(x));
    }
    __device__ static uint4 pack(const float (&x)[8]) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            w[i] = bits(x[2 * i]) | (bits(x[2 * i + 1]) << 16);
        return make_uint4(w[0], w[1], w[2], w[3]);
    }
    __device__ static uint4 load_part(const __nv_bfloat16* p, int count) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint32_t lo = 2 * i < count ? __bfloat16_as_ushort(p[2 * i])
                                              : 0u;
            const uint32_t hi = 2 * i + 1 < count
                ? __bfloat16_as_ushort(p[2 * i + 1]) : 0u;
            w[i] = lo | (hi << 16);
        }
        return make_uint4(w[0], w[1], w[2], w[3]);
    }
    __device__ static void store_part(__nv_bfloat16* p, int count,
                                      const uint4& u) {
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (2 * i < count)
                p[2 * i] = __ushort_as_bfloat16((unsigned short)w[i]);
            if (2 * i + 1 < count)
                p[2 * i + 1] = __ushort_as_bfloat16(
                    (unsigned short)(w[i] >> 16));
        }
    }
    __device__ static void load(const __nv_bfloat16* p, float (&x)[8]) {
        unpack(*reinterpret_cast<const uint4*>(p), x);
    }
    __device__ static float from(__nv_bfloat16 x) {
        return __bfloat162float(x);
    }
    __device__ static __nv_bfloat16 to(float x) {
        return __float2bfloat16(x);
    }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(n) : "memory");
}

// A copy that never lands (a fault in the launcher's sizes) traps after
// about 2^24 polls instead of hanging the card: the launch then fails.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    for (uint32_t polls = 0; !done; ++polls) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
        if (polls == (1u << 24)) __trap();
    }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t n, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(n), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy4_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kStages - 1 of this thread's groups are pending: the
// group of the tile about to be reduced has landed.
__device__ __forceinline__ void copy4_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
}

// kStats: also write each row's (m, l) to stats[2 * row], stats[2 * row + 1]
template <typename T, bool kBulk, bool kStats>
__global__ void __launch_bounds__(kThreads, 4)
target_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ mask,
                            T* __restrict__ out, float* __restrict__ stats,
                            int N, int L, int D, int tile, int dp,
                            float scale) {
    constexpr int kVec = Vec<T>::n;
    extern __shared__ __align__(128) unsigned char smem[];
    const Layout lay(tile, dp, sizeof(T));
    // per stage: one barrier for q and k, one for v
    uint64_t* k_bars = reinterpret_cast<uint64_t*>(smem);
    uint64_t* v_bars = k_bars + kStages;
    float* scores = reinterpret_cast<float*>(smem + lay.scores_off);
    float* red = reinterpret_cast<float*>(smem + lay.red_off);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int C = lay.chunks;                 // 16-byte chunks of a row
    const int S = lay.split;                  // threads per q.k
    const int part = tid % S;
    const int j_of_tid = tid / S;             // position of this q.k share
    const int per_pass = kThreads / S;
    const int G = kThreads / C;               // position groups of the v pass
    const int g = tid / C;
    const int c = tid - g * C;
    const int tiles_per_row = (L + tile - 1) / tile;
    const int rows = blockIdx.x < N
        ? (N - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    const int items = rows * tiles_per_row;

    auto stage_of = [&](int s) {
        return reinterpret_cast<T*>(smem + lay.stages_off
                                    + s * lay.stage_bytes);
    };
    auto mask_of = [&](int s) {
        return reinterpret_cast<float*>(smem + lay.mask_off) + s * tile;
    };
    // start the copies of work item `it` (row, tile) into stage it % kStages;
    // each mask entry is fetched by the thread that will read it
    auto issue = [&](int it) {
        if (it < items) {
            const int s = it % kStages;
            const size_t row = blockIdx.x
                + (size_t)(it / tiles_per_row) * gridDim.x;
            const int t0 = (it % tiles_per_row) * tile;
            const int tl = min(tile, L - t0);
            if (kBulk && tid == 0) {
                T* st = stage_of(s);
                const uint32_t qb = D * sizeof(T);
                const uint32_t kvb = (uint32_t)tl * D * sizeof(T);
                // the stage was last read before a __syncthreads; order those
                // generic-proxy reads before the async-proxy writes
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                mbar_expect_tx(&k_bars[s], qb + kvb);
                bulk_copy(st, q + row * D, qb, &k_bars[s]);
                bulk_copy(st + dp, k + (row * L + t0) * D, kvb, &k_bars[s]);
                mbar_expect_tx(&v_bars[s], kvb);
                bulk_copy(st + dp + (size_t)tile * dp,
                          v + (row * L + t0) * D, kvb, &v_bars[s]);
            }
            if (part == 0) {
                const float* m_src = mask + row * L + t0;
                float* m_dst = mask_of(s);
                for (int j = j_of_tid; j < tl; j += per_pass)
                    copy4_async(m_dst + j, m_src + j);
            }
        }
        copy4_commit();          // one group per item, empty or not
    };

    if (kBulk && tid == 0) {
        for (int s = 0; s < 2 * kStages; ++s) mbar_init(&k_bars[s]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    for (int s = 0; s < kStages; ++s) issue(s);

    float m_run = -INFINITY, l_run = 0.0f;
    float acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;

    for (int it = 0; it < items; ++it) {
        const int s = it % kStages;
        const uint32_t parity = (it / kStages) & 1;
        const size_t row = blockIdx.x
            + (size_t)(it / tiles_per_row) * gridDim.x;
        const int tidx = it % tiles_per_row;
        const int t0 = tidx * tile;
        const int tl = min(tile, L - t0);
        T* st = stage_of(s);
        const T* q_s = st;
        const T* k_s = st + dp;
        const T* v_s = st + dp + (size_t)tile * dp;
        const float* m_s = mask_of(s);

        if (kBulk) {
            mbar_wait(&k_bars[s], parity);
        } else {
            // plain loads, each stage row padded to dp columns with zeros
            for (int i = tid; i < dp; i += kThreads)
                st[i] = Vec<T>::to(i < D ? Vec<T>::from(q[row * D + i])
                                         : 0.0f);
            for (int i = tid; i < tl * dp; i += kThreads) {
                const int j = i / dp, d = i - j * dp;
                const size_t src = (row * L + t0 + j) * D + d;
                st[dp + i] = d < D ? k[src] : Vec<T>::to(0.0f);
                st[dp + (size_t)tile * dp + i] = d < D ? v[src]
                                                       : Vec<T>::to(0.0f);
            }
            __syncthreads();
        }
        copy4_wait();            // this thread's own mask entries

        // scores: S threads per position, each a share of its chunks (the
        // chunk order rotated by position, so that a warp's 16-byte reads
        // fall in distinct banks), summed with shuffles
        for (int j0 = 0; j0 < tl; j0 += per_pass) {
            const int j = j0 + j_of_tid;
            float dot = 0.0f;
            if (j < tl) {
                const T* k_j = k_s + (size_t)j * dp;
                int ch = (part + S * j) % C;
                for (int cc = part; cc < C; cc += S) {
                    float qv[kVec], kv[kVec];
                    Vec<T>::load(q_s + ch * kVec, qv);
                    Vec<T>::load(k_j + ch * kVec, kv);
#pragma unroll
                    for (int e = 0; e < kVec; ++e)
                        dot = fmaf(qv[e], kv[e], dot);
                    ch += S;
                    if (ch >= C) ch -= C;
                }
            }
            for (int off = 1; off < S; off <<= 1)
                dot += __shfl_xor_sync(0xffffffffu, dot, off);
            if (j < tl && part == 0)
                scores[j] = m_s[j] > 0.0f ? dot / scale : kMasked;
        }
        __syncthreads();

        // the tile's max and sum, taken by every warp alike
        float mt = -INFINITY;
        for (int j = lane; j < tl; j += 32) mt = fmaxf(mt, scores[j]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        const float m_new = fmaxf(m_run, mt);
        float t_sum = 0.0f;
        for (int j = lane; j < tl; j += 32) t_sum += __expf(scores[j] - m_new);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            t_sum += __shfl_xor_sync(0xffffffffu, t_sum, off);
        const float corr = __expf(m_run - m_new);
        l_run = l_run * corr + t_sum;
        m_run = m_new;

        // numerator: group g takes positions g, g + G, ... of chunk c
        if (kBulk) mbar_wait(&v_bars[s], parity);
        if (g < G) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[e] *= corr;
            for (int j = g; j < tl; j += G) {
                const float p = __expf(scores[j] - m_new);
                float vv[kVec];
                Vec<T>::load(v_s + (size_t)j * dp + c * kVec, vv);
#pragma unroll
                for (int e = 0; e < kVec; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
            }
        }
        __syncthreads();         // the stage and the scores are free
        issue(it + kStages);

        if (tidx == tiles_per_row - 1) {
            // sum the groups' numerators: shuffles inside a warp where the
            // groups tile it, then one pass over the rows of `red`
            int slot = g;
            bool writer = g < G;
            if (32 % C == 0) {
                for (int off = C; off < 32; off <<= 1) {
#pragma unroll
                    for (int e = 0; e < kVec; ++e)
                        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
                }
                slot = warp;
                writer = lane < C;
            }
            if (writer) {
#pragma unroll
                for (int e = 0; e < kVec; ++e)
                    red[slot * dp + c * kVec + e] = acc[e];
            }
            __syncthreads();
            if (tid < D) {
                float total = 0.0f;
                for (int r = 0; r < lay.red_rows; ++r)
                    total += red[r * dp + tid];
                out[row * D + tid] = Vec<T>::to(total / l_run);
            }
            if (kStats && tid == 0) {
                stats[2 * row] = m_run;
                stats[2 * row + 1] = l_run;
            }
            m_run = -INFINITY;
            l_run = 0.0f;
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
        }
    }
}

// How a launch over rows of [L, D] is cut on one device: positions per
// tile, padded row width, dynamic shared memory, and the blocks the card
// holds at once (the persistent grid, capped by N at launch).
struct Plan {
    int tile, dp, bytes, resident;
};

// The plan of an instantiation, computed once per (device, L, D) under a
// lock. The kernel's dynamic shared memory limit is a per-device attribute:
// it is raised on each device to the largest plan made there.
template <typename T, bool kBulk, bool kStats>
cudaError_t get_plan(int L, int D, Plan* p) {
    static std::mutex mu;
    static std::map<std::tuple<int, int, int>, Plan> plans;
    static std::map<int, int> smem_limit;
    int device;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple(device, L, D);
    const auto hit = plans.find(key);
    if (hit != plans.end()) {
        *p = hit->second;
        return cudaSuccess;
    }
    constexpr int kVec = Vec<T>::n;
    Plan n;
    n.dp = (D + kVec - 1) / kVec * kVec;
    const int fit = kStageBytes / (2 * n.dp * (int)sizeof(T));
    n.tile = std::max(1, std::min({fit, kMaxTile, L}));
    n.bytes = Layout(n.tile, n.dp, sizeof(T)).bytes;
    auto kernel = target_attention_fwd_kernel<T, kBulk, kStats>;
    int& limit = smem_limit[device];
    if (n.bytes > std::max(limit, 48 * 1024)) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, n.bytes);
        if (err != cudaSuccess) return err;
        limit = n.bytes;
    }
    int sms, per_sm;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess)
        return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, n.bytes)) != cudaSuccess)
        return err;
    n.resident = std::max(1, per_sm) * sms;
    plans[key] = n;
    *p = n;
    return cudaSuccess;
}

template <typename T, bool kBulk, bool kStats>
int launch_kernel(const T* q, const T* k, const T* v, const float* mask,
                  T* out, float* stats, int N, int L, int D, float scale,
                  cudaStream_t stream) {
    Plan p;
    const cudaError_t err = get_plan<T, kBulk, kStats>(L, D, &p);
    if (err != cudaSuccess) return (int)err;
    target_attention_fwd_kernel<T, kBulk, kStats>
        <<<std::min(N, p.resident), kThreads, p.bytes, stream>>>(
            q, k, v, mask, out, stats, N, L, D, p.tile, p.dp, scale);
    return (int)cudaGetLastError();
}

// Rows of D values and every base pointer 16-byte aligned: what bulk
// copies and 16-byte accesses need.
template <typename T, typename... Ptrs>
bool aligned16(int D, const Ptrs*... ptrs) {
    return (D * sizeof(T)) % 16 == 0
        && ((reinterpret_cast<uintptr_t>(ptrs) % 16 == 0) && ...);
}

template <typename T, bool kStats>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* out, float* stats, int N, int L, int D, float scale,
           void* stream) {
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    T* ot = static_cast<T*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return aligned16<T>(D, q, k, v)
        ? launch_kernel<T, true, kStats>(qt, kt, vt, mask, ot, stats, N, L,
                                         D, scale, s)
        : launch_kernel<T, false, kStats>(qt, kt, vt, mask, ot, stats, N, L,
                                          D, scale, s);
}

// ---------------------------------------------------------------- backward
//
// Lanes along D in 16-byte chunks: a row of D columns is C = ceil(D / n)
// chunks of n values (8 in bf16 and 16 in f32 at D = 64). A group of G
// lanes takes one position, G the chunk count rounded up to a power of two
// (at most 32; beyond D = 128 an f32 lane takes two chunks), so a warp
// takes 32 / G positions at once (4 in bf16 and 2 in f32 at D = 64). A
// lane whose chunk lies past D holds zeros (q, dout, k and v alike) and
// adds zeros to its group's sums; it stores nothing.

constexpr int kBwdThreads = 128;            // one row per block
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdUnroll = 2;     // positions per group per step (16-byte form)
constexpr int kMaxD = 256;

// Chunk c of a row: one 16-byte access where rows and bases are 16-byte
// aligned (kVec16), else plain element accesses; past C, zeros and no
// access.
template <typename T, bool kVec16>
__device__ __forceinline__ uint4 load_chunk(const T* row, int c, int C,
                                            int D) {
    constexpr int n = Vec<T>::n;
    if (c >= C) return make_uint4(0u, 0u, 0u, 0u);
    if (kVec16) return *reinterpret_cast<const uint4*>(row + c * n);
    return Vec<T>::load_part(row + c * n, D - c * n);
}

template <typename T, bool kVec16>
__device__ __forceinline__ void store_chunk(T* row, int c, int C, int D,
                                            const uint4& u) {
    constexpr int n = Vec<T>::n;
    if (c >= C) return;
    if (kVec16)
        *reinterpret_cast<uint4*>(row + c * n) = u;
    else
        Vec<T>::store_part(row + c * n, D - c * n, u);
}

// the sum over the G lanes of a group (xor shuffles: a fixed order)
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// One block per row (rows blockIdx.x, +gridDim.x, ...). Group `grp` of
// warp w takes, in step t and slot u, position
// t * kPerStep + (u * kBwdWarps + w) * kGroups + grp: a warp's access is
// kGroups consecutive rows of k (or v, dk, dv), one contiguous span. The
// next step's k, v and mask are loaded before this step's sums, so that
// two steps' loads are in flight per warp. dq: each lane sums its chunks
// over its positions in order, the groups of a warp are summed with xor
// shuffles and the warps in order through shared memory.
template <typename T, bool kVec16, int G, int kPerLane>
__global__ void __launch_bounds__(kBwdThreads, kPerLane == 1 ? 8 : 4)
target_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ mask,
                            const T* __restrict__ out,
                            const T* __restrict__ dout,
                            const float* __restrict__ stats,
                            T* __restrict__ dq, T* __restrict__ dk,
                            T* __restrict__ dv, int N, int L, int D,
                            float scale) {
    constexpr int kVec = Vec<T>::n;
    constexpr int kGroups = 32 / G;                // positions per warp
    // the plain form's element accesses take the registers of a second slot
    constexpr int kUnroll = kVec16 ? kBwdUnroll : 1;
    constexpr int kPerStep = kBwdWarps * kGroups * kUnroll;
    __shared__ float red[kBwdWarps][kMaxD];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int grp = lane / G;
    const int sub = lane % G;
    const int C = (D + kVec - 1) / kVec;
    const int steps = (L + kPerStep - 1) / kPerStep;

    for (int row = blockIdx.x; row < N; row += gridDim.x) {
        const size_t r = row;
        // q and dout stay packed; dq's share of this lane in f32
        uint4 qc[kPerLane], gc[kPerLane];
        float dqa[kPerLane][kVec];
        float delta = 0.0f;                        // dout . out
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
            const int c = sub + G * i;
            qc[i] = load_chunk<T, kVec16>(q + r * D, c, C, D);
            gc[i] = load_chunk<T, kVec16>(dout + r * D, c, C, D);
            float gf[kVec], of[kVec];
            Vec<T>::unpack(gc[i], gf);
            Vec<T>::unpack(load_chunk<T, kVec16>(out + r * D, c, C, D), of);
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
                delta = fmaf(gf[e], of[e], delta);
                dqa[i][e] = 0.0f;
            }
        }
        delta = group_sum<G>(delta);
        const float m = stats[2 * r];
        const float l = stats[2 * r + 1];

        auto position = [&](int t, int u) {
            return t * kPerStep + (u * kBwdWarps + warp) * kGroups + grp;
        };
        // step t's k, v chunks and mask values; past L, zeros and no loads
        auto fetch = [&](int t, uint4 (&kb)[kUnroll][kPerLane],
                         uint4 (&vb)[kUnroll][kPerLane],
                         float (&mb)[kUnroll]) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int j = position(t, u);
                const size_t base = (r * L + j) * D;
#pragma unroll
                for (int i = 0; i < kPerLane; ++i) {
                    const int c = j < L ? sub + G * i : C;
                    kb[u][i] = load_chunk<T, kVec16>(k + base, c, C, D);
                    vb[u][i] = load_chunk<T, kVec16>(v + base, c, C, D);
                }
                mb[u] = j < L ? mask[r * L + j] : 0.0f;
            }
        };
        uint4 kc[kUnroll][kPerLane], vc[kUnroll][kPerLane];
        float mc[kUnroll];
        fetch(0, kc, vc, mc);

        for (int t = 0; t < steps; ++t) {
            uint4 kn[kUnroll][kPerLane], vn[kUnroll][kPerLane];
            float mn[kUnroll];
            fetch(t + 1, kn, vn, mn);

            // q.k and dout.v of each slot, summed over the group together
            float sc[kUnroll], dp[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                sc[u] = 0.0f;
                dp[u] = 0.0f;
#pragma unroll
                for (int i = 0; i < kPerLane; ++i) {
                    float qf[kVec], gf[kVec], kf[kVec], vf[kVec];
                    Vec<T>::unpack(qc[i], qf);
                    Vec<T>::unpack(gc[i], gf);
                    Vec<T>::unpack(kc[u][i], kf);
                    Vec<T>::unpack(vc[u][i], vf);
#pragma unroll
                    for (int e = 0; e < kVec; ++e) {
                        sc[u] = fmaf(qf[e], kf[e], sc[u]);
                        dp[u] = fmaf(gf[e], vf[e], dp[u]);
                    }
                }
            }
#pragma unroll
            for (int off = 1; off < G; off <<= 1) {
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], off);
                    dp[u] += __shfl_xor_sync(0xffffffffu, dp[u], off);
                }
            }

#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int j = position(t, u);
                if (j >= L) continue;
                const bool valid = mc[u] > 0.0f;
                const float p = __expf((valid ? sc[u] / scale : kMasked) - m)
                    / l;
                const float dsc = valid ? p * (dp[u] - delta) / scale : 0.0f;
                const size_t base = (r * L + j) * D;
#pragma unroll
                for (int i = 0; i < kPerLane; ++i) {
                    const int c = sub + G * i;
                    float qf[kVec], gf[kVec], kf[kVec];
                    Vec<T>::unpack(qc[i], qf);
                    Vec<T>::unpack(gc[i], gf);
                    Vec<T>::unpack(kc[u][i], kf);
                    float dvf[kVec], dkf[kVec];
#pragma unroll
                    for (int e = 0; e < kVec; ++e) {
                        dvf[e] = p * gf[e];
                        dkf[e] = dsc * qf[e];
                        dqa[i][e] = fmaf(dsc, kf[e], dqa[i][e]);
                    }
                    store_chunk<T, kVec16>(dv + base, c, C, D,
                                           Vec<T>::pack(dvf));
                    store_chunk<T, kVec16>(dk + base, c, C, D,
                                           Vec<T>::pack(dkf));
                }
            }

#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                mc[u] = mn[u];
#pragma unroll
                for (int i = 0; i < kPerLane; ++i) {
                    kc[u][i] = kn[u][i];
                    vc[u][i] = vn[u][i];
                }
            }
        }

        // dq: the warp's groups with shuffles, then the warps in order
#pragma unroll
        for (int off = G; off < 32; off <<= 1) {
#pragma unroll
            for (int i = 0; i < kPerLane; ++i) {
#pragma unroll
                for (int e = 0; e < kVec; ++e)
                    dqa[i][e] += __shfl_xor_sync(0xffffffffu, dqa[i][e], off);
            }
        }
        if (grp == 0) {
#pragma unroll
            for (int i = 0; i < kPerLane; ++i) {
                const int c = sub + G * i;
                if (c < C) {
#pragma unroll
                    for (int e = 0; e < kVec; ++e)
                        red[warp][c * kVec + e] = dqa[i][e];
                }
            }
        }
        __syncthreads();
        for (int c = threadIdx.x; c < D; c += kBwdThreads) {
            float total = 0.0f;
            for (int w = 0; w < kBwdWarps; ++w) total += red[w][c];
            dq[r * D + c] = Vec<T>::to(total);
        }
        __syncthreads();
    }
}

template <typename T>
using BwdKernel = void (*)(const T*, const T*, const T*, const float*,
                           const T*, const T*, const float*, T*, T*, T*, int,
                           int, int, float);

// The instance for D: lanes per position the chunk count rounded up to a
// power of two, at most 32 (two chunks a lane beyond that, f32 only).
template <typename T, bool kVec16>
BwdKernel<T> bwd_kernel_for(int D) {
    const int C = (D + Vec<T>::n - 1) / Vec<T>::n;
    if constexpr (sizeof(T) == 4) {
        if (C > 32) return target_attention_bwd_kernel<T, kVec16, 32, 2>;
    }
    return C > 16 ? target_attention_bwd_kernel<T, kVec16, 32, 1>
        : C > 8 ? target_attention_bwd_kernel<T, kVec16, 16, 1>
        : C > 4 ? target_attention_bwd_kernel<T, kVec16, 8, 1>
        : C > 2 ? target_attention_bwd_kernel<T, kVec16, 4, 1>
        : C > 1 ? target_attention_bwd_kernel<T, kVec16, 2, 1>
        : target_attention_bwd_kernel<T, kVec16, 1, 1>;
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v,
               const float* mask, const void* out, const void* dout,
               const float* stats, void* dq, void* dk, void* dv, int N,
               int L, int D, float scale, void* stream) {
    const BwdKernel<T> kernel =
        aligned16<T>(D, q, k, v, out, dout, dq, dk, dv)
        ? bwd_kernel_for<T, true>(D) : bwd_kernel_for<T, false>(D);
    kernel<<<std::min(N, 1 << 16), kBwdThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), mask, static_cast<const T*>(out),
        static_cast<const T*>(dout), stats, static_cast<T*>(dq),
        static_cast<T*>(dk), static_cast<T*>(dv), N, L, D, scale);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t). Pointers are device pointers to
// contiguous arrays: q [N, D], k and v [N, L, D] and out [N, D] of the
// entry point's type, mask [N, L] f32. Requires N >= 1, L >= 1 and
// 1 <= D <= 256; the Python wrapper (target_attention_cuda) checks them.
// Returns the cudaGetLastError() code of the launch (0 on success).
int target_attention_fwd_f32(const void* q, const void* k, const void* v,
                             const float* mask, void* out, int N, int L,
                             int D, float scale, void* stream) {
    return launch<float, false>(q, k, v, mask, out, nullptr, N, L, D, scale,
                                stream);
}

int target_attention_fwd_bf16(const void* q, const void* k, const void* v,
                              const float* mask, void* out, int N, int L,
                              int D, float scale, void* stream) {
    return launch<__nv_bfloat16, false>(q, k, v, mask, out, nullptr, N, L,
                                        D, scale, stream);
}

// The training forward: as above, and stats [N, 2] f32 gets each row's
// running max and denominator for the backward.
int target_attention_fwd_stats_f32(const void* q, const void* k,
                                   const void* v, const float* mask,
                                   void* out, float* stats, int N, int L,
                                   int D, float scale, void* stream) {
    return launch<float, true>(q, k, v, mask, out, stats, N, L, D, scale,
                               stream);
}

int target_attention_fwd_stats_bf16(const void* q, const void* k,
                                    const void* v, const float* mask,
                                    void* out, float* stats, int N, int L,
                                    int D, float scale, void* stream) {
    return launch<__nv_bfloat16, true>(q, k, v, mask, out, stats, N, L, D,
                                       scale, stream);
}

// The backward: q, out, dout, dq [N, D] and k, v, dk, dv [N, L, D] of the
// entry point's type, mask [N, L] and stats [N, 2] (from the training
// forward) f32, all contiguous. Same requirements and return code.
int target_attention_bwd_f32(const void* q, const void* k, const void* v,
                             const float* mask, const void* out,
                             const void* dout, const float* stats, void* dq,
                             void* dk, void* dv, int N, int L, int D,
                             float scale, void* stream) {
    return launch_bwd<float>(q, k, v, mask, out, dout, stats, dq, dk, dv, N,
                             L, D, scale, stream);
}

int target_attention_bwd_bf16(const void* q, const void* k, const void* v,
                              const float* mask, const void* out,
                              const void* dout, const float* stats, void* dq,
                              void* dk, void* dv, int N, int L, int D,
                              float scale, void* stream) {
    return launch_bwd<__nv_bfloat16>(q, k, v, mask, out, dout, stats, dq, dk,
                                     dv, N, L, D, scale, stream);
}

const char* target_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
