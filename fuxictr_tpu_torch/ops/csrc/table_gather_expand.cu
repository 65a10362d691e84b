// Backward of the deduped embedding expand, f32 and bf16, for sm_90a.
//
// Replaces the custom VJPs of fuxictr_tpu/ops/embedding.py:
// table_gather_expand (_tge_bwd) and table_gather_expand_multi (_tgem_bwd).
// The forward gathers a batch's U unique rows of k fields from one fused
// table [V, D] and expands them to the batch's N flat positions through
// `inv`: out [N, k*D] = concat_i(table[ids[i]] * mask[i])[inv]. Its
// gradient is
//
//     seg[u]     = sum over positions n with inv[n] == u of g[n]   ([U, k*D])
//     dtable[r]  = sum over fields i, slots u with ids[i, u] == r of
//                  seg[u, i*D:(i+1)*D] * mask[i, u]                ([V, D])
//
// which JAX computes as one scatter-add into the [U, k*D] temp and k
// scatter-adds into the table, one field after another. Here every sum is
// f32 and the output is rounded once to g's type (bf16 compute hands the
// cast table's gradient back to the f32 master through the cast).
//
// Deterministic: no floating-point atomics, so two identical steps give
// bitwise-equal gradients. The wrapper (ops/embedding.py) first sorts
// `inv` and the flattened [k*U] `ids` stably (bookkeeping on indices);
// then, on the wrapper's stream:
//
// 1. slot_bounds: each slot's [start, end) in the sorted positions (empty
//    slots, such as the bucket padding, get an empty range);
// 2. tile_sums: one warp per tile of kTile sorted positions, lanes along
//    the k*D columns, sums each run of one slot in position order. The
//    first run of a tile that continues a slot from the tile before goes
//    to head[tile]; every other run is its slot's first piece and goes to
//    seg[slot]. A slot as long as the batch's padding item (a third of the
//    positions at SIM's full width) is thus cut into tiles that run in
//    parallel;
// 3. row_sums: one warp per sorted (field, slot) entry that starts a run of
//    one table row; it adds, in sorted order (field 0 first, slots
//    ascending), each non-empty, unmasked slot's seg piece plus its heads,
//    and writes the row once. Its lanes look up 32 entries at a time, so
//    the bucket padding (thousands of empty slots naming row 0 of a field)
//    costs a few coalesced loads, not a chain of thousands. Rows that no
//    entry names stay zero (memset).
//
// Bound: bytes. g is read once (N*k*D values), inv and ids once, dtable
// written once; a few flops per byte. The scratch (seg: U*k*D, head:
// N/kTile*k*D f32, bounds: 2U ints) is small beside g.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;       // rows of g in flight per warp

template <typename T> struct Elem;

template <> struct Elem<float> {
    __device__ static float from(float x) { return x; }
    __device__ static float to(float x) { return x; }
};

template <> struct Elem<__nv_bfloat16> {
    __device__ static float from(__nv_bfloat16 x) {
        return __bfloat162float(x);
    }
    __device__ static __nv_bfloat16 to(float x) {
        return __float2bfloat16(x);
    }
};

__global__ void slot_bounds_kernel(const int64_t* __restrict__ inv_sorted,
                                   int N, int* __restrict__ start,
                                   int* __restrict__ end) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= N) return;
    const int64_t u = inv_sorted[p];
    if (p == 0 || inv_sorted[p - 1] != u) start[u] = p;
    if (p == N - 1 || inv_sorted[p + 1] != u) end[u] = p + 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_sums_kernel(const T* __restrict__ g,
                 const int64_t* __restrict__ inv_sorted,
                 const int64_t* __restrict__ perm, int N, int C, int tile,
                 float* __restrict__ seg, float* __restrict__ head) {
    const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    const int p0 = w * tile;
    if (p0 >= N) return;
    const int p1 = min(N, p0 + tile);
    const int64_t first = inv_sorted[p0];
    const bool first_continues = p0 > 0 && inv_sorted[p0 - 1] == first;
    for (int c0 = 0; c0 < C; c0 += 32) {
        const int c = c0 + lane;
        int64_t cur = first;
        bool continues = first_continues;
        float acc = 0.0f;
        auto flush = [&]() {
            float* dst = continues ? head + (size_t)w * C
                                   : seg + (size_t)cur * C;
            if (c < C) dst[c] = acc;
        };
        for (int base = p0; base < p1; base += 32) {
            const int n = min(32, p1 - base);
            // lane j holds sorted position base + j's slot and row of g
            const int64_t my_u = lane < n ? inv_sorted[base + lane] : -1;
            const int64_t my_row = lane < n ? perm[base + lane] : 0;
            for (int j0 = 0; j0 < n; j0 += kUnroll) {
                float x[kUnroll];
#pragma unroll
                for (int jj = 0; jj < kUnroll; ++jj) {
                    const int j = j0 + jj;
                    const int64_t row = __shfl_sync(0xffffffffu, my_row, j);
                    x[jj] = (j < n && c < C)
                        ? Elem<T>::from(g[row * C + c]) : 0.0f;
                }
#pragma unroll
                for (int jj = 0; jj < kUnroll; ++jj) {
                    const int j = j0 + jj;
                    const int64_t u = __shfl_sync(0xffffffffu, my_u, j);
                    if (j < n) {
                        if (u != cur) {
                            flush();
                            cur = u;
                            continues = false;
                            acc = 0.0f;
                        }
                        acc += x[jj];
                    }
                }
            }
        }
        flush();
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_sums_kernel(const int64_t* __restrict__ keys_sorted,
                const int64_t* __restrict__ eperm, int E, int U,
                const uint8_t* __restrict__ mask,
                const int* __restrict__ start, const int* __restrict__ end,
                const float* __restrict__ seg,
                const float* __restrict__ head, int C, int D, int tile,
                T* __restrict__ dtable) {
    const int e = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (e >= E) return;
    const int64_t r = keys_sorted[e];
    if (e > 0 && keys_sorted[e - 1] == r) return;   // not the row's first
    for (int c0 = 0; c0 < D; c0 += 32) {
        const int c = c0 + lane;
        const bool ok = c < D;
        float acc = 0.0f;
        // the row's entries 32 at a time: lane j looks up entry e0 + j (its
        // slot and range, in parallel), then the warp adds the entries that
        // are in the row, unmasked and non-empty, in sorted order
        bool in_row = true;
        for (int e0 = e; in_row && e0 < E; e0 += 32) {
            const int f = e0 + lane;
            bool take = f < E && keys_sorted[f] == r;
            in_row = __all_sync(0xffffffffu, take);
            int field = 0, u = 0, s0 = 0, s1 = 0;
            if (take) {
                const int64_t ent = eperm[f];            // field * U + slot
                field = (int)(ent / U);
                u = (int)(ent - (int64_t)field * U);
                s0 = start[u];
                s1 = end[u];
                take = s0 != s1 && (mask == nullptr || mask[ent] != 0);
            }
            for (unsigned live = __ballot_sync(0xffffffffu, take); live;
                 live &= live - 1) {
                const int j = __ffs(live) - 1;
                const int fj = __shfl_sync(0xffffffffu, field, j);
                const int uj = __shfl_sync(0xffffffffu, u, j);
                const int s0j = __shfl_sync(0xffffffffu, s0, j);
                const int s1j = __shfl_sync(0xffffffffu, s1, j);
                const size_t col = (size_t)fj * D + c;
                float sum = ok ? seg[(size_t)uj * C + col] : 0.0f;
                // the slot's pieces in later tiles, in order; the history
                // padding item spans ~1,400 tiles at SIM's full width, so
                // 32 head loads are issued before their adds
                const int b1 = (s1j - 1) / tile;
                int b = s0j / tile + 1;
                for (; b + 32 <= b1 + 1; b += 32) {
                    float h[32];
#pragma unroll
                    for (int i = 0; i < 32; ++i)
                        h[i] = ok ? head[(size_t)(b + i) * C + col] : 0.0f;
#pragma unroll
                    for (int i = 0; i < 32; ++i) sum += h[i];
                }
                for (; b <= b1; ++b)
                    sum += ok ? head[(size_t)b * C + col] : 0.0f;
                acc += sum;
            }
        }
        if (ok) dtable[r * D + c] = Elem<T>::to(acc);
    }
}

int blocks_for(long long threads) {
    return (int)((threads + kThreads - 1) / kThreads);
}

template <typename T>
int launch(const void* g, const int64_t* inv_sorted, const int64_t* perm,
           const int64_t* keys_sorted, const int64_t* eperm,
           const uint8_t* mask, int* bounds, float* seg, float* head,
           void* dtable, int N, int U, int k, int D, long long V, int tile,
           void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int C = k * D;
    const int E = k * U;
    cudaError_t err = cudaMemsetAsync(dtable, 0, (size_t)V * D * sizeof(T),
                                      s);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(bounds, 0, (size_t)2 * U * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    slot_bounds_kernel<<<blocks_for(N), kThreads, 0, s>>>(
        inv_sorted, N, bounds, bounds + U);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const long long tiles = (N + tile - 1) / tile;
    tile_sums_kernel<T><<<blocks_for(tiles * 32), kThreads, 0, s>>>(
        static_cast<const T*>(g), inv_sorted, perm, N, C, tile, seg, head);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    row_sums_kernel<T><<<blocks_for((long long)E * 32), kThreads, 0, s>>>(
        keys_sorted, eperm, E, U, mask, bounds, bounds + U, seg, head, C, D,
        tile, static_cast<T*>(dtable));
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t). Device pointers to contiguous
// arrays: g [N, k*D] of the entry point's type; inv_sorted and perm [N]
// int64 (torch.sort(inv, stable=True)); keys_sorted and eperm [k*U] int64
// (the same of ids [k, U] flattened); mask [k, U] bool, or null for all
// ones; scratch bounds [2*U] int32, seg [U, k*D] and head
// [ceil(N/tile), k*D] f32; the output dtable [V, D] of g's type. Requires
// N, U >= 1, 0 <= inv < U, 0 <= ids < V and N * k * D < 2^31; the Python
// wrapper (table_gather_expand_bwd_cuda) checks what it can without a
// device sync. Returns the first failing CUDA call's code (0 on success).
int table_gather_expand_bwd_f32(
        const void* g, const int64_t* inv_sorted, const int64_t* perm,
        const int64_t* keys_sorted, const int64_t* eperm,
        const uint8_t* mask, int* bounds, float* seg, float* head,
        void* dtable, int N, int U, int k, int D, long long V, int tile,
        void* stream) {
    return launch<float>(g, inv_sorted, perm, keys_sorted, eperm, mask,
                         bounds, seg, head, dtable, N, U, k, D, V, tile,
                         stream);
}

int table_gather_expand_bwd_bf16(
        const void* g, const int64_t* inv_sorted, const int64_t* perm,
        const int64_t* keys_sorted, const int64_t* eperm,
        const uint8_t* mask, int* bounds, float* seg, float* head,
        void* dtable, int N, int U, int k, int D, long long V, int tile,
        void* stream) {
    return launch<__nv_bfloat16>(g, inv_sorted, perm, keys_sorted, eperm,
                                 mask, bounds, seg, head, dtable, N, U, k, D,
                                 V, tile, stream);
}

const char* table_gather_expand_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
