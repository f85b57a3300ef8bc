// K2: fused PCG vector update (Algorithm 1 lines 4-7a), and the
// block-partial reduction it shares with det_dot.
//
// Replaces src/repro/kernels/fused_cg.py::fused_cg_update_pallas (TPU
// (m, 128)-tiled kernel with per-tile fp32 partials + a jnp.sum
// epilogue).  One pass computes
//     x' = x + alpha p,  r' = r - alpha ap,  z' = r' * inv_diag,
//     rz' = sum r' z'
// with alpha read from device memory (no host round trip per iteration).
//
// Bound on the H100: memory.  5 reads + 3 writes of n values per call
// (the minimum with the reduction fused), a handful of flops per value;
// det_dot reads 2 values per product.  Design: a CTA of THREADS threads
// owns a tile of TILE = THREADS * ITEMS consecutive values inside ONE
// partition block (grid.y = partition block, grid.x = tile).  A thread
// owns ITEMS / V groups of V consecutive values, V = 16 / sizeof(T), so
// one group is one 16-byte load per input (double2 / float4 / 8 bf16);
// group g of thread t starts at tile offset (g * THREADS + t) * V, so a
// warp's loads are coalesced and all of a thread's loads are in flight
// before its arithmetic.  When a pointer is not 16-byte aligned or V
// does not divide the block size, the same groups are loaded one value
// at a time: the load width never changes which values a thread owns or
// the order it adds them.  The reduction is deterministic, with no
// atomic in its arithmetic, in this fixed order:
//   1. per thread, its products in ascending offset (group by group,
//      value by value), from +0; values past the block's end add nothing;
//   2. per tile, a pairwise tree over the 32 lanes of each warp
//      (__shfl_down_sync by 16, 8, 4, 2, 1: lane i adds lane i + s), then
//      the same tree over the WARPS warp sums;
//   3. per partition block, thread t of one CTA adds the block's tile
//      partials t, t + THREADS, t + 2 THREADS, ... in ascending order
//      from +0, and the tree of step 2 combines the threads;
//   4. a left-to-right chain over the nblocks block sums.
// (the order-pinned shape of the reference's make_det_dot; fused_cg.py's
// det_dot_order_plain repeats it step by step in torch).  Steps 3 and 4
// run in the same launch: each CTA stores its tile partial and takes a
// ticket from its partition block's counter; the CTA that takes the
// last ticket folds the block (step 3), stores the block sum, and takes
// a ticket from the chain counter, whose last taker runs step 4.  A
// ticket decides only WHICH CTA adds, never the order, so the bits are
// the same in every run; each counter is reset to 0 by the CTA that took
// its last ticket, so it is 0 again when the launch ends (the wrapper
// keeps one counter array per stream).  The tiling depends on (n,
// nblocks) alone, never on the card.  det_dot runs the SAME tiling and
// steps 1-4 on a * b, so the loop's p.ap, its rz' and reconstruction's
// recomputed rz share one rounding order.  float64 inputs accumulate in
// float64 (the main path's rz is a float64 dot); float32/bf16 accumulate
// in float32 (the TPU contract).  Any n divisible by nblocks works
// (ragged tiles are masked); the reference's n % 128 and bm rules were
// TPU (8, 128) tiling rules.
//
// K4: the same update plus the erasure stripe's staging of the input p
// (replaces fused_cg.py::fused_cg_update_persist_pallas).  K4 is K2's
// kernel instantiated with STAGE = true: same tiles, same arithmetic,
// same steps 1-4, so x', r', z' and rz' are bitwise K2's.  With
// K | block_size, chunk j of block b is p[b*bs + j*chunk, +chunk), so the
// (nblocks, K, chunk) chunk array is p in its own order: each thread
// copies the p value it already loaded.  Parity element c of block b
// combines the K elements p[b*bs + j*chunk + c], which lie chunk apart
// and so in other tiles; the threads whose offset in the block is below
// chunk each read those K elements (p is read-only, the update's
// reduction is untouched) and write the P/Q parity words, byte t of a
// word being byte t of the little-endian element, as numpy's
// .view(np.uint8) orders them.  Bound: memory, K2's 8n values plus n
// chunk values and n*P/K parity bytes written (fused_pass_traffic); the
// parity threads' K reads of p mostly hit L2 next to their tiles' own.
// The reference's 128 | block_size rule was (8, 128) TPU tiling and is
// dropped, as K2 dropped it.
//
// Lane mode (LANES = true; the multi-tenant service's bucket step, where
// the reference vmaps one lane's step over a bucket): a (lanes, n)
// bucket is the (nblocks = lanes) geometry, so each lane is one
// partition block, alpha is read per block (alpha_ptr[blockIdx.y]), and
// step 4 is dropped: the CTA that folds a lane (step 3) writes its sum
// to out[lane] instead of chaining it.  Tiles depend on the lane's length
// alone and never straddle two lanes, so lane i's outputs are bitwise a
// solo launch with nblocks = 1 on lane i (whose chain over one block
// sum is that sum), whatever the lane count or the lane's place.
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"
#include "gf256.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)
#define ITEMS 8
#define TILE (THREADS * ITEMS)

// Values per 16-byte group.
template <typename T> struct Vec { static constexpr int N = 16 / (int)sizeof(T); };

// One group: the 16-byte word and its values.
template <typename T> union Pack {
    uint4 u;
    T e[Vec<T>::N];
};

// Group load: `valid` leading values of p (WIDE: all or none, in one
// 16-byte load); the rest are left unset and never read.
template <typename T, bool WIDE>
__device__ __forceinline__ void load_group(const T* __restrict__ p, int valid, Pack<T>& g) {
    if constexpr (WIDE) {
        if (valid > 0) g.u = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
#pragma unroll
        for (int e = 0; e < Vec<T>::N; ++e)
            if (e < valid) g.e[e] = p[e];
    }
}

template <typename T, bool WIDE>
__device__ __forceinline__ void store_group(T* __restrict__ p, int valid, const Pack<T>& g) {
    if constexpr (WIDE) {
        if (valid > 0) *reinterpret_cast<uint4*>(p) = g.u;
    } else {
#pragma unroll
        for (int e = 0; e < Vec<T>::N; ++e)
            if (e < valid) p[e] = g.e[e];
    }
}

// Values of the group starting at block offset off that lie in the block.
__device__ __forceinline__ int group_valid(long long off, long long bs, int n) {
    const long long left = bs - off;
    return left <= 0 ? 0 : (left >= n ? n : (int)left);
}

// Tile offset of group g of this thread.
template <typename T>
__device__ __forceinline__ long long group_offset(int g) {
    constexpr int N = Vec<T>::N;
    return (long long)blockIdx.x * TILE + ((long long)g * THREADS + threadIdx.x) * N;
}

// Step 2's tree: lanes, then warps; the total lands in thread 0.
template <typename A>
__device__ __forceinline__ A cta_tree(A v, A* sh) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v = add_rn(v, __shfl_down_sync(0xffffffffu, v, s));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) sh[warp] = v;
    __syncthreads();
    A total = A(0);
    if (warp == 0) {
        v = lane < WARPS ? sh[lane] : A(0);
#pragma unroll
        for (int s = WARPS / 2; s > 0; s >>= 1) v = add_rn(v, __shfl_down_sync(0xffffffffu, v, s));
        total = v;
    }
    __syncthreads();
    return total;
}

// Steps 2-4 from each thread's step-1 sum (LANES: steps 2-3, block blk's
// sum to out[blk]).  partials holds nblocks * tiles tile partials, then
// nblocks block sums; tickets holds nblocks + 1 counters, all 0 on entry
// and again on exit.
template <typename T, bool LANES>
__device__ __forceinline__ void reduce_tiles(typename Acc<T>::type local,
                                             typename Acc<T>::type* __restrict__ partials,
                                             unsigned* __restrict__ tickets, T* __restrict__ out) {
    typedef typename Acc<T>::type A;
    __shared__ A sh[WARPS];
    __shared__ bool last;
    const unsigned tiles = gridDim.x, blk = blockIdx.y, nblocks = gridDim.y;
    const A tile_sum = cta_tree(local, sh);
    if (threadIdx.x == 0) {
        partials[(long long)blk * tiles + blockIdx.x] = tile_sum;
        __threadfence();
        last = atomicAdd(&tickets[blk], 1u) == tiles - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    const A* pb = partials + (long long)blk * tiles;
    A s = A(0);
    for (unsigned j = threadIdx.x; j < tiles; j += THREADS) s = add_rn(s, __ldcg(pb + j));
    const A block_sum = cta_tree(s, sh);
    if (threadIdx.x == 0) {
        tickets[blk] = 0;
        if constexpr (LANES) {
            out[blk] = from_acc<T>(block_sum);
            return;
        }
        A* sums = partials + (long long)nblocks * tiles;
        sums[blk] = block_sum;
        __threadfence();
        if (atomicAdd(&tickets[nblocks], 1u) == nblocks - 1) {
            __threadfence();
            A chain = __ldcg(sums);
            for (unsigned b = 1; b < nblocks; ++b) chain = add_rn(chain, __ldcg(sums + b));
            out[0] = from_acc<T>(chain);
            tickets[nblocks] = 0;
        }
    }
}

// The unsigned word holding one element's bytes (the parity unit of K4).
template <typename T> struct Word;
template <> struct Word<double> { typedef uint64_t type; };
template <> struct Word<float> { typedef uint32_t type; };
template <> struct Word<__nv_bfloat16> { typedef uint16_t type; };

// STAGE = false is K2; STAGE = true is K4 (chunks, parity, k_data,
// nparity and chunk are read only then); LANES = true is K2's lane mode
// (alpha and rz per partition block, with STAGE = false only).
template <typename T, bool STAGE, bool LANES, bool WIDE>
__global__ void __launch_bounds__(THREADS)
fused_cg_update_kernel(const T* __restrict__ x, const T* __restrict__ r,
                       const T* __restrict__ p, const T* __restrict__ ap,
                       const T* __restrict__ inv, const T* __restrict__ alpha_ptr,
                       T* __restrict__ xo, T* __restrict__ ro, T* __restrict__ zo,
                       typename Acc<T>::type* __restrict__ partials,
                       unsigned* __restrict__ tickets, T* __restrict__ rz,
                       long long bs, T* __restrict__ chunks,
                       uint8_t* __restrict__ parity, int k_data, int nparity,
                       long long chunk) {
    typedef typename Acc<T>::type A;
    typedef typename Word<T>::type W;
    constexpr int N = Vec<T>::N;
    __shared__ uint8_t sexp[STAGE ? GF_EXP_SIZE : 1];
    __shared__ uint8_t slog[STAGE ? GF_LOG_SIZE : 1];
    if constexpr (STAGE) {
        if (nparity == 2) gf_load_tables(sexp, slog);
    }
    const A alpha = to_acc(alpha_ptr[LANES ? blockIdx.y : 0]);
    const long long base = (long long)blockIdx.y * bs;
    A local = A(0);
#pragma unroll
    for (int g = 0; g < ITEMS / N; ++g) {
        const long long off0 = group_offset<T>(g);
        const int valid = group_valid(off0, bs, N);
        const long long i0 = base + off0;
        Pack<T> xv, rv, pv, apv, iv, xn, rn, zn;
        load_group<T, WIDE>(x + i0, valid, xv);
        load_group<T, WIDE>(r + i0, valid, rv);
        load_group<T, WIDE>(p + i0, valid, pv);
        load_group<T, WIDE>(ap + i0, valid, apv);
        load_group<T, WIDE>(inv + i0, valid, iv);
#pragma unroll
        for (int e = 0; e < N; ++e) {
            if (e < valid) {
                xn.e[e] = from_acc<T>(add_rn(to_acc(xv.e[e]), mul_rn(alpha, to_acc(pv.e[e]))));
                rn.e[e] = from_acc<T>(sub_rn(to_acc(rv.e[e]), mul_rn(alpha, to_acc(apv.e[e]))));
                zn.e[e] = from_acc<T>(mul_rn(to_acc(rn.e[e]), to_acc(iv.e[e])));
                local = add_rn(local, mul_rn(to_acc(rn.e[e]), to_acc(zn.e[e])));
                if constexpr (STAGE) {
                    const long long off = off0 + e;
                    if (off < chunk) {
                        const W* pw = reinterpret_cast<const W*>(p + base + off);
                        W pp = 0, qq = 0;
                        for (int j = 0; j < k_data; ++j) {
                            const W d = pw[(long long)j * chunk];
                            pp ^= d;
                            if (nparity == 2) qq ^= gf_mul_word<W>(d, j % 255, sexp, slog);
                        }
                        W* outw = reinterpret_cast<W*>(parity) +
                                  (long long)blockIdx.y * nparity * chunk + off;
                        outw[0] = pp;
                        if (nparity == 2) outw[chunk] = qq;
                    }
                }
            }
        }
        store_group<T, WIDE>(xo + i0, valid, xn);
        store_group<T, WIDE>(ro + i0, valid, rn);
        store_group<T, WIDE>(zo + i0, valid, zn);
        if constexpr (STAGE) store_group<T, WIDE>(chunks + i0, valid, pv);
    }
    reduce_tiles<T, LANES>(local, partials, tickets, rz);
}

template <typename T, bool LANES, bool WIDE>
__global__ void __launch_bounds__(THREADS)
dot_kernel(const T* __restrict__ a, const T* __restrict__ b,
           typename Acc<T>::type* __restrict__ partials, unsigned* __restrict__ tickets,
           T* __restrict__ out, long long bs) {
    typedef typename Acc<T>::type A;
    constexpr int N = Vec<T>::N;
    constexpr int G = ITEMS / N;
    const long long base = (long long)blockIdx.y * bs;
    Pack<T> av[G], bv[G];
    int valid[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
        const long long off0 = group_offset<T>(g);
        valid[g] = group_valid(off0, bs, N);
        load_group<T, WIDE>(a + base + off0, valid[g], av[g]);
        load_group<T, WIDE>(b + base + off0, valid[g], bv[g]);
    }
    A local = A(0);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < N; ++e)
            if (e < valid[g]) local = add_rn(local, mul_rn(to_acc(av[g].e[e]), to_acc(bv[g].e[e])));
    reduce_tiles<T, LANES>(local, partials, tickets, out);
}

static long long tiles_for(long long bs) { return (bs + TILE - 1) / TILE; }

// 16-byte loads need every pointer 16-byte aligned and every block's
// start on a group boundary.
static bool wide_ok(long long bs, int n, std::initializer_list<const void*> ptrs) {
    if (bs % n != 0) return false;
    for (const void* q : ptrs)
        if (q != nullptr && (uintptr_t)q % 16 != 0) return false;
    return true;
}

template <typename T, bool STAGE, bool LANES = false>
static int update(const void* x, const void* r, const void* p, const void* ap,
                  const void* inv, const void* alpha, void* xo, void* ro, void* zo,
                  void* partials, void* tickets, void* rz, long long n, int nblocks,
                  int device, void* stream, void* chunks = nullptr, void* parity = nullptr,
                  int k_data = 1, int nparity = 1) {
    typedef typename Acc<T>::type A;
    DeviceGuard guard(device);
    const long long bs = n / nblocks;
    const dim3 grid((unsigned)tiles_for(bs), (unsigned)nblocks, 1);
    cudaStream_t s = (cudaStream_t)stream;
    const bool wide = wide_ok(bs, Vec<T>::N, {x, r, p, ap, inv, xo, ro, zo, chunks});
#define LAUNCH_UPDATE(W)                                                                 \
    fused_cg_update_kernel<T, STAGE, LANES, W><<<grid, THREADS, 0, s>>>(                 \
        (const T*)x, (const T*)r, (const T*)p, (const T*)ap, (const T*)inv,              \
        (const T*)alpha, (T*)xo, (T*)ro, (T*)zo, (A*)partials, (unsigned*)tickets,       \
        (T*)rz, bs, (T*)chunks, (uint8_t*)parity, k_data, nparity, bs / k_data)
    if (wide) LAUNCH_UPDATE(true);
    else LAUNCH_UPDATE(false);
#undef LAUNCH_UPDATE
    return (int)cudaGetLastError();
}

template <typename T, bool LANES = false>
static int dot(const void* a, const void* b, void* partials, void* tickets, void* out,
               long long n, int nblocks, int device, void* stream) {
    typedef typename Acc<T>::type A;
    DeviceGuard guard(device);
    const long long bs = n / nblocks;
    const dim3 grid((unsigned)tiles_for(bs), (unsigned)nblocks, 1);
    cudaStream_t s = (cudaStream_t)stream;
    if (wide_ok(bs, Vec<T>::N, {a, b}))
        dot_kernel<T, LANES, true><<<grid, THREADS, 0, s>>>((const T*)a, (const T*)b, (A*)partials,
                                                     (unsigned*)tickets, (T*)out, bs);
    else
        dot_kernel<T, LANES, false><<<grid, THREADS, 0, s>>>((const T*)a, (const T*)b, (A*)partials,
                                                      (unsigned*)tickets, (T*)out, bs);
    return (int)cudaGetLastError();
}

extern "C" {

// partials: nblocks * (tiles + 1) accumulators (tiles = ceil(bs / TILE));
// tickets: nblocks + 1 unsigned counters, 0 on entry, 0 again on exit;
// device: the tensors' CUDA device, stream: a stream of that device.
#define UPDATE_ARGS                                                               \
    const void *x, const void *r, const void *p, const void *ap, const void *inv,  \
        const void *alpha, void *xo, void *ro, void *zo, void *partials,           \
        void *tickets, void *rz, long long n, int nblocks, int device, void *stream
#define UPDATE_CALL \
    x, r, p, ap, inv, alpha, xo, ro, zo, partials, tickets, rz, n, nblocks, device, stream

int fused_cg_update_f64(UPDATE_ARGS) { return update<double, false>(UPDATE_CALL); }
int fused_cg_update_f32(UPDATE_ARGS) { return update<float, false>(UPDATE_CALL); }
int fused_cg_update_bf16(UPDATE_ARGS) { return update<__nv_bfloat16, false>(UPDATE_CALL); }

// K4: K2's arguments, then the (nblocks, K, chunk) chunk array, the
// (nblocks, P, chunk * itemsize) parity bytes, K and P (K | n / nblocks,
// P in {1, 2}: the wrapper checks both).
#define PERSIST_ARGS UPDATE_ARGS, void *chunks, void *parity, int k_data, int nparity
#define PERSIST_CALL UPDATE_CALL, chunks, parity, k_data, nparity

int fused_cg_update_persist_f64(PERSIST_ARGS) { return update<double, true>(PERSIST_CALL); }
int fused_cg_update_persist_f32(PERSIST_ARGS) { return update<float, true>(PERSIST_CALL); }
int fused_cg_update_persist_bf16(PERSIST_ARGS) {
    return update<__nv_bfloat16, true>(PERSIST_CALL);
}

#define DOT_ARGS                                                                     \
    const void *a, const void *b, void *partials, void *tickets, void *out, long long n, \
        int nblocks, int device, void *stream
#define DOT_CALL a, b, partials, tickets, out, n, nblocks, device, stream

int det_dot_f64(DOT_ARGS) { return dot<double>(DOT_CALL); }
int det_dot_f32(DOT_ARGS) { return dot<float>(DOT_CALL); }
int det_dot_bf16(DOT_ARGS) { return dot<__nv_bfloat16>(DOT_CALL); }

// Lane mode: nblocks is the lane count, n = lanes * lane length; alpha
// holds one value a lane, and rz / out one result a lane.
int fused_cg_update_lanes_f64(UPDATE_ARGS) { return update<double, false, true>(UPDATE_CALL); }
int fused_cg_update_lanes_f32(UPDATE_ARGS) { return update<float, false, true>(UPDATE_CALL); }
int fused_cg_update_lanes_bf16(UPDATE_ARGS) {
    return update<__nv_bfloat16, false, true>(UPDATE_CALL);
}
int det_dot_lanes_f64(DOT_ARGS) { return dot<double, true>(DOT_CALL); }
int det_dot_lanes_f32(DOT_ARGS) { return dot<float, true>(DOT_CALL); }
int det_dot_lanes_bf16(DOT_ARGS) { return dot<__nv_bfloat16, true>(DOT_CALL); }

}  // extern "C"
