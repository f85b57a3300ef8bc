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
// (the minimum with the reduction fused), a handful of flops per value.
// Design: a CTA of THREADS threads owns a tile of TILE consecutive values
// inside ONE partition block (grid.y = partition block, grid.x = tile),
// each thread strides by THREADS so warps load coalesced.  The reduction
// is deterministic and atomic-free, in a fixed order:
//   1. per thread, its ITEMS products in ascending order;
//   2. per tile, a shared-memory tree over the CTA's threads;
//   3. per partition block, a tree over that block's tile partials;
//   4. a left-to-right chain over the nblocks block partials
// (the order-pinned shape of the reference's make_det_dot).  det_dot
// runs the SAME tiling and the same steps 1-4 on a * b, so the loop's
// p.ap, its rz' and reconstruction's recomputed rz share one rounding
// order.  float64 inputs accumulate in float64 (the main path's rz is a
// float64 dot); float32/bf16 accumulate in float32 (the TPU contract).
// Any n works (ragged tiles are masked); the reference's n % 128 and bm
// rules were TPU (8, 128) tiling rules.
#include <stdint.h>

#include "common.cuh"

#define THREADS 256
#define ITEMS 8
#define TILE (THREADS * ITEMS)

// Fixed-order tree over the CTA; every thread gets the total.
template <typename A>
__device__ __forceinline__ A cta_sum(A v, A* sh) {
    sh[threadIdx.x] = v;
    __syncthreads();
    for (int s = THREADS / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) sh[threadIdx.x] = add_rn(sh[threadIdx.x], sh[threadIdx.x + s]);
        __syncthreads();
    }
    const A total = sh[0];
    __syncthreads();
    return total;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_cg_update_kernel(const T* __restrict__ x, const T* __restrict__ r,
                       const T* __restrict__ p, const T* __restrict__ ap,
                       const T* __restrict__ inv, const T* __restrict__ alpha_ptr,
                       T* __restrict__ xo, T* __restrict__ ro, T* __restrict__ zo,
                       typename Acc<T>::type* __restrict__ partials,
                       long long bs) {
    typedef typename Acc<T>::type A;
    __shared__ A sh[THREADS];
    const A alpha = to_acc(alpha_ptr[0]);
    const long long base = (long long)blockIdx.y * bs;
    const long long t0 = (long long)blockIdx.x * TILE + threadIdx.x;
    A local = A(0);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const long long off = t0 + (long long)k * THREADS;
        if (off < bs) {
            const long long i = base + off;
            const A xn = add_rn(to_acc(x[i]), mul_rn(alpha, to_acc(p[i])));
            const T rn = from_acc<T>(sub_rn(to_acc(r[i]), mul_rn(alpha, to_acc(ap[i]))));
            const T zn = from_acc<T>(mul_rn(to_acc(rn), to_acc(inv[i])));
            xo[i] = from_acc<T>(xn);
            ro[i] = rn;
            zo[i] = zn;
            local = add_rn(local, mul_rn(to_acc(rn), to_acc(zn)));
        }
    }
    const A total = cta_sum(local, sh);
    if (threadIdx.x == 0) partials[(long long)blockIdx.y * gridDim.x + blockIdx.x] = total;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dot_partials_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    typename Acc<T>::type* __restrict__ partials, long long bs) {
    typedef typename Acc<T>::type A;
    __shared__ A sh[THREADS];
    const long long base = (long long)blockIdx.y * bs;
    const long long t0 = (long long)blockIdx.x * TILE + threadIdx.x;
    A local = A(0);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const long long off = t0 + (long long)k * THREADS;
        if (off < bs) {
            const long long i = base + off;
            local = add_rn(local, mul_rn(to_acc(a[i]), to_acc(b[i])));
        }
    }
    const A total = cta_sum(local, sh);
    if (threadIdx.x == 0) partials[(long long)blockIdx.y * gridDim.x + blockIdx.x] = total;
}

// Steps 3-4: one CTA folds each partition block's tile partials with the
// fixed tree, then chains the block sums left to right.
template <typename T>
__global__ void __launch_bounds__(THREADS)
finish_kernel(const typename Acc<T>::type* __restrict__ partials, int nblocks,
              long long tiles, T* __restrict__ out) {
    typedef typename Acc<T>::type A;
    __shared__ A sh[THREADS];
    A chain = A(0);
    for (int blk = 0; blk < nblocks; ++blk) {
        const typename Acc<T>::type* pb = partials + (long long)blk * tiles;
        A local = A(0);
        for (long long j = threadIdx.x; j < tiles; j += THREADS) local = add_rn(local, pb[j]);
        const A block_sum = cta_sum(local, sh);
        chain = blk == 0 ? block_sum : add_rn(chain, block_sum);
    }
    if (threadIdx.x == 0) out[0] = from_acc<T>(chain);
}

static long long tiles_for(long long bs) { return (bs + TILE - 1) / TILE; }

template <typename T>
static int update(const void* x, const void* r, const void* p, const void* ap,
                  const void* inv, const void* alpha, void* xo, void* ro, void* zo,
                  void* partials, void* rz, long long n, int nblocks, void* stream) {
    typedef typename Acc<T>::type A;
    const long long bs = n / nblocks;
    const long long tiles = tiles_for(bs);
    cudaStream_t s = (cudaStream_t)stream;
    fused_cg_update_kernel<T><<<dim3((unsigned)tiles, (unsigned)nblocks, 1), THREADS, 0, s>>>(
        (const T*)x, (const T*)r, (const T*)p, (const T*)ap, (const T*)inv,
        (const T*)alpha, (T*)xo, (T*)ro, (T*)zo, (A*)partials, bs);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    finish_kernel<T><<<1, THREADS, 0, s>>>((const A*)partials, nblocks, tiles, (T*)rz);
    return (int)cudaGetLastError();
}

template <typename T>
static int dot(const void* a, const void* b, void* partials, void* out,
               long long n, int nblocks, void* stream) {
    typedef typename Acc<T>::type A;
    const long long bs = n / nblocks;
    const long long tiles = tiles_for(bs);
    cudaStream_t s = (cudaStream_t)stream;
    dot_partials_kernel<T><<<dim3((unsigned)tiles, (unsigned)nblocks, 1), THREADS, 0, s>>>(
        (const T*)a, (const T*)b, (A*)partials, bs);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    finish_kernel<T><<<1, THREADS, 0, s>>>((const A*)partials, nblocks, tiles, (T*)out);
    return (int)cudaGetLastError();
}

extern "C" {

long long fused_cg_tiles(long long block_size) { return tiles_for(block_size); }

#define UPDATE_ARGS                                                              \
    const void *x, const void *r, const void *p, const void *ap, const void *inv, \
        const void *alpha, void *xo, void *ro, void *zo, void *partials, void *rz, \
        long long n, int nblocks, void *stream
#define UPDATE_CALL x, r, p, ap, inv, alpha, xo, ro, zo, partials, rz, n, nblocks, stream

int fused_cg_update_f64(UPDATE_ARGS) { return update<double>(UPDATE_CALL); }
int fused_cg_update_f32(UPDATE_ARGS) { return update<float>(UPDATE_CALL); }
int fused_cg_update_bf16(UPDATE_ARGS) { return update<__nv_bfloat16>(UPDATE_CALL); }

#define DOT_ARGS                                                                 \
    const void *a, const void *b, void *partials, void *out, long long n, int nblocks, \
        void *stream
#define DOT_CALL a, b, partials, out, n, nblocks, stream

int det_dot_f64(DOT_ARGS) { return dot<double>(DOT_CALL); }
int det_dot_f32(DOT_ARGS) { return dot<float>(DOT_CALL); }
int det_dot_bf16(DOT_ARGS) { return dot<__nv_bfloat16>(DOT_CALL); }

}  // extern "C"
