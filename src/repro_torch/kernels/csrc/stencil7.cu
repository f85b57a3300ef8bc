// K1: 7-point Poisson stencil SpMV, homogeneous Dirichlet boundary.
//
// Replaces src/repro/kernels/stencil7.py::stencil7_pallas (TPU z-slab
// kernel).  out = 6u - u[z-1] - u[z+1] - u[y-1] - u[y+1] - u[x-1] - u[x+1]
// on a (batch, nz, ny, nx) grid, out-of-domain neighbours zero.
//
// Bound on the H100: memory.  The least traffic is one read of u and one
// write of out (7 flops per point against 16 bytes in float64).  Design:
// a 32x8 thread block owns an x-y tile with threads contiguous along x
// (coalesced 256-byte rows in float64) and marches along z over a chunk
// of ZCHUNK planes, carrying the z-1 / z / z+1 values in registers, so
// each u value comes from DRAM about once; the x/y neighbours of the
// current plane are re-read through L1/L2.  Boundaries are masked in the
// kernel, so any (nz, ny, nx) works: the TPU's z-block size bz was a VMEM
// tiling choice and has no counterpart here.
//
// Halo mode (HALO = true; a sharded apply, one launch per z-slab shard):
// u is one shard's (nz_s, ny, nx) slab, and the planes beyond its ends
// come from two (ny, nx) halo planes, lo (plane -1, the neighbour
// below) and hi (plane nz_s, the neighbour above), each null at the
// domain's boundary (zero).  Every other operation is the full launch's,
// in the same order (mul_rn, then six sub_rn), so the slabs' outputs put
// side by side are bitwise one full launch's.
#include <stdint.h>

#include "common.cuh"

#define TX 32
#define TY 8
#define ZCHUNK 16

template <typename T, bool HALO>
__global__ void __launch_bounds__(TX * TY)
stencil7_kernel(const T* __restrict__ u, const T* __restrict__ lo,
                const T* __restrict__ hi, T* __restrict__ out,
                int nz, int ny, int nx, int zchunks) {
    typedef typename Acc<T>::type A;
    const int x = blockIdx.x * TX + threadIdx.x;
    const int y = blockIdx.y * TY + threadIdx.y;
    if (x >= nx || y >= ny) return;
    const int batch = blockIdx.z / zchunks;
    const int z0 = (blockIdx.z % zchunks) * ZCHUNK;
    const int z1 = min(z0 + ZCHUNK, nz);
    const long long plane = (long long)ny * nx;
    const long long xy = (long long)y * nx + x;
    const T* ub = u + (long long)batch * nz * plane;
    T* ob = out + (long long)batch * nz * plane;

    A prev = z0 > 0 ? to_acc(ub[(long long)(z0 - 1) * plane + xy])
                    : (HALO && lo != nullptr ? to_acc(lo[xy]) : A(0));
    A cur = to_acc(ub[(long long)z0 * plane + xy]);
    for (int z = z0; z < z1; ++z) {
        const long long i = (long long)z * plane + xy;
        const A next = z + 1 < nz ? to_acc(ub[i + plane])
                                  : (HALO && hi != nullptr ? to_acc(hi[xy]) : A(0));
        const A ym = y > 0 ? to_acc(ub[i - nx]) : A(0);
        const A yp = y + 1 < ny ? to_acc(ub[i + nx]) : A(0);
        const A xm = x > 0 ? to_acc(ub[i - 1]) : A(0);
        const A xp = x + 1 < nx ? to_acc(ub[i + 1]) : A(0);
        A v = mul_rn(A(6), cur);
        v = sub_rn(v, prev);
        v = sub_rn(v, next);
        v = sub_rn(v, ym);
        v = sub_rn(v, yp);
        v = sub_rn(v, xm);
        v = sub_rn(v, xp);
        ob[i] = from_acc<T>(v);
        prev = cur;
        cur = next;
    }
}

template <typename T, bool HALO = false>
static int launch(const void* u, void* out, long long batch, int nz, int ny,
                  int nx, void* stream, const void* lo = nullptr,
                  const void* hi = nullptr) {
    const int zchunks = (nz + ZCHUNK - 1) / ZCHUNK;
    const long long max_batch = 65535 / zchunks;  // gridDim.z limit
    const dim3 block(TX, TY, 1);
    const long long grid_elems = (long long)nz * ny * nx;
    for (long long b0 = 0; b0 < batch; b0 += max_batch) {
        const long long nb = batch - b0 < max_batch ? batch - b0 : max_batch;
        const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY,
                        (unsigned)(nb * zchunks));
        stencil7_kernel<T, HALO><<<grid, block, 0, (cudaStream_t)stream>>>(
            (const T*)u + b0 * grid_elems, (const T*)lo, (const T*)hi,
            (T*)out + b0 * grid_elems, nz, ny, nx, zchunks);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

extern "C" {

int stencil7_f64(const void* u, void* out, long long batch, int nz, int ny,
                 int nx, void* stream) {
    return launch<double>(u, out, batch, nz, ny, nx, stream);
}

int stencil7_f32(const void* u, void* out, long long batch, int nz, int ny,
                 int nx, void* stream) {
    return launch<float>(u, out, batch, nz, ny, nx, stream);
}

int stencil7_bf16(const void* u, void* out, long long batch, int nz, int ny,
                  int nx, void* stream) {
    return launch<__nv_bfloat16>(u, out, batch, nz, ny, nx, stream);
}

// Halo mode: one (nz, ny, nx) slab u with its halo planes lo and hi
// ((ny, nx) each, or null for zero).
int stencil7_halo_f64(const void* u, const void* lo, const void* hi, void* out,
                      int nz, int ny, int nx, void* stream) {
    return launch<double, true>(u, out, 1, nz, ny, nx, stream, lo, hi);
}

int stencil7_halo_f32(const void* u, const void* lo, const void* hi, void* out,
                      int nz, int ny, int nx, void* stream) {
    return launch<float, true>(u, out, 1, nz, ny, nx, stream, lo, hi);
}

int stencil7_halo_bf16(const void* u, const void* lo, const void* hi, void* out,
                       int nz, int ny, int nx, void* stream) {
    return launch<__nv_bfloat16, true>(u, out, 1, nz, ny, nx, stream, lo, hi);
}

}  // extern "C"
