// K3: Reed-Solomon P/Q parity over K equal-length uint8 data shards in
// GF(2^8) (the erasure stripe's parity encode).
//
// Replaces src/repro/kernels/gf256_encode.py::gf256_rs_encode_pallas (a
// TPU kernel over (K, bm, 128) byte tiles with the EXP/LOG tables as
// lane-resident lookup inputs, its input zero-padded to the tile grid).
// For data shards d_0 .. d_{K-1}:
//     P = XOR_j d_j,    Q = XOR_j gf_mul(g^j, d_j)   (only when P == 2)
// bitwise the numpy route (nvm/gf256.py).
//
// Bound on the H100: memory.  Each data byte is read once and both
// parity rows are written from that one read (K + P bytes moved per
// column).  Q takes no table: Horner's rule from the last shard,
// q = xtime(q) ^ d_j, with xtime on eight packed bytes (gf_xtime64 in
// gf256.cuh), a few integer operations per 8 bytes instead of two
// dependent, data-indexed shared-memory lookups per byte.  Design: a
// grid-stride loop over 16-byte column words, one word per thread per
// step; the thread loads the words of ROWS shards at a time (all of them
// for K <= ROWS) before their arithmetic, as 16-byte loads.  A row whose
// start is not 16-byte aligned (the row length is not a multiple of 16,
// or the tensor starts off alignment) is read as the two aligned words
// around the column word and shifted into place; the shift is the same
// for every thread on a row, so no warp diverges.  The second word lies
// in the same 16-byte block as the column word's last byte, so it never
// leaves the row's memory pages.  A parity row whose start is unaligned
// is written in the widest pieces its alignment allows.  The L % 16 tail
// bytes of each row are extra items of the same loop, one byte column
// each.  Nothing is padded.  The grid is sized from the card's SM count
// and the kernel's occupancy, so the loop runs in one wave.
#include <stdint.h>

#include <cuda_runtime.h>

#include "common.cuh"
#include "gf256.cuh"

#define THREADS 256
// shard words a thread loads before their arithmetic
#define ROWS 4

struct Word16 {
    uint64_t lo, hi;
};

// Bytes s.. of the 16-byte little-endian pair (lo, hi), s in 1..7.
__device__ __forceinline__ uint64_t funnel(uint64_t lo, uint64_t hi, int s) {
    return (lo >> (8 * s)) | (hi << (64 - 8 * s));
}

// The 16 bytes at p, where shift = p % 16.
__device__ __forceinline__ Word16 load16(const uint8_t* p, int shift) {
    const uint4* q = reinterpret_cast<const uint4*>(p - shift);
    const uint4 v0 = __ldg(q);
    const uint64_t a0 = ((uint64_t)v0.y << 32) | v0.x, a1 = ((uint64_t)v0.w << 32) | v0.z;
    if (shift == 0) return {a0, a1};
    const uint4 v1 = __ldg(q + 1);
    const uint64_t a2 = ((uint64_t)v1.y << 32) | v1.x, a3 = ((uint64_t)v1.w << 32) | v1.z;
    if (shift < 8) return {funnel(a0, a1, shift), funnel(a1, a2, shift)};
    if (shift == 8) return {a1, a2};
    return {funnel(a1, a2, shift - 8), funnel(a2, a3, shift - 8)};
}

// Store 16 bytes at p, where shift = p % 16, in the widest aligned pieces.
__device__ __forceinline__ void store16(uint8_t* p, Word16 w, int shift) {
    if (shift == 0) {
        *reinterpret_cast<uint4*>(p) =
            make_uint4((uint32_t)w.lo, (uint32_t)(w.lo >> 32), (uint32_t)w.hi, (uint32_t)(w.hi >> 32));
    } else if (shift % 8 == 0) {
        reinterpret_cast<uint64_t*>(p)[0] = w.lo;
        reinterpret_cast<uint64_t*>(p)[1] = w.hi;
    } else if (shift % 4 == 0) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
            reinterpret_cast<uint32_t*>(p)[t] = (uint32_t)((t < 2 ? w.lo : w.hi) >> (32 * (t % 2)));
    } else if (shift % 2 == 0) {
#pragma unroll
        for (int t = 0; t < 8; ++t)
            reinterpret_cast<uint16_t*>(p)[t] = (uint16_t)((t < 4 ? w.lo : w.hi) >> (16 * (t % 4)));
    } else {
#pragma unroll
        for (int t = 0; t < 16; ++t) p[t] = (uint8_t)((t < 8 ? w.lo : w.hi) >> (8 * (t % 8)));
    }
}

__device__ __forceinline__ int misalign(const uint8_t* p) { return (int)((uintptr_t)p % 16); }

template <bool Q>
__global__ void __launch_bounds__(THREADS)
gf256_encode_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ parity,
                    int k_data, long long length) {
    const long long words = length / 16;
    const long long items = words + length % 16;
    const long long stride = (long long)gridDim.x * THREADS;
    uint8_t* const qrow = parity + length;
    for (long long it = (long long)blockIdx.x * THREADS + threadIdx.x; it < items; it += stride) {
        if (it < words) {
            const long long col = it * 16;
            Word16 pw = {0, 0}, qw = {0, 0};
            for (int j0 = k_data - 1; j0 >= 0; j0 -= ROWS) {
                Word16 d[ROWS];
#pragma unroll
                for (int c = 0; c < ROWS; ++c) {
                    if (j0 - c >= 0) {
                        const uint8_t* row = data + (long long)(j0 - c) * length;
                        d[c] = load16(row + col, misalign(row));
                    }
                }
#pragma unroll
                for (int c = 0; c < ROWS; ++c) {
                    if (j0 - c >= 0) {
                        pw.lo ^= d[c].lo;
                        pw.hi ^= d[c].hi;
                        if (Q) {
                            qw.lo = gf_xtime64(qw.lo) ^ d[c].lo;
                            qw.hi = gf_xtime64(qw.hi) ^ d[c].hi;
                        }
                    }
                }
            }
            store16(parity + col, pw, misalign(parity));
            if (Q) store16(qrow + col, qw, misalign(qrow));
        } else {
            // tail: one byte column, the same Horner steps on one lane
            const long long col = words * 16 + (it - words);
            uint64_t pb = 0, qb = 0;
            for (int j = k_data - 1; j >= 0; --j) {
                const uint64_t d = data[(long long)j * length + col];
                pb ^= d;
                if (Q) qb = gf_xtime64(qb) ^ d;
            }
            parity[col] = (uint8_t)pb;
            if (Q) qrow[col] = (uint8_t)qb;
        }
    }
}

// CTAs of the grid-stride loop: as many as the card holds at once (SMs
// times resident CTAs per SM), so no partial wave trails the loop.
template <bool Q>
static long long resident_ctas() {
    static long long cached[64];
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 1;
    if (dev < 64 && cached[dev] > 0) return cached[dev];
    int sms = 1, per_sm = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gf256_encode_kernel<Q>, THREADS, 0);
    const long long ctas = (long long)sms * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) cached[dev] = ctas;
    return ctas;
}

template <bool Q>
static int launch(const void* data, void* parity, int k_data, long long length,
                  cudaStream_t s) {
    const long long items = length / 16 + length % 16;
    long long ctas = (items + THREADS - 1) / THREADS;
    const long long cap = resident_ctas<Q>();
    if (ctas > cap) ctas = cap;
    if (ctas < 1) ctas = 1;
    gf256_encode_kernel<Q><<<(unsigned)ctas, THREADS, 0, s>>>(
        (const uint8_t*)data, (uint8_t*)parity, k_data, length);
    return (int)cudaGetLastError();
}

extern "C" {

// data: (k_data, length) uint8, row-major; parity: (nparity, length)
// uint8.  1 <= k_data <= 255 and nparity in {1, 2} (the wrapper checks).
// Any pointer alignment and any length.  Launches on `device` (the
// tensors' device) on `stream`, whatever device the caller has current.
int gf256_rs_encode(const void* data, void* parity, int k_data, int nparity,
                    long long length, int device, void* stream) {
    DeviceGuard guard(device);
    cudaStream_t s = (cudaStream_t)stream;
    if (nparity == 2) return launch<true>(data, parity, k_data, length, s);
    return launch<false>(data, parity, k_data, length, s);
}

}  // extern "C"
