// K3: Reed-Solomon P/Q parity over K equal-length uint8 data shards in
// GF(2^8) (the erasure stripe's parity encode).
//
// Replaces src/repro/kernels/gf256_encode.py::gf256_rs_encode_pallas (a
// TPU kernel over (K, bm, 128) byte tiles with the EXP/LOG tables as
// lane-resident lookup inputs, its input zero-padded to the tile grid).
// For data shards d_0 .. d_{K-1}:
//     P = XOR_j d_j,    Q = XOR_j gf_mul(g^j, d_j)   (only when P == 2)
// with gf_mul of gf256.cuh, bitwise the numpy route (nvm/gf256.py).
//
// Bound on the H100: memory.  Each data byte is read once and both
// parity rows are written from that one read (K + P bytes moved per
// column); Q adds two shared-memory table lookups per data byte, well
// under the memory time.  Design: a grid-stride loop over columns, one
// column word per thread per step: 8 bytes (uint64) when the row length
// is a multiple of 8 and the pointers are 8-byte aligned, so each row's
// words stay aligned; otherwise one byte per thread.  Any length works
// and nothing is padded: the loop bound masks the ragged tail.  The
// tables are copied from __constant__ into shared memory once per CTA.
#include <stdint.h>

#include <cuda_runtime.h>

#include "gf256.cuh"

#define THREADS 256
// CTAs per SM of the grid-stride loop (132 SMs on the H100 SXM)
#define MAX_CTAS (132 * 8)

template <typename W>
__global__ void __launch_bounds__(THREADS)
gf256_encode_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ parity,
                    int k_data, int nparity, long long words, long long row_bytes) {
    __shared__ uint8_t sexp[GF_EXP_SIZE];
    __shared__ uint8_t slog[GF_LOG_SIZE];
    if (nparity == 2) gf_load_tables(sexp, slog);
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long w = (long long)blockIdx.x * THREADS + threadIdx.x; w < words; w += stride) {
        W pw = 0, qw = 0;
        for (int j = 0; j < k_data; ++j) {
            const W d = reinterpret_cast<const W*>(data + (long long)j * row_bytes)[w];
            pw ^= d;
            if (nparity == 2) qw ^= gf_mul_word<W>(d, j % 255, sexp, slog);
        }
        reinterpret_cast<W*>(parity)[w] = pw;
        if (nparity == 2) reinterpret_cast<W*>(parity + row_bytes)[w] = qw;
    }
}

template <typename W>
static int launch(const void* data, void* parity, int k_data, int nparity,
                  long long length, cudaStream_t s) {
    const long long words = length / (long long)sizeof(W);
    long long ctas = (words + THREADS - 1) / THREADS;
    if (ctas > MAX_CTAS) ctas = MAX_CTAS;
    if (ctas < 1) ctas = 1;
    gf256_encode_kernel<W><<<(unsigned)ctas, THREADS, 0, s>>>(
        (const uint8_t*)data, (uint8_t*)parity, k_data, nparity, words, length);
    return (int)cudaGetLastError();
}

extern "C" {

// data: (k_data, length) uint8, row-major; parity: (nparity, length)
// uint8.  1 <= k_data <= 255 and nparity in {1, 2} (the wrapper checks).
int gf256_rs_encode(const void* data, void* parity, int k_data, int nparity,
                    long long length, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const bool aligned = length % 8 == 0 && (uintptr_t)data % 8 == 0 &&
                         (uintptr_t)parity % 8 == 0;
    if (aligned) return launch<uint64_t>(data, parity, k_data, nparity, length, s);
    return launch<uint8_t>(data, parity, k_data, nparity, length, s);
}

}  // extern "C"
