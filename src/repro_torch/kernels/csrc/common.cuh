// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every elementwise operation goes through an explicitly rounded
// intrinsic (no FMA contraction), in the same order as the plain
// PyTorch version beside each kernel, so a float64 kernel output is
// bitwise the plain version's wherever no reduction is involved.
// bf16 values are computed in float32 and rounded once on store.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

template <typename T> struct Acc;
template <> struct Acc<double> { typedef double type; };
template <> struct Acc<float> { typedef float type; };
template <> struct Acc<__nv_bfloat16> { typedef float type; };

__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_acc(typename Acc<T>::type v);
template <> __device__ __forceinline__ double from_acc<double>(double v) { return v; }
template <> __device__ __forceinline__ float from_acc<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

// Makes `device` current for a launch and restores the caller's device
// (the wrappers pass the tensors' device instead of entering a Python
// device context on every call).
struct DeviceGuard {
    int prev = -1;
    explicit DeviceGuard(int device) {
        int cur = device;
        if (cudaGetDevice(&cur) == cudaSuccess && cur != device) {
            prev = cur;
            cudaSetDevice(device);
        }
    }
    ~DeviceGuard() {
        if (prev >= 0) cudaSetDevice(prev);
    }
};
