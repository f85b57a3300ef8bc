"""K3: the GF(2^8) Reed-Solomon P/Q parity encode of the erasure stripe,
hand-written CUDA for Hopper, and its plain PyTorch version.

Replaces ``src/repro/kernels/gf256_encode.py::gf256_rs_encode_pallas``
(the TPU kernel ``_make_encode_kernel`` over ``(K, bm, 128)`` byte tiles).
For K data shards ``d_j`` of one length ``L``, parity row 0 is the
bytewise XOR of the shards and row 1 (when ``nparity == 2``) XORs
``gf_mul(g^j, d_j) = EXP[LOG[d_j] + j % 255]`` with zero bytes masked:
the arithmetic of :mod:`repro_torch.nvm.gf256`, so the bytes are
bitwise ``gf256.rs_encode``'s.

On the H100 the encode is bound by memory: ``K + P`` bytes move per
column.  ``csrc/gf256_encode.cu`` reads each data byte once and writes
both parity rows from that read, as the TPU kernel does.  The reference
zero-padded its input to the tile grid; the CUDA kernel masks the tail,
so any ``L`` works without a copy.  The ``(K, L)`` data tensor is the
stripe's K chunks side by side (``ErasureSession._shards``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.nvm import gf256

#: kernel launches since the last reset (the main-path proof counter)
launches = 0

#: (data, parity, k_data, nparity, length, stream)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_void_p)


def _check(data: torch.Tensor, nparity: int) -> None:
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data shards must be a (K, L) uint8 tensor, got "
                         f"{data.dtype} of shape {tuple(data.shape)}")
    # same arity validation (and error text) as the numpy reference
    gf256.vandermonde(nparity, data.shape[0])


def _tables(device: torch.device):
    return (torch.from_numpy(gf256.EXP).to(device),
            torch.from_numpy(gf256.LOG).to(device))


def gf256_rs_encode_plain(data: torch.Tensor, nparity: int) -> torch.Tensor:
    """``(P, L)`` parity of the ``(K, L)`` uint8 shards ``data``, from
    torch operations (``bitwise_xor``, table ``index_select``,
    ``where``), on ``data``'s device."""
    _check(data, nparity)
    k_data = data.shape[0]
    p = data[0].clone()
    for j in range(1, k_data):
        p = torch.bitwise_xor(p, data[j])
    rows = [p]
    if nparity == 2:
        exp, log = _tables(data.device)
        q = torch.zeros_like(data[0])
        for j in range(k_data):
            dj = data[j]
            idx = torch.index_select(log, 0, dj.long().reshape(-1)) + (j % 255)
            term = torch.index_select(exp, 0, idx).reshape(dj.shape)
            term = torch.where(dj == 0, torch.zeros_like(term), term)
            q = torch.bitwise_xor(q, term)
        rows.append(q)
    return torch.stack(rows)


def gf256_rs_encode_cuda(data: torch.Tensor, nparity: int) -> torch.Tensor:
    """Launch K3 on a contiguous ``(K, L)`` uint8 CUDA tensor; returns the
    ``(P, L)`` parity on the same device and stream."""
    global launches
    if data.device.type != "cuda":
        raise ValueError(f"gf256_rs_encode_cuda needs a CUDA tensor, got "
                         f"{data.device}")
    _check(data, nparity)
    if not data.is_contiguous():
        raise ValueError("gf256_rs_encode_cuda needs a contiguous tensor")
    k_data, length = data.shape
    fn = _build.function("gf256_encode", "gf256_rs_encode", _ARGTYPES)
    out = torch.empty((nparity, length), dtype=torch.uint8, device=data.device)
    with torch.cuda.device(data.device):
        rc = fn(data.data_ptr(), out.data_ptr(), k_data, nparity, length,
                torch.cuda.current_stream(data.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gf256_rs_encode kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out
