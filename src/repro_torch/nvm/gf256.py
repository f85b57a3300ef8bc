"""GF(2^8) arithmetic and Reed-Solomon P/Q parity (port of
``repro/nvm/gf256.py``, numpy only, kept here so the port imports
nothing of the reference package).

The erasure stripe (``nvm/backend.py``) protects its K data shards with
P ∈ {1, 2} parity shards: parity row P is the bytewise XOR of the K
data shards, parity row Q weights shard ``j`` by the generator power
``g^j`` in GF(2^8) before XOR-accumulating.  Both rows together form a
2xK Vandermonde matrix over the field, every square submatrix of which
is invertible, so *any* two erased shards (data or parity) are exactly
recoverable.

Everything here operates on **raw bytes** (``uint8`` views of the
stored payload), never on float values: reconstruction returns the
identical bit pattern the data children persisted.  This module is the
numpy route of the stripe write and the byte oracle of the port's
GF(256) kernels (``kernels/gf256_encode.py`` and K4 in
``kernels/fused_cg.py``).

Field: GF(2^8) with the primitive polynomial ``x^8+x^4+x^3+x^2+1``
(0x11D) and generator ``g = 2``.  Tables are built once at import:
``EXP[i] = g^i`` (doubled to 510 entries so products skip one modulo),
``LOG[g^i] = i``.

Scope: the Vandermonde rows ``g^(i·j)`` are guaranteed MDS only for
``nparity <= 2`` (rows ``1...1`` and ``g^0..g^(K-1)``); the module
refuses wider codes rather than silently emitting a non-MDS matrix.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

#: primitive polynomial x^8 + x^4 + x^3 + x^2 + 1
PRIMITIVE_POLY = 0x11D
#: generator of the multiplicative group under :data:`PRIMITIVE_POLY`
GENERATOR = 2
#: widest parity the g^(i·j) Vandermonde rows are provably MDS for
MAX_PARITY = 2

# ---------------------------------------------------------------- tables
EXP = np.zeros(510, dtype=np.uint8)   # EXP[i] = g^i, doubled for mul
LOG = np.zeros(256, dtype=np.int64)   # LOG[g^i] = i; LOG[0] is unused


def _build_tables() -> None:
    x = 1
    for i in range(255):
        EXP[i] = x
        LOG[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIMITIVE_POLY
    EXP[255:510] = EXP[0:255]


_build_tables()


# ------------------------------------------------------------ arithmetic
def gf_mul(a, b) -> np.ndarray:
    """Elementwise GF(2^8) product of ``a`` and ``b`` (scalars or uint8
    arrays, broadcast like numpy)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = EXP[LOG[a] + LOG[b]]
    return np.where((a == 0) | (b == 0), np.uint8(0), out).astype(np.uint8)


def gf_div(a, b) -> np.ndarray:
    """Elementwise GF(2^8) quotient ``a / b``; division by zero raises."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    if np.any(b == 0):
        raise ZeroDivisionError("division by zero in GF(2^8)")
    out = EXP[(LOG[a] - LOG[b]) % 255]
    return np.where(a == 0, np.uint8(0), out).astype(np.uint8)


def gf_pow(a: int, n: int) -> int:
    """Scalar GF(2^8) power ``a^n`` (``0^0 == 1`` by convention)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP[(int(LOG[a]) * n) % 255])


def gf_inv(a: int) -> int:
    """Scalar multiplicative inverse; ``gf_inv(0)`` raises."""
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return int(EXP[255 - int(LOG[a])])


# --------------------------------------------------------- Reed-Solomon
def vandermonde(nparity: int, k_data: int) -> np.ndarray:
    """The ``nparity x k_data`` encode matrix ``V[i, j] = g^(i·j)``.

    Row 0 is all ones (P parity == plain XOR, which keeps the wire
    format of the old distance-2 stripe); row 1 weights shard ``j`` by
    ``g^j`` (Q parity).  MDS is only guaranteed up to
    :data:`MAX_PARITY` rows — see the module docstring.
    """
    if not 1 <= nparity <= MAX_PARITY:
        raise ValueError(
            f"nparity must be in [1, {MAX_PARITY}] (the g^(i*j) rows are "
            f"only provably MDS up to {MAX_PARITY} parities), got {nparity}")
    if not 1 <= k_data <= 255:
        raise ValueError(f"k_data must be in [1, 255], got {k_data}")
    return np.array([[gf_pow(GENERATOR, i * j) for j in range(k_data)]
                     for i in range(nparity)], dtype=np.uint8)


def _scaled(coeff: int, shard: np.ndarray) -> np.ndarray:
    """``coeff * shard`` with the cheap cases short-circuited (row 0 of
    the Vandermonde is all ones, so P parity never pays table lookups)."""
    if coeff == 0:
        return np.zeros_like(shard)
    if coeff == 1:
        return shard
    return gf_mul(coeff, shard)


def rs_encode(data: Sequence[np.ndarray], nparity: int) -> List[np.ndarray]:
    """Encode ``nparity`` parity shards over equal-length uint8 data
    shards: ``parity[i] = XOR_j  V[i, j] * data[j]``."""
    shards = [np.ascontiguousarray(d, dtype=np.uint8) for d in data]
    if len({s.shape for s in shards}) != 1:
        raise ValueError(
            f"data shards must share one shape, got "
            f"{[s.shape for s in shards]}")
    v = vandermonde(nparity, len(shards))
    out = []
    for i in range(nparity):
        acc = np.zeros_like(shards[0])
        for j, d in enumerate(shards):
            acc ^= _scaled(int(v[i, j]), d)
        out.append(acc)
    return out


def _solve(a: np.ndarray, rhs: List[np.ndarray]) -> List[np.ndarray]:
    """Solve ``a @ x = rhs`` over GF(2^8): ``a`` is a small square uint8
    coefficient matrix, each RHS entry a byte array.  Plain Gaussian
    elimination — the systems here are at most MAX_PARITY x MAX_PARITY,
    but the loop is written generically."""
    m = len(rhs)
    a = a.astype(np.uint8).copy()
    rhs = [r.copy() for r in rhs]
    for col in range(m):
        pivot = next((r for r in range(col, m) if a[r, col] != 0), None)
        if pivot is None:
            raise ValueError("singular reconstruction system in GF(2^8)")
        if pivot != col:
            a[[col, pivot]] = a[[pivot, col]]
            rhs[col], rhs[pivot] = rhs[pivot], rhs[col]
        inv = gf_inv(int(a[col, col]))
        a[col] = gf_mul(inv, a[col])
        rhs[col] = _scaled(inv, rhs[col])
        for r in range(m):
            if r != col and a[r, col] != 0:
                factor = int(a[r, col])
                a[r] ^= gf_mul(factor, a[col])
                rhs[r] = rhs[r] ^ _scaled(factor, rhs[col])
    return rhs


def rs_reconstruct(shards: Sequence[Optional[np.ndarray]],
                   k_data: int) -> List[np.ndarray]:
    """Recover the ``k_data`` data shards from a partially erased stripe.

    ``shards`` lists the logical stripe — ``k_data`` data shards
    followed by the parity shards of :func:`rs_encode` — with ``None``
    marking an erased shard.  Returns the complete data shards,
    byte-identical to what was encoded; raises ``ValueError`` when the
    erasures exceed what the surviving parity can solve.
    """
    nparity = len(shards) - k_data
    if nparity < 1:
        raise ValueError(
            f"stripe of {len(shards)} shards with k_data={k_data} leaves "
            f"no parity")
    missing = [j for j in range(k_data) if shards[j] is None]
    if not missing:
        return [np.asarray(s, dtype=np.uint8) for s in shards[:k_data]]
    alive_parity = [i for i in range(nparity)
                    if shards[k_data + i] is not None]
    if len(missing) > len(alive_parity):
        raise ValueError(
            f"{len(missing)} data shard(s) erased but only "
            f"{len(alive_parity)} parity shard(s) survive — beyond the "
            f"code's remaining distance")
    v = vandermonde(nparity, k_data)
    rows = alive_parity[:len(missing)]
    # RHS per chosen row: parity_i minus (XOR) the surviving data terms.
    rhs = []
    for i in rows:
        acc = np.asarray(shards[k_data + i], dtype=np.uint8).copy()
        for j in range(k_data):
            if shards[j] is not None:
                acc ^= _scaled(int(v[i, j]), np.asarray(shards[j], np.uint8))
        rhs.append(acc)
    a = v[np.ix_(rows, missing)]
    solved = _solve(a, rhs)
    out: List[np.ndarray] = []
    for j in range(k_data):
        if shards[j] is None:
            out.append(solved[missing.index(j)])
        else:
            out.append(np.asarray(shards[j], dtype=np.uint8))
    return out
