"""Solver state and minimal-recovery-set schemas (port of
``repro/core/state.py``).

An ESR-recoverable solver persists a *minimal* set of named vectors and
scalars per iteration from which every lost shard is exactly
reconstructible.  For PCG that set is ``{p^(k), p^(k-1), beta^(k-1), k}``.

Slot wire format (one block's shard of one iteration), byte-identical to
the reference package's, so slots written by either package decode in
the other::

    k:int64 | scalars (f64 each, schema order) | vector shards (schema order)
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Mapping, NamedTuple, Tuple

import numpy as np
import torch

_K_HEADER = struct.Struct("<q")


@dataclasses.dataclass(frozen=True)
class RecoverySchema:
    """Declares the minimal recovery set persisted by one solver.

    ``vectors``: names of block-sharded vectors, persisted shard-wise.
    ``scalars``: names of replicated scalars persisted alongside each slot.
    ``history``: number of *consecutive* persisted iterations a recovery
    needs (2 for the PCG pair).
    """

    solver: str
    vectors: Tuple[str, ...]
    scalars: Tuple[str, ...] = ()
    history: int = 2

    def __post_init__(self):
        if not self.vectors:
            raise ValueError("a recovery schema needs at least one vector")
        if self.history < 1:
            raise ValueError(f"history must be >= 1, got {self.history}")

    def slot_nbytes(self, block_size: int, dtype) -> int:
        """Payload bytes of one block's slot (excludes backend headers)."""
        return (
            _K_HEADER.size
            + 8 * len(self.scalars)
            + len(self.vectors) * block_size * np.dtype(dtype).itemsize
        )

    def encode(
        self,
        k: int,
        scalars: Mapping[str, float],
        vector_shards: Mapping[str, np.ndarray],
    ) -> bytes:
        """Serialize one block's slot payload (dtype fixed by caller)."""
        parts = [_K_HEADER.pack(int(k))]
        parts.append(struct.pack(f"<{len(self.scalars)}d",
                                 *(float(scalars[s]) for s in self.scalars)))
        for name in self.vectors:
            parts.append(np.ascontiguousarray(vector_shards[name]).tobytes())
        return b"".join(parts)

    def decode(self, raw: bytes, dtype) -> "RecoverySet":
        (k,) = _K_HEADER.unpack(raw[: _K_HEADER.size])
        off = _K_HEADER.size
        ns = len(self.scalars)
        vals = struct.unpack(f"<{ns}d", raw[off : off + 8 * ns])
        off += 8 * ns
        flat = np.frombuffer(raw[off:], dtype=dtype)
        if len(flat) % len(self.vectors):
            raise ValueError(
                f"payload holds {len(flat)} values, not divisible by "
                f"{len(self.vectors)} schema vectors")
        per = len(flat) // len(self.vectors)
        vectors = {
            name: flat[i * per : (i + 1) * per].copy()
            for i, name in enumerate(self.vectors)
        }
        return RecoverySet(k=k, scalars=dict(zip(self.scalars, vals)),
                           vectors=vectors)


def peek_k(raw: bytes) -> int:
    """Read a slot payload's iteration header without decoding it."""
    return _K_HEADER.unpack(raw[: _K_HEADER.size])[0]


def newest_complete_run(ks, history: int):
    """Newest ``k`` ending a consecutive ``history``-long run within the
    iteration set ``ks``, or None if no complete run exists."""
    ks = set(ks)
    best = None
    for k in sorted(ks):
        if all(k - i in ks for i in range(history)):
            best = k
    return best


class RecoverySet(NamedTuple):
    """One iteration's decoded recovery payload (host arrays).

    ``vectors`` maps names to either a single block shard or the
    concatenated union of failed-block shards.
    """

    k: int
    scalars: Dict[str, float]
    vectors: Dict[str, np.ndarray]


class PCGState(NamedTuple):
    """State after ``k`` completed PCG iterations.

    Vectors and the scalars ``rz`` / ``beta_prev`` are tensors on the
    solve's device (0-d for the scalars); ``k`` is a host ``int``.

    Invariants (exact arithmetic):
      - ``r = b - A x``
      - ``z = P r``
      - ``p = z + beta_prev * p_prev``  (``p = z`` when k == 0)
      - ``rz = <r, z>``
    """

    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    beta_prev: torch.Tensor
    k: int


# The paper's PCG recovery set: {p^(k), p^(k-1), beta^(k-1), k}.
PCG_SCHEMA = RecoverySchema("pcg", vectors=("p",), scalars=("beta",), history=2)


class RecoveryPayload(NamedTuple):
    """The pre-zoo PCG-shaped recovery slot, as the deprecated
    ``persist``/``recover`` backend methods speak it."""

    k: int
    beta: float  # beta^(k-1): the scalar linking p^(k-1) -> p^(k)
    p: np.ndarray  # p^(k), the block shard (or full vector)


def encode_payload(k: int, beta: float, p_block: np.ndarray) -> bytes:
    """Serialize one PCG slot (wire-compatible with the generic codec and
    with the reference package's bytes)."""
    return PCG_SCHEMA.encode(k, {"beta": beta}, {"p": p_block})


def decode_payload(raw: bytes, dtype) -> RecoveryPayload:
    rset = PCG_SCHEMA.decode(raw, dtype)
    return RecoveryPayload(k=rset.k, beta=rset.scalars["beta"],
                           p=rset.vectors["p"])


def payload_nbytes(block_size: int, dtype) -> int:
    return PCG_SCHEMA.slot_nbytes(block_size, dtype)


def minimal_recovery_state(state: PCGState) -> Tuple[int, float, torch.Tensor]:
    """The paper's minimal persistent set at this iteration: ``(k, beta,
    p)``, ``p`` the state's own tensor."""
    return int(state.k), float(state.beta_prev), state.p


def legacy_pair(sets) -> Tuple[RecoveryPayload, RecoveryPayload]:
    """Map a PCG-schema (prev, cur) recovery to the legacy payload pair."""
    prev, cur = sets[-2], sets[-1]
    return (
        RecoveryPayload(prev.k, 0.0, prev.vectors["p"]),
        RecoveryPayload(cur.k, cur.scalars["beta"], cur.vectors["p"]),
    )


def require_pcg_schema(schema: RecoverySchema, api: str) -> None:
    """Guard for the legacy ``persist``/``recover`` backend shims, which
    speak PCG payloads only: fail with a pointer instead of a KeyError
    deep in the codec."""
    if (schema.vectors, schema.scalars, schema.history) != (("p",), ("beta",), 2):
        raise TypeError(
            f"the legacy {api}() API carries PCG payloads only, but this "
            f"backend persists schema {schema.solver!r}; use "
            f"persist_set()/recover_set()")


def typed_vectors(schema: RecoverySchema, vectors: Mapping[str, np.ndarray],
                  dtype) -> Dict[str, np.ndarray]:
    """Convert every schema vector to the backend dtype once per event."""
    return {name: np.asarray(vectors[name], dtype) for name in schema.vectors}


def shard_vectors(schema: RecoverySchema, vectors: Mapping[str, np.ndarray],
                  block: int, block_size: int) -> Dict[str, np.ndarray]:
    """One block's shard of every (already-typed) schema vector."""
    lo, hi = block * block_size, (block + 1) * block_size
    return {name: vectors[name][lo:hi] for name in schema.vectors}


def concat_sets(schema: RecoverySchema, per_block) -> RecoverySet:
    """Merge per-block recovery sets into one union set (block order kept)."""
    first = per_block[0]
    return RecoverySet(
        k=first.k,
        scalars=dict(first.scalars),
        vectors={name: np.concatenate([s.vectors[name] for s in per_block])
                 for name in schema.vectors},
    )


def wipe_vectors(state, partition, blocks, vector_fields, nan_scalars=()):
    """Simulate failure of ``blocks`` on any NamedTuple solver state: the
    failed shards of every volatile vector become garbage (NaN; on a
    sharded vector, in copies of the dead shards' slabs), and the
    non-replicated reduction scalars are NaN'd too."""
    nan = float("nan")
    repl = {f: partition.fill_blocks(getattr(state, f), list(blocks), nan)
            for f in vector_fields}
    for f in nan_scalars:
        old = getattr(state, f)
        repl[f] = torch.full((), nan, dtype=old.dtype, device=old.device)
    return state._replace(**repl)


def wipe_blocks(state: PCGState, partition, blocks) -> PCGState:
    """PCG-shaped :func:`wipe_vectors` (the legacy entry point)."""
    return wipe_vectors(state, partition, blocks, ("x", "r", "z", "p"),
                        nan_scalars=("rz",))
