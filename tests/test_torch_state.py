"""The slot wire format and the persisted bytes: byte-identical across
the reference package and the port.

Slots encoded by either package's ``RecoverySchema.encode`` decode in the
other, and the same persistence events through either package's NVM
backend leave the same bytes on the simulated durable media.
"""
import numpy as np
import pytest
import torch

from _torch_port import rng_normal
from repro.core import nvm_esr as ref_nvm
from repro.core import state as ref_state
from repro_torch.core import nvm_esr as port_nvm
from repro_torch.core import state as port_state


def _shard(dtype, seed=0, n=64):
    return rng_normal(seed, n).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_encode_is_byte_identical(dtype):
    p = _shard(dtype)
    a = ref_state.PCG_SCHEMA.encode(17, {"beta": 0.25}, {"p": p})
    b = port_state.PCG_SCHEMA.encode(17, {"beta": 0.25}, {"p": p})
    assert a == b
    assert len(a) == port_state.PCG_SCHEMA.slot_nbytes(64, dtype) \
        == ref_state.PCG_SCHEMA.slot_nbytes(64, dtype)


@pytest.mark.parametrize("writer,reader", [
    (ref_state.PCG_SCHEMA, port_state.PCG_SCHEMA),
    (port_state.PCG_SCHEMA, ref_state.PCG_SCHEMA)])
def test_slots_decode_across_packages(writer, reader):
    p = _shard(np.float64, seed=3)
    raw = writer.encode(-5, {"beta": -1.5e-3}, {"p": p})
    got = reader.decode(raw, np.float64)
    assert got.k == -5 and got.scalars == {"beta": -1.5e-3}
    assert got.vectors["p"].tobytes() == p.tobytes()
    assert port_state.peek_k(raw) == ref_state.peek_k(raw) == -5


def test_multi_vector_schema_round_trip():
    spec = dict(solver="x", vectors=("r", "p"), scalars=("rho", "w"),
                history=1)
    ref_schema = ref_state.RecoverySchema(**spec)
    port_schema = port_state.RecoverySchema(**spec)
    vecs = {"r": _shard(np.float64, 1), "p": _shard(np.float64, 2)}
    raw = port_schema.encode(3, {"rho": 1.0, "w": 2.0}, vecs)
    assert raw == ref_schema.encode(3, {"rho": 1.0, "w": 2.0}, vecs)
    back = ref_schema.decode(raw, np.float64)
    for name in vecs:
        assert back.vectors[name].tobytes() == vecs[name].tobytes()


@pytest.mark.parametrize("ks,history", [((0, 1, 2, 4), 2), ((3, 5, 7), 2),
                                        ((1, 2, 3), 3), ((), 1)])
def test_newest_complete_run_agrees(ks, history):
    assert (port_state.newest_complete_run(ks, history)
            == ref_state.newest_complete_run(ks, history))


@pytest.mark.parametrize("cls", ["NVMESRPRD", "NVMESRHomogeneous"])
def test_persisted_media_bytes_identical(cls):
    """Five persistence events (one torn by a crash of block 1) through
    each package's backend leave byte-identical durable media, and the
    port's recovery reads what the reference's does."""
    nblocks, bs = 4, 32
    ref_be = getattr(ref_nvm, cls)(nblocks, bs, np.float64)
    port_be = getattr(port_nvm, cls)(nblocks, bs, np.float64)
    for k in range(5):
        p = rng_normal(10 + k, nblocks * bs)
        for be in (ref_be, port_be):
            be.persist_set(k, {"beta": 0.1 * k}, {"p": p})
    for be in (ref_be, port_be):
        if hasattr(be, "drain"):
            be.drain()
        be.fail((1,))
    if cls == "NVMESRPRD":
        stores = [(ref_be.prd.store, port_be.prd.store)]
    else:
        stores = list(zip((pl.store for pl in ref_be.pools),
                          (pl.store for pl in port_be.pools)))
    for ref_store, port_store in stores:
        assert bytes(ref_store._durable) == bytes(port_store._durable)
    assert port_be.durable_run() == ref_be.durable_run() == 4
    ref_sets = ref_be.recover_set((1, 3), (3, 4))
    port_sets = port_be.recover_set((1, 3), (3, 4))
    for a, b in zip(ref_sets, port_sets):
        assert (a.k, a.scalars) == (b.k, b.scalars)
        assert a.vectors["p"].tobytes() == b.vectors["p"].tobytes()


def test_wipe_vectors_nans_failed_blocks_only():
    from repro_torch.core.poisson import BlockPartition

    part = BlockPartition(16, 4)
    st = port_state.PCGState(
        x=torch.arange(16.0, dtype=torch.float64), r=torch.ones(16, dtype=torch.float64),
        z=torch.ones(16, dtype=torch.float64), p=torch.ones(16, dtype=torch.float64),
        rz=torch.tensor(2.0, dtype=torch.float64),
        beta_prev=torch.tensor(0.5, dtype=torch.float64), k=3)
    wiped = port_state.wipe_vectors(st, part, (1, 3), ("x", "r"), ("rz",))
    bad = torch.isnan(wiped.x.reshape(4, 4)).all(dim=1)
    assert bad.tolist() == [False, True, False, True]
    assert torch.isnan(wiped.rz) and not torch.isnan(st.rz)
    assert torch.equal(wiped.z, st.z) and wiped.k == 3
    assert not torch.isnan(st.x).any()  # the input state is untouched
