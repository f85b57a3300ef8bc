"""The port's kernels against the reference's, and on the card against
their plain versions.

On the CPU the port's ``ops`` take the plain PyTorch versions; they are
held against the JAX package's Pallas kernels run as its own tests run
them (``mode="pallas"``, interpreted) in float32/bfloat16, and against
the reference's float64 jnp operators.  The kernels themselves are
held against these plain versions on the card in test_torch_cuda.py.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import rng_normal
from repro.core.poisson import stencil7 as ref_stencil7
from repro.core.spmv import make_det_dot
from repro.kernels import ops as ref_ops
from repro_torch.kernels import fused_cg, ops, stencil7

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: the reference's own kernel tolerances (tests/test_kernels.py:21,45,53)
STENCIL_TOL = {"float32": 1e-5, "bfloat16": 1e-1}
UPDATE_TOL = {"float32": 2e-5, "bfloat16": 2e-1}
RZ_REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _both(a32: np.ndarray, name: str):
    """The same float32 values in both frameworks at ``name``'s dtype
    (both round to nearest even when narrowing to bfloat16)."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a32).astype(jdt), torch.from_numpy(a32).to(tdt)


@pytest.mark.parametrize("shape,bz", [((8, 8, 128), 8), ((16, 8, 64), 4),
                                      ((24, 10, 130), 4)])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_stencil7_matches_pallas_kernel(shape, bz, name):
    ju, tu = _both(rng_normal(0, *shape, dtype=np.float32), name)
    want = np.asarray(ref_ops.stencil7(ju, mode="pallas", bz=bz), np.float32)
    got = ops.stencil7(tu).float().numpy()
    tol = STENCIL_TOL[name]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("n,bm", [(128 * 8, 8), (128 * 64, 16)])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_fused_cg_update_matches_pallas_kernel(n, bm, name):
    vals = [rng_normal(seed, n, dtype=np.float32) for seed in range(5)]
    jx, jr, jp, jap, jinv = (_both(v, name)[0] for v in vals)
    tx, tr, tp, tap, tinv = (_both(v, name)[1] for v in vals)
    jdt, tdt = DTYPES[name]
    want = ref_ops.fused_cg_update(jx, jr, jp, jap, jnp.asarray(0.37, jdt),
                                   jinv, mode="pallas", bm=bm)
    got = ops.fused_cg_update(tx, tr, tp, tap, torch.tensor(0.37, dtype=tdt),
                              tinv)
    tol = UPDATE_TOL[name]
    for g, w, field in zip(got[:3], want[:3], ("x", "r", "z")):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=tol, atol=tol, err_msg=field)
    rz_rel = abs(float(got[3]) - float(want[3])) / (abs(float(want[3])) + 1e-9)
    # both accumulate in float32; the bf16 slack covers the final downcast
    assert rz_rel < RZ_REL_TOL[name]


@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 6, 5), (5, 7, 9)])
def test_stencil7_float64_matches_reference_operator(shape):
    u = rng_normal(1, *shape)
    want = np.asarray(ref_stencil7(jnp.asarray(u)))
    got = ops.stencil7(torch.from_numpy(u)).numpy()
    # same operations in the same order; 1e-14 leaves room for XLA
    # contracting 6u - a into a fused multiply-add
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)


def test_stencil7_batched_equals_per_grid():
    u = torch.from_numpy(rng_normal(2, 3, 4, 5, 6))
    batched = ops.stencil7(u)
    for i in range(3):
        assert torch.equal(batched[i], ops.stencil7(u[i]))


@pytest.mark.parametrize("nblocks", [1, 4])
def test_fused_cg_update_float64_matches_reference_lines(nblocks):
    n = 8 * 8 * 8
    x, r, p, ap = (rng_normal(s, n) for s in range(4))
    inv = 1.0 / (5.0 + np.abs(rng_normal(4, n)))
    alpha = 0.37
    got = ops.fused_cg_update(*(torch.from_numpy(v) for v in (x, r, p, ap)),
                              torch.tensor(alpha, dtype=torch.float64),
                              torch.from_numpy(inv), nblocks)
    jx, jr, jp, jap, jinv = (jnp.asarray(v) for v in (x, r, p, ap, inv))
    # the reference PCG step's lines 4-7a (core/pcg.py:69-72) in float64
    xn, rn = jx + alpha * jp, jr - alpha * jap
    zn = rn * jinv
    rz = make_det_dot(nblocks)(rn, zn)
    for g, w in zip(got[:3], (xn, rn, zn)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15,
                                   atol=1e-15)
    # float64 accumulation (not the TPU kernel's float32); the block sums
    # run in another order inside each block, hence 1e-13 relative
    np.testing.assert_allclose(float(got[3]), float(rz), rtol=1e-13)


@pytest.mark.parametrize("nblocks", [1, 2, 8])
def test_det_dot_matches_reference_det_dot(nblocks):
    a, b = rng_normal(5, 1024), rng_normal(6, 1024)
    want = float(make_det_dot(nblocks)(jnp.asarray(a), jnp.asarray(b)))
    got = ops.det_dot(torch.from_numpy(a), torch.from_numpy(b), nblocks)
    assert got.dim() == 0 and got.dtype == torch.float64
    # same per-block partials and left-to-right chain; only the order
    # inside each block's sum may differ
    np.testing.assert_allclose(float(got), want, rtol=1e-13)


def test_ref_module_names_the_plain_versions():
    from repro_torch.kernels import ref

    assert ref.stencil7_ref is stencil7.stencil7_plain
    assert ref.fused_cg_update_ref is fused_cg.fused_cg_update_plain


def test_cpu_calls_launch_no_kernel():
    ops.reset_launch_counts()
    u = torch.zeros(4, 4, 4, dtype=torch.float64)
    ops.stencil7(u)
    ops.det_dot(u.reshape(-1), u.reshape(-1), 4)
    lanes = u.reshape(4, -1)
    ops.det_dot_lanes(lanes, lanes)
    ops.fused_cg_update_lanes(lanes, lanes, lanes, lanes,
                              torch.ones(4, dtype=torch.float64), lanes)
    ops.stencil7_halo(u[:2], None, u[2])
    assert ops.launch_counts() == {"stencil7": 0, "fused_cg_update": 0,
                                   "det_dot": 0, "gf256_rs_encode": 0,
                                   "fused_cg_update_persist": 0,
                                   "fused_cg_update_lanes": 0,
                                   "det_dot_lanes": 0, "stencil7_halo": 0}


@pytest.mark.parametrize("nblocks", [1, 4])
def test_det_rowdots_matches_reference(nblocks):
    from repro.core.spmv import make_det_rowdots as ref_rowdots
    from repro_torch.core.spmv import make_det_rowdots

    m, w = rng_normal(7, 3, 64), rng_normal(8, 64)
    want = np.asarray(ref_rowdots(nblocks)(jnp.asarray(m), jnp.asarray(w)))
    got = make_det_rowdots(nblocks)(torch.from_numpy(m), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13)


# ----------------------------------------------------------------------
# det_dot's reduction order (csrc/fused_cg.cu, det_dot_order_plain)
# ----------------------------------------------------------------------
CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"
ORDER_DTYPES = {"float64": (np.float64, torch.float64, jnp.float64, 1e-12),
                "float32": (np.float32, torch.float32, jnp.float32, 1e-4),
                "bfloat16": (np.float32, torch.bfloat16, None, 3e-2)}


def test_order_constants_match_the_cuda_source():
    text = (CSRC / "fused_cg.cu").read_text()
    defined = dict(re.findall(r"#define (\w+) (.+)", text))
    assert int(defined["THREADS"]) == fused_cg.THREADS
    assert int(defined["ITEMS"]) == fused_cg.ITEMS
    assert defined["WARPS"] == "(THREADS / 32)"
    assert fused_cg.WARPS == fused_cg.THREADS // 32
    assert fused_cg.TILE == fused_cg.THREADS * fused_cg.ITEMS


@pytest.mark.parametrize("dtype", list(ORDER_DTYPES))
@pytest.mark.parametrize("nblocks", [1, 3, 8])
@pytest.mark.parametrize("block_size", [1, 4097, 2 * 4096 + 13])
def test_det_dot_order_plain_matches_block_dot_and_reference(dtype, nblocks,
                                                             block_size):
    np_dt, t_dt, j_dt, rtol = ORDER_DTYPES[dtype]
    n = nblocks * block_size
    a = rng_normal(nblocks * 100 + block_size, n, dtype=np_dt)
    b = rng_normal(nblocks * 100 + block_size + 1, n, dtype=np_dt)
    ta, tb = torch.from_numpy(a).to(t_dt), torch.from_numpy(b).to(t_dt)
    got = fused_cg.det_dot_order_plain(ta, tb, nblocks)
    assert got.dim() == 0 and got.dtype == t_dt
    want = float(fused_cg.block_dot_plain(ta, tb, nblocks))
    scale = float((ta.double() * tb.double()).abs().sum())
    assert abs(float(got) - want) <= rtol * scale
    if j_dt is not None:
        ref = float(make_det_dot(nblocks)(jnp.asarray(a, j_dt),
                                          jnp.asarray(b, j_dt)))
        assert abs(float(got) - ref) <= rtol * scale


def _scalar_order_dot(a, b, nblocks, one):
    """The order in fused_cg.cu's header comment, one addition at a time,
    with ``one(x)`` rounding to the accumulation type."""
    threads, items = fused_cg.THREADS, fused_cg.ITEMS
    vec = 16 // a.itemsize

    def tree(values):
        while len(values) > 1:
            h = len(values) // 2
            values = [one(values[i] + values[i + h]) for i in range(h)]
        return values[0]

    def cta(per_thread):
        warps = [tree(per_thread[w * 32:(w + 1) * 32])
                 for w in range(fused_cg.WARPS)]
        return tree(warps)

    bs = a.shape[0] // nblocks
    tiles = -(-bs // fused_cg.TILE)
    block_sums = []
    for blk in range(nblocks):
        tile_sums = []
        for tile in range(tiles):
            per_thread = []
            for t in range(threads):
                local = one(0.0)
                for g in range(items // vec):
                    for v in range(vec):
                        off = tile * fused_cg.TILE + (g * threads + t) * vec + v
                        if off < bs:
                            i = blk * bs + off
                            local = one(local + one(one(a[i]) * one(b[i])))
                per_thread.append(local)
            tile_sums.append(cta(per_thread))
        per_thread = []
        for t in range(threads):
            s = one(0.0)
            for j in range(t, tiles, threads):
                s = one(s + tile_sums[j])
            per_thread.append(s)
        block_sums.append(cta(per_thread))
    total = block_sums[0]
    for s in block_sums[1:]:
        total = one(total + s)
    return total


@pytest.mark.parametrize("dtype,n,nblocks", [
    ("float64", 3 * (4096 + 37), 3), ("float64", 8 * 1001, 8),
    ("float64", 2 * 4096 + 5, 1), ("float64", 257 * 4096 + 5, 1),
    ("float32", 3 * (4096 + 37), 3), ("float32", 8 * 1001, 8)])
def test_det_dot_order_plain_equals_the_documented_order(dtype, n, nblocks):
    """The vectorised emulation adds in exactly the order the CUDA source
    documents (steps 1-4), bit for bit; the last float64 case has more
    tile partials than threads, so step 3 runs two rounds."""
    np_dt = np.float64 if dtype == "float64" else np.float32
    a = rng_normal(n, n, dtype=np_dt)
    b = rng_normal(n + 1, n, dtype=np_dt)
    one = float if dtype == "float64" else np.float32
    want = _scalar_order_dot(a, b, nblocks, one)
    got = fused_cg.det_dot_order_plain(torch.from_numpy(a),
                                       torch.from_numpy(b), nblocks)
    assert np.asarray(got.item(), np_dt).tobytes() == \
        np.asarray(want, np_dt).tobytes()
