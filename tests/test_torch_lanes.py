"""The lane modes of K2 and ``det_dot`` (``ops.fused_cg_update_lanes``,
``ops.det_dot_lanes``) and the batched lane steps, on the CPU.

The plain lane versions are held against the reference's oracle lane by
lane (``repro.kernels.ref.fused_cg_update_ref`` in float32/bfloat16 at
the reference's own kernel tolerances; the reference PCG step's float64
lines and its ``make_det_dot(1)`` at 1e-15 / 1e-13, as in
test_torch_kernels.py), and each lane against a solo plain call on that
lane with ``nblocks=1``, bitwise — whatever the lane count and whatever
the other lanes hold (a free lane's NaN included).  The batched step of
every batchable solver is bitwise its solo step on each lane's masked
operator.  The CUDA kernels are held to the same solo bits on the card
in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import rng_normal
from repro.core.spmv import make_det_dot
from repro.kernels.ref import fused_cg_update_ref
from repro_torch.kernels import fused_cg, ops
from repro_torch.serving.solve_service import _LaneOperator, _LanePreconditioner
from repro_torch.solvers import SOLVERS
from repro_torch.solvers.driver import make_batched_step

#: the reference's own kernel tolerances (tests/test_kernels.py:45,53)
UPDATE_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-1}
RZ_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _lane_inputs(lanes, n, dtype=torch.float64, seed=0):
    vals = [torch.from_numpy(rng_normal(seed + s, lanes, n)).to(dtype)
            for s in range(4)]
    inv = (0.5 + torch.from_numpy(np.abs(rng_normal(seed + 9, lanes, n)))
           ).to(dtype)
    alpha = torch.from_numpy(0.1 + np.abs(rng_normal(seed + 7, lanes))).to(dtype)
    return vals, inv, alpha


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lanes", [2, 4])
def test_fused_cg_update_lanes_matches_the_reference_oracle(dtype, lanes):
    (x, r, p, ap), inv, alpha = _lane_inputs(lanes, 1024, dtype)
    got = ops.fused_cg_update_lanes(x, r, p, ap, alpha, inv)
    assert got[3].shape == (lanes,)
    tol = UPDATE_TOL[dtype]
    for i in range(lanes):
        jdt = JDT[dtype]
        args = [jnp.asarray(t[i].float().numpy()).astype(jdt)
                for t in (x, r, p, ap)]
        want = fused_cg_update_ref(
            *args, jnp.asarray(float(alpha[i]), jdt),
            jnp.asarray(inv[i].float().numpy()).astype(jdt))
        for g, w, field in zip(got[:3], want[:3], "xrz"):
            np.testing.assert_allclose(g[i].float().numpy(),
                                       np.asarray(w, np.float32), rtol=tol,
                                       atol=tol, err_msg=f"lane {i} {field}")
        rz_rel = (abs(float(got[3][i]) - float(want[3]))
                  / (abs(float(want[3])) + 1e-9))
        assert rz_rel < RZ_REL_TOL[dtype], f"lane {i}"


@pytest.mark.parametrize("lanes", [1, 3])
def test_lanes_float64_match_the_reference_step_lines(lanes):
    (x, r, p, ap), inv, alpha = _lane_inputs(lanes, 8 * 8 * 8)
    got = ops.fused_cg_update_lanes(x, r, p, ap, alpha, inv)
    dots = ops.det_dot_lanes(p, ap)
    dot1 = make_det_dot(1)
    for i in range(lanes):
        a = float(alpha[i])
        jx, jr, jp, jap, jinv = (jnp.asarray(t[i].numpy())
                                 for t in (x, r, p, ap, inv))
        # the reference PCG step's lines 4-7a (core/pcg.py:69-72)
        xn, rn = jx + a * jp, jr - a * jap
        zn = rn * jinv
        for g, w in zip(got[:3], (xn, rn, zn)):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w),
                                       rtol=1e-15, atol=1e-15)
        # float64 accumulation; another order inside the one block
        np.testing.assert_allclose(float(got[3][i]), float(dot1(rn, zn)),
                                   rtol=1e-13)
        np.testing.assert_allclose(float(dots[i]), float(dot1(jp, jap)),
                                   rtol=1e-13)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("lanes", [1, 3, 4])
def test_each_lane_is_a_solo_call_bitwise(dtype, lanes):
    (x, r, p, ap), inv, alpha = _lane_inputs(lanes, 1000, dtype, seed=3)
    got = ops.fused_cg_update_lanes(x, r, p, ap, alpha, inv)
    dots = ops.det_dot_lanes(p, ap)
    for i in range(lanes):
        solo = ops.fused_cg_update(x[i], r[i], p[i], ap[i], alpha[i], inv[i], 1)
        for g, s in zip(got, solo):
            assert torch.equal(g[i], s), f"lane {i}"
        assert torch.equal(dots[i], ops.det_dot(p[i], ap[i], 1))


def test_a_lane_ignores_what_its_cohabitants_hold():
    """A free lane computes 0/0; its NaN must stay in its lane."""
    (x, r, p, ap), inv, alpha = _lane_inputs(4, 512, seed=5)
    clean = ops.fused_cg_update_lanes(x, r, p, ap, alpha, inv)
    clean_dot = ops.det_dot_lanes(p, ap)
    for t in (x, r, p, ap):
        t[2] = float("nan")
    alpha[2] = float("nan")
    dirty = ops.fused_cg_update_lanes(x, r, p, ap, alpha, inv)
    dirty_dot = ops.det_dot_lanes(p, ap)
    for lane in (0, 1, 3):
        for c, d in zip(clean, dirty):
            assert torch.equal(c[lane], d[lane])
        assert torch.equal(clean_dot[lane], dirty_dot[lane])
    assert torch.isnan(dirty[3][2]) and torch.isnan(dirty_dot[2])


def test_lane_plain_versions_are_what_ops_runs_on_the_cpu():
    (x, r, p, ap), inv, alpha = _lane_inputs(2, 64)
    for g, w in zip(ops.fused_cg_update_lanes(x, r, p, ap, alpha, inv),
                    fused_cg.fused_cg_update_lanes_plain(x, r, p, ap, alpha,
                                                         inv)):
        assert torch.equal(g, w)
    assert torch.equal(ops.det_dot_lanes(p, ap),
                       fused_cg.det_dot_lanes_plain(p, ap))


# ---------------------------------------------------------------------------
# The batched lane step: bitwise the solo step on each lane's operator
# ---------------------------------------------------------------------------
BUCKET = (4, 4, 8)
TENANT_GRIDS = ((3, 4, 8), (4, 4, 8), (2, 3, 5))


def _lane_setup(solver_name):
    """Three tenants of a (4, 4, 8) bucket, each with its masked lane
    operator, a Jacobi-like diagonal, a seeded zero-padded b, a solver
    built for it, its initial lane state and its lane params."""
    n = int(np.prod(BUCKET))
    lanes = []
    for i, grid in enumerate(TENANT_GRIDS):
        mask = torch.zeros(BUCKET, dtype=torch.bool)
        mask[:grid[0], :grid[1], :grid[2]] = True
        mask = mask.reshape(-1)
        pdiag = torch.where(mask, torch.tensor(1.0 / 6.0, dtype=torch.float64),
                            torch.tensor(1.0, dtype=torch.float64))
        b = torch.where(mask, torch.from_numpy(0.5 + rng_normal(i, n)), 0.0)
        opts = {"chebyshev": {"lam_min": 0.05 + 0.01 * i, "lam_max": 2.0},
                "jacobi": {"omega": 0.6 + 0.05 * i}}.get(solver_name, {})
        solver = SOLVERS[solver_name](**opts)
        op = _LaneOperator(BUCKET, mask)
        pre = _LanePreconditioner(pdiag)
        init = solver.init_state(op, pre, b)
        lanes.append(dict(mask=mask, pdiag=pdiag, op=op, pre=pre,
                          solver=solver, init=init,
                          params=solver.lane_params()))
    return lanes


@pytest.mark.parametrize("solver_name", ["pcg", "jacobi", "chebyshev",
                                         "bicgstab"])
def test_batched_step_is_the_solo_step_on_every_lane(solver_name):
    lanes = _lane_setup(solver_name)
    stacked = type(lanes[0]["init"])(*[
        torch.tensor([int(lane["init"].k) for lane in lanes]) if f == "k"
        else torch.stack([getattr(lane["init"], f) for lane in lanes])
        for f in lanes[0]["init"]._fields])
    params = {name: torch.stack([torch.as_tensor(lane["params"][name],
                                                 dtype=torch.float64
                                                 ).reshape(-1)
                                 for lane in lanes])
              for name in lanes[0]["params"]}
    data = {"mask": torch.stack([lane["mask"] for lane in lanes]),
            "pdiag": torch.stack([lane["pdiag"] for lane in lanes]),
            "params": params}

    def make_lane_ops(lane):
        def op_apply(x):
            xin = torch.where(lane["mask"], x, 0.0).reshape(-1, *BUCKET)
            return torch.where(lane["mask"], ops.stencil7(xin).reshape(x.shape),
                               x)

        return (op_apply, _LanePreconditioner(lane["pdiag"]),
                lambda a, b: ops.det_dot_lanes(a, b).unsqueeze(-1),
                lane["params"])

    step = make_batched_step(SOLVERS[solver_name], make_lane_ops)
    solo_states = [lane["init"] for lane in lanes]
    solo_steps = [lane["solver"].make_step(lane["op"], lane["pre"])
                  for lane in lanes]
    for _ in range(4):
        stacked = step(stacked, data)
        solo_states = [s(st) for s, st in zip(solo_steps, solo_states)]
        for i, st in enumerate(solo_states):
            for f in st._fields:
                got = getattr(stacked, f)[i]
                want = getattr(st, f)
                if f == "k":
                    assert int(got) == want
                else:
                    assert torch.equal(got, want), f"lane {i} field {f}"


def test_gmres_has_no_batched_step():
    with pytest.raises(NotImplementedError, match="not batchable"):
        make_batched_step(SOLVERS["gmres"], lambda lane: None)
    with pytest.raises(NotImplementedError, match="no batched lane step"):
        SOLVERS["gmres"].lane_step(None, None, None, {})
