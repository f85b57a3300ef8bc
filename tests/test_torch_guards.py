"""Guards on the port's boundaries.

- ``src/repro_torch`` and ``chip_smoke.py`` import neither JAX nor the
  reference package (an AST scan, and a fresh interpreter that imports
  every port module and finds neither in ``sys.modules``);
- entry points run on CUDA unless asked for the CPU, and raise when no
  CUDA device is visible;
- the ``ops`` seam launches the kernel or raises for a CUDA tensor: it
  never falls back to the plain version;
- ``chip_smoke.py`` exits non-zero, printing no result, without a card
  or outside a checkout.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api, convert
from repro_torch.core import poisson, solve_jit
from repro_torch.kernels import _build, fused_cg, gf256_encode, ops, stencil7
from repro_torch.solvers.driver import SolveConfig

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.relative_to(REPO)}:{node.lineno} imports {bad}"


def test_importing_the_port_loads_no_jax_or_reference():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO}")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def _default_problem_parts():
    problem = api.Problem.poisson(8)
    return problem.op, problem.precond, problem.b


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    lambda: api.Problem.poisson(8),
    lambda: poisson.make_poisson_problem(4, 4, 4, 2),
    lambda: poisson.StencilOperator(4, 4, 4, 2),
    lambda: convert.problem_from_numpy((4, 4, 4), 2, np.zeros(64)),
    lambda: convert.state_from_numpy(
        {f: np.zeros(4) for f in "xrzp"} | {"rz": 0.0, "beta_prev": 0.0,
                                            "k": 0}),
    lambda: api.solve(api.Problem.poisson(8), "pcg",
                      api.ResilienceSpec("erasure(nvm-prd x4+2p)",
                                         fused_persist=True)),
    lambda: api.advise(api.Problem.poisson(8), []),
    lambda: solve_jit(*_default_problem_parts()),
    lambda: api.serve(api.generate_request_trace(0, nrequests=1)),
    lambda: api.SolveService().submit_request(
        api.generate_request_trace(0, nrequests=1)[0]),
], ids=["Problem.poisson", "make_poisson_problem", "StencilOperator",
        "problem_from_numpy", "state_from_numpy", "erasure solve", "advise",
        "solve_jit", "serve", "SolveService.submit_request"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, entry):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_cpu_is_served_when_asked(no_cuda):
    problem = api.Problem.poisson(4, nblocks=2, device="cpu")
    assert problem.device.type == "cpu"
    res = api.solve(problem, api.SolverSpec("pcg", maxiter=3))
    assert res.state.x.device.type == "cpu" and res.iterations == 3


@pytest.mark.parametrize("solver", ["jacobi", "chebyshev", "bicgstab",
                                    "gmres"])
def test_zoo_is_served_on_the_cpu_when_asked(no_cuda, solver):
    ops.reset_launch_counts()
    problem = api.Problem.poisson(4, nblocks=2, device="cpu")
    res = api.solve(problem, api.SolverSpec(solver, maxiter=3),
                    "replicated(nvm-prd x2)")
    # a GMRES(20) cycle solves the 64-unknown problem before the cap
    assert res.state.x.device.type == "cpu" and 1 <= res.iterations <= 3
    assert set(ops.launch_counts().values()) == {0}


def test_advise_and_solve_jit_are_served_on_the_cpu_when_asked(no_cuda):
    problem = api.Problem.poisson(4, nblocks=2, device="cpu")
    assert api.advise(problem, []).chosen is not None
    info = {}
    x, k = solve_jit(problem.op, problem.precond, problem.b, info=info)
    assert x.device.type == "cpu" and k > 0 and info["graph"] is False


@pytest.mark.parametrize("mode", ["sync", "overlap"])
def test_fused_persist_is_served_on_the_cpu_when_asked(no_cuda, mode):
    """The NotImplementedError of the first slice is gone: the fused
    erasure path runs, on the plain versions of K3/K4."""
    assert SolveConfig(fused_persist=True).fused_persist
    ops.reset_launch_counts()
    problem = api.Problem.poisson(8, nblocks=4, device="cpu")
    res = api.solve(problem, api.SolverSpec("pcg", maxiter=6),
                    api.ResilienceSpec("erasure(nvm-prd x4+2p)",
                                       persist_mode=mode, fused_persist=True))
    assert res.iterations == 6 and res.report.persist_events == 7
    assert set(ops.launch_counts().values()) == {0}


class _FakeCudaTensor:
    """Just enough of a CUDA tensor to reach the kernel wrappers' build
    step on a machine without a card."""

    def __init__(self, shape, dtype=torch.float64):
        self.device = torch.device("cuda", 0)
        self.dtype = dtype
        self.shape = torch.Size(shape)
        self.is_cuda = True

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def numel(self):
        return int(np.prod(self.shape))


@pytest.fixture
def broken_build(monkeypatch):
    """A kernel build that fails, and plain versions that must not run."""

    def fail(name):
        raise RuntimeError(f"build of {name} failed")

    def plain_called(*args, **kwargs):
        raise AssertionError("a CUDA tensor fell back to the plain version")

    monkeypatch.setattr(_build, "load", fail)
    monkeypatch.setattr(stencil7, "stencil7_plain", plain_called)
    monkeypatch.setattr(stencil7, "stencil7_halo_plain", plain_called)
    monkeypatch.setattr(fused_cg, "fused_cg_update_plain", plain_called)
    monkeypatch.setattr(fused_cg, "block_dot_plain", plain_called)
    monkeypatch.setattr(fused_cg, "fused_cg_update_persist_plain",
                        plain_called)
    monkeypatch.setattr(fused_cg, "fused_cg_update_lanes_plain", plain_called)
    monkeypatch.setattr(fused_cg, "det_dot_lanes_plain", plain_called)
    monkeypatch.setattr(gf256_encode, "gf256_rs_encode_plain", plain_called)


@pytest.mark.parametrize("call", [
    lambda v, g, b: ops.stencil7(g),
    lambda v, g, b: ops.det_dot(v, v, 4),
    lambda v, g, b: ops.fused_cg_update(v, v, v, v, v, v, 4),
    lambda v, g, b: ops.rs_encode(b, 2),
    lambda v, g, b: ops.fused_cg_update_persist(v, v, v, v, v, v, 4, 4, 2),
    lambda v, g, b: ops.fused_cg_update_lanes(*[_FakeCudaTensor((4, 16))] * 4,
                                              _FakeCudaTensor((4,)),
                                              _FakeCudaTensor((4, 16))),
    lambda v, g, b: ops.det_dot_lanes(_FakeCudaTensor((4, 16)),
                                      _FakeCudaTensor((4, 16))),
    lambda v, g, b: ops.stencil7_halo(g, None, None),
], ids=["stencil7", "det_dot", "fused_cg_update", "rs_encode",
        "fused_cg_update_persist", "fused_cg_update_lanes", "det_dot_lanes",
        "stencil7_halo"])
def test_ops_never_fall_back_for_cuda_tensors(broken_build, call):
    # the fake reaches the failing build (or the wrapper's own checks);
    # a fallback would hit the patched plain versions' AssertionError
    vec = _FakeCudaTensor((64,))
    grid = _FakeCudaTensor((4, 4, 4))
    shards = _FakeCudaTensor((4, 64), torch.uint8)
    with pytest.raises((RuntimeError, ValueError)):
        call(vec, grid, shards)


def test_cuda_path_surfaces_the_build_failure(broken_build):
    with pytest.raises(RuntimeError, match="build of stencil7 failed"):
        ops.stencil7(_FakeCudaTensor((4, 4, 4)))
    with pytest.raises(RuntimeError, match="build of fused_cg failed"):
        ops.det_dot(_FakeCudaTensor((64,)), _FakeCudaTensor((64,)), 4)
    with pytest.raises(RuntimeError, match="build of gf256_encode failed"):
        ops.rs_encode(_FakeCudaTensor((4, 64), torch.uint8), 1)
    with pytest.raises(RuntimeError, match="build of fused_cg failed"):
        ops.det_dot_lanes(_FakeCudaTensor((4, 16)), _FakeCudaTensor((4, 16)))


def test_stripe_hands_tensors_to_the_kernel_seam(monkeypatch):
    """Under a kernel encode mode the stripe encodes a tensor through
    ``ops.rs_encode`` on the tensor's own device (K3 on a card), never
    through the numpy route."""
    from repro_torch.nvm import backend

    seen = []

    def spy(data, nparity):
        seen.append((data.device.type, tuple(data.shape), nparity))
        return gf256_encode.gf256_rs_encode_plain(data, nparity)

    def numpy_route(*args, **kwargs):
        raise AssertionError("a tensor took the numpy encode route")

    monkeypatch.setattr(backend.ops, "rs_encode", spy)
    monkeypatch.setattr(backend.gf256, "rs_encode", numpy_route)
    session = backend.create_backend("erasure(nvm-prd x4+2p)", 4,
                                     16).open_session()
    session.persist(0, {"beta": 0.0},
                    {"p": torch.arange(64, dtype=torch.float64)})
    assert seen == [("cpu", (4, 4 * 4 * 8), 2)]
    assert session.device_to_host_bytes == 6 * 4 * 4 * 8


def test_ops_refuse_other_devices():
    meta = torch.empty(4, 4, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel route"):
        ops.stencil7(meta)


def test_kernel_wrappers_validate_before_launch():
    cpu = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        stencil7.stencil7_cuda(cpu.reshape(2, 2, 2))
    with pytest.raises(ValueError, match="CUDA"):
        fused_cg.det_dot_cuda(cpu, cpu, 2)
    with pytest.raises(TypeError):
        stencil7.stencil7_cuda(_FakeCudaTensor((2, 2, 2), torch.int32))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def _no_result(res):
    return '"ok": true' not in res.stdout


def test_chip_smoke_refuses_a_machine_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         timeout=240, cwd=REPO)
    assert res.returncode != 0 and _no_result(res)


def test_chip_smoke_refuses_to_run_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=240,
                         cwd=tmp_path)
    assert res.returncode != 0 and _no_result(res)
