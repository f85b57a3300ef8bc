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
from repro_torch.core import poisson
from repro_torch.kernels import _build, fused_cg, ops, stencil7

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
], ids=["Problem.poisson", "make_poisson_problem", "StencilOperator",
        "problem_from_numpy", "state_from_numpy"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, entry):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_cpu_is_served_when_asked(no_cuda):
    problem = api.Problem.poisson(4, nblocks=2, device="cpu")
    assert problem.device.type == "cpu"
    res = api.solve(problem, api.SolverSpec("pcg", maxiter=3))
    assert res.state.x.device.type == "cpu" and res.iterations == 3


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
    monkeypatch.setattr(fused_cg, "fused_cg_update_plain", plain_called)
    monkeypatch.setattr(fused_cg, "block_dot_plain", plain_called)


@pytest.mark.parametrize("call", [
    lambda v, g: ops.stencil7(g),
    lambda v, g: ops.det_dot(v, v, 4),
    lambda v, g: ops.fused_cg_update(v, v, v, v, v, v, 4),
], ids=["stencil7", "det_dot", "fused_cg_update"])
def test_ops_never_fall_back_for_cuda_tensors(broken_build, call):
    # the fake reaches the failing build (or the wrapper's own checks);
    # a fallback would hit the patched plain versions' AssertionError
    vec = _FakeCudaTensor((64,))
    grid = _FakeCudaTensor((4, 4, 4))
    with pytest.raises((RuntimeError, ValueError)):
        call(vec, grid)


def test_cuda_path_surfaces_the_build_failure(broken_build):
    with pytest.raises(RuntimeError, match="build of stencil7 failed"):
        ops.stencil7(_FakeCudaTensor((4, 4, 4)))
    with pytest.raises(RuntimeError, match="build of fused_cg failed"):
        ops.det_dot(_FakeCudaTensor((64,)), _FakeCudaTensor((64,)), 4)


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
