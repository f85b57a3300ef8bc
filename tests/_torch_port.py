"""Shared helpers for the tests that hold the PyTorch port
(``repro_torch``) against the JAX reference package (``repro``).

Inputs are made with numpy from a seed and handed to both packages, so
the two compute from the same values.  Everything here runs on the CPU
except the :func:`cuda_device` fixture's tests, which need a card and
are marked ``cuda``.
"""
import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip when none is visible (decided per test,
    never at import: pytest-xdist workers must collect the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda")


def rng_normal(seed: int, *shape, dtype=np.float64) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def ref_problem(grid, nblocks, preconditioner="jacobi"):
    """The reference package's Poisson problem (op, b, precond)."""
    from repro.core.poisson import PRECONDITIONERS, make_poisson_problem

    op, b = make_poisson_problem(*grid, nblocks=nblocks)
    return op, b, PRECONDITIONERS[preconditioner](op)


def port_problem(grid, nblocks, b, preconditioner="jacobi"):
    """The port's problem built from the reference's right-hand side."""
    from repro_torch.convert import problem_from_numpy

    return problem_from_numpy(grid, nblocks, np.asarray(b), preconditioner,
                              device="cpu")


def ref_state_numpy(state) -> dict:
    """A reference ``PCGState`` as the numpy dict ``convert`` takes."""
    return {f: np.asarray(getattr(state, f))
            for f in ("x", "r", "z", "p", "rz", "beta_prev")} | {
                "k": int(state.k)}
