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


# ----------------------------------------------------------------------
# LM serving: the reference's models carried into the port
# ----------------------------------------------------------------------
#: the reference's decode-consistency tolerance (f32 accumulation-order
#: noise; tests/test_decode_consistency.py)
LM_TOL = 5e-4


def lm_cfg(cfg, compute_dtype="float32"):
    """A SMOKE config in ``compute_dtype``; f32 MoE configs get ample
    capacity (``tests/test_decode_consistency.py``'s ``_f32``)."""
    import dataclasses

    kw = {"compute_dtype": compute_dtype}
    if cfg.n_experts > 0 and compute_dtype == "float32":
        kw["capacity_factor"] = 16.0
    return dataclasses.replace(cfg, **kw)


_REF_LM = {}


def ref_lm(arch, compute_dtype="float32"):
    """The reference's SMOKE model of ``arch``: ``(cfg, params, tree)``
    with params from ``init_params(PRNGKey(0))`` (jitted; the parameters
    do not depend on the compute dtype) and ``tree`` their numpy copy,
    cached per process."""
    import jax
    from repro.models import registry as RR

    base = RR.get_config(arch, smoke=True)
    if arch not in _REF_LM:
        params = jax.jit(lambda key: RR.init_params(base, key)[0])(
            jax.random.PRNGKey(0))
        _REF_LM[arch] = (params, jax.tree.map(np.asarray, params))
    return (lm_cfg(base, compute_dtype),) + _REF_LM[arch]


def port_lm(arch, compute_dtype="float32"):
    """The port's SMOKE model of ``arch`` on the CPU holding the
    reference's parameters: ``(cfg, model)``."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import registry as PR

    cfg = lm_cfg(PR.get_config(arch, smoke=True), compute_dtype)
    return cfg, lm_params_from_numpy(cfg, ref_lm(arch, compute_dtype)[2],
                                     device="cpu")


def lm_inputs(cfg, seed, b, s):
    """Seeded numpy inputs of a forward: tokens ``(b, s)``, plus frames
    for the encoder-decoder, or patch embeddings and three M-RoPE
    position streams for the vision frontend."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        out["tokens"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        out["positions"] = rng.integers(0, 4 * s, (3, b, s)).astype(np.int32)
    return out


def train_inputs(cfg, seed, b, s):
    """:func:`lm_inputs` plus next-token ``targets (b, s)``."""
    out = lm_inputs(cfg, seed, b, s)
    out["targets"] = np.random.default_rng(seed + 1000).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)
    return out


def to_torch(inputs):
    """numpy inputs as CPU tensors (integer arrays as int64)."""
    return {k: torch.as_tensor(v).long() if v.dtype.kind in "iu"
            else torch.as_tensor(v) for k, v in inputs.items()}


def max_abs_diff(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def ref_rows(tree, cfg, names):
    """The reference tree's values of the port's parameters ``names``
    (a stacked leaf's row for a layer), as numpy arrays."""
    from repro_torch.models.registry import reference_path

    out = {}
    for name in names:
        path, row = reference_path(cfg, name)
        leaf = tree
        for key in path:
            leaf = leaf[key]
        leaf = np.asarray(leaf)
        out[name] = leaf if row is None else leaf[row]
    return out


def tree_max_abs_diff(a, b) -> float:
    """Largest difference over two nested dicts of arrays of one
    structure."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (sorted(a), sorted(b))
        return max((tree_max_abs_diff(a[k], b[k]) for k in a), default=0.0)
    return max_abs_diff(a, b)
