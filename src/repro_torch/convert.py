"""Carry the reference package's data across into the port.

A solver has no weights: what crosses between the two packages is the
problem data, the solver state and the persisted slots.  Problems and
states cross as numpy arrays through the functions below; slots cross
through the wire format itself (bytes encoded by either package's
``RecoverySchema.encode`` decode in the other).

An LM's parameters, its training state and its decode caches cross as
the reference's pytrees of numpy arrays (:func:`lm_params_from_numpy`,
:func:`train_state_from_numpy`, :func:`lm_caches_from_numpy` and their
inverses).  The reference stacks a pattern group's
layers along a leading axis (``groups/{j}/...`` of shape ``(n_groups,
...)``, the encoder-decoder's ``enc``/``dec`` and its caches' ``self``/
``cross`` of shape ``(n_layers, ...)``); the port keeps one module, and
one cache, a layer, so layer ``g * period + j`` is row ``g`` of slot
``j``.  numpy has no bfloat16: a bfloat16 array crosses as its float32
values (exact both ways).  With ``mesh=`` the parameters and caches are
placed on a :class:`~repro_torch.distributed.sharding.DeviceMesh` leaf
by leaf (each crosses whole to the mesh's first device, then is split
onto the shards), and placed parameters, moments and caches are
gathered whole on the way back, one leaf at a time (never the whole
model on one device).  A training state crosses the same way: a
checkpoint slot holds whole leaves in the reference's layout, whatever
mesh wrote it, and :func:`train_state_from_numpy` with ``mesh=`` places
each leaf by its spec on any mesh shape (the elastic restore).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.api import Problem, _preconditioner
from repro_torch.core.poisson import StencilOperator
from repro_torch.core.state import PCGState
from repro_torch.distributed.sharding import (DeviceMesh, Placed,
                                              physical_spec, place, to_whole)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init
from repro_torch.models import transformer as T
from repro_torch.models.registry import (build_model, named_leaves,
                                         place_parameters,
                                         reference_cache_path,
                                         reference_path, serving_rules)
from repro_torch.solvers.bicgstab import BiCGStabState
from repro_torch.solvers.chebyshev import ChebyshevState
from repro_torch.solvers.gmres import GMRESState
from repro_torch.solvers.jacobi import JacobiState

#: solver name -> its state class (every field but ``k`` is a tensor:
#: block vectors, or 0-d scalars)
STATE_CLASSES = {
    "pcg": PCGState,
    "jacobi": JacobiState,
    "chebyshev": ChebyshevState,
    "bicgstab": BiCGStabState,
    "gmres": GMRESState,
}


def problem_from_numpy(grid: Sequence[int], nblocks: int, b: np.ndarray,
                       preconditioner: str = "jacobi",
                       device: Union[str, torch.device] = "cuda") -> Problem:
    """The Poisson problem on ``grid = (nz, ny, nx)`` with right-hand side
    ``b`` (its dtype is the problem's), placed on ``device``, with the
    named preconditioner (``"identity"``, ``"jacobi"`` or
    ``"block_jacobi"``)."""
    dev = resolve_device(device)
    b_t = torch.as_tensor(np.array(b)).to(dev).reshape(-1)
    nz, ny, nx = grid
    op = StencilOperator(nz, ny, nx, nblocks, dtype=b_t.dtype, device=dev)
    if b_t.numel() != op.n:
        raise ValueError(f"b has {b_t.numel()} values, grid {tuple(grid)} "
                         f"needs {op.n}")
    return Problem(op=op, b=b_t, precond=_preconditioner(preconditioner, op))


#: the 0-d reduction/recurrence scalars among the state fields
_SCALARS = frozenset({"rz", "beta_prev", "alpha", "rho", "omega"})


def _state_class(fields: Mapping[str, np.ndarray], solver: Optional[str]):
    if solver is not None:
        return STATE_CLASSES[solver]
    matches = sorted(name for name, cls in STATE_CLASSES.items()
                     if set(cls._fields) == set(fields))
    if len(matches) != 1:
        raise ValueError(
            f"fields {sorted(fields)} match the states of {matches}; name "
            f"the solver (one of {sorted(STATE_CLASSES)})")
    return STATE_CLASSES[matches[0]]


def state_from_numpy(fields: Mapping[str, np.ndarray],
                     device: Union[str, torch.device] = "cuda",
                     solver: Optional[str] = None):
    """A solver state from numpy fields (block vectors, scalars and the
    iteration count ``k``), placed on ``device``.  The state class is
    ``solver``'s (``"pcg"``, ``"jacobi"``, ``"chebyshev"``,
    ``"bicgstab"``, ``"gmres"``) or, without it, the one whose field set
    the mapping has (Jacobi and GMRES share ``x, r, k``: name one)."""
    dev = resolve_device(device)
    cls = _state_class(fields, solver)
    vals = {f: torch.as_tensor(np.array(fields[f])).to(dev)
            for f in cls._fields if f != "k"}
    for f in _SCALARS.intersection(vals):
        vals[f] = vals[f].reshape(())
    return cls(k=int(fields["k"]), **vals)


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """The inverse of :func:`state_from_numpy` (host copies; ``k`` is an
    ``int``)."""
    out: Dict[str, object] = {f: getattr(state, f).detach().cpu().numpy()
                              for f in state._fields if f != "k"}
    out["k"] = int(state.k)
    return out


# ----------------------------------------------------------------------
# LM parameters and caches
# ----------------------------------------------------------------------
def _tensor(arr, device: torch.device,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A numpy (or ml_dtypes bfloat16) array as a tensor on ``device``."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.as_tensor(np.array(a))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def _numpy(t: Union[torch.Tensor, Placed]) -> np.ndarray:
    """A host copy of ``t`` (never a view of a CPU tensor, which a train
    step goes on updating in place); a placed tensor gathered whole."""
    if isinstance(t, Placed):
        t = to_whole(t)
    t = t.detach().to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _get(tree: Mapping[str, Any], path: Sequence[str]):
    for key in path:
        tree = tree[key]
    return tree


def lm_params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any],
                         device: Union[str, torch.device] = "cuda",
                         mesh: Optional[DeviceMesh] = None
                         ) -> torch.nn.Module:
    """The port's model of ``cfg`` holding the reference's parameters
    ``tree`` (the pytree of ``repro.models.registry.init_params``, as
    numpy arrays), on ``device``, or with ``mesh`` placed on it by the
    serving rules (``registry.place_parameters``)."""
    dev = resolve_device(device if mesh is None else mesh.device)
    model = build_model(cfg, Init(torch.device("meta")))

    def values():
        for name, param in list(model.named_parameters()):
            path, row = reference_path(cfg, name)
            arr = _get(tree, path)
            val = _tensor(arr if row is None else np.asarray(arr)[row], dev,
                          param.dtype)
            if val.shape != param.shape:
                raise ValueError(f"{'/'.join(path)}: shape {tuple(val.shape)}, "
                                 f"the port's {name} is {tuple(param.shape)}")
            yield name, val

    if mesh is not None:
        return place_parameters(model, mesh, values())
    model = model.to_empty(device=dev)
    with torch.no_grad():
        for name, val in values():
            model.get_parameter(name).copy_(val)
    return model


def _nest(flat: Dict[Tuple[str, ...], Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, val in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return out


def _ref_tree(cfg: ModelConfig, named) -> Dict[str, Any]:
    """The reference's pytree of ``named`` (pairs of a parameter name and
    a tensor keyed like it), as numpy arrays: a stacked leaf's rows are
    copied into one array, row by row."""
    rows: Dict[Tuple[str, ...], Dict[int, torch.Tensor]] = {}
    flat: Dict[Tuple[str, ...], Any] = {}
    for name, t in named:
        path, row = reference_path(cfg, name)
        if row is None:
            flat[path] = _numpy(t)
        else:
            rows.setdefault(path, {})[row] = t
    for path, by_row in rows.items():
        first = _numpy(by_row[0])
        out = np.empty((len(by_row),) + first.shape, first.dtype)
        out[0] = first
        for r in range(1, len(by_row)):
            out[r] = _numpy(by_row[r])
        flat[path] = out
    tree = _nest(flat)
    if cfg.family != "encdec":
        tree.setdefault("tail", {})     # the reference's, empty or not
    return tree


def lm_params_to_numpy(model: torch.nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`lm_params_from_numpy`: the reference's
    pytree of the model's parameters, as numpy arrays (a placed model's
    leaves gathered whole one at a time)."""
    return _ref_tree(model.cfg, named_leaves(model))


def train_state_to_numpy(model: torch.nn.Module,
                         opt_state: Mapping[str, Any]) -> Dict[str, Any]:
    """The training state as the reference's tree: ``{"params": tree,
    "opt": {"m": tree, "v": tree, "step": int32}}`` with stacked groups,
    as numpy arrays (host copies; bfloat16 moments as their float32
    values).  It is what a checkpoint slot holds in both packages.  A
    placed model's parameters and moments are gathered whole one leaf at
    a time, so its tree is the one-device state's of the same values.
    The error-feedback residual of ``compress_grads`` is not carried."""
    if "ef" in opt_state:
        raise ValueError("the error-feedback residual (opt_state['ef']) "
                         "has no place in the reference's train state")
    cfg = model.cfg
    return {"params": lm_params_to_numpy(model),
            "opt": {"m": _ref_tree(cfg, opt_state["m"].items()),
                    "v": _ref_tree(cfg, opt_state["v"].items()),
                    "step": np.asarray(int(opt_state["step"]), np.int32)}}


def train_state_like(cfg: ModelConfig) -> Dict[str, Any]:
    """The structure of :func:`train_state_to_numpy`'s tree for ``cfg``,
    its leaves empty stand-ins: the ``like`` a checkpoint restore reads
    the keys from, with no copy of the state."""
    model = build_model(cfg, Init(torch.device("meta")))
    stand_in = {reference_path(cfg, name)[0]: np.empty(0, np.float32)
                for name, _ in model.named_parameters()}
    tree = _nest(stand_in)
    return {"params": tree, "opt": {"m": tree, "v": tree,
                                    "step": np.empty(0, np.int32)}}


def train_state_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any],
                           device: Union[str, torch.device] = "cuda",
                           mesh: Optional[DeviceMesh] = None
                           ) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """The inverse of :func:`train_state_to_numpy`: the model of ``cfg``
    and its optimizer state (``adamw_init``'s layout; each moment keeps
    its array's dtype) on ``device``, from the reference's train state
    ``tree`` (numpy arrays).  With ``mesh`` the parameters are placed by
    the serving rules (:func:`lm_params_from_numpy`) and each moment
    with its parameter's spec, leaf by leaf, whatever mesh (or one
    device) the tree was written from; ``step`` lives on the mesh's
    first device."""
    dev = resolve_device(device if mesh is None else mesh.device)
    model = lm_params_from_numpy(cfg, tree["params"], dev, mesh=mesh)
    moments = {}
    for part in ("m", "v"):
        moments[part] = {}
        for name, param in named_leaves(model):
            path, row = reference_path(cfg, name)
            arr = _get(tree["opt"][part], path)
            val = _tensor(arr if row is None else np.asarray(arr)[row], dev)
            moments[part][name] = (place(val, mesh, param.spec)
                                   if isinstance(param, Placed) else val)
    step = torch.tensor(int(np.asarray(tree["opt"]["step"])),
                        dtype=torch.int32, device=dev)
    return model, {"m": moments["m"], "v": moments["v"], "step": step}


def lm_caches_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any],
                         device: Union[str, torch.device] = "cuda",
                         mesh: Optional[DeviceMesh] = None
                         ) -> List[Dict[str, Any]]:
    """The port's per-layer caches from the reference's cache pytree
    (``repro.models.registry.init_caches``' first half, or a step's
    returned caches), as numpy arrays, on ``device`` in the compute
    dtype (ring positions stay int32), or with ``mesh`` placed on it by
    the caches' logical specs under the serving rules, layer by
    layer."""
    dev = resolve_device(device if mesh is None else mesh.device)

    def conv(a):
        a = np.asarray(a)
        return _tensor(a, dev, None if a.dtype.kind in "iu" else cfg.cdt)

    if mesh is not None:
        rules = serving_rules(cfg, mesh)

    def placed(entry, specs):
        if mesh is None:
            return entry
        return {n: place(t, mesh, physical_spec(rules, t.shape, specs[n]))
                for n, t in entry.items()}

    if cfg.family == "encdec":
        kv = T.layer_cache_specs("global")
        return [{part: placed({n: conv(np.asarray(a)[i])
                               for n, a in tree[part].items()}, kv)
                 for part in ("self", "cross")}
                for i in range(cfg.n_layers)]
    caches = []
    for layer, kind in enumerate(T.layer_kinds(cfg)):
        path, row = reference_cache_path(cfg, layer)
        entry = _get(tree, path)
        caches.append(placed({n: conv(a if row is None else np.asarray(a)[row])
                              for n, a in entry.items()},
                             T.layer_cache_specs(kind)))
    return caches


def lm_caches_to_numpy(cfg: ModelConfig, caches: Sequence[Mapping[str, Any]]
                       ) -> Dict[str, Any]:
    """The inverse of :func:`lm_caches_from_numpy`: the reference's cache
    pytree, as numpy arrays (bfloat16 values as float32)."""
    if cfg.family == "encdec":
        return {part: {n: np.stack([_numpy(c[part][n]) for c in caches])
                       for n in caches[0][part]}
                for part in ("self", "cross")}
    rows: Dict[Tuple[str, ...], Dict[int, Mapping[str, Any]]] = {}
    flat: Dict[Tuple[str, ...], Any] = {}
    for layer, cache in enumerate(caches):
        path, row = reference_cache_path(cfg, layer)
        if row is None:
            flat[path] = {n: _numpy(t) for n, t in cache.items()}
        else:
            rows.setdefault(path, {})[row] = cache
    for path, by_row in rows.items():
        flat[path] = {n: np.stack([_numpy(by_row[r][n])
                                   for r in range(len(by_row))])
                      for n in by_row[0]}
    out = _nest(flat)
    out.setdefault("groups", {})
    out.setdefault("tail", {})
    return out
