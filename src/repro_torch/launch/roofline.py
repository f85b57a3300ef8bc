"""Roofline terms of the port's kernels and solver steps, counted from the
functions (port of ``repro/launch/roofline.py``).

The reference reads FLOPs and bytes from a compiled XLA program
(``cost_analysis``) and collective bytes from its HLO text.  PyTorch has
no such compile, so the port counts each function's **compulsory** work
from its shapes: every input read once, every output written once, and
the operations the function does on them (one per rounded multiply, add
or subtract).  A count depends on the function and its arguments alone,
never on the launches that ran, so a faster implementation of the same
function is held against the same bound.  The kernels' counts are the
ones ``chip_smoke.py`` prints beside each kernel's times; a step's count
is the sum of its functions in the reference's decomposition (SpMV,
``p.Ap``, the fused update, ``p = z + beta p``, the ESR copy).

``chips`` counts the data mesh's shards (the reference's devices), all
on the one card.  A :class:`Roofline` holds the card's totals (every
shard's work) and its time terms are the card's; :meth:`Roofline.as_row`
writes the ``*_per_chip`` counts per shard, the card's total over its
shards, as the reference's rows count one device's program.  A halo
plane or a shard sum moves between shards as a device-to-device copy
through the card's HBM; ``coll_by_kind`` names the halo planes
``collective-permute``, the gathered shard sums ``all-reduce`` and the
in-memory ESR replica of ``p`` ``all-gather`` (the reference's kind
names).

For LM serving, :func:`model_flops` is the reference's MODEL_FLOPS
formula and :func:`decode_step_bytes` counts a greedy decode step's
compulsory bytes from the model's and the caches' shapes (built on the
meta device: nothing is allocated).

For the LM dry run's cells the work is counted, not derived: an
:class:`OpCounter` dispatch mode over one step that really runs counts
its products' operations (``torch.utils.flop_counter``'s registry) and
every ATen op's input and output bytes, the eager counterpart of XLA's
``cost_analysis``; :func:`lm_collectives` counts, from the cell's
shapes and its layout under the axis rules, the bytes each chip must
exchange over the network.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed.sharding import spec_for_shape
from repro_torch.kernels.fused_cg import fused_pass_traffic
from repro_torch.launch.mesh import peak_ops
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.layers import Init
from repro_torch.models.registry import build_model, param_specs

DType = Union[str, torch.dtype]


def _dtype_name(dtype: DType) -> str:
    return str(dtype).replace("torch.", "")


def _itemsize(dtype: DType) -> int:
    return torch.empty((), dtype=getattr(torch, _dtype_name(dtype))
                       ).element_size()


def _acc_itemsize(dtype: DType) -> int:
    """Bytes of one reduction result for inputs of ``dtype`` (float64
    accumulates in float64, float32 and bfloat16 in float32)."""
    return 8 if _dtype_name(dtype) == "float64" else 4


@dataclasses.dataclass(frozen=True)
class Work:
    """The compulsory bytes and operations of one function call."""

    nbytes: float
    ops: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.nbytes + other.nbytes, self.ops + other.ops)


def bound_ms(work: Work, dtype: DType, rate: float) -> Tuple[float, str]:
    """The least time (ms) the card could take for ``work`` and what
    bounds it: the larger of its bytes over the HBM ``rate`` and its
    operations over the peak rate of ``dtype``."""
    t_bytes = work.nbytes / rate
    t_ops = work.ops / peak_ops(dtype) if work.ops else 0.0
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ----------------------------------------------------------------------
# One count per kernel function; ``n`` counts every value of the call
# (every lane's, in a lane mode)
# ----------------------------------------------------------------------
def stencil7_work(n: int, dtype: DType) -> Work:
    """K1, ``A u`` on ``n`` grid points: ``u`` read, ``A u`` written; one
    multiply and six subtracts a point."""
    return Work(2 * n * _itemsize(dtype), 7 * n)


def stencil7_halo_work(m: int, plane: int, halos: int, dtype: DType) -> Work:
    """K1's halo mode on one slab of ``m`` points: the slab and its
    ``halos`` (0-2) neighbour planes of ``plane`` points read, the slab
    written."""
    return Work((2 * m + halos * plane) * _itemsize(dtype), 7 * m)


def fused_cg_update_work(n: int, dtype: DType) -> Work:
    """K2 (and its lane mode), ``x', r', z'`` and ``r'.z'``: ``x, r, p,
    ap, inv_diag`` read, ``x', r', z'`` written; seven operations a
    value."""
    return Work(8 * n * _itemsize(dtype), 7 * n)


def det_dot_work(n: int, dtype: DType) -> Work:
    """det_dot (and its lane mode), ``sum a b``: ``a, b`` read; a
    multiply and an add a value."""
    return Work(2 * n * _itemsize(dtype), 2 * n)


def gf256_rs_encode_work(k_data: int, length: int, nparity: int) -> Work:
    """K3, the P/Q parity of a ``(K, L)`` byte stripe: the data bytes
    read, the parity bytes written (byte operations, counted as none)."""
    return Work((k_data + nparity) * length, 0)


def fused_cg_update_persist_work(n: int, dtype: DType, k_data: int,
                                 nparity: int) -> Work:
    """K4, K2 plus the staged chunks and parity of ``p``
    (``kernels/fused_cg.py::fused_pass_traffic``)."""
    traffic = fused_pass_traffic(n, _itemsize(dtype), k_data, nparity)
    return Work(traffic["total_bytes"], 7 * n)


def p_update_work(n: int, dtype: DType) -> Work:
    """``p = z + beta p``: ``z, p`` read, ``p`` written; a multiply and
    an add a value."""
    return Work(3 * n * _itemsize(dtype), 2 * n)


# ----------------------------------------------------------------------
# The roofline of a step
# ----------------------------------------------------------------------
@dataclasses.dataclass
class Roofline:
    """A step's compulsory work on the card and its three time terms.

    ``flops`` and ``hbm_bytes`` are the card's counts (for a solver step
    the kernels' and the vector update's compulsory work on the whole
    card; for an LM cell one chip's share of what :class:`OpCounter`
    counts, each chip a card of its own: the products' operations only,
    and the eager program's ATen traffic, which is no compulsory bound,
    so there ``t_memory``, ``bottleneck`` and ``step_time_lb`` describe
    the eager program, not a lower bound); ``coll_bytes``
    the bytes moved between shards or chips (``coll_by_kind``);
    ``chips`` the shards whose work the card holds (1 for an LM cell);
    ``hbm_rate`` the card's HBM rate
    (:func:`repro_torch.launch.mesh.device_hbm_rate`: read from the card,
    given on the CPU, never assumed) and ``dtype`` the dtype of the
    peak rate the operations are held to.  ``coll_rate`` is the rate
    the collectives move at: ``None`` for shards on one card, whose
    collective bytes are device-to-device copies through HBM, or the
    network's (:data:`repro_torch.launch.mesh.NETWORK_RATE`) for chips
    on cards of their own."""

    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_by_kind: Dict[str, int]
    chips: int
    hbm_rate: float
    dtype: str = "float32"
    coll_rate: Optional[float] = None

    @property
    def t_compute(self) -> float:
        """Operations over the card's peak rate for the dtype."""
        return self.flops / peak_ops(self.dtype)

    @property
    def t_memory(self) -> float:
        """The counted bytes over the card's HBM rate."""
        return self.hbm_bytes / self.hbm_rate

    @property
    def t_collective(self) -> float:
        """Over the network: the collective bytes over ``coll_rate``.  On
        one card: the shard-to-shard bytes as copies, each byte read and
        written once through HBM, so twice the bytes over the HBM
        rate."""
        if self.coll_rate is not None:
            return self.coll_bytes / self.coll_rate
        return 2 * self.coll_bytes / self.hbm_rate

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lb(self) -> float:
        """Lower bound on the step's time on the card where the counts
        are compulsory (a solver step; an LM cell's counted traffic makes
        it the eager program's roofline time instead).  On one card the
        copies share HBM with the kernels, so the memory and collective
        terms add and compute overlaps them; over the network the three
        overlap (the reference's perfect-overlap bound)."""
        if self.coll_rate is not None:
            return max(self.t_compute, self.t_memory, self.t_collective)
        return max(self.t_compute, self.t_memory + self.t_collective)

    def as_row(self) -> Dict[str, float]:
        """The reference's row: the card's time terms, and the counts
        per shard (the card's totals over ``chips``)."""
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "flops_per_chip": self.flops / self.chips,
            "hbm_bytes_per_chip": self.hbm_bytes / self.chips,
            "coll_bytes_per_chip": self.coll_bytes / self.chips,
        }


def pcg_step_roofline(grid: Sequence[int], dtype: DType, nshards: int = 1,
                      nblocks: int = 1, sum_dtype: Optional[DType] = None,
                      esr_mode: str = "nvm", *, hbm_rate: float) -> Roofline:
    """One Jacobi-preconditioned PCG iteration on ``grid`` (``(nz, ny,
    nx)``, or ``(lanes, nz, ny, nx)`` for a service bucket's stacked
    lanes): K1 for ``A p`` (its halo mode a z-slab when ``nshards > 1``,
    with each interior boundary's two planes copied), det_dot for
    ``p.Ap``, K2 for the update and ``r'.z'``, then ``p = z + beta p``.
    With ``nshards > 1`` both reductions gather their ``nblocks`` block
    sums (of ``sum_dtype``, the reduction's own type by default) before
    the chain; with ``esr_mode="inmemory"`` the step copies the new
    ``p`` into the replicated ESR buffer.  ``hbm_rate`` is the card's
    (bytes/s)."""
    n = math.prod(grid)
    work = (det_dot_work(n, dtype) + fused_cg_update_work(n, dtype)
            + p_update_work(n, dtype))
    coll: Dict[str, int] = {}
    if nshards == 1:
        work = work + stencil7_work(n, dtype)
    else:
        if len(grid) != 3 or grid[0] % nshards:
            raise ValueError(f"a sharded step takes an (nz, ny, nx) grid "
                             f"whose nz divides into {nshards} slabs, got "
                             f"{tuple(grid)}")
        plane = grid[1] * grid[2]
        slab = n // nshards
        for s in range(nshards):
            halos = (s > 0) + (s < nshards - 1)
            work = work + stencil7_halo_work(slab, plane, halos, dtype)
        coll["collective-permute"] = (2 * (nshards - 1) * plane
                                      * _itemsize(dtype))
        sums = (_itemsize(sum_dtype) if sum_dtype is not None
                else _acc_itemsize(dtype))
        coll["all-reduce"] = 2 * nblocks * sums
    if esr_mode == "inmemory":
        coll["all-gather"] = n * _itemsize(dtype)
    elif esr_mode not in ("nvm", "none"):
        raise ValueError(f"unknown esr_mode {esr_mode!r}")
    return Roofline(flops=float(work.ops), hbm_bytes=float(work.nbytes),
                    coll_bytes=float(sum(coll.values())), coll_by_kind=coll,
                    chips=nshards, hbm_rate=hbm_rate,
                    dtype=_dtype_name(dtype))


def grid_step_roofline(variant: str, grid: Sequence[int], dtype: DType,
                       nshards: int, esr_mode: str = "nvm", *,
                       hbm_rate: float) -> Roofline:
    """The sharded grid steps of :mod:`repro_torch.core.spmv`:
    ``"auto"`` (:func:`~repro_torch.core.spmv.make_sharded_pcg_step`,
    shard sums of the grid's reduction type) and ``"shardmap"``
    (:func:`~repro_torch.core.spmv.make_shardmap_pcg_step`, float32
    shard sums), one lane a shard."""
    if variant not in ("auto", "shardmap"):
        raise ValueError(f"unknown variant {variant!r}")
    return pcg_step_roofline(
        grid, dtype, nshards=nshards, nblocks=nshards,
        sum_dtype="float32" if variant == "shardmap" else None,
        esr_mode=esr_mode, hbm_rate=hbm_rate)


# ----------------------------------------------------------------------
# LM serving: the reference's MODEL_FLOPS and a decode step's bytes
# ----------------------------------------------------------------------
def model_flops(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS: 6*N*D for training (N = params, dense; N_active MoE),
    2*N*D for prefill, 2*N per token for decode (the reference's
    formula; ``shape`` has ``batch`` and ``seq``)."""
    n_total = cfg.param_count()
    if cfg.n_experts > 0:
        # active params: replace expert MLPs with top_k experts
        gates = 3 if "gated" in cfg.mlp_act else 2
        expert_p = cfg.n_experts * gates * cfg.d_model * cfg.d_ff
        active_p = n_total - cfg.n_layers * expert_p \
            + cfg.n_layers * cfg.top_k * gates * cfg.d_model * cfg.d_ff
    else:
        active_p = n_total
    tokens = shape.batch * (shape.seq if kind != "decode" else 1)
    mult = 6.0 if kind == "train" else 2.0
    return mult * active_p * tokens


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rows_nbytes(t: torch.Tensor, rows: int) -> int:
    """Bytes of ``rows`` rows of ``t`` along its dimension 1."""
    return _nbytes(t) // t.shape[1] * rows


def decode_step_bytes(cfg, batch: int, position: int) -> int:
    """The compulsory HBM bytes of one greedy decode step of ``batch``
    rows at ``position`` (the cache index), from the model's and the
    caches' shapes:

    - every parameter the step uses, read once in its stored dtype: the
      embedding tables give only the rows gathered (``batch`` token rows,
      one position row), unless tied, when the whole table is read as
      the unembedding; an MoE layer reads ``min(n_experts, batch *
      top_k)`` experts (each token's ``top_k`` distinct from the
      others'); an encoder-decoder's decode step reads no encoder weight
      and no cross ``wk``/``wv`` (its cross K/V are cached);
    - the caches: a global layer's K/V up to ``position``, a ring's
      occupied slots and its positions, the cross K/V, and the recurrent
      and SSM states read and written; one new K/V row written a layer;
    - the logits written in ``logit_dtype``.
    """
    meta = torch.device("meta")
    model = build_model(cfg, Init(meta))
    total = 0
    for name, param in model.named_parameters():
        parts = name.split(".")
        if parts[0] in ("enc", "enc_pos", "enc_norm") or (
                parts[0] == "dec" and parts[2] == "xattn"
                and parts[3] in ("wk", "wv")):
            continue
        if parts[0] in ("pos_embed", "dec_pos"):
            total += _nbytes(param[0])
        elif parts[0] == "embed":
            total += _nbytes(param) if cfg.tie_embeddings else \
                batch * _nbytes(param[0])
        elif len(parts) > 3 and parts[2] == "moe" and parts[3] != "router":
            total += min(cfg.n_experts, batch * cfg.top_k) * _nbytes(param[0])
        else:
            total += _nbytes(param)

    if cfg.family == "encdec":
        caches = E.init_encdec_cache(cfg, batch, position + 1, cfg.cdt, meta)
        for c in caches:
            total += sum(_nbytes(t) for t in c["cross"].values())
            total += sum(_rows_nbytes(t, position + 1) + _rows_nbytes(t, 1)
                         for t in c["self"].values())
    else:
        caches = T.init_decoder_cache(cfg, batch, position + 1, cfg.cdt, meta)
        for kind, c in zip(T.layer_kinds(cfg), caches):
            if kind in ("global", "local"):
                kv_len = c["k"].shape[1]      # min(window, position + 1)
                total += sum(_rows_nbytes(c[n], kv_len) + _rows_nbytes(c[n], 1)
                             for n in ("k", "v"))
                if "pos" in c:
                    total += _nbytes(c["pos"])
            else:
                total += 2 * sum(_nbytes(t) for t in c.values())
    logit = torch.empty((), dtype=getattr(torch, cfg.logit_dtype))
    return total + batch * cfg.padded_vocab * logit.element_size()


# ----------------------------------------------------------------------
# LM cells: the counted work of a step, and its collective bytes
# ----------------------------------------------------------------------
#: ops that allocate without writing a value: they move no byte
_NO_TRAFFIC = frozenset(("empty", "empty_strided", "empty_like", "new_empty",
                         "new_empty_strided"))


class OpCounter(TorchDispatchMode):
    """Counts every ATen op dispatched while it is active (forward,
    backward and the backward's recompute alike): ``flops``, the
    operations of the products in ``torch.utils.flop_counter``'s
    registry (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions,
    attention kernels: two a multiply-add; any other op adds none, so
    elementwise work is not in it, and a step whose useful work is
    mostly elementwise, an SSM or recurrent decode, counts fewer
    operations than ``model_flops``), and ``nbytes``, the bytes of every
    tensor an op takes and returns (read once, written once): the eager
    program's traffic, f32 temporaries included, not the step's
    compulsory bytes.  A view moves nothing and allocations write
    nothing: neither is counted.  ``ops`` counts every op dispatched."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.nbytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in flop_registry:
            # a composite op (``matmul`` under inference mode) is counted
            # as the ops it decomposes into, as FlopCounterMode counts it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self.ops += 1
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view and packet.__name__ not in _NO_TRAFFIC:
            for t in tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.nbytes += t.numel() * t.element_size()
        return out


def _axes(phys) -> Tuple[str, ...]:
    """The mesh axes of one physical spec entry."""
    return () if phys is None else phys if isinstance(phys, tuple) else (phys,)


def _extent(mesh, axes) -> int:
    return math.prod(int(mesh.shape[a]) for a in axes)


#: the logical axes of a row-parallel product's contraction dimension
#: (its output is a partial sum over the axis' shards)
_ROW_PARALLEL = {"wo": "heads", "w_out": ("mlp", "experts")}


def lm_collectives(cell) -> Dict[str, int]:
    """The bytes one chip must exchange in one step of an LM dry-run
    cell (``repro_torch.models.registry.Cell``), by kind: the compulsory
    transfers its layout under the axis rules implies, counted from the
    shapes.  A ring all-gather or reduce-scatter over ``n`` chips moves
    ``(n-1)/n`` of the whole tensor a chip, an all-reduce twice that.

    - **FSDP gathers** (``all-gather``): every parameter sharded over
      the ``fsdp`` axis (``n_f`` chips) is gathered whole along it
      before use: ``(n_f - 1) x`` its per-device bytes, in the compute
      dtype under ``bf16_gather`` (else the parameter dtype), once a
      step when serving (none under ``serve_resident``, whose rules
      drop ``fsdp``) and twice a microbatch in training (the forward
      and the backward);
    - **gradients** (training): an fsdp-sharded parameter's gradient is
      reduce-scattered back (``reduce-scatter``, ``(n_f - 1) x`` its
      per-device bytes, f32, or the compute dtype under
      ``bf16_gather``), and every gradient is all-reduced over the batch
      axes its parameter is not sharded on (``all-reduce``,
      ``2 (n - 1) / n x`` its per-device bytes), once a step;
    - **row-parallel products** (over ``model``, ``n_m`` chips): the
      output of each product whose contraction dimension is sharded
      over ``model`` (attention's ``wo`` over ``heads``, the MLP's,
      recurrent and SSM blocks' ``w_out`` over ``mlp``, the MoE combine
      over ``experts``) is summed across its shards, in the forward
      and, in training, again in the backward (the input gradient of
      the column-parallel products).  Where the residual stream is
      seq-placed (the rules put ``seq`` on ``model`` and ``n_m``
      divides the stream's positions) the sum is a ``reduce-scatter``
      onto the positions and the next block's input an ``all-gather``
      of them, each ``(n_m - 1) / n_m x b_dev x tokens x d_model`` in
      the compute dtype a layer (``b_dev`` the per-device batch,
      ``tokens`` the step's sequence, ``enc_seq`` for the encoder);
      where it is whole (a decode step's one position) an
      ``all-reduce`` of twice that: the same bytes;
    - **the embedding** of token ids, vocabulary-sharded over
      ``model``: its partial rows are summed as a row-parallel output
      is, the seq layout's ``all-gather`` being the gather of the final
      norm's output before the logits (a stream that is not looked up,
      or whose table is whole, has that gather alone); the encoder's
      seq-placed output is gathered once (``all-gather``) for the cross
      K/V;
    - **the decode softmax over a ``kv_seq``-sharded cache**
      (``all-reduce`` over the cache's sequence shards, ``n``): each
      attention layer combines its shards' partial outputs with their
      running maximum and sum, ``2 (n - 1) / n x b_dev x n_heads x
      (head_dim + 2)`` f32 values.

    Microbatches split the batch, so the products' bytes do not grow
    with them; the vocabulary-sharded loss's logsumexp and the
    resharding of a prefill's K/V into the caches are not counted."""
    cfg, rules, shape = cell.cfg, cell.rules, cell.shape
    mesh = rules.mesh
    train = shape.kind == "train"
    out: Dict[str, float] = {}

    def add(kind: str, nbytes: float) -> None:
        if nbytes > 0:
            out[kind] = out.get(kind, 0) + nbytes

    def ring(n: int) -> float:
        return (n - 1) / n

    batch_axes = set(_axes(spec_for_shape(rules, (shape.batch, 1),
                                          ("batch", None))[0]))
    b_dev = shape.batch // _extent(mesh, batch_axes)
    fsdp_axes = set(_axes(rules.physical("fsdp")))
    cdt, pdt = _itemsize(cfg.cdt), _itemsize(cfg.pdt)
    gather_item = cdt if cfg.bf16_gather else pdt
    grad_item = cdt if cfg.bf16_gather else 4
    gathers = 2 * cfg.microbatches if train else 1
    model_n = int(mesh.shape["model"]) if "model" in mesh.axis_names else 1
    tokens = shape.seq if shape.kind != "decode" else 1
    passes = 2 if train else 1
    act_item = cfg.d_model * cdt * b_dev * passes

    def seq_split(seq: int) -> bool:
        spec = spec_for_shape(rules, (shape.batch, seq, cfg.d_model),
                              ("batch", "seq", None))
        return model_n > 1 and "model" in _axes(spec[1])

    def summed(seq: int, rows: int = 1) -> None:
        # a (b_dev, seq, d) partial over model, ``rows`` layers of it
        act = rows * seq * act_item
        if seq_split(seq):
            add("reduce-scatter", ring(model_n) * act)
            add("all-gather", ring(model_n) * act)
        else:
            add("all-reduce", 2 * ring(model_n) * act)

    specs = param_specs(cfg)
    structs, physical = cell.in_structs[0], cell.in_shardings[0]
    for path, st in structs.items():
        ph = physical[path]
        used = {a for dim in ph.spec for a in _axes(dim)}
        numel = math.prod(ph.shape)
        n_f = _extent(mesh, used & fsdp_axes)
        if n_f > 1:
            add("all-gather", gathers * (n_f - 1) * numel * gather_item)
            if train:
                add("reduce-scatter", (n_f - 1) * numel * grad_item)
        n_r = _extent(mesh, batch_axes - used)
        if train and n_r > 1:
            add("all-reduce", 2 * ring(n_r) * numel * grad_item)

        logical = specs[path]
        want = _ROW_PARALLEL.get(path[-1], ())
        want = want if isinstance(want, tuple) else (want,)
        stacked = path[0] in ("groups", "enc", "dec")
        dim = 1 if stacked else 0
        if (logical[dim] in want and "model" in _axes(ph.spec[dim])
                and not (path[0] == "enc" and shape.kind == "decode")):
            summed(cfg.enc_seq if path[0] == "enc" else tokens,
                   st.shape[0] if stacked else 1)

    looked_up = cfg.frontend != "vision" or shape.kind == "decode"
    if looked_up and "model" in _axes(physical[("embed",)].spec[0]):
        summed(tokens)
    elif seq_split(tokens):
        add("all-gather", ring(model_n) * tokens * act_item)
    if (cfg.family == "encdec" and shape.kind != "decode"
            and seq_split(cfg.enc_seq)):
        add("all-gather", ring(model_n) * cfg.enc_seq * act_item)

    if shape.kind == "decode":
        for path, ph in cell.in_shardings[2].items():
            if path[-1] != "k":
                continue
            n = _extent(mesh, _axes(ph.spec[2 if len(ph.shape) == 5 else 1]))
            rows = ph.shape[0] if len(ph.shape) == 5 else 1
            if n > 1:
                add("all-reduce", rows * 2 * ring(n) * b_dev * cfg.n_heads
                    * (cfg.hd + 2) * 4)
    return {k: int(round(v)) for k, v in out.items()}
