"""Two train steps of the port (``repro_torch.training.make_train_step``
over ``make_train_forward``) against the reference's jitted step on the
CPU, for all ten SMOKE configs in f32 compute, and with microbatches and
int8 gradient compression.

The reference's parameters and a fresh ``adamw_init`` state are carried
across by ``repro_torch.convert``; inputs are numpy arrays from a seed.
Tolerance: the parameters, moments, loss and grad norm after each step
within 1e-4 of the reference (relative to each leaf's largest
magnitude).  The gradients already agree within 1e-4 of each leaf's
scale (``tests/test_torch_train_models.py``); Adam divides a moment by
the root of another, so a gradient element near zero can move its update
by up to ``lr`` (3e-6 and 6e-6 in the warmup's first two steps), far
under 1e-4 of parameters of magnitude 0.1-1.  With int8 compression a
gradient element within that f32 noise of a rounding boundary of the
quantizer can land one level apart (``tests/test_torch_train_step.py``),
moving its moments by one quantization step, 1/127 of the leaf's
largest value: the moments are held within 1/127 of their scale a step
there, the parameters and metrics still within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import port_lm, ref_lm, to_torch, train_inputs
from repro.models import registry as RR
from repro.training import optimizer as RO
from repro.training import train_step as RT
from repro_torch import convert
from repro_torch.models import registry as PR
from repro_torch.training import optimizer as PO
from repro_torch.training import train_step as PTS

REL = 1e-4
B, S = 2, 16


def _close_tree(got, want, rel=REL):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close_tree(got[k], want[k], rel)
        return
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if want.size:
        scale = max(float(np.max(np.abs(want))), 1e-30)
        assert float(np.max(np.abs(got - want))) <= rel * scale


def _both_steps(arch, tcfg_kw, steps=2, seed=5, moments_rel=REL):
    rcfg, params, tree = ref_lm(arch)
    np_in = train_inputs(rcfg, seed, B, S)
    rstep = jax.jit(RT.make_train_step(RR.make_train_forward(rcfg),
                                       RO.AdamWConfig(),
                                       RT.TrainConfig(**tcfg_kw)))
    pcfg, model = port_lm(arch)
    pstep = PTS.make_train_step(PR.make_train_forward(pcfg), PO.AdamWConfig(),
                                PTS.TrainConfig(**tcfg_kw))
    p, o = params, RO.adamw_init(params)
    opt = PO.adamw_init(model)
    jin = {k: jnp.asarray(v) for k, v in np_in.items()}
    tin = to_torch(np_in)
    for _ in range(steps):
        p, o, rm = rstep(p, o, jin)
        pm = pstep(model, opt, tin)
        for k in ("loss", "grad_norm", "lr", "aux"):
            assert pm[k].dim() == 0
            _close_tree(pm[k].numpy(), rm[k])
    opt.pop("ef", None)
    got = convert.train_state_to_numpy(model, opt)
    _close_tree(got["params"], jax.tree.map(np.asarray, p))
    assert int(got["opt"]["step"]) == int(o["step"]) == steps
    for k in ("m", "v"):
        _close_tree(got["opt"][k], jax.tree.map(np.asarray, o[k]), moments_rel)
    return model, opt


@pytest.mark.parametrize("arch", PR.ARCH_IDS)
def test_two_train_steps_match_the_reference(arch):
    _both_steps(arch, {})


@pytest.mark.parametrize("tcfg_kw,moments_rel", [
    ({"microbatches": 2}, REL), ({"compress_grads": True}, 2 / 127)],
    ids=["microbatches", "compress_grads"])
def test_train_step_levers_match_the_reference(tcfg_kw, moments_rel):
    _, opt = _both_steps("llama3_8b", tcfg_kw, moments_rel=moments_rel)
    assert int(opt["step"]) == 2


def test_microbatched_positions_split_on_their_batch_axis():
    """M-RoPE positions (3, B, S) split on axis 1, every other input on
    axis 0, into contiguous row blocks."""
    cfg, _ = port_lm("qwen2_vl_72b")
    batch = to_torch(train_inputs(cfg, 2, 4, 8))
    parts = PTS._split(batch, 2)
    assert parts[1]["positions"].shape == (3, 2, 8)
    assert torch.equal(parts[1]["positions"], batch["positions"][:, 2:])
    assert torch.equal(parts[0]["tokens"], batch["tokens"][:2])


def test_train_state_round_trips_through_convert():
    """``train_state_from_numpy`` of ``train_state_to_numpy`` is the same
    model and optimizer state, bitwise; the structure-only ``like`` has
    the same keys."""
    from repro_torch.ft.checkpoint import _leaves

    cfg, model = port_lm("gemma3_12b")
    opt = PO.adamw_init(model)
    step = PTS.make_train_step(PR.make_train_forward(cfg), PO.AdamWConfig())
    step(model, opt, to_torch(train_inputs(cfg, 1, B, S)))
    tree = convert.train_state_to_numpy(model, opt)
    model2, opt2 = convert.train_state_from_numpy(cfg, tree, "cpu")
    for (n, a), (n2, b) in zip(model.named_parameters(),
                               model2.named_parameters()):
        assert n == n2 and torch.equal(a, b)
    for part in ("m", "v"):
        assert all(torch.equal(opt[part][n], opt2[part][n]) for n in opt[part])
    assert opt2["step"].dtype == torch.int32 and int(opt2["step"]) == 1
    assert [k for k, _ in _leaves(convert.train_state_like(cfg))] == \
        [k for k, _ in _leaves(tree)]
    # host copies, not views of the CPU state the next step updates
    before = tree["params"]["embed"].copy()
    with torch.no_grad():
        model.embed.add_(1.0)
        opt["m"]["embed"].add_(1.0)
    assert np.array_equal(tree["params"]["embed"], before)
    assert not np.shares_memory(tree["opt"]["m"]["embed"],
                                opt["m"]["embed"].numpy())
    opt["ef"] = {}
    with pytest.raises(ValueError, match="error-feedback"):
        convert.train_state_to_numpy(model, opt)
