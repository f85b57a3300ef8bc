"""The port's training substrate (``repro_torch.training``) against the
reference (``repro.training``) on the CPU: the token cross-entropy, the
AdamW update, int8 error-feedback compression (with the port's
counterparts of ``tests/test_compression.py``) and the data pipeline.

Inputs are numpy arrays from a seed, handed to both packages.
Tolerances:
- f32 results within 1e-6 of the reference relative to each leaf's
  largest magnitude: a few f32 roundings (6e-8 each) of the same
  operations, where XLA and torch may fuse or order them differently;
- bfloat16 moments within one bf16 ulp of the reference's (2^-7 of the
  value): an f32 difference of one rounding can cross a bf16 rounding
  boundary; the parameters moved by them within one ulp of the
  update they feed (``lr`` x 2^-7 a step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.training import compression as RC
from repro.training import data as RD
from repro.training import optimizer as RO
from repro.training import train_step as RT
from repro_torch.models import registry as PR
from repro_torch.training import compression as PC
from repro_torch.training import data as PD
from repro_torch.training import optimizer as PO
from repro_torch.training import train_step as PT

F32_REL = 1e-6


def _close(got, want, rel=F32_REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30) if want.size else 1.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rel * scale, (err, scale)


# ----------------------------------------------------------------------
# token cross-entropy
# ----------------------------------------------------------------------
@pytest.mark.parametrize("z_weight", [0.0, 1e-4, 0.5])
@pytest.mark.parametrize("pad", [0, 24])
def test_token_xent_matches_the_reference(z_weight, pad):
    rng = np.random.default_rng(0)
    logits = (4 * rng.standard_normal((3, 7, 104))).astype(np.float32)
    if pad:
        logits[..., -pad:] = -1e30      # the padded vocabulary's columns
    targets = rng.integers(0, 104 - pad, (3, 7)).astype(np.int32)
    r_loss, r_ce = RT.token_xent(jnp.asarray(logits), jnp.asarray(targets),
                                 z_weight)
    p_loss, p_ce = PT.token_xent(torch.as_tensor(logits),
                                 torch.as_tensor(targets), z_weight)
    _close(p_loss.numpy(), r_loss)
    _close(p_ce.numpy(), r_ce)


def test_token_xent_gradient_matches_the_reference():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 5, 64)).astype(np.float32)
    targets = rng.integers(0, 64, (2, 5)).astype(np.int32)
    want = jax.grad(lambda x: RT.token_xent(x, jnp.asarray(targets), 1e-4)[0])(
        jnp.asarray(logits))
    x = torch.as_tensor(logits).requires_grad_()
    PT.token_xent(x, torch.as_tensor(targets), 1e-4)[0].backward()
    _close(x.grad.numpy(), want)


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------
_SHAPES = {"attn.wq": (8, 4), "b": (16,), "c.d.e": (3, 3, 2), "c.a": (5,)}


def _ref_tree(flat):
    out = {}
    for name, v in flat.items():
        node = out
        parts = name.split(".")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v.astype(jnp.float32)
                                         if v.dtype == jnp.bfloat16 else v)
    return out


def _bf16_ulp_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp), float(np.max(np.abs(got - want) / ulp))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
def test_adamw_update_matches_the_reference(moment_dtype, grad_clip):
    """Three updates of a random tree; the warmup (2 steps) is crossed,
    and with ``grad_clip=1`` the gradients (norm about 20) are clipped."""
    cfg = dict(lr=1e-2, warmup_steps=2, grad_clip=grad_clip,
               moment_dtype=moment_dtype)
    rng = np.random.default_rng(2)
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in _SHAPES.items()}
    grads = [{n: (3 * rng.standard_normal(s)).astype(np.float32)
              for n, s in _SHAPES.items()} for _ in range(3)]

    rp = _ref_tree({n: jnp.asarray(v) for n, v in params.items()})
    ro = RO.adamw_init(rp)
    pp = {n: torch.as_tensor(v.copy()) for n, v in params.items()}
    po = PO.adamw_init(pp)
    for g in grads:
        rp, ro, rm = RO.adamw_update(
            _ref_tree({n: jnp.asarray(v) for n, v in g.items()}), ro, rp,
            RO.AdamWConfig(**cfg))
        pm = PO.adamw_update({n: torch.as_tensor(v) for n, v in g.items()},
                             po, pp, PO.AdamWConfig(**cfg))
        _close(pm["grad_norm"].numpy(), rm["grad_norm"])
        _close(pm["lr"].numpy(), rm["lr"])
        assert pm["lr"].dtype == torch.float32 and pm["lr"].dim() == 0
        assert int(po["step"]) == int(ro["step"])
        ref_p, ref_m, ref_v = _flat(rp), _flat(ro["m"]), _flat(ro["v"])
        for n in _SHAPES:
            assert po["m"][n].dtype == getattr(torch, moment_dtype)
            if moment_dtype == "float32":
                _close(pp[n].numpy(), ref_p[n])
                _close(po["m"][n].numpy(), ref_m[n])
                _close(po["v"][n].numpy(), ref_v[n])
            else:
                _bf16_ulp_close(po["m"][n].float().numpy(), ref_m[n])
                _bf16_ulp_close(po["v"][n].float().numpy(), ref_v[n])
                assert np.max(np.abs(pp[n].numpy() - ref_p[n])) <= \
                    3 * cfg["lr"] * 2.0 ** -7


def test_global_norm_sums_in_the_reference_leaf_order():
    """The default order is the nested tree's (sorted paths: ``c.a``
    before ``c.d.e``, ``attn.wq`` first); a stacked leaf's rows make one
    term."""
    assert PO.default_order(_SHAPES) == [["attn.wq"], ["b"], ["c.a"],
                                         ["c.d.e"]]
    rng = np.random.default_rng(3)
    rows = {f"r{i}": rng.standard_normal(6).astype(np.float32)
            for i in range(3)}
    got = PO._global_norm({n: torch.as_tensor(v) for n, v in rows.items()},
                          [["r0", "r1", "r2"]])
    want = RO._global_norm([jnp.stack([jnp.asarray(rows[f"r{i}"])
                                       for i in range(3)])])
    _close(got.numpy(), want)


# ----------------------------------------------------------------------
# int8 + error-feedback compression
# ----------------------------------------------------------------------
def _tie(values, scale):
    """Where ``values / scale`` lies within f32 round-off of a .5 tie."""
    x = np.asarray(values, np.float64) / float(scale)
    return np.abs(np.abs(x - np.trunc(x)) - 0.5) < 1e-5 * np.maximum(np.abs(x), 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compression_matches_the_reference(seed):
    """Three error-feedback steps: ``q`` equal except by one where the
    corrected value sits on a .5 tie (both packages round half to
    even, but the division may land either side of it), the scales and
    residuals within f32 round-off, equal byte counts."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (33, 7), "b": (64,)}
    rs = RC.GradCompression.init({n: jnp.zeros(s, jnp.float32)
                                  for n, s in shapes.items()})
    ps = PC.GradCompression.init({n: torch.zeros(s) for n, s in shapes.items()})
    for _ in range(3):
        g = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()}
        g["b"][:8] = np.array([0.5, -1.5, 2.5, 127.0, -127.0, 0.0, 3.0, 1.0],
                              np.float32) * float(np.max(np.abs(g["b"]))) / 127.0
        r_res = {n: np.asarray(v) for n, v in rs.residual.items()}
        rc, rs = rs.compress({n: jnp.asarray(v) for n, v in g.items()})
        pc, ps = ps.compress({n: torch.as_tensor(v) for n, v in g.items()},
                             [[n] for n in shapes])
        assert PC.compressed_bytes(pc) == RC.compressed_bytes(rc)
        for n in shapes:
            scale = float(rc.scale[n])
            _close(pc.scale[(n,)].numpy(), rc.scale[n])
            q_r, q_p = np.asarray(rc.q[n], np.int32), pc.q[n].numpy().astype(np.int32)
            assert pc.q[n].dtype == torch.int8
            differ = q_r != q_p
            assert np.all(np.abs(q_r - q_p) <= 1)
            assert np.all(_tie(g[n][differ] + r_res[n][differ], scale))
            res_r, res_p = np.asarray(rs.residual[n]), ps.residual[n].numpy()
            assert np.all(np.abs(res_p - res_r)[~differ] <= F32_REL * scale)
            assert np.allclose(np.abs(res_p - res_r)[differ], scale, rtol=1e-5)
        back_r, back_p = RC.decompress(rc), PC.decompress(pc)
        for n in shapes:
            same = np.asarray(rc.q[n]) == pc.q[n].numpy()
            _close(back_p[n].numpy()[same], np.asarray(back_r[n])[same])


def test_compression_scales_a_stacked_leaf_once():
    """A reference leaf that stacks a pattern group's layers has one
    scale, its largest ``max |g|``: the port's per-layer tensors of that
    leaf, named as one group, quantize with it, ``q`` equal to the
    reference's rows except by one on a .5 tie; without the group each
    takes its own."""
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((2, 16, 5)).astype(np.float32)
    rows[1] *= 4.0
    rc, _ = RC.GradCompression.init({"w": jnp.zeros(rows.shape)}).compress(
        {"w": jnp.asarray(rows)})
    tree = {"w.0": torch.as_tensor(rows[0]), "w.1": torch.as_tensor(rows[1])}
    ef = PC.GradCompression.init(tree)
    pc, _ = ef.compress(tree, groups=[["w.0", "w.1"]])
    assert PC.compressed_bytes(pc) == RC.compressed_bytes(rc)
    scale = float(rc.scale["w"])
    _close(pc.scale[("w.0", "w.1")].numpy(), rc.scale["w"])
    for i, name in enumerate(tree):
        q_r = np.asarray(rc.q["w"][i], np.int32)
        q_p = pc.q[name].numpy().astype(np.int32)
        differ = q_r != q_p
        assert np.all(np.abs(q_r - q_p) <= 1)
        assert np.all(_tie(rows[i][differ], scale))
    alone, _ = ef.compress(tree, [["w.0"], ["w.1"]])
    assert float(alone.scale[("w.0",)]) < 0.5 * scale


def test_round_half_to_even_like_jnp():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    assert np.array_equal(torch.round(torch.as_tensor(x)).numpy(),
                          np.asarray(jnp.round(jnp.asarray(x))))


def test_roundtrip_error_bounded():
    tree = {"a": torch.linspace(-3, 3, 128), "b.c": torch.ones((4, 4)) * 0.1}
    ef = PC.GradCompression.init(tree)
    c, ef = ef.compress(tree, [[n] for n in tree])
    back = PC.decompress(c)
    for n, x in tree.items():
        scale = float(torch.max(torch.abs(x))) / 127.0
        assert float(torch.max(torch.abs(x - back[n]))) <= scale * 0.5 + 1e-9


def test_compression_ratio():
    tree = {"w": torch.zeros((1024, 1024))}
    c, _ = PC.GradCompression.init(tree).compress(tree, [["w"]])
    assert PC.compressed_bytes(c) < 1024 * 1024 * 4 / 3.9  # ~4x


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 1000), steps=st.integers(2, 6))
def test_error_feedback_accumulates_to_truth(seed, steps):
    """Summed dequantized grads + final residual == summed true grads:
    error feedback loses nothing over time."""
    rng = np.random.default_rng(seed)
    ef = PC.GradCompression.init({"w": torch.zeros(64)})
    total_q = torch.zeros(64)
    total_true = torch.zeros(64)
    for s in range(steps):
        g = {"w": torch.as_tensor(rng.standard_normal(64).astype(np.float32)
                                  * np.float32(0.1 ** s))}
        total_true = total_true + g["w"]
        c, ef = ef.compress(g, [["w"]])
        total_q = total_q + PC.decompress(c)["w"]
    np.testing.assert_allclose((total_q + ef.residual["w"]).numpy(),
                               total_true.numpy(), rtol=1e-5, atol=1e-5)


def test_compressed_training_converges_like_uncompressed():
    """The port's counterpart of ``tests/test_compression.py``'s."""
    cfg = PR.get_config("llama3_8b", smoke=True)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 32))),
             "targets": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 32)))}

    def run(compress):
        model = PR.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        step = PT.make_train_step(PR.make_train_forward(cfg),
                                   PO.AdamWConfig(lr=1e-3),
                                   PT.TrainConfig(compress_grads=compress))
        opt = PO.adamw_init(model)
        return [float(step(model, opt, batch)["loss"]) for _ in range(8)]

    plain, comp = run(False), run(True)
    assert comp[-1] < comp[0]                          # it learns
    assert abs(comp[-1] - plain[-1]) < 0.25 * plain[0]  # tracks the baseline


# ----------------------------------------------------------------------
# data pipeline
# ----------------------------------------------------------------------
@pytest.mark.parametrize("host_index,host_count", [(0, 1), (0, 2), (1, 2)])
def test_synthetic_batches_are_the_references(host_index, host_count):
    kw = dict(vocab=1000, batch=8, seq=16, seed=9, host_index=host_index,
              host_count=host_count)
    ref, port = RD.SyntheticCorpus(**kw), PD.SyntheticCorpus(**kw)
    for step in range(6):
        a, b = ref.batch_at(step), port.batch_at(step)
        assert sorted(a) == sorted(b) == ["targets", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


@pytest.mark.parametrize("host_index,host_count", [(0, 1), (1, 2)])
def test_memmap_batches_are_the_references(tmp_path, host_index, host_count):
    path = str(tmp_path / "toks.bin")
    PD.write_token_file(path, np.random.default_rng(0).integers(0, 500, 10_000))
    with open(path, "rb") as f:
        port_bytes = f.read()
    RD.write_token_file(path, np.random.default_rng(0).integers(0, 500, 10_000))
    with open(path, "rb") as f:
        assert f.read() == port_bytes
    kw = dict(vocab=500, batch=4, seq=32, host_index=host_index,
              host_count=host_count)
    ref, port = RD.MemmapCorpus(path, **kw), PD.MemmapCorpus(path, **kw)
    for step in range(6):
        a, b = ref.batch_at(step), port.batch_at(step)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])


def test_batches_become_index_tensors():
    batch = PD.SyntheticCorpus(vocab=100, batch=2, seq=5).batch_at(0)
    batch["frames"] = np.zeros((2, 3, 4), np.float32)
    got = PD.to_tensors(batch, "cpu")
    assert got["tokens"].dtype == got["targets"].dtype == torch.int64
    assert got["frames"].dtype == torch.float32
    assert np.array_equal(got["tokens"].numpy(), batch["tokens"])
