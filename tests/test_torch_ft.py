"""The port's fault-tolerant training runtime (``repro_torch.ft``) and its
train CLI (``repro_torch.launch.train``) on the CPU: the counterparts of
``tests/test_checkpoint.py`` and ``tests/test_training_ft.py``, slots
byte-identical to the reference's and restorable across the two
packages, and the CLI's lines in the reference's format.

Tolerances: within the port the resumed run is bitwise the uninterrupted
one (the same operations on the same values, on the CPU); against the
reference its final parameters are within the reference test's own
``rtol = atol = 1e-6`` (``tests/test_training_ft.py``) of the
reference's uninterrupted run, both in f32 compute.
"""
import copy
import filecmp
import os
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import port_lm, ref_lm, ref_rows
from repro.ft import checkpoint as RCK
from repro.ft import period as RPD
from repro.ft import straggler as RSG
from repro.models import registry as RR
from repro.nvm.store import Tier as RefTier
from repro.training import data as RD
from repro.training import optimizer as RO
from repro.training import train_step as RT
from repro_torch import convert
from repro_torch.ft import (CheckpointConfig, NVMCheckpointManager,
                            PersistencePeriodTuner, StragglerMonitor,
                            TrainingRecovery, inject_host_failure,
                            optimal_period)
from repro_torch.ft.checkpoint import _leaves
from repro_torch.launch import train as train_cli
from repro_torch.models import registry as PR
from repro_torch.nvm.store import Tier
from repro_torch.training import optimizer as PO
from repro_torch.training import train_step as PTS
from repro_torch.training.data import SyntheticCorpus, to_tensors


def _tree(seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((32, 16), generator=g) * scale,
        "nested": {"b": torch.arange(8, dtype=torch.float32) * scale},
        "step_arr": torch.tensor([seed], dtype=torch.int32),
    }


def _equal_trees(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ----------------------------------------------------------------------
# the counterparts of tests/test_checkpoint.py
# ----------------------------------------------------------------------
def test_save_restore_roundtrip(tmp_path):
    mgr = NVMCheckpointManager(CheckpointConfig(str(tmp_path)))
    t = _tree(1)
    mgr.save(t, step=7, extra={"cursor": 7})
    got, step, extra = mgr.restore(t)
    assert step == 7 and extra["cursor"] == 7
    _equal_trees(got, t)


def test_double_buffer_two_slots_alternate(tmp_path):
    mgr = NVMCheckpointManager(CheckpointConfig(str(tmp_path)))
    mgr.save(_tree(1), step=1)
    mgr.save(_tree(2), step=2)
    got, step, _ = mgr.restore(_tree(0))
    assert step == 2
    # corrupt the newest slot -> restore falls back to the previous
    _, slot = mgr._latest_valid()
    for f in sorted(os.listdir(slot)):
        if f.endswith(".npy"):
            with open(os.path.join(slot, f), "r+b") as fh:
                fh.seek(60)
                fh.write(b"\xde\xad\xbe\xef")
            break
    got, step, _ = mgr.restore(_tree(0))
    assert step == 1  # CRC catches the torn payload; previous slot wins
    _equal_trees(got, _tree(1))


def test_crash_mid_persist_keeps_previous(tmp_path):
    mgr = NVMCheckpointManager(CheckpointConfig(str(tmp_path)))
    mgr.save(_tree(1), step=1)
    # simulate crash mid-write of slot for step 2: payload without manifest
    slot = mgr._slot_dir(mgr._seq + 1)
    os.makedirs(slot, exist_ok=True)
    with open(os.path.join(slot, "w.npy"), "wb") as f:
        np.save(f, np.zeros((32, 16)))
    mgr2 = NVMCheckpointManager(CheckpointConfig(str(tmp_path)))
    _, step, _ = mgr2.restore(_tree(0))
    assert step == 1


def test_async_drain_overlaps_and_joins(tmp_path):
    mgr = NVMCheckpointManager(CheckpointConfig(str(tmp_path), async_drain=True))
    t = _tree(3)
    mgr.save_async(t, step=3)
    mgr.join()
    got, step, _ = mgr.restore(t)
    assert step == 3
    wall, modeled = mgr.last_persist_seconds
    assert wall > 0 and modeled > 0
    assert mgr.last_persist_bytes == 32 * 16 * 4 + 8 * 4 + 4


def test_save_takes_a_function_called_once_at_the_snapshot(tmp_path):
    """A caller converts its state only when it persists: ``save`` and
    ``save_async`` call a function in place of a tree once, before they
    return."""
    mgr = NVMCheckpointManager(CheckpointConfig(str(tmp_path)))
    calls = []

    def state():
        calls.append(1)
        return _tree(4)

    mgr.save_async(state, step=4)
    assert calls == [1]
    mgr.save(state, step=5)
    assert calls == [1, 1]
    _equal_trees(mgr.restore(_tree(0))[0], _tree(4))


def test_save_waits_for_an_async_drain_in_flight(tmp_path, monkeypatch):
    """ROADMAP N6, the port's deliberate difference: ``save`` joins a
    ``save_async`` drain still in flight before it writes, so the two
    steps land in the two slots in turn (the reference's ``save`` does
    not wait, and both would write the same slot).  The first drain is
    held until a timer releases it, after ``save`` was called."""
    mgr = NVMCheckpointManager(CheckpointConfig(str(tmp_path),
                                                async_drain=True))
    seq0 = mgr._seq
    release = threading.Event()
    real = NVMCheckpointManager._drain

    def slow(self, flat, step, extra):
        if step == 1:
            assert release.wait(timeout=60)
        return real(self, flat, step, extra)

    monkeypatch.setattr(NVMCheckpointManager, "_drain", slow)
    mgr.save_async(_tree(1), step=1)
    assert mgr._drainer.is_alive() and mgr._seq == seq0
    timer = threading.Timer(0.2, release.set)
    timer.start()
    try:
        mgr.save(_tree(2), step=2)
    finally:
        timer.join(timeout=60)
    assert release.is_set() and mgr._drainer is None
    assert mgr._seq == seq0 + 2
    keys = [k for k, _ in _leaves(_tree(0))]
    for step in (1, 2):
        slot = mgr._slot_dir(seq0 + step)
        flat, manifest = mgr._try_load_slot(slot, keys)
        assert (manifest["step"], manifest["seq"]) == (step, seq0 + step)
        for key, leaf in _leaves(_tree(step)):
            np.testing.assert_array_equal(flat[key], np.asarray(leaf))
    got, step, _ = mgr.restore(_tree(0))
    assert step == 2
    _equal_trees(got, _tree(2))


def test_snapshot_is_a_copy_of_cpu_tensors(tmp_path):
    """The drain writes what the state was at ``save_async``, though the
    next step updates the tensors in place while it runs."""
    mgr = NVMCheckpointManager(CheckpointConfig(str(tmp_path)))
    t = _tree(6)
    kept = copy.deepcopy(t)
    mgr.save_async(t, step=6)
    with torch.no_grad():
        t["w"].add_(1.0)
    got, _, _ = mgr.restore(t)
    np.testing.assert_array_equal(got["w"], kept["w"].numpy())


def test_elastic_restore_with_device(tmp_path):
    """Restore re-places arrays on the current device (the CPU here), in
    the dtype of ``like``'s tensor leaves; without ``device`` the leaves
    are numpy arrays."""
    mgr = NVMCheckpointManager(CheckpointConfig(str(tmp_path)))
    t = _tree(4)
    t["half"] = torch.linspace(-1, 1, 5, dtype=torch.bfloat16)
    mgr.save(t, step=4)
    got, step, _ = mgr.restore(t, device="cpu")
    assert step == 4
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for _, v in _leaves(got))
    assert got["half"].dtype == torch.bfloat16
    assert torch.equal(got["half"], t["half"])
    raw, _, _ = mgr.restore(t)
    assert isinstance(raw["w"], np.ndarray)
    assert raw["half"].dtype == np.float32   # bf16 is kept as f32 values


def test_training_recovery_cycle(tmp_path):
    mgr = NVMCheckpointManager(CheckpointConfig(str(tmp_path)))
    tuner = PersistencePeriodTuner(mtbf_s=10.0, min_period=1)
    rec = TrainingRecovery(mgr, tuner)
    state = _tree(5)
    kept = copy.deepcopy(state)
    rec.maybe_persist(state, step=0)
    mgr.join()
    dead = inject_host_failure(state)
    assert dead is state                      # lost where it lived
    assert bool(torch.isnan(state["w"]).all())
    assert int(state["step_arr"][0]) == 0
    restored, step, _ = rec.recover(kept, failed_step=3)
    assert step == 0 and rec.failures_recovered == 1 and rec.steps_wasted == 3
    np.testing.assert_array_equal(restored["w"], kept["w"].numpy())


def test_inject_host_failure_reaches_a_model_and_its_optimizer():
    cfg = PR.get_config("llama3_8b", smoke=True)
    model = PR.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = PO.adamw_init(model)
    opt["step"].fill_(3)
    inject_host_failure({"params": model, "opt": [opt["m"], (opt["step"],)]})
    assert all(bool(torch.isnan(p).all()) for p in model.parameters())
    assert all(bool(torch.isnan(m).all()) for m in opt["m"].values())
    assert int(opt["step"]) == 0


def test_young_daly_period():
    # delta=1s, MTBF=1h, step=1s -> T_opt = sqrt(2*1*3600) = 84.8 steps
    assert optimal_period(1.0, 3600.0, 1.0) == 85
    assert optimal_period(1.0, 36.0, 1.0) < optimal_period(1.0, 3600.0, 1.0)
    t = PersistencePeriodTuner(mtbf_s=3600.0)
    for _ in range(5):
        t.observe(persist_cost_s=1.0, step_time_s=1.0)
    assert 60 <= t.period <= 110
    assert 0 < t.expected_overhead_fraction() < 0.1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_period_and_straggler_copies_match_the_reference(seed):
    """The same observations give the reference's periods, overheads and
    straggler advice."""
    rng = np.random.default_rng(seed)
    kw = dict(mtbf_s=float(rng.uniform(10, 1e4)), min_period=2,
              max_period=500)
    ours, ref = PersistencePeriodTuner(**kw), RPD.PersistencePeriodTuner(**kw)
    mon, rmon = StragglerMonitor(window=20, persist_k=3), \
        RSG.StragglerMonitor(window=20, persist_k=3)
    for _ in range(40):
        delta, step = rng.uniform(1e-3, 2.0), rng.uniform(1e-3, 1.0)
        spike = step * (20 if rng.random() < 0.2 else 1)
        ours.observe(delta, step)
        ref.observe(delta, step)
        assert ours.period == ref.period
        assert ours.expected_overhead_fraction() == \
            ref.expected_overhead_fraction()
        assert vars(mon.observe(spike)) == vars(rmon.observe(spike))
    assert optimal_period(0.3, 900.0, 0.05) == RPD.optimal_period(0.3, 900.0,
                                                                  0.05)


def test_modeled_tier_costs(tmp_path):
    costs = {}
    for tier in (Tier.DRAM, Tier.NVM, Tier.SSD):
        mgr = NVMCheckpointManager(CheckpointConfig(str(tmp_path / tier.value),
                                                    tier=tier))
        costs[tier] = mgr.save(_tree(1), step=1)
    assert costs[Tier.DRAM] < costs[Tier.NVM] < costs[Tier.SSD]
    # the reference's models, to the bit
    for tier in (Tier.DRAM, Tier.NVM, Tier.SSD):
        ref = RCK.NVMCheckpointManager(RCK.CheckpointConfig(
            str(tmp_path / f"ref_{tier.value}"), tier=RefTier(tier.value)))
        assert ref.save({k: np.asarray(v) for k, v in _leaves(_tree(1))},
                        step=1) == pytest.approx(costs[tier], rel=1e-12)


def test_straggler_monitor_classifies_and_advises():
    mon = StragglerMonitor(window=20, spike_mad=5.0, persist_k=3, warmup=5)
    for _ in range(10):
        a = mon.observe(0.100)
    assert a.classification == "normal" and not a.defer_persistence
    a = mon.observe(1.0)
    assert a.classification == "transient"
    assert a.defer_persistence and not a.suggest_eviction
    a = mon.observe(0.101)
    assert a.classification == "normal"
    for _ in range(3):
        a = mon.observe(1.0)
    assert a.classification == "persistent" and a.suggest_eviction
    assert abs(mon.median_step_s - 0.100) < 0.01


# ----------------------------------------------------------------------
# slots across the two packages
# ----------------------------------------------------------------------
def _numpy_tree():
    rng = np.random.default_rng(6)
    return {"params": {"groups": {"0": {"w": rng.standard_normal((2, 3, 4)).astype(np.float32)}},
                       "embed": rng.standard_normal((8, 3)).astype(np.float32),
                       "tail": {}},
            "opt": {"step": np.asarray(3, np.int32),
                    "m": [rng.standard_normal(5).astype(np.float32),
                          np.arange(3, dtype=np.int64)]},
            "zz": np.float64(2.5)}


def test_equal_trees_give_byte_identical_slots(tmp_path):
    """The same tree saved by both packages: the same files, byte for
    byte, ``MANIFEST.json`` included; and the port's tensors of the same
    values write the same bytes."""
    tree = _numpy_tree()
    for i, (ours, ref) in enumerate([("port_a", "ref_a"), ("port_b", "ref_b")]):
        NVMCheckpointManager(CheckpointConfig(str(tmp_path / ours))).save(
            tree, step=3 + i, extra={"cursor": 3})
        RCK.NVMCheckpointManager(RCK.CheckpointConfig(str(tmp_path / ref))).save(
            tree, step=3 + i, extra={"cursor": 3})
    as_tensors = jax.tree.map(torch.as_tensor, tree)
    NVMCheckpointManager(CheckpointConfig(str(tmp_path / "port_t"))).save(
        as_tensors, step=3, extra={"cursor": 3})
    for ours, ref in (("port_a", "ref_a"), ("port_b", "ref_b"),
                      ("port_t", "ref_a")):
        a, b = tmp_path / ours / "slot1", tmp_path / ref / "slot1"
        files = sorted(os.listdir(a))
        assert files == sorted(os.listdir(b)) and "MANIFEST.json" in files
        match, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
        assert mismatch == [] and errors == [] and len(match) == len(files)


def test_each_package_restores_the_others_slots(tmp_path):
    tree = _numpy_tree()
    RCK.NVMCheckpointManager(RCK.CheckpointConfig(str(tmp_path / "ref"))).save(
        tree, step=9)
    got, step, _ = NVMCheckpointManager(CheckpointConfig(
        str(tmp_path / "ref"))).restore(tree)
    assert step == 9
    _equal_trees(got, tree)
    NVMCheckpointManager(CheckpointConfig(str(tmp_path / "port"))).save(
        jax.tree.map(torch.as_tensor, tree), step=11)
    got, step, _ = RCK.NVMCheckpointManager(RCK.CheckpointConfig(
        str(tmp_path / "port"))).restore(tree)
    assert step == 11
    _equal_trees(got, tree)


def test_a_reference_train_state_slot_resumes_in_the_port(tmp_path):
    """The reference checkpoints its train state after a step; the port
    restores the slot (``train_state_like``), builds the model and
    optimizer from it, and its own checkpoint of that state is the
    reference's slot, byte for byte."""
    rcfg, params, _ = ref_lm("starcoder2_3b")
    np_in = {k: jnp.asarray(v) for k, v in RD.SyntheticCorpus(
        vocab=rcfg.vocab, batch=2, seq=16, seed=1).batch_at(0).items()}
    step = jax.jit(RT.make_train_step(RR.make_train_forward(rcfg),
                                      RO.AdamWConfig()))
    p, o, _ = step(params, RO.adamw_init(params), np_in)
    ref_state = {"params": p, "opt": o}
    RCK.NVMCheckpointManager(RCK.CheckpointConfig(str(tmp_path / "ref"))).save(
        ref_state, step=1)

    cfg, _ = port_lm("starcoder2_3b")
    tree, at, _ = NVMCheckpointManager(CheckpointConfig(
        str(tmp_path / "ref"))).restore(convert.train_state_like(cfg))
    assert at == 1
    model, opt = convert.train_state_from_numpy(cfg, tree, "cpu")
    names = [n for n, _ in model.named_parameters()]
    want = ref_rows(jax.tree.map(np.asarray, p), cfg, names)
    for name, param in model.named_parameters():
        np.testing.assert_array_equal(param.detach().numpy(), want[name])
    assert int(opt["step"]) == 1
    NVMCheckpointManager(CheckpointConfig(str(tmp_path / "port"))).save(
        lambda: convert.train_state_to_numpy(model, opt), step=1)
    a, b = tmp_path / "port" / "slot1", tmp_path / "ref" / "slot1"
    files = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == files
    assert filecmp.cmpfiles(a, b, files, shallow=False)[0] == files


# ----------------------------------------------------------------------
# the counterparts of tests/test_training_ft.py
# ----------------------------------------------------------------------
def _train(model, opt, step_fn, data, steps):
    for s in steps:
        step_fn(model, opt, to_tensors(data.batch_at(s), "cpu"))


def test_train_recover_resume_matches_uninterrupted(tmp_path):
    """Train 8 steps; in a parallel universe, crash at step 5, recover
    from the NVM checkpoint at step 4 and resume: the final parameters
    are bitwise the uninterrupted run's, and within 1e-6 of the
    reference's uninterrupted run from the same parameters."""
    cfg, model0 = port_lm("llama3_8b")
    step_fn = PTS.make_train_step(PR.make_train_forward(cfg),
                                  PO.AdamWConfig(lr=3e-4))
    data = SyntheticCorpus(vocab=cfg.vocab, batch=4, seq=32, seed=3)

    # --- uninterrupted run ---
    ref_model = copy.deepcopy(model0)
    ref_opt = PO.adamw_init(ref_model)
    _train(ref_model, ref_opt, step_fn, data, range(8))

    # --- fault-tolerant run with failure at step 5 ---
    mgr = NVMCheckpointManager(CheckpointConfig(str(tmp_path), async_drain=False))
    tuner = PersistencePeriodTuner(mtbf_s=1e9, min_period=4, max_period=4)
    rec = TrainingRecovery(mgr, tuner)
    model, opt = model0, PO.adamw_init(model0)
    s, injected = 0, False
    while s < 8:
        if s == 5 and not injected:
            injected = True
            inject_host_failure({"params": model, "opt": opt})
            tree, ck_step, _ = rec.recover(convert.train_state_like(cfg), s)
            model, opt = convert.train_state_from_numpy(cfg, tree, "cpu")
            s = ck_step  # data cursor restored from the checkpoint step
            continue
        step_fn(model, opt, to_tensors(data.batch_at(s), "cpu"))
        s += 1
        if s % tuner.period == 0:
            mgr.save(lambda: convert.train_state_to_numpy(model, opt), step=s)

    assert rec.failures_recovered == 1
    assert rec.steps_wasted == 1  # failed at 5, checkpoint at 4
    for (n, a), (_, b) in zip(ref_model.named_parameters(),
                              model.named_parameters()):
        assert torch.equal(a, b), n
    assert int(opt["step"]) == 8

    # --- the reference's uninterrupted run from the same parameters ---
    rcfg, params, _ = ref_lm("llama3_8b")
    rstep = jax.jit(RT.make_train_step(RR.make_train_forward(rcfg),
                                       RO.AdamWConfig(lr=3e-4)))
    p, o = params, RO.adamw_init(params)
    for i in range(8):
        p, o, _ = rstep(p, o, {k: jnp.asarray(v)
                               for k, v in data.batch_at(i).items()})
    want = ref_rows(jax.tree.map(np.asarray, p), cfg,
                    [n for n, _ in model.named_parameters()])
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(), want[name],
                                   rtol=1e-6, atol=1e-6)


def test_loss_decreases_over_short_run():
    cfg = PR.get_config("llama3_8b", smoke=True)
    model = PR.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = PTS.make_train_step(PR.make_train_forward(cfg), PO.AdamWConfig())
    batch = to_tensors(SyntheticCorpus(vocab=cfg.vocab, batch=4, seq=32,
                                       seed=3).batch_at(0), "cpu")
    opt = PO.adamw_init(model)
    losses = [float(step(model, opt, batch)["loss"]) for _ in range(6)]
    assert losses[-1] < losses[0]


# ----------------------------------------------------------------------
# the train CLI
# ----------------------------------------------------------------------
_STEP_LINE = re.compile(r"^step +(\d+) loss (\d+\.\d{4}) period (\d+)$")
_RESUME = re.compile(r"^elastic restore: resuming from step (\d+)$")
_STRAGGLER = re.compile(r"^step \d+: persistent straggler detected "
                        r"\(\d+ms vs median \d+ms\) — evict \+ "
                        r"elastic-restore advised$")


def _kinds(lines):
    """Each line's format: the run-dependent numbers (a loss, a period
    that follows the measured step time, a straggler's times) are not
    compared, the formats are."""
    kinds = []
    for ln in lines:
        for name, pat in (("step", _STEP_LINE), ("resume", _RESUME),
                          ("straggler", _STRAGGLER)):
            if pat.match(ln):
                kinds.append(name)
                break
        else:
            kinds.append(ln)
    return kinds


def test_train_cli_lines_and_resume(tmp_path, capsys, monkeypatch):
    """Twelve steps of the llama3 SMOKE config on the CPU print lines in
    the reference CLI's formats (its own run beside them); a second run
    with ``--steps 16`` in the same directory resumes from the newest
    slot."""
    args = ["--arch", "llama3_8b", "--smoke", "--batch", "2", "--seq", "32"]
    ckpt = str(tmp_path / "port")
    train_cli.main(args + ["--steps", "12", "--ckpt-dir", ckpt,
                           "--device", "cpu"])
    first = capsys.readouterr().out.splitlines()

    from repro.launch import train as ref_cli
    monkeypatch.setattr("sys.argv", ["train"] + args + [
        "--steps", "12", "--ckpt-dir", str(tmp_path / "ref")])
    ref_cli.main()
    ref_lines = capsys.readouterr().out.splitlines()
    assert first[0] == ref_lines[0]      # "arch llama3-smoke: ...M params ..."
    assert first[-1] == ref_lines[-1] == "done."
    assert "step" in _kinds(first) and "step" in _kinds(ref_lines)
    assert set(_kinds(first[1:-1])) <= {"step", "straggler"}
    assert set(_kinds(ref_lines[1:-1])) <= {"step", "straggler"}

    train_cli.main(args + ["--steps", "16", "--ckpt-dir", ckpt,
                           "--device", "cpu"])
    second = capsys.readouterr().out.splitlines()
    resumed = _RESUME.match(second[1])
    assert resumed and int(resumed.group(1)) in (5, 10), second
    assert second[0] == first[0] and second[-1] == "done."


class _Stop(Exception):
    pass


def test_default_ckpt_dir_is_the_ports_own(monkeypatch, tmp_path):
    """Under the temporary directory, and not the reference's: a
    reference run's slots are never resumed by accident."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    seen = []

    def manager(cfg):
        seen.append(cfg.directory)
        raise _Stop

    monkeypatch.setattr(train_cli, "NVMCheckpointManager", manager)
    with pytest.raises(_Stop):
        train_cli.main(["--arch", "llama3_8b", "--smoke", "--device", "cpu"])
    assert seen == [os.path.join(str(tmp_path), "nvm_esr_train_torch")]
