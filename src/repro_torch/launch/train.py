"""Production training driver (port of ``repro/launch/train.py``).

Runs any assigned architecture (SMOKE config on the CPU; the full
config on the card) under the fault-tolerant runtime: NVM checkpoints
(double-buffered, async-drained, in the reference's slot layout),
Young/Daly persistence period, restore on restart, deterministic
resumable data::

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \
        --smoke --steps 100 --batch 8 --seq 256

``--device cpu`` runs on the CPU; the default is the card, and with no
card visible the run raises.  The mesh follows the reference
(``repro/launch/train.py``: ``make_mesh_for(ndev)`` when more than one
device is visible): with several cards visible the model trains over
``launch.mesh.make_mesh_for(torch.cuda.device_count())``, its shards
spanning the cards; on one card, or with ``--device cpu``, on one
device, unless ``--mesh N`` asks for the ``(data, model)`` mesh of ``N``
shards (``make_mesh_for(N)``: on one card or the CPU, ``N`` shards of
it; ``--mesh 1`` is one device).  Over a mesh the parameters and
moments are placed, and a checkpoint slot holds whole leaves in the
reference's layout, so a run resumes from a slot written on any mesh
shape or on one device.  Every family trains over a mesh, as the
reference's does: the decoder LMs, mamba2's SSD heads, recurrentgemma's
RG-LRU channels, whisper's encoder-decoder and qwen2_vl's patch
embeddings with M-RoPE positions.  The stub
inputs of a vision arch (patch embeddings and M-RoPE positions) and of
the encoder-decoder (frames) are drawn from a ``torch.Generator``
seeded with the step, not from ``jax.random``: they are the reference's
in shape and distribution, not in value.  The default ``--ckpt-dir``
ends in ``_torch``, so a reference run's slots are never resumed by
accident.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

from repro_torch import convert
from repro_torch._device import resolve_device
from repro_torch.ft.checkpoint import CheckpointConfig, NVMCheckpointManager
from repro_torch.ft.period import PersistencePeriodTuner
from repro_torch.ft.recovery import TrainingRecovery
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import registry as R
from repro_torch.training.data import SyntheticCorpus, to_tensors
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_step import TrainConfig, make_train_step


def stub_inputs(cfg, batch: dict, step: int, dev: torch.device) -> dict:
    """The modality stubs of step ``step``: patch embeddings and three
    identical M-RoPE streams for a vision arch, frames for the
    encoder-decoder, drawn from a generator seeded with the step."""
    gen = torch.Generator(device=dev).manual_seed(step)
    if cfg.frontend == "vision":
        b, sq = batch["tokens"].shape
        batch["tokens"] = torch.randn((b, sq, cfg.d_model), generator=gen,
                                      device=dev).to(cfg.cdt)
        batch["positions"] = torch.arange(sq, device=dev).expand(3, b, sq)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (batch["tokens"].shape[0], cfg.enc_seq, cfg.d_model),
            generator=gen, device=dev)
    return batch


def mesh_shards(dev: torch.device, asked: Optional[int]) -> int:
    """The shard count a model trains over on ``dev``: ``asked``
    (``--mesh``) where given, else every visible card when there are
    several and ``dev`` names none of them (the reference's
    ``make_mesh_for(ndev)``, for every family), else one device."""
    if asked is not None:
        return asked
    if dev.type != "cuda" or dev.index is not None:
        return 1
    return max(torch.cuda.device_count(), 1)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=R.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU); omit on the card")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "nvm_esr_train_torch"))
    ap.add_argument("--mtbf", type=float, default=3600.0,
                    help="assumed MTBF seconds for the Young/Daly period")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: the card (default) or cpu")
    ap.add_argument("--mesh", type=int, default=None,
                    help="train over make_mesh_for(N), a (data, model) mesh "
                         "of N shards (default: every visible card when "
                         "there are several, else one device)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = R.get_config(args.arch, smoke=args.smoke)
    shards = mesh_shards(dev, args.mesh)
    mesh = make_mesh_for(shards, device=dev) if shards > 1 else None
    if mesh is not None:
        dev = mesh.device
    model = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, mesh=mesh)
    n = sum(math.prod(p.shape) for _, p in R.named_leaves(model))
    where = "" if mesh is None else (
        f" as a ({mesh.shape['data']}, {mesh.shape['model']}) mesh")
    print(f"arch {cfg.name}: {n/1e6:.1f}M params on {shards} device(s)"
          f"{where}")

    step_fn = make_train_step(R.make_train_forward(cfg), AdamWConfig(lr=args.lr),
                              TrainConfig(microbatches=args.microbatches))
    data = SyntheticCorpus(vocab=cfg.vocab, batch=args.batch, seq=args.seq)
    mgr = NVMCheckpointManager(CheckpointConfig(args.ckpt_dir))
    tuner = PersistencePeriodTuner(mtbf_s=args.mtbf, min_period=5)
    rec = TrainingRecovery(mgr, tuner)
    straggle = StragglerMonitor()

    opt = adamw_init(model)
    start = 0
    restored = mgr.restore(convert.train_state_like(cfg))
    if restored is not None:
        tree, start, _ = restored
        model, opt = convert.train_state_from_numpy(cfg, tree, dev,
                                                    mesh=mesh)
        print(f"elastic restore: resuming from step {start}")

    for s in range(start, args.steps):
        t0 = time.perf_counter()
        batch = stub_inputs(cfg, to_tensors(data.batch_at(s), dev), s, dev)
        m = step_fn(model, opt, batch)
        if mesh is not None:
            mesh.synchronize()
        elif dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        rec.observe_step(dt)
        advice = straggle.observe(dt)
        if advice.suggest_eviction:
            print(f"step {s+1}: persistent straggler detected "
                  f"({dt*1e3:.0f}ms vs median {advice.median_s*1e3:.0f}ms) — "
                  "evict + elastic-restore advised")
        if not advice.defer_persistence:
            rec.maybe_persist(
                lambda: convert.train_state_to_numpy(model, opt), s + 1)
        if (s + 1) % 10 == 0:
            print(f"step {s+1:5d} loss {float(m['loss']):.4f} "
                  f"period {tuner.period}")
    mgr.join()
    print("done.")


if __name__ == "__main__":
    main()
