"""Training driver for the transformer family (reduced or full configs),
on the card.

The port of ``repro/launch/train.py``, with its flags and its lines, and
``--device`` (``cuda`` by default; ``cpu`` runs the same code on the host,
never chosen on its own) and ``--dtype`` (the parameters' type; by default
the config's own: bfloat16 at full width, float32 reduced):

  python -m repro_torch.launch.train --arch gemma2-2b --steps 5 \\
      --batch 8 --seq 256
  python -m repro_torch.launch.train --arch gemma2-2b --reduced --steps 20 \\
      --device cpu --ckpt-dir /tmp/lm_ckpt
  python -m repro_torch.launch.train --arch gemma2-2b --reduced --steps 4 \\
      --dtype bfloat16 --ckpt-dir /tmp/lm_ckpt --ckpt-every 2 --resume

Weights come from a torch generator seeded with ``--seed``; each step's
batch from numpy's ``default_rng((seed << 20) + step)``, the same tokens
as the JAX driver's.  ``--ckpt-dir`` / ``--resume`` write and read the
JAX package's checkpoint layout, so either driver resumes the other's.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs.lm import LM_CONFIGS, reduced as lm_reduced
from repro_torch.launch.stream_ingest import require_device
from repro_torch.models.transformer import model as tmodel
from repro_torch.training import AdamWConfig, init_train_state, make_train_step
from repro_torch.training.steps import lm_loss_fn


def synthetic_lm_batch(rng: np.random.Generator, batch: int, seq: int,
                       vocab: int, device="cuda") -> dict:
    """Zipf-distributed token stream (deterministic; replayable by step)."""
    toks = (rng.zipf(1.3, size=(batch, seq + 1)) % vocab).astype(np.int32)
    return {"tokens": torch.as_tensor(toks[:, :-1]).to(device),
            "labels": torch.as_tensor(toks[:, 1:]).to(device)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b", choices=sorted(LM_CONFIGS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back on its own")
    ap.add_argument("--dtype", default="", choices=("", "float32", "bfloat16"),
                    help="the parameters' type (default: the config's)")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Train; print the JAX driver's lines.  Returns ``{"losses",
    "step_s", "state"}``: every step's loss, each step's host time (ending
    in a device synchronise, since each loss is read back) and the final
    training state."""
    args = build_parser().parse_args(argv)
    device = require_device(args.device)
    cfg = LM_CONFIGS[args.arch]
    if args.reduced:
        cfg = lm_reduced(cfg)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"active~{cfg.active_param_count()/1e6:.1f}M")

    opt_cfg = AdamWConfig(lr_peak=args.lr, warmup_steps=max(args.steps // 10, 5),
                          total_steps=args.steps)
    params = tmodel.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    state = init_train_state(params, opt_cfg)
    step_fn = make_train_step(lm_loss_fn(cfg), opt_cfg)

    start = 0
    if args.resume and args.ckpt_dir:
        try:
            state, meta = store.restore(args.ckpt_dir, state)
            start = meta["step"]
            print(f"resumed at step {start}")
        except FileNotFoundError:
            pass

    losses, step_s = [], []
    t0 = time.time()
    for step in range(start, args.steps):
        ts = time.perf_counter()
        rng = np.random.default_rng((args.seed << 20) + step)  # replayable
        batch = synthetic_lm_batch(rng, args.batch, args.seq, cfg.vocab, device)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - ts)
        if (step + 1) % args.log_every == 0:
            tok_s = args.batch * args.seq * args.log_every / (time.time() - t0)
            print(f"step {step+1:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} tok/s {tok_s:,.0f}")
            t0 = time.time()
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            store.save(args.ckpt_dir, step + 1, state,
                       extra={"loss": losses[-1]})
    _sync(device)
    if len(losses) > 20:
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"loss {first:.3f} -> {last:.3f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return {"losses": losses, "step_s": step_s, "state": state}


if __name__ == "__main__":
    main(sys.argv[1:])
