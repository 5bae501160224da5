"""End-to-end training driver: a ~100M-param gemma-2-style LM for a few
hundred steps on synthetic Zipf token streams.

    python -m repro_torch.examples.train_lm [--steps 300] [--tiny] [--device cpu]

The JAX package's ``examples/train_lm.py`` on the port (--tiny switches to
a ~1M-param config, so a CPU run finishes in seconds): the same configs,
batches and AdamW schedule, its lines every 25 steps and a verdict on the
loss.  The weights come from a torch seed, so the losses are the port's
own, not the JAX example's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.lm import GEMMA2_2B, reduced
from repro_torch.launch.stream_ingest import require_device
from repro_torch.launch.train import synthetic_lm_batch
from repro_torch.models.transformer import model as tmodel
from repro_torch.training import AdamWConfig, init_train_state, make_train_step
from repro_torch.training.steps import lm_loss_fn


def config_100m():
    """gemma-2 topology at ~100M params (24 + 77 embed)."""
    return dataclasses.replace(
        GEMMA2_2B,
        name="gemma2-100m",
        n_layers=8,
        d_model=512,
        n_heads=8,
        n_kv_heads=4,
        d_head=64,
        d_ff=2048,
        vocab=32_000,
        window=256,
        attn_chunk_q=128,
        attn_chunk_kv=256,
        ce_chunk=128,
        dtype="float32",
        remat=False,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits if no card) or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    cfg = reduced(GEMMA2_2B) if args.tiny else config_100m()
    print(f"config {cfg.name}: ~{cfg.param_count()/1e6:.1f}M params")

    opt = AdamWConfig(lr_peak=3e-3, warmup_steps=args.steps // 10,
                      total_steps=args.steps)
    params = tmodel.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    state = init_train_state(params, opt)
    step_fn = make_train_step(lm_loss_fn(cfg), opt)

    losses = []
    t0 = time.time()
    for step in range(args.steps):
        rng = np.random.default_rng(step)
        batch = synthetic_lm_batch(rng, args.batch, args.seq, cfg.vocab, device)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if (step + 1) % 25 == 0:
            print(f"step {step+1:4d}  loss {np.mean(losses[-25:]):.4f}  "
                  f"({args.batch*args.seq*25/(time.time()-t0):,.0f} tok/s)")
            t0 = time.time()
    if not np.isfinite(losses).all():
        raise SystemExit(f"non-finite loss: {losses}")
    first, last = np.mean(losses[:20]), np.mean(losses[-20:])
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'LEARNING' if last < first - 0.2 else 'check hyperparams'})")


if __name__ == "__main__":
    main()
