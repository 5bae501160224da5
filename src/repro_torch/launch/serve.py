"""Serving driver: prefill and batched decode with a KV cache, on the card.

The port of ``repro/launch/serve.py``, with its flags and its lines, and
``--device`` (``cuda`` by default; ``cpu`` runs the same code on the host,
never chosen on its own):

  python -m repro_torch.launch.serve --arch gemma2-2b --batch 4 \\
      --prompt-len 32 --gen 16
  python -m repro_torch.launch.serve --arch gemma2-2b --reduced --device cpu

Weights come from a torch generator seeded with ``--seed`` (other numbers
than the JAX package's key of the same seed); the prompts from numpy's
``default_rng(seed)``, the same tokens as the JAX driver's.  Greedy decode
(``--temperature 0``) takes the first index of the largest logit, as
``jnp.argmax``; a positive temperature samples from a ``torch.Generator``
seeded with ``seed + 1``.  The cache is float32, as the JAX driver makes
it.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs.lm import LM_CONFIGS, reduced as lm_reduced
from repro_torch.launch.stream_ingest import require_device
from repro_torch.models.transformer import model as tmodel


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, prompts: torch.Tensor, gen: int, *,
             temperature: float = 0.0,
             generator: torch.Generator | None = None) -> dict:
    """Prefill ``prompts`` (B, P) and decode ``gen`` tokens through a
    float32 cache.  Returns ``{"tokens": (B, gen) numpy, "prefill_s",
    "decode_s"}`` (host clock, each ending in a device synchronise)."""
    device = prompts.device
    b, p = prompts.shape
    cache = tmodel.init_cache(cfg, b, p + gen, dtype=torch.float32,
                              device=device)
    t0 = time.perf_counter()
    logits, cache = tmodel.prefill(cfg, params, prompts, cache)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    out_tokens = []
    nxt = torch.argmax(logits, -1).to(torch.int32)
    t0 = time.perf_counter()
    for _ in range(gen):
        out_tokens.append(nxt[:, 0])
        logits, cache = tmodel.decode_step(cfg, params, nxt, cache)
        if temperature > 0:
            probs = torch.softmax(logits[:, 0].float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator).to(torch.int32)
        else:
            nxt = torch.argmax(logits, -1).to(torch.int32)
    _sync(device)
    t_decode = time.perf_counter() - t0
    tokens = torch.stack(out_tokens, 1).cpu().numpy() if gen else np.zeros(
        (b, 0), np.int32)
    return {"tokens": tokens, "prefill_s": t_prefill, "decode_s": t_decode}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b", choices=sorted(LM_CONFIGS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back on its own")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = require_device(args.device)
    cfg = LM_CONFIGS[args.arch]
    if args.reduced:
        cfg = lm_reduced(cfg)
    params = tmodel.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device,
        requires_grad=False)
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int32).to(device)
    sampler = torch.Generator(device=device).manual_seed(args.seed + 1)
    out = generate(cfg, params, prompts, args.gen,
                   temperature=args.temperature, generator=sampler)
    print(f"prefill: {args.batch}x{args.prompt_len} tokens in "
          f"{out['prefill_s']*1e3:.1f} ms")
    dt = out["decode_s"]
    print(f"decode: {args.gen} steps x batch {args.batch} in {dt*1e3:.1f} ms "
          f"({args.gen*args.batch/dt:,.0f} tok/s)")
    print("sample token ids:", out["tokens"][0][:12].tolist())
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
