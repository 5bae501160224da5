"""Run a ported architecture at reduced scale: one forward, asserting
finite outputs — the CLI face of ``repro.launch.smoke`` for the port.

  python -m repro_torch.launch.smoke --arch fm                # on the card
  python -m repro_torch.launch.smoke --arch fm --device cpu   # plain versions

  python -m repro_torch.launch.smoke --arch gemma2-2b --device cpu

The FM and the five LM architectures are ported; the GNN architectures of
the JAX package's smoke are refused with a pointer to ROADMAP.md (§A, the
GNN family).
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.launch.stream_ingest import require_device

# the JAX package's smoke architectures that the port does not have yet
NOT_PORTED = ("gatedgcn", "graphcast", "nequip", "equiformer-v2")


def smoke_lm(name: str, device) -> dict:
    """``smoke_lm`` of the JAX package: the reduced config, tokens (2, 64)
    as both input and labels, a finite loss."""
    from repro_torch.configs.lm import LM_CONFIGS, reduced
    from repro_torch.models.transformer import model as tmodel

    cfg = reduced(LM_CONFIGS[name])
    gen = torch.Generator(device=device).manual_seed(0)
    params = tmodel.init_params(cfg, gen, device, requires_grad=False)
    toks = torch.randint(0, cfg.vocab, (2, 64), generator=gen, device=device,
                         dtype=torch.int32)
    with torch.no_grad():
        loss, metrics = tmodel.lm_loss(cfg, params, toks, toks)
    if not torch.isfinite(loss):
        raise SystemExit(f"error: {name} loss is not finite ({float(loss)})")
    return {"loss": float(loss), "ce": float(metrics["ce"]),
            "device": str(device)}


def smoke_recsys(name: str, device) -> dict:
    """``smoke_recsys`` of the JAX package: vocab 5,000, 7 fields, 32 rows,
    a finite BCE at all-zero labels."""
    from repro_torch.models.recsys.fm import FMConfig, bce_loss, init_params

    cfg = FMConfig(total_vocab=5000, n_fields=7)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device=device)
    ids = torch.randint(0, 1 << 30, (32, 7), generator=gen, device=device,
                        dtype=torch.int32)
    labels = torch.zeros((32,), dtype=torch.float32, device=device)
    loss = float(bce_loss(cfg, params, ids, labels))
    if not torch.isfinite(torch.tensor(loss)):
        raise SystemExit(f"error: {name} BCE is not finite ({loss})")
    return {"bce": loss, "device": str(device)}


FAMILIES = {"gemma2-2b": smoke_lm, "internlm2-20b": smoke_lm,
            "gemma3-27b": smoke_lm, "mixtral-8x7b": smoke_lm,
            "grok-1-314b": smoke_lm, "fm": smoke_recsys}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    choices=sorted((*FAMILIES, *NOT_PORTED)))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back on its own")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.arch not in FAMILIES:
        raise SystemExit(
            f"error: {args.arch} is not ported to PyTorch yet; see "
            "ROADMAP.md, §A (the GNN family). Ported: "
            f"{', '.join(sorted(FAMILIES))}")
    device = require_device(args.device)
    t0 = time.time()
    out = FAMILIES[args.arch](args.arch, device)
    print(f"[smoke OK] {args.arch:15s} {time.time() - t0:5.1f}s {out}")


if __name__ == "__main__":
    main(sys.argv[1:])
