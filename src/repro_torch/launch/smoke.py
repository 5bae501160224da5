"""Run any assigned architecture at reduced scale: one forward, asserting
finite outputs — the CLI face of ``repro.launch.smoke`` for the port.

  python -m repro_torch.launch.smoke --arch fm                # on the card
  python -m repro_torch.launch.smoke --arch fm --device cpu   # plain versions
  python -m repro_torch.launch.smoke --arch equiformer-v2 --device cpu
  python -m repro_torch.launch.smoke --all --device cpu

Every architecture of the JAX package's smoke is ported: the FM, the five
LMs and the four GNNs.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.launch.stream_ingest import require_device


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


def gnn_smoke_config(name: str):
    """The reduced config of the JAX package's ``smoke_gnn`` for ``name``."""
    from repro_torch.models.gnn import equiformer_v2, gatedgcn, graphcast, nequip

    return {
        "gatedgcn": lambda: gatedgcn.GatedGCNConfig(n_layers=3, d_hidden=16,
                                                    d_out=4),
        "graphcast": lambda: graphcast.GraphCastConfig(n_layers=2, d_hidden=32,
                                                       n_vars=13),
        "nequip": lambda: nequip.NequIPConfig(n_layers=2, d_hidden=8,
                                              edge_chunk=32),
        "equiformer-v2": lambda: equiformer_v2.EquiformerV2Config(
            n_layers=2, d_hidden=16, l_max=3, n_heads=4, edge_chunk=32),
    }[name]()


def smoke_gnn(name: str, device) -> dict:
    """``smoke_gnn`` of the JAX package: ``synthetic_graph(24, 64, 13)`` and
    its four reduced configs, one forward (NequIP: the energy), finite."""
    from repro_torch.configs.registry import gnn_module, init_gnn_params
    from repro_torch.models.gnn import synthetic_graph

    g = synthetic_graph(24, 64, 13, seed=0, device=device)
    cfg = gnn_smoke_config(name)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_gnn_params(name, cfg, gen, 13, device, requires_grad=False)
    module = gnn_module(name)
    with torch.no_grad():
        out = (module.energy(cfg, params, g, g.positions) if name == "nequip"
               else module.forward(cfg, params, g))
    if not bool(torch.isfinite(out).all()):
        raise SystemExit(f"error: {name} output is not finite")
    return {"out_shape": list(out.shape), "device": str(device)}


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
            "grok-1-314b": smoke_lm,
            "gatedgcn": smoke_gnn, "graphcast": smoke_gnn,
            "nequip": smoke_gnn, "equiformer-v2": smoke_gnn,
            "fm": smoke_recsys}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--arch", choices=sorted(FAMILIES))
    which.add_argument("--all", action="store_true",
                       help="every architecture, in name order")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back on its own")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = require_device(args.device)
    for name in sorted(FAMILIES) if args.all else [args.arch]:
        t0 = time.time()
        out = FAMILIES[name](name, device)
        print(f"[smoke OK] {name:15s} {time.time() - t0:5.1f}s {out}",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
