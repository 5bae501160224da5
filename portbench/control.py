"""The control and the sweep of ``correct``'s readings, on the card.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--stand-in control|program]

runs the cell once per seed in one process, with the control in the
program's place (``reference/control.py``: the reference's ingest with its
counters in float16) or, with ``--stand-in program``, the program itself,
and prints one JSON line per seed with each compared number.  The numbers
set the limits (``PERF.md``): the program's dozen seeds give the lower
readings, the control's the upper.  The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys

from portbench import harness
from portbench.reference.control import ControlModule
from portbench.reference.counters import Layout
from portbench.reference.plan import make_plan
from portbench.traffic.stream import stream_from_config


def control_module(mod, ctx) -> ControlModule:
    """The control for the cell's configuration and seed, its plan worked
    out by the reference from the benchmark's own stream."""
    stream = stream_from_config(ctx.config,
                                batch_size=int(ctx.params["batch_edges"]),
                                seed=ctx.seed)
    plan = make_plan(ctx.config, (stream.batch_numpy(i)
                                  for i in range(stream.num_batches)),
                     ctx.seed)
    return ControlModule(mod, Layout(plan))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--stand-in", choices=("control", "program"),
                    default="control")
    args = ap.parse_args(argv)
    from portbench import program
    program.import_port()
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    module = control_module if args.stand_in == "control" else None
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run_cell(args.workload, seed, args.seconds, False,
                                  device, harness.process_start(),
                                  module=module)
        print(json.dumps({
            "workload": args.workload, "stand_in": args.stand_in,
            "seed": seed, "correct": result["line"]["correct"],
            "checks": {k: v for k, (v, _) in result["checks"].items()},
            "metrics": result["line"]["metrics"],
            "info": {k: v for k, v in result["info"].items()
                     if k in ("passes", "publishes", "answers_checked",
                              "answer_notes", "lateness_ms")}},
            default=str), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
