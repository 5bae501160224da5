"""Run one cell of the port's benchmark and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It puts ``src`` on the path, runs the cell on
the first CUDA card (there is no CPU fallback: without a card it exits 2
and prints no result), checks what the timed path produced against the
plain reference under ``portbench/reference``, and prints, as its last
line, one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; last in it, ``checks``: each number
compared with its limit.  The line before it holds the run's generator
lateness, the seconds spent building or loading the kernels (``build_s``,
a part of ``setup_s``), the card's name and its power limit; the checks
end standard error too.  It exits 3, printing no result, if JAX or the JAX package was
loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from portbench import harness

T_PROCESS = harness.process_start()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unread ({exc.__class__.__name__})"
    return out.splitlines()[0] if out else "unread"


def checks_text(checks: dict) -> list[str]:
    return [f"{name} {value} limit {limit}"
            for name, (value, limit) in checks.items()]


def main(argv=None) -> int:
    args = parse_args(argv)
    os.environ.pop("REPRO_PROFILE", None)  # the program's opt-in timing hooks
    try:
        harness.find_cell(args.workload)
        from portbench import program
        program.import_port()
    except (OSError, ImportError, KeyError, ValueError) as exc:
        print(f"error: cannot set up {args.workload!r}: {exc}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("error: no CUDA card; the benchmark does not run on the CPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device, T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    line = dict(result["line"])
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, (value, limit) in result["checks"].items()}
    info = dict(result["info"])
    info["card"] = power_limit()
    info["torch"] = torch.__version__
    print(json.dumps({"run": info}, default=str))
    sys.stderr.write("\n".join(checks_text(result["checks"])) + "\n")
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
