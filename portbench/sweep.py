"""The knee sweep of a serving cell, on the card.

    python3 -m portbench.sweep --workload <cell> --seed <n> --seconds 5 \
        --rates 500,1000,2000,4000

runs the cell once per offered rate in one process (the ingest running as
in the cell) and prints one JSON line per rate: offered and achieved QPS,
the generator's lateness over the first and the last quarter of the
requests, the p95 latency and the ingest rate.  The knee is the highest
rate at which achieved QPS holds the offer and the lateness does not grow;
a serving cell offers about four fifths of it (``PERF.md``).
"""
from __future__ import annotations

import argparse
import json
import sys

from portbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    from portbench import program
    program.import_port()
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for rate in (float(r) for r in args.rates.split(",")):
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  False, device, harness.process_start(),
                                  overrides={"qps": rate})
        info, metrics = result["info"], result["line"]["metrics"]
        print(json.dumps({
            "workload": args.workload, "offered_qps": rate,
            "achieved_qps": info["achieved_qps"],
            "lateness_ms": info["lateness_ms"],
            "query_p95_ms": metrics["query_p95_ms"]["value"],
            "ingest_medges_per_s": metrics["ingest_medges_per_s"]["value"],
            "correct": result["line"]["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
