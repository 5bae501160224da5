"""Live telemetry poller: render per-shard ingest/query panels in a loop.

    python -m repro_torch.obs.dashboard --connect HOST:PORT [--auth-token T]
    python -m repro_torch.obs.dashboard --json /path/metrics.json

``--connect`` scrapes the ``metrics`` frame that both servers expose
(``query_serve --serve`` front-ends and ``stream_ingest --listen`` worker
hosts); ``--json`` follows a ``--metrics-json`` file instead — same
payload, no socket.  Every poll the payload's Prometheus text is run
through ``parse_prometheus_text`` so a malformed exposition fails loudly;
``--once`` renders a single frame and exits non-zero on any fetch or
parse failure, which makes it double as the CI scrape assertion.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time

# exposition sample: name, optional {labels}, value (exponents included)
_SAMPLE_RE = re.compile(
    r"([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(-?(?:[0-9.eE+-]+|[Ii]nf|[Nn]a[Nn]))")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus_text(text: str) -> dict[tuple, float]:
    """Parse exposition text into ``{(name, ((label, value), ...)): float}``.

    Deliberately strict where it matters for our own output: every
    non-comment line must be a well-formed sample and every value must
    parse as a float, so a rendering regression fails the CI scrape check
    instead of producing silently unscrapeable metrics.
    """
    samples: dict[tuple, float] = {}
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        m = _SAMPLE_RE.fullmatch(line.strip())
        if m is None:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name, labelstr, raw = m.groups()
        labels = []
        if labelstr:
            matched = _LABEL_RE.findall(labelstr)
            stripped = _LABEL_RE.sub("", labelstr).replace(",", "").strip()
            if stripped:
                raise ValueError(f"malformed label set: {labelstr!r}")
            labels = [(k, v.replace('\\"', '"').replace("\\\\", "\\")
                       .replace("\\n", "\n")) for k, v in matched]
        samples[(name, tuple(sorted(labels)))] = float(raw)
    return samples


def fetch_payload(args) -> dict:
    """One scrape: over TCP (``--connect``) or from a ``--metrics-json``
    file (``--json``); both carry the ``repro_torch.obs.dump`` payload shape."""
    if args.json:
        with open(args.json) as f:
            return json.load(f)

    from repro_torch.net import wire

    address = wire.parse_hostport(args.connect)
    sock = wire.connect_with_retry(address, deadline_s=args.timeout_s)
    try:
        token = wire.resolve_auth_token(args.auth_token or None)
        if token:
            wire.send_message(sock, ("auth", token), deadline_s=args.timeout_s)
        wire.send_message(sock, ("metrics_req",), deadline_s=args.timeout_s)
        deadline = time.monotonic() + args.timeout_s
        while True:
            reply = wire.recv_message(sock, poll_s=0.2,
                                      frame_deadline_s=args.timeout_s)
            if reply is not None:
                break
            if time.monotonic() > deadline:
                raise TimeoutError("no metrics frame within the deadline")
        if reply[0] != "metrics":
            raise wire.WireError(f"expected metrics, got {reply[0]!r}")
        return reply[1]
    finally:
        try:
            sock.close()
        except OSError:
            pass


# ------------------------------------------------------------- rendering --


def _rows(state: dict, section: str, name: str) -> list[tuple[dict, object]]:
    return [(dict(labels), value) for n, labels, value
            in state.get(section, ()) if n == name]


def _by_tenant(state: dict, section: str, name: str) -> dict[str, object]:
    return {labels.get("tenant", ""): value
            for labels, value in _rows(state, section, name)}


def _q(hstate, q: float) -> float:
    from repro_torch.obs.hub import quantile_from_state

    return quantile_from_state(hstate, q)


def render_panels(payload: dict) -> str:
    """Per-shard ingest panel + query panel from a scrape payload."""
    state = payload.get("state", {})
    out = [f"-- scrape @ {time.strftime('%H:%M:%S', time.localtime(payload.get('ts', 0)))} --"]

    edges = _by_tenant(state, "counters", "repro_ingest_edges_total")
    eps = _by_tenant(state, "gauges", "repro_ingest_edges_per_s")
    depth = _by_tenant(state, "gauges", "repro_queue_depth")
    epoch = _by_tenant(state, "gauges", "repro_epoch")
    dropped = _by_tenant(state, "counters", "repro_queue_dropped_edges_total")
    pub_lat = {labels.get("tenant", ""): h for labels, h
               in _rows(state, "hists", "repro_publish_latency_seconds")}
    if edges:
        out.append("ingest (per shard)")
        out.append(f"  {'tenant':<40} {'edges':>10} {'edges/s':>10} "
                   f"{'queue':>6} {'epoch':>6} {'drop':>6} {'pub p99 ms':>10}")
        for tenant in sorted(edges):
            h = pub_lat.get(tenant)
            p99 = f"{_q(h, 0.99) * 1e3:.1f}" if h and h["count"] else "-"
            out.append(
                f"  {tenant:<40} {int(edges[tenant]):>10} "
                f"{eps.get(tenant, 0.0):>10.1f} "
                f"{int(depth.get(tenant, 0)):>6} "
                f"{int(epoch.get(tenant, 0)):>6} "
                f"{int(dropped.get(tenant, 0)):>6} {p99:>10}")
    else:
        out.append("ingest: no shards reporting yet")

    ledger = {name: value for name, labels, value
              in state.get("counters", ()) if name.startswith("repro_query_")}
    lat = _rows(state, "hists", "repro_query_latency_seconds")
    if ledger or lat:
        out.append("query")
        keys = ("repro_query_offered_requests_total",
                "repro_query_served_requests_total",
                "repro_query_shed_overload_total",
                "repro_query_auth_failures_total")
        out.append("  " + "  ".join(
            f"{k.removeprefix('repro_query_').removesuffix('_total')}="
            f"{int(ledger.get(k, 0))}" for k in keys))
        inflight = _rows(state, "gauges", "repro_query_inflight")
        if inflight:
            out.append(f"  inflight={int(inflight[0][1])}")
        if lat and lat[0][1]["count"]:
            h = lat[0][1]
            out.append(
                f"  latency ms: p50={_q(h, 0.5) * 1e3:.2f} "
                f"p90={_q(h, 0.9) * 1e3:.2f} p99={_q(h, 0.99) * 1e3:.2f} "
                f"p999={_q(h, 0.999) * 1e3:.2f} n={h['count']}")
    else:
        out.append("query: no front-end reporting")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="poll a repro telemetry surface and render live panels")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--connect", metavar="HOST:PORT",
                     help="scrape the 'metrics' frame from a query_serve "
                          "--serve or stream_ingest --listen address")
    src.add_argument("--json", metavar="PATH",
                     help="follow a --metrics-json file instead of a socket")
    ap.add_argument("--auth-token", default="",
                    help="token for a remote server "
                         "(default: $KMATRIX_NET_TOKEN)")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--timeout-s", type=float, default=15.0)
    ap.add_argument("--once", action="store_true",
                    help="one frame then exit; non-zero on fetch/parse "
                         "failure (the CI scrape assertion)")
    args = ap.parse_args(argv)

    while True:
        try:
            payload = fetch_payload(args)
            samples = parse_prometheus_text(payload.get("prometheus", ""))
        except Exception as exc:  # noqa: BLE001 — every failure mode counts
            print(f"scrape failed: {exc!r}", file=sys.stderr)
            if args.once:
                return 1
            time.sleep(args.interval)
            continue
        print(render_panels(payload))
        print(f"   ({len(samples)} exposition samples parsed)")
        sys.stdout.flush()
        if args.once:
            return 0
        time.sleep(args.interval)


if __name__ == "__main__":
    raise SystemExit(main())
