"""Exposition plumbing shared by the launchers and the net servers (a copy
of the JAX package's ``obs/dump.py``).

``scrape_payload`` is the one canonical shape a telemetry consumer sees —
the same dict whether it arrives as a ``metrics`` wire frame (query_serve
``--serve`` / stream_ingest ``--listen``), a ``--metrics-json`` file on
disk, or a dashboard poll:

    {"prometheus": <text exposition>, "state": <merged hub state>, "ts": ...}

``MetricsJsonDumper`` is the file flavour: a daemon thread renders the
payload every ``interval_s`` and lands it with write-to-tmp + ``os.replace``
so a concurrent reader (the dashboard, a CI assertion) never sees a torn
JSON document.
"""
from __future__ import annotations

import json
import os
import threading
import time

from repro_torch.obs.hub import get_hub, render_prometheus


def scrape_payload() -> dict:
    """One telemetry scrape: the process-global hub, merged across adopted
    workers, as both Prometheus text and the raw state dict."""
    state = get_hub().merged_state()
    return {"prometheus": render_prometheus(state), "state": state,
            "ts": time.time()}


class MetricsJsonDumper:
    """Periodically dump ``scrape_payload()`` to ``path`` atomically."""

    def __init__(self, path: str, interval_s: float = 1.0) -> None:
        self.path = path
        self.interval_s = max(0.05, float(interval_s))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.writes = 0

    def write_once(self) -> None:
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump(scrape_payload(), f)
        os.replace(tmp, self.path)
        self.writes += 1

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.write_once()
            except OSError:
                pass  # transient fs trouble must not kill the dump cadence

    def start(self) -> "MetricsJsonDumper":
        self.write_once()  # the file exists before the workload starts
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="metrics-json-dumper")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the cadence and land one final dump (the post-drain state —
        the one a scripted run actually wants to read)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.write_once()
