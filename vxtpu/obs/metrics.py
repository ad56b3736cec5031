"""Performance metrics: fps and Mrays/s/chip — the judged metric
(BASELINE.json: "Mrays/s/chip at 512³ grid, 1080p") — plus march-step
statistics. The reference analog is the SFML fps-counter overlay
(SURVEY.md §3 C15); here metrics go to stdout/JSONL so headless benches and
the driver can consume them.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import jax


def mrays_per_s(height: int, width: int, frame_s: float) -> float:
    return height * width / frame_s / 1e6


@dataclass
class MetricsSink:
    """JSONL + stdout metric emission.

    Multi-host: BOTH the echo and the file write are gated to process 0
    unless ``all_hosts`` is set — N hosts appending to one shared JSONL
    path would interleave lines. Set all_hosts=True
    only with per-host paths (e.g. suffix jax.process_index())."""

    path: str | None = None
    echo: bool = True
    all_hosts: bool = False
    _t0: float = field(default_factory=time.time)

    def _is_emitter(self) -> bool:
        if self.all_hosts:
            return True
        try:
            return jax.process_index() == 0
        except Exception:
            return True

    def emit(self, **kv):
        if not self._is_emitter():
            return
        rec = dict(t=round(time.time() - self._t0, 3), **kv)
        line = json.dumps(rec)
        if self.echo:
            print(line, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
