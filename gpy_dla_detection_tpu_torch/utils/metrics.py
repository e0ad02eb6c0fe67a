"""Structured run metrics: JSON-lines event log for survey runs.

The reference's observability is wall-clock ``print`` statements
(reference: run_bayes_select.py:142,232-234; ``fprintf_debug`` in
set_parameters.m:92).  Production survey runs need a machine-readable
record: the ``RunLogger`` emits one JSON object per event —
run configuration, per-batch throughput, per-spectrum failures, and the
final summary — to a sidecar ``<output>.metrics.jsonl`` file that
monitoring can tail.  Purely host-side; never touches the device.

The port's own copy of ``gpy_dla_detection_tpu/utils/metrics.py``, kept equal
to it name for name, so that the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import json
import os
import time


class RunLogger:
    """Append-only JSONL event logger for one pipeline run.

    Every event carries ``ts`` (unix seconds), ``elapsed_s`` (since the
    logger was created) and ``event``.  A ``None`` path disables
    logging (all methods become no-ops) so CLIs can thread it
    unconditionally.
    """

    def __init__(self, path: str | None, run_config: dict | None = None):
        self._path = path
        self._t0 = time.time()
        self._f = None
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")
            self.emit("run_start", config=run_config or {})

    def emit(self, event: str, **fields) -> None:
        if self._f is None:
            return
        now = time.time()
        record = {
            "ts": round(now, 3),
            "elapsed_s": round(now - self._t0, 3),
            "event": event,
        }
        record.update(fields)
        self._f.write(json.dumps(record, default=_jsonable) + "\n")
        self._f.flush()

    def batch(self, index: int, size: int, done: int, total: int,
              seconds: float, **extra) -> None:
        self.emit(
            "batch_done",
            batch_index=index,
            batch_size=size,
            spectra_done=done,
            spectra_total=total,
            batch_seconds=round(seconds, 3),
            spectra_per_sec=round(done / max(time.time() - self._t0, 1e-9), 3),
            **extra,
        )

    def failure(self, item: str, error: str) -> None:
        self.emit("spectrum_failed", item=item, error=error)

    def finish(self, **summary) -> None:
        self.emit("run_end", **summary)
        if self._f is not None:
            self._f.close()
            self._f = None


def _jsonable(x):
    try:
        return float(x)
    except Exception:
        return str(x)


def read_metrics(path: str) -> list[dict]:
    """Parse a metrics JSONL file back into a list of events."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events
