"""Asynchronous telemetry stream: one JSONL record per control step.

Counterpart of `tpu_dialmpc/telemetry/stream.py`, with its record keys.
`emit(record)` queues any JSON-serialisable dict as it is.  The
control loop hands `emit_step` its step's state and planner infos; the
values it records stay on the device, packed into one small tensor, and a
writer thread reads them back and writes the JSONL line, so the loop never
waits for a record.  The queue is bounded: when it is full a record is
dropped (counted in `dropped`) rather than stall the loop.

The writer thread hands each JSONL line to one of two backends, as in the
JAX package: `"native"`, the C++ ring-buffer sink (`telemetry/native.py`,
built from `csrc/telemetry_sink.cpp` at first use), which raises
RuntimeError where it cannot be built; `"python"`, a file the thread writes
itself; and `"auto"` (the default), the native sink where it builds and
the Python writer where it does not.  Both write the same lines.  Without a
path nothing is written and no sink is made; the records are kept
(`records`) either way.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Optional

import torch

from tpu_dialmpc_torch.telemetry.native import NativeSink

_BASE = ("reward", "done", "z")
_PLANNER = ("ess", "entropy", "rew_mean", "rew_max", "rew_std")


class TelemetryStream:
    """JSONL telemetry writer with a background thread."""

    def __init__(self, path: Optional[str] = None, maxsize: int = 4096, backend: str = "auto"):
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"unknown telemetry backend {backend!r}")
        self.path = path
        self._dropped = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._records = []
        self._native = None
        self._file = None
        if path and backend in ("auto", "native"):
            try:
                self._native = NativeSink(path, capacity=maxsize)
            except RuntimeError:
                if backend == "native":
                    raise
        if path and self._native is None:
            self._file = open(path, "w")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._writer, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def emit_step(self, t: int, state, infos) -> None:
        """Queue one control step's diagnostics: the executed step's reward,
        done flag and torso height, the last annealing iteration's ESS,
        weight entropy and candidate reward statistics, and under
        `diag_states` the end of its weighted state averages."""
        parts = [state.reward, state.done, state.pipeline.qpos[2]]
        diag = False
        if infos is not None:
            rews = infos.rews[-1]
            parts += [infos.ess[-1], infos.entropy[-1], rews.mean(), rews.max(),
                      rews.std(correction=0)]
            # the placeholders are (1, 1) per iteration (dial-core.h:577-589)
            diag = infos.qbar.numel() > infos.qbar.shape[0]
            if diag:
                parts += [*infos.xbar[-1][-1], infos.qbar[-1][-1, 2],
                          torch.linalg.vector_norm(infos.qdbar[-1][-1])]
        packed = torch.stack([p.detach().to(torch.float64) for p in parts])
        try:
            self._q.put_nowait((int(t), time.time(), infos is not None, diag, packed))
        except queue.Full:
            self._dropped += 1  # drop rather than stall the control loop

    def emit(self, record: dict) -> None:
        """Queue one record as it is (a dict the writer serialises to a JSONL
        line); dropped, and counted in `dropped`, when the queue is full."""
        try:
            self._q.put_nowait(record)
        except queue.Full:
            self._dropped += 1

    # ------------------------------------------------------------------
    @staticmethod
    def _record(item) -> dict:
        if isinstance(item, dict):  # from emit: written as given
            return item
        t, stamp, planner, diag, packed = item
        vals = packed.tolist()  # the one read back, on this thread
        rec = {"t": t, "time": stamp, **dict(zip(_BASE, vals))}
        rec["done"] = bool(rec["done"])
        rec.update(dict(zip(_PLANNER, vals[3:8] if planner else [None] * 5)))
        if diag:
            rec["xbar_end"] = vals[8:11]
            rec["qbar_end_z"], rec["qdbar_end_norm"] = vals[11], vals[12]
        return rec

    def _write(self, rec: dict) -> None:
        if self._native is not None:
            self._native.push(json.dumps(rec))
        elif self._file:
            self._file.write(json.dumps(rec) + "\n")

    def _writer(self):
        while not self._stop.is_set() or not self._q.empty():
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            rec = self._record(item)
            self._records.append(rec)
            self._write(rec)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=30.0)
        if self._native is not None:
            self._native.close()  # drains its ring to the file
        if self._file:
            self._file.close()
            self._file = None

    @property
    def backend(self) -> Optional[str]:
        """"native" or "python": where the lines go (None without a path)."""
        if self._native is not None:
            return "native"
        return "python" if self.path else None

    @property
    def dropped(self) -> int:
        """Records dropped: by the full queue, and by the native sink's full
        ring."""
        return self._dropped + (self._native.dropped if self._native is not None else 0)

    @property
    def records(self):
        return list(self._records)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
