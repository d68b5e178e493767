"""Structured JSONL event log (slow-query log and friends).

One JSON object per line: ``{"ts": <unix seconds>, "kind": ...,
**payload}``. Writes are serialized by a lock and flushed per event —
a slow-query log that loses its tail on crash is useless, and the
emit rate is bounded by the slow threshold, not the query rate.

A bounded in-memory ring mirrors the last events so tests and the
STATS surface can read them without re-parsing the file; ``path=None``
keeps the log memory-only.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import Optional, Union


class EventLog:
    def __init__(self, path: Optional[Union[str, Path]] = None, *,
                 ring: int = 256):
        self.path = Path(path) if path is not None else None
        self._lock = threading.Lock()
        self._ring: "deque[dict]" = deque(maxlen=ring)
        self._emitted = 0
        self._fh = None
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")

    def emit(self, kind: str, payload: dict) -> dict:
        event = {"ts": time.time(), "kind": kind}
        event.update(payload)
        line = json.dumps(event, separators=(",", ":"),
                          default=str)
        with self._lock:
            self._emitted += 1
            self._ring.append(event)
            if self._fh is not None:
                self._fh.write(line + "\n")
                self._fh.flush()
        return event

    @property
    def emitted(self) -> int:
        with self._lock:
            return self._emitted

    def tail(self, n: int = 0, *, kind: Optional[str] = None) -> list[dict]:
        with self._lock:
            events = list(self._ring)
        if kind is not None:
            events = [e for e in events if e.get("kind") == kind]
        return events[-n:] if n else events

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path: Union[str, Path]) -> list[dict]:
    """Parse a JSONL event file (skipping torn/blank lines)."""
    out = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out
