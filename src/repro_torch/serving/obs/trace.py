"""Structured tracing for the serving engines: a fixed-capacity ring buffer
of spans, exportable as Chrome trace-event JSON.

Design constraints (these ARE the feature):

  * O(1) append into a preallocated ring — recording a span is a few tuple
    stores, no allocation growth, no locks (the serve loops are
    single-threaded per engine; the metrics HTTP thread only READS exported
    snapshots).
  * Zero device-side cost: every span is built from host timestamps the
    engine already takes for ``EngineStats`` (dispatch walls, the harvest's
    wait on the sync packet, scheduler submit/admit stamps).  Tracing
    never adds a device synchronisation or a transfer.
  * Off by default: engines take ``tracer=None`` and guard every record
    site with one ``is not None`` check, so the tracing-off overhead is a
    single attribute test per boundary.
  * Overflow drops the OLDEST spans (ring semantics) and counts them in
    ``dropped`` — a long serve with a small buffer keeps the most recent
    window instead of dying or silently truncating the tail.

Lane conventions (how the engines use pid/tid):

  * request-lifecycle spans: ``pid`` = shard id, ``tid`` = slot index —
    one Perfetto row per slot, "queued" (submit -> admit) and "request"
    (admit -> retire) spans with rid/rounds/accepts/theta_live attributes.
  * boundary spans: ``pid`` = shard id, ``tid`` = num_slots + lane —
    dispatch / device / harvest rows underneath the slots.

Export is the Chrome trace-event JSON array format ("X" complete events
with ts/dur in microseconds plus "M" metadata name events), which
https://ui.perfetto.dev loads directly.
"""

from __future__ import annotations

import json
import time
from typing import Optional


class TraceRecorder:
    """Fixed-capacity ring buffer of trace spans.

    Args:
      capacity: maximum retained events; older events are dropped (and
        counted) once exceeded.
      enabled: record-site gate; a disabled recorder ignores appends so a
        CLI can build one unconditionally and flip it on for a window.
    """

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self.dropped = 0
        # epoch: export timestamps are relative to recorder construction so
        # traces from one run are comparable and deterministic in layout
        self.epoch = time.perf_counter()
        self._buf: list = [None] * self.capacity
        self._start = 0  # ring read position
        self._n = 0      # live events
        self._seq = 0    # insertion counter (stable export order)
        # lane names, registered once per (pid)/(pid, tid): exported as
        # Chrome "M" metadata events so Perfetto labels the rows
        self._pnames: dict = {}
        self._tnames: dict = {}

    def __len__(self) -> int:
        return self._n

    @staticmethod
    def now() -> float:
        """The clock spans are recorded against (``time.perf_counter``)."""
        return time.perf_counter()

    def _append(self, event: tuple) -> None:
        if self._n == self.capacity:  # drop-oldest ring overflow
            self._buf[self._start] = event
            self._start = (self._start + 1) % self.capacity
            self.dropped += 1
        else:
            self._buf[(self._start + self._n) % self.capacity] = event
            self._n += 1
        self._seq += 1

    def _register(self, pid: int, tid: Optional[int],
                  pname: Optional[str], tname: Optional[str]) -> None:
        if pname is not None and pid not in self._pnames:
            self._pnames[pid] = pname
        if tname is not None and tid is not None and (
                (pid, tid) not in self._tnames):
            self._tnames[(pid, tid)] = tname

    def add_span(self, name: str, t0: float, t1: float, *,
                 pid: int = 0, tid: int = 0,
                 pname: Optional[str] = None, tname: Optional[str] = None,
                 args: Optional[dict] = None) -> None:
        """Record one complete span [t0, t1] (perf_counter seconds)."""
        if not self.enabled:
            return
        self._register(pid, tid, pname, tname)
        self._append(("X", name, t0, max(t1 - t0, 0.0), pid, tid,
                      args, self._seq))

    def add_instant(self, name: str, t: float, *,
                    pid: int = 0, tid: int = 0,
                    pname: Optional[str] = None, tname: Optional[str] = None,
                    args: Optional[dict] = None) -> None:
        """Record one instant event at ``t`` (perf_counter seconds)."""
        if not self.enabled:
            return
        self._register(pid, tid, pname, tname)
        self._append(("i", name, t, 0.0, pid, tid, args, self._seq))

    def clear(self) -> None:
        """Empty the ring (names and the epoch are kept)."""
        self._buf = [None] * self.capacity
        self._start = 0
        self._n = 0
        self.dropped = 0

    # -- export --------------------------------------------------------------

    def _events(self) -> list:
        return [self._buf[(self._start + i) % self.capacity]
                for i in range(self._n)]

    def spans(self) -> list:
        """Snapshot of the retained events as dicts, insertion-ordered."""
        out = []
        for ph, name, t0, dur, pid, tid, args, _ in self._events():
            d = {"ph": ph, "name": name, "t0": t0, "dur": dur,
                 "pid": pid, "tid": tid}
            if args:
                d["args"] = dict(args)
            out.append(d)
        return out

    def to_chrome(self) -> dict:
        """The Chrome trace-event object: "M" metadata name events first,
        then the retained spans sorted by (ts, insertion order) — a stable
        layout, so the export is deterministic for a given recording."""
        events = []
        for pid in sorted(self._pnames):
            events.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": self._pnames[pid]}})
        for pid, tid in sorted(self._tnames):
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": self._tnames[(pid, tid)]}})
        recs = sorted(self._events(), key=lambda e: (e[2], e[7]))
        for ph, name, t0, dur, pid, tid, args, _ in recs:
            ev = {
                "ph": ph, "name": name,
                "ts": round((t0 - self.epoch) * 1e6, 3),
                "pid": pid, "tid": tid,
            }
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            else:
                ev["s"] = "t"  # instant scope: thread
            if args:
                ev["args"] = {k: v for k, v in args.items() if v is not None}
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "droppedEvents": self.dropped}

    def export_chrome_trace(self, path: str) -> dict:
        """Write the Chrome trace JSON to ``path`` (open in Perfetto:
        https://ui.perfetto.dev -> Open trace file).  Returns the object."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f, sort_keys=True, separators=(",", ":"))
            f.write("\n")
        return doc
