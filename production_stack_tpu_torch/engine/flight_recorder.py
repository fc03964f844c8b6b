"""Per-request flight recorder: a bounded in-memory ring of event
timelines.

Counterpart of ``production_stack_tpu/engine/flight_recorder.py``, the same
API and record shapes (``FlightRecord``, ``FlightRecorder.start / event /
finish / alias / get / timeline``, ``phases``), so a port engine's
``GET /debug/requests/{id}`` answers what the JAX engine's does.

When a request misses its SLO, aggregate Prometheus series cannot say
where its time went: queue wait, a shared-tier restore, prefill, or the
decode trains' cadence. The recorder keeps one event timeline per recent
request, appended from the engine loop's dispatch points (enqueue,
schedule, each dispatch's issue and fetch, restore round trips,
preemption, resume, handoff, finish) and served at
``GET /debug/requests/{id}`` and ``GET /debug/timeline``.

Hot-path contract: every append is an O(1) in-memory list append with a
per-request cap: no syscalls, no locks (the engine loop and the debug
handlers share one event-loop thread), no device value read, no effect on
scheduling or sampling. Bounded two ways: at most ``capacity`` request
records (oldest evicted first) and at most ``max_events`` events per
record (overflow is counted on the record, never silently lost).

``phases()`` folds a record's events into queue-wait / prefill / decode /
kv-restore / handoff intervals, which the API server exports as OTLP child
spans of the request's server span (``tracing.py``).
"""

import time
from collections import OrderedDict
from typing import Dict, List, Optional

import torch  # noqa: F401 — every module of the port is a torch module

# Event names the engine records (the JAX package's schema).
EVENT_NAMES = (
    "enqueue", "resume", "schedule", "prefill_issue", "prefill_fetch",
    "decode_issue", "decode_fetch", "restore", "preempt",
    "handoff_restore", "handoff_publish", "finish",
)


class FlightRecord:
    """One request's timeline. Events are (wall_time_s, name, data|None)
    tuples — tuples, not dicts, to keep the hot-path append allocation
    small and the JSON rendering explicit."""

    __slots__ = ("request_id", "created", "events", "finished",
                 "events_dropped", "meta")

    def __init__(self, request_id: str, meta: Optional[dict] = None):
        self.request_id = request_id
        self.created = time.time()
        self.events: List[tuple] = []
        self.finished = False
        self.events_dropped = 0
        self.meta = meta or {}

    def to_dict(self) -> dict:
        return {
            "request_id": self.request_id,
            "created": self.created,
            "finished": self.finished,
            "events_dropped": self.events_dropped,
            **self.meta,
            "events": [
                {"t": round(t, 6), "event": name, **(data or {})}
                for t, name, data in self.events
            ],
            "phases": phases(self),
        }

    def summary(self) -> dict:
        last = self.events[-1] if self.events else None
        return {
            "request_id": self.request_id,
            "created": round(self.created, 6),
            "finished": self.finished,
            "num_events": len(self.events),
            "events_dropped": self.events_dropped,
            "last_event": last[1] if last else None,
            "last_event_t": round(last[0], 6) if last else None,
            **self.meta,
        }


class FlightRecorder:
    """Bounded ring of FlightRecords keyed by engine request id, with an
    alias index so the router-visible ``x-request-id`` (and the OpenAI
    response id) resolve to the engine-internal child request ids."""

    def __init__(self, capacity: int = 256, max_events: int = 512):
        self.capacity = max(1, capacity)
        self.max_events = max(8, max_events)
        self._records: "OrderedDict[str, FlightRecord]" = OrderedDict()
        self._aliases: "OrderedDict[str, List[str]]" = OrderedDict()
        self.records_evicted_total = 0

    # ------------------------------------------------------------ hot path
    def start(self, request_id: str, **meta) -> None:
        if request_id in self._records:
            # Re-used id (tests, resubmits): the new attempt replaces the
            # old timeline at the ring's tail.
            self._records.pop(request_id, None)
        self._records[request_id] = FlightRecord(request_id, meta or None)
        while len(self._records) > self.capacity:
            self._records.popitem(last=False)
            self.records_evicted_total += 1

    def event(self, request_id: str, name: str,
              data: Optional[dict] = None, t: Optional[float] = None) -> None:
        rec = self._records.get(request_id)
        if rec is None:
            return
        if len(rec.events) >= self.max_events:
            rec.events_dropped += 1
            return
        rec.events.append((t if t is not None else time.time(), name, data))

    def finish(self, request_id: str, reason: Optional[str] = None,
               output_tokens: int = 0) -> None:
        rec = self._records.get(request_id)
        if rec is None or rec.finished:
            return
        rec.finished = True
        # The finish event bypasses the per-record cap: a truncated
        # timeline must still show how the request ended.
        rec.events.append((time.time(), "finish", {
            "reason": reason, "output_tokens": output_tokens,
        }))

    # ------------------------------------------------------------- lookup
    def alias(self, external_id: str, request_ids: List[str]) -> None:
        """Map a client-facing id (x-request-id header / response id) to
        the engine-internal per-choice request ids."""
        if not external_id or not request_ids:
            return
        self._aliases[external_id] = list(request_ids)
        while len(self._aliases) > 2 * self.capacity:
            self._aliases.popitem(last=False)

    def get(self, key: str) -> Optional[dict]:
        """Timeline(s) for an engine request id or a client-facing alias.
        Always the same shape: {"request_id": key, "records": [...]}."""
        rec = self._records.get(key)
        if rec is not None:
            return {"request_id": key, "records": [rec.to_dict()]}
        rids = self._aliases.get(key)
        if rids:
            found = [
                self._records[rid].to_dict()
                for rid in rids if rid in self._records
            ]
            if found:
                return {"request_id": key, "records": found}
        return None

    def timeline(self, max_requests: int = 64) -> dict:
        """Most-recent request summaries (newest first) — the fleet-wide
        ``GET /debug/timeline`` view. ``max_requests <= 0`` returns none
        (a negative slice bound would INVERT the cap)."""
        recent = (list(self._records.values())[-max_requests:]
                  if max_requests > 0 else [])
        return {
            "capacity": self.capacity,
            "recorded": len(self._records),
            "records_evicted_total": self.records_evicted_total,
            "requests": [r.summary() for r in reversed(recent)],
        }


# ------------------------------------------------------------- phase tree
def phases(rec: FlightRecord) -> List[dict]:
    """Fold a record's events into phase intervals: the engine-side span
    tree (queue-wait, prefill, decode aggregated per train, kv-restore,
    handoff). Pure over the event list, so the same function backs both
    the debug endpoint and the OTLP span emission."""
    first_issue = None
    prefill_start = prefill_end = None
    decode_start = decode_end = None
    decode_trains = 0
    decode_tokens = 0
    spec_accepted = 0   # batch-level sum over trains (see decode_fetch)
    spec_drafts = 0     # batch-level drafted sum (variable under gamma)
    enqueue_t = None
    restore_tokens = 0
    restore_seconds = 0.0
    restore_start = restore_end = None
    handoff = None
    finish_t = None
    for t, name, data in rec.events:
        data = data or {}
        if name == "enqueue":
            enqueue_t = t
        elif name in ("prefill_issue", "decode_issue"):
            if first_issue is None:
                first_issue = t
            if name == "prefill_issue":
                if prefill_start is None:
                    prefill_start = t
            elif decode_start is None:
                decode_start = t
        elif name == "prefill_fetch":
            prefill_end = t
        elif name == "decode_fetch":
            decode_end = t
            decode_trains += 1
            decode_tokens += int(data.get("tokens", 0))
            # BATCH-level acceptance per train (the device commits per
            # dispatch, not per row) — the phase attr keeps the _batch
            # suffix so nobody reads it as this request's own count.
            spec_accepted += int(data.get("spec_accepted_batch", 0))
            spec_drafts += int(data.get("spec_drafts_batch", 0))
        elif name == "restore":
            secs = float(data.get("seconds", 0.0))
            restore_tokens += int(data.get("tokens", 0))
            restore_seconds += secs
            if restore_start is None:
                restore_start = t - secs
            restore_end = t
        elif name == "handoff_publish":
            handoff = {"name": "handoff", "start": round(t, 6),
                       "end": round(t, 6),
                       "attrs": {"ok": bool(data.get("ok", False))}}
        elif name == "handoff_restore":
            handoff = {"name": "handoff", "start": round(t, 6),
                       "end": round(t, 6),
                       "attrs": {"blocks": int(data.get("blocks", 0))}}
        elif name == "finish":
            finish_t = t
    out: List[dict] = []
    if enqueue_t is not None:
        # Queue wait ends at the first dispatch issue; a request that
        # never dispatched (shed/abort while waiting) waits to its end.
        end = first_issue if first_issue is not None else \
            (finish_t if finish_t is not None else enqueue_t)
        out.append({"name": "queue_wait", "start": round(enqueue_t, 6),
                    "end": round(end, 6), "attrs": {}})
    if restore_start is not None:
        out.append({
            "name": "kv_restore", "start": round(restore_start, 6),
            "end": round(restore_end, 6),
            "attrs": {"tokens": restore_tokens,
                      "seconds": round(restore_seconds, 6)},
        })
    if prefill_start is not None:
        out.append({
            "name": "prefill", "start": round(prefill_start, 6),
            "end": round(prefill_end if prefill_end is not None
                         else prefill_start, 6),
            "attrs": {},
        })
    if decode_start is not None:
        attrs: Dict[str, object] = {"trains": decode_trains,
                                    "tokens": decode_tokens}
        if spec_accepted:
            attrs["spec_accepted_batch"] = spec_accepted
        if spec_drafts:
            # Denominator companion: adaptive gamma makes the per-train
            # draft count variable, so acceptance is no longer derivable
            # from spec_accepted_batch alone.
            attrs["spec_drafts_batch"] = spec_drafts
        out.append({
            "name": "decode", "start": round(decode_start, 6),
            "end": round(decode_end if decode_end is not None
                         else decode_start, 6),
            "attrs": attrs,
        })
    if handoff is not None:
        out.append(handoff)
    return out
