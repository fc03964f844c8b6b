"""Incremental SSE stream parser for the router's mid-stream resume splice
(docs/RESILIENCE.md).

The relay used to forward raw bytes (``iter_any``); a backend dying
mid-event could leave half an SSE frame on the client's wire, making any
continuation unsplicable. This parser sits between the backend read and the
client write:

  * only COMPLETE events (``\\n\\n``-terminated) are forwarded, so the
    client's stream always ends on an event boundary;
  * each event's ``pstpu`` payload (emitted by the engine's streaming
    handlers: the chunk's output token ids, their offset, and the request's
    resolved sampler seed base) is tracked, giving the router the exact
    resume state — delivered token ids + seed — it needs to re-issue the
    request on another engine;
  * events whose tokens were already delivered (overlap after a resume) are
    dropped by token offset, so a splice never duplicates bytes;
  * a ``finish_reason`` chunk and the ``[DONE]`` sentinel are tracked so
    the router knows whether a dead backend's stream was semantically
    complete (synthesize ``[DONE]``) or truly interrupted (resume or
    truncate).

Deliberately forgiving: events that do not parse as JSON are forwarded
untouched, and a buffer overflow (non-SSE bytes mislabelled as an event
stream) flushes raw and permanently degrades to passthrough — the parser
must never break a relay it cannot understand, only withdraw resumability.

The port's copy of ``production_stack_tpu/router/sse.py``.
"""

import json
from typing import List, Optional

#: Cap on buffered partial-event bytes before degrading to passthrough.
MAX_EVENT_BYTES = 1 << 20

DONE_EVENT = b"data: [DONE]\n\n"


class SseResumeParser:
    """Tracks one client stream's delivered state across backend hops."""

    def __init__(self, delivered: Optional[List[int]] = None):
        self._buf = b""
        # Output token ids delivered to the client, in order. Seeded with
        # the request's own resume_tokens when the CLIENT is itself
        # resuming (router-of-routers): engine offsets then line up.
        self.delivered: List[int] = list(delivered or [])
        self.seed: Optional[int] = None    # resolved sampler seed base
        self.finished = False              # a finish_reason chunk was relayed
        self.done = False                  # data: [DONE] was relayed
        self.degraded = False              # passthrough mode, not resumable
        # After a router-initiated resume the attached backend MUST speak
        # the resume protocol (pstpu token payloads): a backend that
        # streams content chunks without them (mixed-version fleet) would
        # restart the answer from token 0 and the splice would duplicate
        # it. begin_strict() arms the check; a violation stops forwarding
        # and the relay aborts the backend.
        self._strict = False
        self.violation = False
        self.events_relayed = 0

    def begin_strict(self) -> None:
        self._strict = True

    @property
    def resumable(self) -> bool:
        """Enough state to splice a continuation: the backend spoke the
        resume protocol (seed seen) and the stream isn't semantically
        complete."""
        return (
            not self.degraded and not self.finished and not self.done
            and self.seed is not None
        )

    def feed(self, data: bytes) -> List[bytes]:
        """Consume backend bytes; return the complete events to forward."""
        if self.degraded:
            # Passthrough — but never strand a previously-buffered partial
            # event: its leading bytes belong before this data on the wire.
            out = self._buf + data
            self._buf = b""
            self.events_relayed += 1
            return [out]
        self._buf += data
        events: List[bytes] = []
        while True:
            # SSE events end on a blank line; both LF and CRLF framing are
            # spec-legal (sse-starlette emits \r\n) — take the earlier.
            i = self._buf.find(b"\n\n")
            j = self._buf.find(b"\r\n\r\n")
            if j >= 0 and (i < 0 or j < i):
                i, seplen = j, 4
            elif i >= 0:
                seplen = 2
            else:
                break
            event = self._buf[: i + seplen]
            self._buf = self._buf[i + seplen:]
            if self._track(event):
                self.events_relayed += 1
                events.append(event)
        if len(self._buf) > MAX_EVENT_BYTES:
            # Not actually SSE (or absurd events): stop buffering, flush
            # raw, and give up resumability for this stream.
            self.degraded = True
            events.append(self._buf)
            self.events_relayed += 1
            self._buf = b""
        return events

    def flush_residue(self) -> bytes:
        """Unterminated tail bytes at end-of-stream. Forwarded by the relay
        for streams that never spoke the resume protocol (a foreign SSE
        backend may legally end without a trailing blank line); protocol
        streams always end on the [DONE] event boundary, and on a
        truncation the partial frame is deliberately dropped."""
        tail, self._buf = self._buf, b""
        return tail

    def _payload(self, event: bytes) -> Optional[bytes]:
        for line in event.split(b"\n"):
            if line.startswith(b"data:"):
                return line[len(b"data:"):].strip()
        return None

    def _track(self, event: bytes) -> bool:
        """Update delivered/finished/done state; False = drop the event
        (already-delivered overlap after a resume)."""
        if self.violation:
            # A violated (post-resume, protocol-breaking) backend is being
            # aborted by the relay: stop forwarding ANYTHING it sends —
            # including its [DONE], which would otherwise mark a
            # token-0 replay "semantically complete" and hide the missing
            # tail from the truncation accounting.
            return False
        payload = self._payload(event)
        if payload is None:
            return True          # comment/keepalive frame: forward
        if payload == b"[DONE]":
            self.done = True
            return True
        try:
            obj = json.loads(payload)
        except ValueError:
            return True          # not ours to judge: forward untouched
        if not isinstance(obj, dict):
            return True
        # Field names are the registry-pinned SSE payload contract
        # (tools/pstpu_lint/http_registry.py; PL011 checks each consumer
        # reads every registered key).
        meta = obj.get("pstpu")
        toks = meta.get("toks") if isinstance(meta, dict) else None
        off = meta.get("off") if isinstance(meta, dict) else None
        has_token_meta = (
            isinstance(toks, list) and isinstance(off, int)
            and all(type(t) is int for t in toks)
        )
        if self._strict and obj.get("choices") and not has_token_meta:
            # Post-resume content chunk WITHOUT the resume payload: the
            # attached backend does not speak the protocol (mixed-version
            # fleet) and may be restarting the answer from token 0 — drop
            # and abort rather than splice a duplicate.
            self.violation = True
            return False
        if isinstance(meta, dict):
            seed = meta.get("seed")
            if seed is not None and type(seed) is not bool and \
                    isinstance(seed, int):
                self.seed = seed
        if has_token_meta:
            if toks and off + len(toks) <= len(self.delivered):
                # Every token in this event was already delivered before
                # the hop — drop it so the splice never repeats bytes.
                # (Token-empty events — role deltas, finish chunks — are
                # never dropped.)
                return False
            if toks and off < len(self.delivered):
                # PARTIAL overlap: the event's text cannot be split to
                # match the token dedup, so relaying it would duplicate
                # the overlapped tokens' bytes. A compliant continuation
                # starts exactly at (or fully before) the delivered
                # boundary, so treat mis-aligned framing like a protocol
                # break: drop and abort (resume again or truncate).
                if self._strict:
                    self.violation = True
                    return False
                self.delivered.extend(toks[len(self.delivered) - off:])
                self.degraded = True
                return True
            if off <= len(self.delivered):
                self.delivered.extend(toks)
            elif self._strict:
                # A token GAP from a resumed backend means the client
                # would receive text with a silent hole between the
                # delivered boundary and ``off`` — abort like any other
                # protocol break instead of relaying a wrong answer.
                self.violation = True
                return False
            else:
                # A gap means the backend skipped tokens we never saw; the
                # stream is no longer provably contiguous, so withdraw
                # resumability but keep relaying.
                self.delivered.extend(toks)
                self.degraded = True
        for choice in obj.get("choices") or []:
            if isinstance(choice, dict) and choice.get("finish_reason"):
                self.finished = True
        return True
