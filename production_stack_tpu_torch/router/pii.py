"""PII detection middleware (feature-gated).

Contract parity with reference src/vllm_router/experimental/pii/: request
bodies are scanned before routing; matches can BLOCK (400 with the detected
types) or REDACT in place (middleware.py:103-154, types.py). The regex
analyzer ships; ``--pii-analyzer presidio`` needs presidio-analyzer and fails
at construction without it.

The port's copy of ``production_stack_tpu/router/pii.py``: the three
counters live on the port's registry (``router/metrics.py``) and render as
the JAX router's do; the block response is a ``router/http.py`` response.
"""

import enum
import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Pattern

from production_stack_tpu_torch.protocols import ErrorResponse
from production_stack_tpu_torch.router import http as web
from production_stack_tpu_torch.router.metrics import Counter
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

pii_requests_total = Counter(
    "vllm:pii_requests_scanned", "Requests scanned for PII"
)
pii_detections_total = Counter(
    "vllm:pii_detections", "PII entities detected", ["pii_type"]
)
pii_blocked_total = Counter(
    "vllm:pii_requests_blocked", "Requests blocked due to PII"
)


class PIIType(str, enum.Enum):
    EMAIL = "email"
    PHONE = "phone"
    SSN = "ssn"
    CREDIT_CARD = "credit_card"
    IP_ADDRESS = "ip_address"
    API_KEY = "api_key"


class PIIAction(str, enum.Enum):
    BLOCK = "block"
    REDACT = "redact"


_PATTERNS: Dict[PIIType, Pattern] = {
    PIIType.EMAIL: re.compile(
        r"\b[A-Za-z0-9._%+-]+@[A-Za-z0-9.-]+\.[A-Za-z]{2,}\b"
    ),
    PIIType.PHONE: re.compile(
        r"\b(?:\+?\d{1,3}[-.\s]?)?\(?\d{3}\)?[-.\s]?\d{3}[-.\s]?\d{4}\b"
    ),
    PIIType.SSN: re.compile(r"\b\d{3}-\d{2}-\d{4}\b"),
    PIIType.CREDIT_CARD: re.compile(r"\b(?:\d[ -]?){13,16}\b"),
    PIIType.IP_ADDRESS: re.compile(r"\b(?:\d{1,3}\.){3}\d{1,3}\b"),
    PIIType.API_KEY: re.compile(r"\b(?:sk|pk|api)[-_][A-Za-z0-9]{16,}\b"),
}


@dataclass
class PIIMatch:
    pii_type: PIIType
    start: int
    end: int
    text: str


class RegexAnalyzer:
    def __init__(self, types: Optional[List[PIIType]] = None):
        self.types = types or list(PIIType)

    def analyze(self, text: str) -> List[PIIMatch]:
        out = []
        for t in self.types:
            for m in _PATTERNS[t].finditer(text):
                out.append(PIIMatch(t, m.start(), m.end(), m.group()))
        return out


# Our PII types <-> Presidio entity names (reference
# src/vllm_router/experimental/pii/analyzers/presidio.py:45-56).
_PII_TO_PRESIDIO = {
    PIIType.EMAIL: "EMAIL_ADDRESS",
    PIIType.PHONE: "PHONE_NUMBER",
    PIIType.SSN: "US_SSN",
    PIIType.CREDIT_CARD: "CREDIT_CARD",
    PIIType.IP_ADDRESS: "IP_ADDRESS",
    PIIType.API_KEY: "API_KEY",
}
_PRESIDIO_TO_PII = {v: k for k, v in _PII_TO_PRESIDIO.items()}


class PresidioAnalyzer:
    """NER-grade analyzer over Microsoft Presidio (optional dependency).

    Same analyze() interface as RegexAnalyzer, so it drops into PIIChecker
    via ``--pii-analyzer presidio`` (reference
    experimental/pii/analyzers/presidio.py:57-172). Import/initialize
    errors raise at CONSTRUCTION time with an actionable message — the
    reference defers to first use, which turns a missing spacy model into
    a per-request 500.
    """

    def __init__(self, types: Optional[List[PIIType]] = None,
                 score_threshold: float = 0.5, engine=None):
        self.types = types or list(PIIType)
        self.score_threshold = score_threshold
        if engine is not None:
            self._engine = engine  # injected (tests, custom NLP config)
            return
        try:
            from presidio_analyzer import AnalyzerEngine
        except ImportError as e:
            raise RuntimeError(
                "PII analyzer 'presidio' needs presidio-analyzer (pip "
                "install presidio-analyzer && python -m spacy download "
                "en_core_web_sm); use --pii-analyzer regex for the "
                "dependency-free tier"
            ) from e
        self._engine = AnalyzerEngine()

    def analyze(self, text: str) -> List[PIIMatch]:
        entities = [
            _PII_TO_PRESIDIO[t] for t in self.types if t in _PII_TO_PRESIDIO
        ]
        results = self._engine.analyze(
            text=text, language="en", entities=entities,
            score_threshold=self.score_threshold,
        )
        out = []
        for r in results:
            t = _PRESIDIO_TO_PII.get(r.entity_type)
            if t is None:
                continue
            out.append(PIIMatch(t, r.start, r.end, text[r.start:r.end]))
        return out


def create_analyzer(kind: str = "regex", **kwargs):
    if kind == "regex":
        return RegexAnalyzer(**kwargs)
    if kind == "presidio":
        return PresidioAnalyzer(**kwargs)
    raise ValueError(
        f"Unknown PII analyzer {kind!r} (available: regex, presidio)"
    )


@dataclass
class PIIChecker:
    action: PIIAction = PIIAction.BLOCK
    analyzer: object = field(default_factory=RegexAnalyzer)

    def _redact_text(self, text: str) -> str:
        """Replace every match with ``[REDACTED:<type>]``.

        Overlapping matches (a credit card whose prefix also matches the
        phone pattern) are MERGED into one span first, so replacements always
        slice the original string — naive sequential replacement would apply
        stale offsets to the rewritten string and leak span tails."""
        matches = sorted(self.analyzer.analyze(text), key=lambda m: m.start)
        if not matches:
            return text
        merged = []  # (start, end, type) non-overlapping, in order
        cur_s, cur_e, cur_t = matches[0].start, matches[0].end, \
            matches[0].pii_type.value
        for m in matches[1:]:
            if m.start < cur_e:  # overlap: extend, keep the wider span's type
                if m.end > cur_e:
                    cur_e = m.end
                    cur_t = m.pii_type.value
            else:
                merged.append((cur_s, cur_e, cur_t))
                cur_s, cur_e, cur_t = m.start, m.end, m.pii_type.value
        merged.append((cur_s, cur_e, cur_t))
        out, prev = [], 0
        for s, e, t in merged:
            out.append(text[prev:s])
            out.append(f"[REDACTED:{t}]")
            prev = e
        out.append(text[prev:])
        return "".join(out)

    async def check(self, request: web.Request) -> Optional[web.Response]:
        """Scan message/prompt text. Returns a 400 response to block, or None.

        In REDACT mode the matched spans are replaced in a COPY of the body
        and the serialized result is stashed at ``request["pii_redacted_body"]``
        — downstream consumers (proxy, semantic cache) use it in place of the
        raw body, so PII never reaches a backend or the cache (closes the
        reference middleware.py:103-154 REDACT contract)."""
        try:
            body = json.loads(await request.read())
        except (json.JSONDecodeError, UnicodeDecodeError):
            return None
        pii_requests_total.inc()
        texts = []
        for m in body.get("messages", []) or []:
            if isinstance(m.get("content"), str):
                texts.append(m["content"])
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            texts.append(prompt)
        matches = [m for t in texts for m in self.analyzer.analyze(t)]
        if not matches:
            return None
        types = sorted({m.pii_type.value for m in matches})
        for t in types:
            pii_detections_total.labels(pii_type=t).inc()
        if self.action == PIIAction.BLOCK:
            pii_blocked_total.inc()
            logger.warning("Blocked request containing PII: %s", types)
            return web.json_response(
                ErrorResponse(
                    message=f"Request blocked: detected PII types {types}",
                    type="pii_detected", code=400,
                ).to_dict(),
                status=400,
            )
        # REDACT: rewrite in place and hand the sanitized body downstream.
        for m in body.get("messages", []) or []:
            if isinstance(m.get("content"), str):
                m["content"] = self._redact_text(m["content"])
        if isinstance(body.get("prompt"), str):
            body["prompt"] = self._redact_text(body["prompt"])
        logger.info("Redacted PII from request: %s", types)
        request["pii_redacted_body"] = json.dumps(body).encode()
        return None
