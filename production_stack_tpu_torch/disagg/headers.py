"""The router <-> engine headers of the disagg and resume protocols, on
the standard library alone: the router imports them from here (it never
imports torch), the engine's server through ``disagg/transfer.py``."""

# Router<->engine disagg headers (router/request_service.py sets them; the
# API server reads them through disagg/transfer.py): one definition.
DISAGG_ROLE_HEADER = "x-pstpu-disagg"            # hop marker: "decode"
DISAGG_KEY_HEADER = "x-pstpu-transfer-key"       # store key for the bundle
DISAGG_ENDPOINT_HEADER = "x-pstpu-endpoint"      # "chat" | "completions"
DISAGG_FALLBACK_HEADER = "x-pstpu-disagg-fallback"  # unlock unified serving
# Mid-stream resume (docs/RESILIENCE.md): the router asks the engine to
# attach the per-chunk resume payload (output token ids, offset, resolved
# sampler seed) to single-choice streams. Gated on a header so DIRECT API
# clients get pristine OpenAI chunks and the internal seed base is only
# exposed on router-requested streams (where it enables the splice and
# router-of-routers composition).
RESUME_HEADER = "x-pstpu-resume"
