"""OpenAI-compatible HTTP server for the port, on the standard library.

Counterpart of ``production_stack_tpu/server/api_server.py`` (which runs on
aiohttp) for the routes of the serving main path:

  * POST /v1/completions, POST /v1/chat/completions — JSON, or SSE with
    ``stream: true`` (events ``data: {...}`` ending in ``data: [DONE]``);
    ``max_tokens``, ``temperature``, ``top_p``, ``top_k``, ``seed``,
    ``stop``, ``ignore_eos`` and ``stream_options.include_usage`` are
    honoured;
  * GET /v1/models, GET /health.

HTTP/1.1 with one request per connection (``Connection: close``); a
streamed response is close-delimited. Response bodies have the JAX
package's shapes. Every other route of the JAX server is not ported yet
(ROADMAP).

Run: ``python -m production_stack_tpu_torch.server.api_server --model
llama-3b --port 8000`` (on the card; ``--device cpu`` for a CPU run). With
``--tensor-parallel-size N`` the server process is tp rank 0 and starts N-1
worker processes (NCCL when the machine has N cards, gloo when the ranks
share one).
"""

import argparse
import asyncio
import json
import time
from typing import Optional, Tuple

import torch  # noqa: F401 — every module of the port is a torch module

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.utils import init_logger, random_uuid

logger = init_logger(__name__)

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            500: "Internal Server Error", 503: "Service Unavailable"}
_MAX_BODY = 16 << 20


def _error_body(status: int, message: str,
                etype: str = "invalid_request_error") -> dict:
    return {"error": {"message": message, "type": etype, "code": status,
                      "param": None}}


def _sse(obj: dict) -> bytes:
    return f"data: {json.dumps(obj)}\n\n".encode()


class _HttpError(Exception):
    def __init__(self, status: int, message: str,
                 etype: str = "invalid_request_error"):
        super().__init__(message)
        self.status, self.message, self.etype = status, message, etype


class OpenAIServer:
    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 8000):
        self.engine = engine
        self.host = host
        self.port = port
        self.model_name = engine.config.model_name
        self._server: Optional[asyncio.base_events.Server] = None

    async def start(self) -> None:
        """Start the engine loop and listen; ``port=0`` picks a free port
        (read it back from ``self.port``)."""
        await self.engine.start()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("Serving %s on http://%s:%d", self.model_name,
                    self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        await self.engine.stop()

    # ---------------------------------------------------------------- HTTP
    async def _read_request(self, reader) -> Tuple[str, str, dict, bytes]:
        line = await reader.readline()
        parts = line.decode("latin-1").strip().split()
        if len(parts) != 3:
            raise _HttpError(400, "malformed request line")
        method, target, _version = parts
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        n = int(headers.get("content-length", "0") or 0)
        if n > _MAX_BODY:
            raise _HttpError(413, "request body too large")
        body = await reader.readexactly(n) if n else b""
        return method, target.split("?", 1)[0], headers, body

    @staticmethod
    def _head(status: int, content_type: str, extra: str = "") -> bytes:
        return (
            f"HTTP/1.1 {status} {_REASONS.get(status, 'Error')}\r\n"
            f"Content-Type: {content_type}\r\nConnection: close\r\n{extra}"
        ).encode()

    async def _send_json(self, writer, status: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        writer.write(self._head(status, "application/json",
                                f"Content-Length: {len(body)}\r\n\r\n"))
        writer.write(body)
        await writer.drain()

    async def _handle(self, reader, writer) -> None:
        try:
            try:
                method, path, headers, body = await self._read_request(reader)
                await self._route(writer, method, path, body)
            except _HttpError as e:
                await self._send_json(writer, e.status,
                                      _error_body(e.status, e.message, e.etype))
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # client went away; generate()'s cleanup aborted its work
        except Exception as e:  # noqa: BLE001 — one bad request, not the server
            logger.exception("Request failed")
            try:
                await self._send_json(writer, 500, _error_body(
                    500, str(e), "internal_error"))
            except ConnectionError:
                pass
        finally:
            writer.close()

    async def _route(self, writer, method: str, path: str, body: bytes) -> None:
        routes = {
            ("GET", "/health"): self.health,
            ("GET", "/v1/models"): self.models,
            ("POST", "/v1/completions"): self.completions,
            ("POST", "/v1/chat/completions"): self.chat_completions,
        }
        handler = routes.get((method, path))
        if handler is None:
            if any(p == path for _, p in routes):
                raise _HttpError(405, f"{method} not allowed on {path}")
            raise _HttpError(404, f"route {path} not found")
        await handler(writer, body)

    # -------------------------------------------------------------- routes
    async def health(self, writer, body: bytes) -> None:
        if self.engine.is_healthy:
            await self._send_json(writer, 200, {"status": "healthy"})
        else:
            await self._send_json(writer, 503, {"status": "unhealthy"})

    async def models(self, writer, body: bytes) -> None:
        await self._send_json(writer, 200, {"object": "list", "data": [{
            "id": self.model_name, "object": "model",
            "created": int(time.time()), "owned_by": "production-stack-tpu",
            "root": None, "parent": None,
        }]})

    @staticmethod
    def _parse(body: bytes) -> dict:
        try:
            obj = json.loads(body)
        except (json.JSONDecodeError, UnicodeDecodeError):
            raise _HttpError(400, "Request body is not valid JSON")
        if not isinstance(obj, dict):
            raise _HttpError(400, "Request body must be a JSON object")
        return obj

    def _check(self, body: dict, chat: bool) -> None:
        model = body.get("model", self.model_name)
        if model != self.model_name:
            raise _HttpError(404, f"Model '{model}' not found", "model_not_found")
        for key in ("logit_bias", "tools", "logprobs", "top_logprobs"):
            if body.get(key):
                raise _HttpError(400, f"'{key}' is not supported by this server")
        if not chat and (body.get("suffix") or body.get("echo")):
            raise _HttpError(400, "'suffix'/'echo' are not supported")
        if body.get("n", 1) not in (1, None):
            raise _HttpError(400, "only n=1 is supported by this server")

    async def completions(self, writer, raw: bytes) -> None:
        body = self._parse(raw)
        prompt = body.get("prompt")
        if isinstance(prompt, list) and prompt and all(type(x) is int for x in prompt):
            vocab = self.engine.tokenizer.vocab_size
            if any(not 0 <= x < vocab for x in prompt):
                raise _HttpError(400, f"prompt token ids must be in [0, {vocab})")
            kw = {"prompt_token_ids": list(prompt)}
        elif isinstance(prompt, str):
            kw = {"prompt": prompt}
        else:
            raise _HttpError(400, "'prompt' must be a string or a list of "
                                  "token ids")
        self._check(body, chat=False)
        sampling = SamplingParams.from_request(body, default_max_tokens=16)
        await self._generate(writer, body, kw, sampling, chat=False)

    async def chat_completions(self, writer, raw: bytes) -> None:
        body = self._parse(raw)
        messages = body.get("messages")
        if not messages or not isinstance(messages, list):
            raise _HttpError(400, "'messages' is required")
        self._check(body, chat=True)
        try:
            prompt = self.engine.tokenizer.apply_chat_template(
                messages, add_generation_prompt=True)
        except (KeyError, TypeError) as e:
            raise _HttpError(400, f"Could not apply chat template: {e}")
        sampling = SamplingParams.from_request(body, default_max_tokens=256)
        await self._generate(writer, body, {"prompt": prompt}, sampling,
                             chat=True)

    async def _generate(self, writer, body: dict, kw: dict,
                        sampling: SamplingParams, chat: bool) -> None:
        n_prompt = len(kw["prompt_token_ids"]) if "prompt_token_ids" in kw \
            else len(self.engine.tokenizer.encode(kw["prompt"]))
        if n_prompt >= self.engine.config.max_model_len:
            raise _HttpError(400, f"Prompt of {n_prompt} tokens exceeds "
                                  f"max_model_len {self.engine.config.max_model_len}")
        request_id = random_uuid("chatcmpl-" if chat else "cmpl-")
        created = int(time.time())
        stream = bool(body.get("stream", False))
        obj = ("chat.completion.chunk" if chat and stream
               else "chat.completion" if chat else "text_completion")
        gen = self.engine.generate(**kw, sampling=sampling,
                                   request_id=request_id)
        if not stream:
            text, final = "", None
            try:
                async for out in gen:
                    text += out.text_delta
                    final = out
            except ValueError as e:
                raise _HttpError(400, str(e))
            if chat:
                choice = {"index": 0,
                          "message": {"role": "assistant", "content": text},
                          "finish_reason": final.finish_reason}
            else:
                choice = {"index": 0, "text": text,
                          "finish_reason": final.finish_reason,
                          "logprobs": None}
            await self._send_json(writer, 200, {
                "id": request_id, "object": obj, "created": created,
                "model": self.model_name, "choices": [choice],
                "usage": self._usage(final),
            })
            return

        writer.write(self._head(
            200, "text/event-stream",
            f"Cache-Control: no-cache\r\nx-request-id: {request_id}\r\n\r\n"))
        first_sent = False
        final = None
        try:
            async for out in gen:
                final = out
                if chat:
                    delta = {}
                    if not first_sent and (out.text_delta or not out.finished):
                        delta["role"] = "assistant"
                        first_sent = True
                    if out.text_delta:
                        delta["content"] = out.text_delta
                    choice = {"index": 0, "delta": delta,
                              "finish_reason": out.finish_reason}
                    write_now = bool(delta) or out.finished
                else:
                    choice = {"index": 0, "text": out.text_delta,
                              "finish_reason": out.finish_reason}
                    write_now = bool(out.text_delta) or out.finished
                if write_now:
                    writer.write(_sse({
                        "id": request_id, "object": obj, "created": created,
                        "model": self.model_name, "choices": [choice],
                    }))
                    await writer.drain()
            if final is not None and (body.get("stream_options") or {}).get(
                    "include_usage"):
                writer.write(_sse({
                    "id": request_id, "object": obj, "created": created,
                    "model": self.model_name, "choices": [],
                    "usage": self._usage(final),
                }))
            writer.write(b"data: [DONE]\n\n")
            await writer.drain()
        finally:
            await gen.aclose()

    @staticmethod
    def _usage(out) -> dict:
        return {
            "prompt_tokens": out.num_prompt_tokens,
            "completion_tokens": out.num_output_tokens,
            "total_tokens": out.num_prompt_tokens + out.num_output_tokens,
        }


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="OpenAI-compatible server (PyTorch port)")
    p.add_argument("--model", default="llama-3b")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--kv-cache-dtype", default="bfloat16",
                   choices=["bfloat16", "int8"],
                   help="KV-cache storage dtype: int8 stores K/V with "
                        "per-(slot, head) bf16 scales (~2x the blocks per "
                        "byte, half the decode kernel's pool bytes)")
    p.add_argument("--max-model-len", type=int, default=4096)
    p.add_argument("--num-kv-blocks", type=int, default=None)
    p.add_argument("--max-num-seqs", type=int, default=64)
    p.add_argument("--num-decode-steps", type=int, default=32)
    p.add_argument("--decode-loop", default="scan", choices=["scan", "while"],
                   help="fused-decode loop: scan runs all K steps of a "
                        "dispatch, while runs only the steps some row needs")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip capturing the decode CUDA graphs at startup "
                        "(decode then runs eagerly)")
    p.add_argument("--no-overlap-dispatch", action="store_true",
                   help="one batch kind per scheduling round (no prefill "
                        "issued while a decode is in flight)")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="dispatches outstanding at once (1 = strict "
                        "issue-fetch-apply; clamped to 2)")
    p.add_argument("--attn-impl", default="auto")
    p.add_argument("--tensor-parallel-size", type=int, default=1,
                   help="tp ranks, one process each (heads split over them; "
                        "tp must divide both head counts)")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = EngineConfig(
        model=args.model, device=args.device, dtype=args.dtype,
        kv_cache_dtype=args.kv_cache_dtype, max_model_len=args.max_model_len,
        num_kv_blocks=args.num_kv_blocks, max_num_seqs=args.max_num_seqs,
        num_decode_steps=args.num_decode_steps, decode_loop=args.decode_loop,
        enable_warmup=not args.no_warmup, pipeline_depth=args.pipeline_depth,
        overlap_dispatch=not args.no_overlap_dispatch,
        attn_impl=args.attn_impl, seed=args.seed,
        tensor_parallel_size=args.tensor_parallel_size,
    )

    async def run():
        engine = ServingEngine(cfg)
        server = OpenAIServer(engine, args.host, args.port)
        await server.start()
        try:
            await asyncio.Event().wait()
        finally:
            await server.stop()
            engine.shutdown()

    asyncio.run(run())


if __name__ == "__main__":
    main()
