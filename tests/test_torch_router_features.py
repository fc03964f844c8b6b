"""The port's gated router features held against the JAX router's, on the
same inputs: the files API and multipart uploads, the batch API (its
SQLite rows and output files, a cancel mid-batch, an orphaned batch picked
up again), PII detection (matches, redactions, block responses, the
injected Presidio engine), the semantic cache (hashed-ngram vectors bit for
bit, hits and misses, the injected sentence-transformer model, persisted
files), the new series' exposition, and all of it through both routers in
front of fake engines and a port engine. Files, batch databases and cache
pickles written by one package load in the other."""

import asyncio
import json
import os
import random
import sqlite3
import sys

import numpy as np
import pytest
from aiohttp import FormData

from production_stack_tpu.router import batch_service as jax_batch
from production_stack_tpu.router import files_service as jax_files
from production_stack_tpu.router import pii as jax_pii
from production_stack_tpu.router import semantic_cache as jax_sc
from production_stack_tpu_torch.router import batch_service as port_batch
from production_stack_tpu_torch.router import files_service as port_files
from production_stack_tpu_torch.router import metrics as port_metrics
from production_stack_tpu_torch.router import pii as port_pii
from production_stack_tpu_torch.router import semantic_cache as port_sc
from production_stack_tpu_torch.utils import SingletonMeta as PortSingletons
from tests.test_torch_router_parity import _normalized_exposition
from tests.test_torch_router_e2e import (
    ROUTERS,
    Fakes,
    PortEngines,
    Router,
    _args,
    _port_args,
    _scrub,
)
from tests.test_torch_surface import MODEL

PKGS = {"jax": (jax_files, jax_batch, jax_pii, jax_sc),
        "port": (port_files, port_batch, port_pii, port_sc)}


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    PortSingletons._instances.clear()
    yield
    PortSingletons._instances.clear()


_VOLATILE = ("id", "created", "created_at", "completed_at", "input_file_id",
             "output_file_id", "error_file_id", "stored_at")


def _norm(obj):
    """A document up to ids and timestamps."""
    if isinstance(obj, dict):
        return {k: _norm(v) for k, v in obj.items() if k not in _VOLATILE}
    if isinstance(obj, list):
        return [_norm(v) for v in obj]
    return obj


# ----------------------------------------------------------------- files
def _form(fields):
    form = FormData()
    for name, value, filename in fields:
        if filename is None:
            form.add_field(name, value)
        else:
            form.add_field(name, value, filename=filename)
    return form


async def _upload(r, fields):
    async with r.session.post(r.url + "/v1/files", data=_form(fields)) as resp:
        return resp.status, await resp.json()


async def _get_raw(r, path):
    async with r.session.get(r.url + path) as resp:
        return resp.status, resp.headers.get("Content-Type", "").split(";")[0], \
            await resp.read()


def _batch_args(urls, tmp, which, **kw):
    return _args(urls, enable_batch_api=True,
                 file_storage_path=str(tmp / which / "files"), **kw)


UPLOADS = [
    [("file", b"line1\nline2", "input.jsonl"), ("purpose", "batch", None)],
    # CRLFs, a delimiter-like line and every byte value in the payload
    [("file", b"a\r\n--not-the-boundary\r\n" + bytes(range(256)) + b"\r\n", "bin.dat")],
    # no purpose part: the default; a quoted space in the filename
    [("file", b"{}", "my file.jsonl")],
    # a text field: no filename, so "upload" (a file part beside it keeps
    # the form multipart)
    [("purpose", "fine-tune", None), ("file", "xyz", None), ("note", b"n", "n.txt")],
    # an empty file
    [("file", b"", "empty.jsonl"), ("purpose", "batch", None)],
]


async def test_file_crud_and_uploads_equal_the_jax_router(tmp_path):
    async with Fakes(1) as fakes:
        runs = {}
        for which in ROUTERS:
            async with Router(which, _batch_args(fakes.urls, tmp_path, which)) as r:
                out = []
                for fields in UPLOADS:
                    st, info = await _upload(r, fields)
                    out.append((st, _norm(info)))
                    out.append(await _get_raw(r, f"/v1/files/{info['id']}/content"))
                    async with r.session.get(r.url + f"/v1/files/{info['id']}") as resp:
                        out.append((resp.status, _norm(await resp.json())))
                out.append(await _get_raw(r, "/v1/files/file-missing"))
                out.append(await _get_raw(r, "/v1/files/file-missing/content"))
            runs[which] = out
        assert runs["port"] == runs["jax"]
        assert [o[0] for o in runs["jax"][:3]] == [200, 200, 200]
        assert runs["jax"][1][2] == b"line1\nline2"
        assert runs["jax"][4][2].endswith(bytes(range(256)) + b"\r\n")
        assert runs["jax"][9][1]["filename"] == "upload"
        assert runs["jax"][9][1]["purpose"] == "fine-tune"
    # Each package's storage loads the other's directory: the same ids,
    # metadata and bytes.
    for mine, other in (("port", "jax"), ("jax", "port")):
        theirs = PKGS[other][0].FileStorage(str(tmp_path / other / "files"))
        loaded = PKGS[mine][0].FileStorage(str(tmp_path / other / "files"))
        want = sorted((f.to_dict() for f in await theirs.list_files()),
                      key=lambda d: d["id"])
        got = sorted((f.to_dict() for f in await loaded.list_files()),
                     key=lambda d: d["id"])
        assert got == want and len(got) == len(UPLOADS)
        for f in got:
            assert await loaded.get_file_content(f["id"]) == \
                await theirs.get_file_content(f["id"])


@pytest.mark.parametrize("body,ctype,status", [
    (b'--XX\r\nContent-Disposition: form-data; name="file"; filename="a.txt"\r\n\r\n'
     b'abc\r\n--XX--\r\n', "multipart/form-data; boundary=XX", 200),
    (b'preamble\r\n--XX\r\nContent-Disposition: form-data; name="file"; '
     b"filename*=utf-8''%C3%BC.txt\r\n\r\nabc\r\n--XX--\r\nepilogue",
     "multipart/form-data; boundary=XX", 200),
    (b'--XX\r\nContent-Disposition: form-data; name="file"\r\n\r\nabc\r\n--XX--\r\n',
     'multipart/form-data; boundary="XX"', 200),
    (b'--XX\r\nContent-Disposition: form-data; name="file"\r\n\r\nabc',
     "multipart/form-data; boundary=XX", 500),
    (b"not multipart", "text/plain", 500),
], ids=["crlf", "rfc2231-filename", "quoted-boundary", "unterminated", "not-multipart"])
async def test_multipart_edge_cases_equal_the_jax_router(tmp_path, body, ctype, status):
    async with Fakes(1) as fakes:
        runs = {}
        for which in ROUTERS:
            async with Router(which, _batch_args(fakes.urls, tmp_path, which)) as r:
                async with r.session.post(r.url + "/v1/files", data=body,
                                          headers={"Content-Type": ctype}) as resp:
                    out = [resp.status]
                    if resp.status == 200:
                        info = await resp.json()
                        out.append(_norm(info))
                        out.append(await _get_raw(r, f"/v1/files/{info['id']}/content"))
            runs[which] = out
        assert runs["port"] == runs["jax"]
        assert runs["jax"][0] == status


async def test_multipart_body_over_the_size_limit_is_refused():
    """The port reads the whole body first, so ``client_max_size`` bounds an
    upload (413), as it bounds every other body."""
    from production_stack_tpu_torch.router import http as web

    async def handler(request):
        reader = await request.multipart()
        return web.json_response([[p.name, p.filename, len(await p.read())]
                                  async for p in reader])

    app = web.Application(client_max_size=1024)
    app.router.add_post("/up", handler)
    port = await app.start("127.0.0.1", 0)
    try:
        import aiohttp

        async with aiohttp.ClientSession() as s:
            for size, want in ((700, 200), (2000, 413)):
                form = _form([("file", b"x" * size, "f.bin")])
                async with s.post(f"http://127.0.0.1:{port}/up", data=form) as resp:
                    assert resp.status == want
                    if want == 200:
                        assert await resp.json() == [["file", "f.bin", size]]
    finally:
        await app.stop()


# ----------------------------------------------------------------- batches
def _lines(model="m1", n=3, bad=True):
    out = [json.dumps({"custom_id": f"req-{i}", "method": "POST",
                       "url": "/v1/chat/completions",
                       "body": {"model": model, "max_tokens": 3 + i,
                                "messages": [{"role": "user", "content": f"hi {i}"}]}})
           for i in range(n)]
    if bad:
        out.insert(1, json.dumps({"custom_id": "req-nope", "body": {
            "model": "nope", "messages": [{"role": "user", "content": "x"}]}}))
        out.append("{not json")
    return out


async def _run_batch(r, lines, timeout=30.0):
    st, up = await _upload(r, [("file", "\n".join(lines).encode(), "batch.jsonl"),
                               ("purpose", "batch", None)])
    assert st == 200
    async with r.session.post(r.url + "/v1/batches", json={
            "input_file_id": up["id"], "endpoint": "/v1/chat/completions",
            "metadata": {"k": "v"}}) as resp:
        created = await resp.json()
    assert created["status"] == "validating"
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while True:
        await asyncio.sleep(0.2)
        async with r.session.get(r.url + f"/v1/batches/{created['id']}") as resp:
            batch = await resp.json()
        if batch["status"] == "completed" or loop.time() > deadline:
            break
    assert batch["status"] == "completed", batch
    st, _, out = await _get_raw(r, f"/v1/files/{batch['output_file_id']}/content")
    async with r.session.get(r.url + "/v1/batches") as resp:
        listing = await resp.json()
    return created, batch, [json.loads(ln) for ln in out.decode().splitlines()], listing


def _db_rows(path):
    db = sqlite3.connect(path)
    try:
        return [(json.loads(d)) for (d,) in db.execute(
            "SELECT data FROM batches ORDER BY rowid")]
    finally:
        db.close()


async def test_batch_execution_equals_the_jax_router(tmp_path):
    """A JSONL of chats (one for a model nobody serves, one line of broken
    JSON) through each router's batch API: the batch documents, the output
    lines and the SQLite rows are equal up to ids and timestamps; the
    engines saw the same requests."""
    async with Fakes(2) as fakes:
        runs = {}
        for which in ROUTERS:
            fakes.reset()
            async with Router(which, _batch_args(fakes.urls, tmp_path, which)) as r:
                created, batch, out, listing = await _run_batch(r, _lines())
                async with r.session.post(
                        r.url + f"/v1/batches/{batch['id']}/cancel") as resp:
                    cancel = (resp.status, _norm(await resp.json()))
                missing = [await _get_raw(r, "/v1/batches/batch_missing"),
                           (await r.call("POST", "/v1/batches", {"endpoint": "x"}))[::2]]
            rows = _db_rows(str(tmp_path / which / "files" / "batch.db"))
            runs[which] = (_norm(created), _norm(batch), _norm(out), _norm(listing),
                           cancel, missing, _norm(rows),
                           sorted(json.dumps(_scrub(b), sort_keys=True)
                                  for e in fakes.engines for _, b in e.requests_seen))
        assert runs["port"] == runs["jax"]
        batch, out = runs["jax"][1], runs["jax"][2]
        assert batch["request_counts"] == {"total": 5, "completed": 3, "failed": 2}
        assert [o["custom_id"] for o in out] == ["req-0", None, "req-1", "req-2", None]
        assert out[0]["response"]["status_code"] == 200
        assert runs["jax"][4][0] == 200 and runs["jax"][4][1]["status"] == "completed"
        assert runs["jax"][6][0]["status"] == "completed"


async def test_batch_lines_through_each_router_to_a_port_engine(tmp_path):
    """Greedy chats of a batch, through each router to a port engine: the
    output lines (texts, usage, finish reasons) are equal."""
    lines = [json.dumps({"custom_id": f"c{i}", "body": {
        "model": MODEL, "max_tokens": 5, "temperature": 0.0, "ignore_eos": True,
        "messages": [{"role": "user", "content": f"batch line {i}"}]}})
        for i in range(2)]
    async with PortEngines(1) as pe:
        runs = {}
        for which in ROUTERS:
            args = _port_args(pe.urls, enable_batch_api=True,
                              file_storage_path=str(tmp_path / which))
            async with Router(which, args) as r:
                _, batch, out, _ = await _run_batch(r, lines, timeout=120.0)
            runs[which] = _norm(out)
        assert runs["port"] == runs["jax"]
        assert [o["response"]["body"]["usage"]["completion_tokens"]
                for o in runs["jax"]] == [5, 5]


async def _processor_run(which, tmp, scenario):
    """Drive one package's LocalBatchProcessor through ``scenario``
    ("cancel": a cancel while the first line is in flight; "orphan": a
    batch left ``in_progress`` by a dead process). Returns what it left."""
    files, batch = PKGS[which][:2]
    storage = files.FileStorage(str(tmp / which / "files"))
    up = await storage.save_file("in.jsonl", "\n".join(_lines(bad=False)).encode())
    entered, gate, calls = asyncio.Event(), asyncio.Event(), []

    async def send_fn(endpoint, body):
        calls.append((endpoint, body))
        entered.set()
        if scenario == "cancel":
            await gate.wait()
        return {"echo": body["messages"][0]["content"]}

    proc = batch.LocalBatchProcessor(storage, db_path=str(tmp / which / "b.db"),
                                     send_fn=send_fn, poll_interval=0.05)
    info = await proc.create_batch(up.id, "/v1/chat/completions")
    if scenario == "orphan":
        info.status = batch.BatchStatus.IN_PROGRESS.value
        info.request_counts_total = 99
        proc._put(info)
    proc.start()
    try:
        if scenario == "cancel":
            await asyncio.wait_for(entered.wait(), 10)
            cancelled = await proc.cancel_batch(info.id)
            assert cancelled.status == "cancelled"
            gate.set()
            await asyncio.sleep(0.4)
        else:
            for _ in range(200):
                await asyncio.sleep(0.05)
                if (await proc.retrieve_batch(info.id)).status == "completed":
                    break
        final = await proc.retrieve_batch(info.id)
        again = await proc.cancel_batch(info.id)
    finally:
        await proc.stop()
    outputs = [f for f in await storage.list_files() if f.purpose == "batch_output"]
    out = [json.loads(ln) for f in outputs
           for ln in (await storage.get_file_content(f.id)).decode().splitlines()]
    return (_norm(final.to_dict()), _norm(again.to_dict()), len(calls),
            _norm(out), _norm(_db_rows(str(tmp / which / "b.db"))))


@pytest.mark.parametrize("scenario", ["cancel", "orphan"])
async def test_cancel_mid_batch_and_orphan_repick_equal_jax(tmp_path, scenario):
    runs = {w: await _processor_run(w, tmp_path, scenario) for w in ROUTERS}
    assert runs["port"] == runs["jax"]
    final, again, calls, out, rows = runs["jax"]
    if scenario == "cancel":
        # The guarded writes let the cancel win: no progress after it.
        assert final["status"] == "cancelled" and calls == 1 and out == []
        assert final["request_counts"]["completed"] == 0
    else:
        assert final["status"] == "completed" and calls == 3
        assert final["request_counts"] == {"total": 3, "completed": 3, "failed": 0}
        assert [o["response"]["body"] for o in out] == [
            {"echo": f"hi {i}"} for i in range(3)]
    assert again == final and rows == [final]


async def test_batch_databases_load_across_packages(tmp_path):
    for writer, reader in (("jax", "port"), ("port", "jax")):
        storage = PKGS[writer][0].FileStorage(str(tmp_path / writer))
        db = str(tmp_path / writer / "batch.db")
        wp = PKGS[writer][1].LocalBatchProcessor(storage, db_path=db)
        made = [await wp.create_batch(f"file-{i}", "/v1/completions",
                                      metadata={"i": i}) for i in range(3)]
        await wp.cancel_batch(made[1].id)
        rp = PKGS[reader][1].LocalBatchProcessor(
            PKGS[reader][0].FileStorage(str(tmp_path / writer)), db_path=db)
        assert [b.to_dict() for b in await rp.list_batches()] == \
            [b.to_dict() for b in await wp.list_batches()]
        assert (await rp.retrieve_batch(made[1].id)).status == "cancelled"


# --------------------------------------------------------------------- PII
PII_TEXTS = [
    "mail me at bob@example.com please",
    "my ssn is 123-45-6789",
    "pay 123-456-7890-1234 now",
    "card 4111 1111 1111 1111 and 4111-1111-1111-1111",
    "call +1 (555) 123-4567 or 555.123.4567",
    "host 10.0.0.12 key sk-abcdefghijklmnop1234 and api_ABCDEFGHIJKLMNOPQR",
    "nothing to see here",
    "a@b.co 078-05-1120 192.168.1.1 pk_0123456789abcdef0 +44 20 7946 0958",
    "",
]


def _random_texts(seed, n=40):
    rng = random.Random(seed)
    atoms = ["bob@example.com", "123-45-6789", "555-123-4567", "4111 1111 1111 1111",
             "10.1.2.3", "sk-" + "a" * 20, "hello", "world", "the", "1234", "-", " ",
             "x.y@z.io", "(555) 123 4567", "99.99.99.999"]
    return ["".join(rng.choice(atoms) + rng.choice(("", " ", ", "))
                    for _ in range(rng.randrange(1, 12))) for _ in range(n)]


def _matches(mod, text, types=None):
    an = mod.RegexAnalyzer([mod.PIIType(t) for t in types] if types else None)
    return [(m.pii_type.value, m.start, m.end, m.text) for m in an.analyze(text)]


@pytest.mark.parametrize("seed", [0, 1])
def test_regex_matches_and_redactions_equal_jax(seed):
    for text in PII_TEXTS + _random_texts(seed):
        assert _matches(port_pii, text) == _matches(jax_pii, text)
        assert _matches(port_pii, text, ["email", "ssn"]) == \
            _matches(jax_pii, text, ["email", "ssn"])
        want = jax_pii.PIIChecker(action=jax_pii.PIIAction.REDACT)._redact_text(text)
        got = port_pii.PIIChecker(action=port_pii.PIIAction.REDACT)._redact_text(text)
        assert got == want
    # the overlapping-span case: no tail of either span leaks
    out = port_pii.PIIChecker(action=port_pii.PIIAction.REDACT)._redact_text(
        "pay 123-456-7890-1234 now")
    assert "1234" not in out and out.startswith("pay [REDACTED:") and out.endswith("now")


class _Req(dict):
    """A request with a body, and per-request state (both routers'
    ``request[...]``)."""

    def __init__(self, body):
        super().__init__()
        self._body = body

    async def read(self):
        return self._body


def _response(resp):
    return None if resp is None else (resp.status, json.loads(resp.body))


PII_BODIES = [
    {"model": "m", "messages": [{"role": "system", "content": "be nice"},
                                {"role": "user", "content": "mail bob@example.com"}]},
    {"model": "m", "prompt": "my ssn is 123-45-6789", "messages": None},
    {"model": "m", "messages": [{"role": "user", "content": ["not", "a", "string"]}],
     "prompt": "pay 123-456-7890-1234 now"},
    {"model": "m", "messages": [{"role": "user", "content": "clean text"}]},
]


async def test_pii_check_block_and_redact_equal_jax():
    for action in ("block", "redact"):
        for body in PII_BODIES + [b"{broken json"]:
            raw = body if isinstance(body, bytes) else json.dumps(body).encode()
            got = {}
            for which, mod in (("jax", jax_pii), ("port", port_pii)):
                checker = mod.PIIChecker(action=mod.PIIAction(action))
                req = _Req(raw)
                got[which] = (_response(await checker.check(req)),
                              req.get("pii_redacted_body"))
            assert got["port"] == got["jax"]
    blocked = got  # the last body: broken JSON is passed through
    assert blocked["jax"] == (None, None)


class _FakePresidioResult:
    def __init__(self, entity_type, start, end):
        self.entity_type, self.start, self.end = entity_type, start, end


class _FakePresidioEngine:
    def __init__(self, results):
        self.results, self.calls = results, []

    def analyze(self, text, language, entities, score_threshold):
        self.calls.append((text, language, tuple(entities), score_threshold))
        return self.results


async def test_injected_presidio_engine_equals_jax():
    text = "mail me at a@b.com or +1 555 123 4567, ssn 078-05-1120"
    results = [_FakePresidioResult("EMAIL_ADDRESS", 11, 18),
               _FakePresidioResult("PHONE_NUMBER", 22, 37),
               _FakePresidioResult("US_SSN", 43, 54),
               _FakePresidioResult("UNMAPPED_TYPE", 0, 4)]
    got = {}
    for which, mod in (("jax", jax_pii), ("port", port_pii)):
        engine = _FakePresidioEngine(results)
        an = mod.PresidioAnalyzer(types=[mod.PIIType.EMAIL, mod.PIIType.SSN,
                                         mod.PIIType.PHONE],
                                  score_threshold=0.7, engine=engine)
        checker = mod.PIIChecker(action=mod.PIIAction.REDACT, analyzer=an)
        req = _Req(json.dumps({"prompt": text}).encode())
        got[which] = ([(m.pii_type.value, m.start, m.end, m.text)
                       for m in an.analyze(text)], engine.calls,
                      _response(await checker.check(req)), req["pii_redacted_body"])
    assert got["port"] == got["jax"]
    assert [m[0] for m in got["jax"][0]] == ["email", "phone", "ssn"]


def test_presidio_and_unknown_analyzers_fail_at_construction_as_jax():
    try:
        import presidio_analyzer  # noqa: F401
        pytest.skip("presidio installed; the error path can't trigger")
    except ImportError:
        pass
    for kind in ("presidio", "banana"):
        errors = []
        for mod in (jax_pii, port_pii):
            with pytest.raises((RuntimeError, ValueError)) as e:
                mod.create_analyzer(kind)
            errors.append((type(e.value), str(e.value)))
        assert errors[0] == errors[1]


def test_presidio_real_engine_detects_email():
    pytest.importorskip("presidio_analyzer")
    an = port_pii.create_analyzer("presidio")
    assert any(m.pii_type == port_pii.PIIType.EMAIL
               for m in an.analyze("contact john.doe@example.com please"))


# ---------------------------------------------------------- semantic cache
def test_hashed_ngram_vectors_equal_jax_bit_for_bit():
    texts = PII_TEXTS + _random_texts(3) + [
        "The Quick brown fox — jumps", "ünïcödé wörds ok", "a " * 300, "_x_ 9"]
    for dim in (512, 64):
        for t in texts:
            want = jax_sc.hashed_ngram_embed(t, dim)
            got = port_sc.hashed_ngram_embed(t, dim)
            assert got.dtype == want.dtype == np.float32
            assert got.tobytes() == want.tobytes()


class _FakeSentenceTransformer:
    def encode(self, text):
        vec = np.zeros(64, dtype=np.float32)
        for ch in text.lower():
            vec[ord(ch) % 64] += 1.0
        return vec


def _chat(text, model="m", **kw):
    return {"model": model, "messages": [{"role": "user", "content": text}], **kw}


async def _cache_trace(mod, embed, prompts, queries):
    cache = mod.SemanticCache(embed_fn=embed, similarity_threshold=0.9,
                              max_entries=6)
    out = []
    for i, p in enumerate(prompts):
        cache.store_response(_chat(p), json.dumps({"answer": i}).encode())
    cache.store_response(_chat("streamed", stream=True), b'{"answer": "s"}')
    cache.store_response(_chat("bad json"), b"{not json")
    cache.store_response({"model": "m", "prompt": "no messages"}, b'{"a": 1}')
    for q in queries:
        out.append(_response(await cache.check(_Req(json.dumps(q).encode()))))
    req = _Req(b"ignored")
    req["pii_redacted_body"] = json.dumps(_chat(prompts[-1])).encode()
    out.append(_response(await cache.check(req)))
    return out, len(cache._entries), cache._vectors.tobytes()


@pytest.mark.parametrize("embedder", ["hashed-ngram", "sentence-transformer"])
async def test_hits_and_misses_equal_jax(embedder):
    rng = random.Random(7)
    words = "what is the capital of france spain italy how tall is a tree".split()
    prompts = [" ".join(rng.choice(words) for _ in range(rng.randrange(3, 9)))
               for _ in range(9)]
    queries = ([_chat(p) for p in prompts] + [_chat(p + " please") for p in prompts]
               + [_chat(prompts[-1], model="other"), _chat(prompts[-1], stream=True),
                  _chat("completely unrelated zebra"), {"model": "m"}])
    runs = {}
    for which, mod in (("jax", jax_sc), ("port", port_sc)):
        embed = (mod.hashed_ngram_embed if embedder == "hashed-ngram" else
                 mod.sentence_transformer_embed_fn(model=_FakeSentenceTransformer()))
        runs[which] = await _cache_trace(mod, embed, prompts, queries)
    assert runs["port"] == runs["jax"]
    outcomes = runs["jax"][0]
    assert any(o is not None for o in outcomes) and any(o is None for o in outcomes)
    assert all(o[1]["cached"] for o in outcomes if o is not None)


def test_embedder_specs_and_errors_equal_jax(monkeypatch):
    assert port_sc.create_embed_fn("hashed-ngram") is port_sc.hashed_ngram_embed
    assert port_sc.create_embed_fn("") is port_sc.hashed_ngram_embed
    # Without the package (made unimportable here): the construction-time
    # error, and nothing is downloaded.
    monkeypatch.setitem(sys.modules, "sentence_transformers", None)
    for spec in ("banana", "sentence-transformers",
                 "sentence-transformers:all-MiniLM-L6-v2"):
        errors = []
        for mod in (jax_sc, port_sc):
            with pytest.raises((RuntimeError, ValueError)) as e:
                mod.create_embed_fn(spec)
            errors.append((type(e.value), str(e.value)))
        assert errors[0] == errors[1]


def test_persisted_caches_load_across_packages(tmp_path):
    for writer, reader in (("jax", "port"), ("port", "jax")):
        wmod, rmod = PKGS[writer][3], PKGS[reader][3]
        path = str(tmp_path / f"{writer}.pkl")
        cache = wmod.SemanticCache(persist_path=path)
        cache.persist_interval = 0.01
        for i in range(5):
            cache.store_response(_chat(f"question number {i}"),
                                 json.dumps({"a": i}).encode())
        for _ in range(200):       # the debounced writer thread
            if not (cache._persist_thread and cache._persist_thread.is_alive()) \
                    and os.path.exists(path):
                break
            import time

            time.sleep(0.01)
        cache._persist()           # and the last state, whole
        loaded = rmod.SemanticCache(persist_path=path)
        assert loaded._entries == cache._entries and len(loaded._entries) == 5
        assert loaded._vectors.tobytes() == cache._vectors.tobytes()
        assert loaded._vectors.dtype == np.float32
        hit = loaded._search(rmod.hashed_ngram_embed("user: question number 3"), "m")
        assert hit is not None and hit["response"] == {"a": 3}


# -------------------------------------------------------------- exposition
def _clear_jax(objs):
    for obj in objs:
        if obj._labelnames:
            obj.clear()
        else:
            obj._value.set(0)


def _series(mod_pii, mod_sc):
    return [mod_pii.pii_requests_total, mod_pii.pii_detections_total,
            mod_pii.pii_blocked_total, mod_sc.hits_total, mod_sc.misses_total,
            mod_sc.cache_size, mod_sc.latency_saved]


def _feature_events(mod_pii, mod_sc):
    mod_pii.pii_requests_total.inc(3)
    mod_pii.pii_detections_total.labels(pii_type="email").inc(2)
    mod_pii.pii_detections_total.labels(pii_type="ssn").inc()
    mod_pii.pii_blocked_total.inc()
    mod_sc.hits_total.inc()
    mod_sc.misses_total.inc(4)
    mod_sc.cache_size.set(12345678)
    mod_sc.latency_saved.inc(0.125)


def test_feature_series_exposition_equals_prometheus_client():
    from prometheus_client import CollectorRegistry, generate_latest

    jax_objs, port_fams = _series(jax_pii, jax_sc), _series(port_pii, port_sc)
    _clear_jax(jax_objs)
    for f in port_fams:
        f.clear()
    _feature_events(jax_pii, jax_sc)
    _feature_events(port_pii, port_sc)
    reg = CollectorRegistry()
    for obj in jax_objs:
        reg.register(obj)
    want = _normalized_exposition(generate_latest(reg).decode())
    got = port_metrics.generate_latest(port_fams).decode().splitlines()
    assert got == want
    # the default exposition holds them, after the router module's own
    every = port_metrics.generate_latest().decode()
    assert "\n".join(got) in every
    _clear_jax(jax_objs)
    for f in port_fams:
        f.clear()


# ------------------------------------------------------ through the routers
def _gated(urls, **kw):
    return _args(urls, feature_gates="SemanticCache=true,PIIDetection=true",
                 semantic_cache_embedder="hashed-ngram", pii_analyzer="regex", **kw)


async def test_pii_before_semantic_cache_through_each_router():
    """Redact mode: the engines never see the email or the SSN, a repeated
    non-streamed chat is answered from the cache (the redacted body is what
    the cache keys), streams and completions pass through redacted; block
    mode answers 400 ``pii_detected``. Equal bodies, series and engine
    traffic from both routers."""
    calls = [
        ("POST", "/v1/chat/completions", _chat("mail me at bob@example.com", "m1",
                                               max_tokens=3)),
        ("POST", "/v1/chat/completions", _chat("mail me at bob@example.com", "m1",
                                               max_tokens=3)),
        ("POST", "/v1/chat/completions", _chat("mail me at eve@example.org", "m1",
                                               max_tokens=3)),
        ("POST", "/v1/chat/completions", _chat("ssn 123-45-6789", "m1", max_tokens=3,
                                               stream=True)),
        ("POST", "/v1/completions", {"model": "m1", "prompt": "ip 10.0.0.1",
                                     "max_tokens": 2}),
        ("POST", "/v1/chat/completions", _chat("nothing here", "m1", max_tokens=2)),
    ]
    prefixes = ("vllm:pii_", "vllm:semantic_cache_")
    async with Fakes(2) as fakes:
        runs = {}
        for which in ROUTERS:
            fakes.reset()
            _clear_jax(_series(jax_pii, jax_sc))
            for f in _series(port_pii, port_sc):
                f.clear()
            out = []
            async with Router(which, _gated(fakes.urls, pii_action="redact")) as r:
                for c in calls:
                    out.append(await r.call(*c))
                async with r.session.get(r.url + "/metrics") as resp:
                    text = await resp.text()
                out.append([ln for ln in _normalized_exposition(text)
                            if (ln.split()[2] if ln.startswith("#")
                                else ln.split("{")[0].split()[0]).startswith(prefixes)])
            async with Router(which, _gated(fakes.urls, pii_action="block")) as r:
                out += [await r.call(*c) for c in calls]
            runs[which] = (out, sorted(json.dumps(_scrub(b), sort_keys=True)
                                       for e in fakes.engines for _, b in e.requests_seen))
        assert runs["port"] == runs["jax"]
        out, seen = runs["jax"]
        assert out[1][2]["cached"] is True and "cached" not in out[0][2]
        assert "eve@example.org" not in "".join(seen) and "bob@" not in "".join(seen)
        assert "[REDACTED:email]" in "".join(seen)
        series = out[len(calls)]
        assert "vllm:semantic_cache_hits_total 2.0" in series  # eve's chat, redacted alike
        blocked = out[len(calls) + 1:]
        assert [o[0] for o in blocked] == [400, 400, 400, 400, 400, 200]
        assert blocked[0][2]["error"]["type"] == "pii_detected"
