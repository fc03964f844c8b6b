"""The port's chart renderer (``production_stack_tpu_torch/helm_lite.py``)
and its YAML reader and writer (``yaml_lite.py``) held against the JAX
package's ``helm_lite`` and PyYAML, exactly (bytes and ``==``): the chart's
files, every rendered manifest, a hypothesis property of the writer, the
refusals; every template's text for every example values file and the
value dicts of ``tests/test_helm_chart.py``, with PyYAML present and
blocked; and the rendered args on the port's entry points (engine config,
router, cache server, controllers) against the JAX ones."""

import argparse
import dataclasses
import datetime
import glob
import json
import math
import os
import subprocess
import sys

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import production_stack_tpu.server.api_server as jax_api
import production_stack_tpu_torch.server.api_server as port_api
from production_stack_tpu import helm_lite as jax_helm
from production_stack_tpu.router import parser as jax_router_parser
from production_stack_tpu_torch import helm_lite as port_helm
from production_stack_tpu_torch import yaml_lite
from production_stack_tpu_torch.router import parser as port_router_parser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHART = os.path.join(REPO, "helm")
EXAMPLES = sorted(glob.glob(os.path.join(CHART, "examples", "values-*.yaml")))
CHART_FILES = [os.path.join(CHART, "Chart.yaml"), os.path.join(CHART, "values.yaml"),
               *EXAMPLES, *sorted(glob.glob(os.path.join(CHART, "crds", "*.yaml")))]

# The value dicts of tests/test_helm_chart.py's speculative (:107), tensor
# parallel (:179) and elastic (:381) tests, copied.
SPECULATIVE = {"servingEngineSpec": {"runtimeClassName": "", "modelSpec": [{
    "name": "spec", "repository": "production-stack-tpu/engine", "tag": "latest",
    "modelURL": "llama-1b", "replicaCount": 1, "requestCPU": 4,
    "requestMemory": "16Gi", "requestGPU": 1,
    "tpuConfig": {"speculativeNumTokens": 3, "speculativeModel": "facebook/opt-125m",
                  "speculativeDraftWindow": 512, "speculativeAdaptive": True,
                  "speculativeTreeWidth": 3}}]}}
TENSOR_PARALLEL = {"servingEngineSpec": {"runtimeClassName": "", "modelSpec": [{
    "name": "multichip", "repository": "production-stack-tpu/engine", "tag": "latest",
    "modelURL": "llama-1b", "replicaCount": 1, "requestCPU": 4,
    "requestMemory": "16Gi", "requestGPU": 4,
    "tpuConfig": {"tensorParallelSize": 4, "kvCacheDtype": "bfloat16"}}]}}
ELASTIC = {
    "servingEngineSpec": {"runtimeClassName": "", "modelSpec": [{
        "name": "elastic", "repository": "production-stack-tpu/engine", "tag": "latest",
        "modelURL": "llama-1b", "replicaCount": 1, "requestCPU": 4,
        "requestMemory": "16Gi", "requestGPU": 1,
        "tpuConfig": {"compilationCacheDir": "/cache/pstpu-xla",
                      "overlapWeightLoad": False}}]},
    "routerSpec": {"serviceDiscovery": "k8s", "routingLogic": "cache_aware_load_balancing",
                   "sessionKey": "x-user-id", "rampInSeconds": 45, "prewarmTopK": 8}}
# Port engines on NVIDIA cards behind a static router, with both controllers.
CARD = {
    "servingEngineSpec": {"modelSpec": [{
        "name": "llama", "repository": "production-stack-tpu-torch/engine",
        "tag": "latest", "modelURL": "llama-3b", "requestGPUType": "nvidia.com/gpu",
        "requestGPU": 1, "vllmConfig": {"dtype": "bfloat16", "maxNumSeqs": 4},
        "tpuConfig": {"attnImpl": "paged", "kvCacheDtype": "int8", "hbmPeakGbps": 3350,
                      "numDecodeSteps": 16}}]},
    "routerSpec": {"serviceDiscovery": "static", "staticBackends": "http://e0:8000",
                   "staticModels": "llama-3b", "routingLogic": "session",
                   "sessionKey": "x-user-id", "engineScrapeInterval": 1},
    "operatorSpec": {"enableOperator": True},
    "loraController": {"enableLoraController": True}}


def _load(path):
    with open(path) as f:
        return yaml.safe_load(f)


CASES = [(os.path.basename(p), _load(p)) for p in EXAMPLES] + [
    ("speculative", SPECULATIVE), ("tensor-parallel", TENSOR_PARALLEL),
    ("elastic", ELASTIC), ("card", CARD)]
CASE_IDS = [c[0] for c in CASES]


def _renderers(values, namespace="prod"):
    return (jax_helm.Renderer(CHART, values, "stack", namespace),
            port_helm.Renderer(CHART, values, "stack", namespace))


def _deployments(values, namespace="prod"):
    return {m["metadata"]["name"]: m for m in port_helm.render_chart(
        CHART, values, release_name="stack", release_namespace=namespace)
        if m["kind"] == "Deployment"}


def _args(deployment, name):
    c = next(c for c in deployment["spec"]["template"]["spec"]["containers"]
             if c["name"] == name)
    return [str(a) for a in c["args"]]


# ------------------------------------------------------------ yaml_lite
@pytest.mark.parametrize("path", CHART_FILES, ids=lambda p: os.path.relpath(p, CHART))
def test_yaml_lite_reads_the_charts_files_as_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert list(yaml_lite.safe_load_all(text)) == list(yaml.safe_load_all(text))
    with open(path) as f:
        assert yaml_lite.safe_load(f) == yaml.safe_load(text)


@pytest.mark.parametrize("name,values", CASES, ids=CASE_IDS)
def test_yaml_lite_reads_every_rendered_manifest_as_pyyaml(name, values):
    jax_r, _ = _renderers(values)
    for fname, src in jax_r.templates.items():
        text = jax_r.render_source(src)
        assert list(yaml_lite.safe_load_all(text)) == list(yaml.safe_load_all(text)), fname


SUBSET = [
    "a: yes\nb: No\nc: ON\nd: off\ne: true\nf: False\n",
    "- ~\n- null\n- Null\n-\n- ''\n- \"\"\n",
    "- 0\n- 017\n- 0x1F\n- 0b101\n- 1_000\n- -1:20\n- 190:20:30\n- +12\n- 09\n",
    "- 1.5\n- 1.\n- .5\n- 1e5\n- 1.0e+5\n- 1.0e-05\n- 1_0.5\n- 190:20:30.15\n- .inf\n"
    "- -.Inf\n- +.INF\n- .NaN\n",
    "- 2001-12-14\n- 2001-12-14t21:59:43.10-05:00\n- 2001-12-14 21:59:43.10\n"
    "- 2001-12-15T02:59:43.1Z\n- 2001-1-2 3:04:05 +1\n",
    "k: 'it''s'\nq: \"tab\\there \\\"q\\\" back\\\\slash \\u00e9 \\x41 \\U0001F600 \\/ \\_ \\N\"\n",
    "key:   value with  spaces   # a comment\nurl: http://x:80/a#frag\n'quoted key': 1\n"
    "\"dq key\": 2\n",
    "folded: a long\n  plain scalar\n\n  over lines\nnext: 1\n",
    "a: 'one\n\n  two\n  three'\nb: \"x\\\n  \\ y\n\n  z\"\n",
    "lit: |\n  line 1\n   indented\n\n  last\nkeep: |+\n  kept\n\n\nstrip: |-\n  gone\n"
    "fold: >\n  a\n  b\n\n  c\n    more\n  d\nfoldstrip: >-\n  x\n  y\nind: |2\n    two\n",
    "outer:\n- a\n- b: 1\n  c: [x, 'y', \"z\"]\n- - nested\n  - seq\n- {}\n- []\n"
    "flow: {p: 1, q, 'r': [1, 2]}\n",
    "# only a comment\n",
    "",
    "--- \n# c\na: 1\n...\n---\n- b\n--- # empty\n---\nc\n...\n",
    "top level\n  plain scalar\n",
    "=: eq\n'<<': merge as string\n1: int key\n~: null key\n",
    "- |\n  in a sequence\n-\n  - deeper\n---\nx:\n|\n  block at the key's column\n",
]


@pytest.mark.parametrize("text", SUBSET, ids=lambda t: repr(t[:24]))
def test_safe_load_reads_the_subset_as_pyyaml(text):
    want = list(yaml.safe_load_all(text))
    got = list(yaml_lite.safe_load_all(text))
    assert repr(got) == repr(want)      # repr: nan == nan, types of keys
    if len(want) <= 1:
        assert repr(yaml_lite.safe_load(text)) == repr(yaml.safe_load(text))


REFUSED = [
    ("a: &x 1\nb: *x\n", 1, "anchors"),
    ("a: 1\nb: !!str 2\n", 2, "tags"),
    ("a:\n  ? complex\n  : key\n", 2, "complex keys"),
    ("a:\n\tb: 1\n", 2, "tab"),
    ("a: 1\nb: x\ty\n", 2, "tab"),
    ("<<: {a: 1}\n", 1, "merge keys"),
    ("%YAML 1.1\n---\na: 1\n", 1, "directives"),
    ("a: [1,\n  2]\n", 1, "does not close on its line"),
    ("a: 'open\n", 2, "ends inside a quoted scalar"),
    ("a: b: c\n", 1, "mapping values are not allowed here"),
    ("a: 'x'\n  b: 2\n", 2, "unexpected indentation"),
    ("a: 1\n b: 2\n", 2, "mapping values are not allowed here"),
    ("a: =\n", 1, "value"),
    ("- a\n--- x\n", 2, "document marker's line"),
]


@pytest.mark.parametrize("text,line,what", REFUSED, ids=[r[2] for r in REFUSED])
def test_safe_load_refuses_what_is_outside_the_subset_naming_the_line(text, line, what):
    with pytest.raises(yaml_lite.YAMLError) as e:
        list(yaml_lite.safe_load_all(text))
    assert e.value.line == line and what in str(e.value)
    assert str(e.value).startswith(f"line {line}: ")


def test_safe_load_wants_one_document():
    with pytest.raises(yaml.YAMLError):
        yaml.safe_load("a\n---\nb\n")
    with pytest.raises(yaml_lite.YAMLError, match="single document"):
        yaml_lite.safe_load("a\n---\nb\n")


@pytest.mark.parametrize("value,what", [
    ({"": 1}, "complex-key"), ({"a\nb": 1}, "complex-key"), ({"k" * 123: 1}, "complex-key"),
    ({"a": [1], "b": None}, None), (set(), "set"), (b"x", "bytes"),
    (datetime.datetime(2001, 1, 2), "datetime")])
def test_safe_dump_refuses_what_pyyaml_writes_outside_the_subset(value, what):
    if what is None:
        shared = [1]
        value = {"a": shared, "b": shared}
        assert "&id001" in yaml.safe_dump(value)
        what = "anchor"
    else:
        yaml.safe_dump(value)       # PyYAML writes it (as '?', !!set, !!binary, ...)
    with pytest.raises(yaml_lite.YAMLError, match=what):
        yaml_lite.safe_dump(value)


RESERVED = ["yes", "No", "ON", "off", "y", "n", "true", "False", "null", "~", "Null", "",
            "0", "010", "09", "0x1F", "0b101", "1_000", "1:20", "1.5", "1.", ".5", ".inf",
            "-.inf", ".NaN", "1e5", "1.0e+5", "2001-12-14", "2001-12-14 21:59:43.10 -5",
            "=", "<<", "---", "...", "- a", "? x", "a: b", "#c", "a #c", "a#c", "%x", "@x",
            "`x", "!t", "&a", "*a", "|", ">", "[a]", "{a: 1}", "'q'", '"q"', "-", ":",
            "a:", "-a", "?a", ":a"]
_ALPHABET = list(":#-'\" \n\t,[]{}?!&*|>%@`._+eE0123456789abxyéñ€\x85\xa0\u2028\ufeff"
                 "\x00\x07\x1b\x7f\U0001F600\\")
_TEXT = st.one_of(
    st.sampled_from(RESERVED),
    st.text(st.sampled_from(_ALPHABET), max_size=40),
    st.text(max_size=20),
    # long runs of words: folding at the width of 80
    st.builds(lambda w, n: (w + " ") * n, st.text(st.sampled_from(_ALPHABET), min_size=1,
                                                  max_size=12), st.integers(1, 30)))
# Keys the way the writer takes them (not empty, one line, short: longer
# ones need YAML's complex-key form, refused above).
_KEYS = st.one_of(_TEXT.filter(lambda s: s and len(s) < 100 and not any(
    c in s for c in "\n\x85\u2028\u2029")), st.integers(-99, 99), st.booleans(), st.none())
_SCALARS = st.one_of(st.none(), st.booleans(), st.integers(-10**20, 10**20),
                     st.floats(allow_nan=False), _TEXT)
_TREES = st.recursive(_SCALARS, lambda children: st.one_of(
    st.lists(children, max_size=4), st.dictionaries(_KEYS, children, max_size=4)),
    max_leaves=24)


@settings(max_examples=200, deadline=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(_TREES)
def test_safe_dump_is_pyyamls_text_and_reads_back(value):
    text = yaml_lite.safe_dump(value)
    assert text == yaml.safe_dump(value, default_flow_style=False, sort_keys=False)
    assert yaml_lite.safe_load(text) == value


def test_safe_dump_of_nan_and_dates_is_pyyamls():
    for value in (math.nan, {"d": datetime.date(2001, 12, 14)}, [()], (1, "a")):
        assert yaml_lite.safe_dump(value) == yaml.safe_dump(
            value, default_flow_style=False, sort_keys=False)


# ------------------------------------------------------------- helm_lite
@pytest.mark.parametrize("name,values", CASES, ids=CASE_IDS)
def test_port_renders_every_template_to_the_jax_bytes(name, values):
    jax_r, port_r = _renderers(values)
    assert port_r.values == jax_r.values and port_r.chart == jax_r.chart
    assert list(port_r.templates) == list(jax_r.templates)
    assert port_r.defines == jax_r.defines
    for fname, src in jax_r.templates.items():
        assert port_r.render_source(src) == jax_r.render_source(src), fname
    assert port_r.render_all() == jax_r.render_all()
    assert port_helm.render_chart(CHART, values, release_name="r") == \
        jax_helm.render_chart(CHART, values, release_name="r")


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_render_chart_of_a_values_file_equals_the_jax_one(path):
    assert port_helm.render_chart(CHART, values_file=path, release_name="stack",
                                  release_namespace="prod") == \
        jax_helm.render_chart(CHART, values_file=path, release_name="stack",
                              release_namespace="prod")


BAD_TEMPLATES = [
    ('{{ required "need x" .Values.nope }}', {}),
    ('{{- $n := .Values.nope }}{{ if gt $n 1 }}x{{ end }}', {}),
    ('{{ if gt .Values.word 1 }}x{{ end }}', {"word": "abc"}),
    ("{{ $undefined.a }}", {}),
    ("{{ frobnicate 1 2 }}", {}),
    ("{{ end }}", {}),
    ("{{ .Values.a | .Values.b }}", {}),
    ("{{ range .Values.list }}x{{ end }}", {"list": [1]}),
    ("{{ if .Values.a }}x", {}),
    ('{{ include "missing" . }}', {}),
    ("{{ @ }}", {}),
    ('{{ "unterminated }}', {}),
]


@pytest.mark.parametrize("src,values", BAD_TEMPLATES, ids=[b[0] for b in BAD_TEMPLATES])
def test_template_errors_equal_the_jax_ones(src, values):
    errors = []
    for r in _renderers(values):
        with pytest.raises(Exception) as e:
            r.render_source(src)
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1]


def test_renders_without_pyyaml_are_the_same_bytes():
    """In a fresh interpreter where ``import yaml`` fails: every case's
    templates render to the JAX renderer's bytes (rendered here, with
    PyYAML), the manifests and render_chart of each values file equal,
    and neither PyYAML, jax nor the JAX package is loaded."""
    code = (
        "import json, sys\n"
        "sys.modules['yaml'] = None\n"
        "from production_stack_tpu_torch import helm_lite\n"
        "cases, examples = json.loads(sys.stdin.read())\n"
        "out = {'texts': {}, 'all': {}, 'files': {}}\n"
        "for name, values in cases:\n"
        "    r = helm_lite.Renderer('helm', values, 'stack', 'prod')\n"
        "    out['texts'][name] = {f: r.render_source(s) for f, s in r.templates.items()}\n"
        "    out['all'][name] = r.render_all()\n"
        "for path in examples:\n"
        "    out['files'][path] = helm_lite.render_chart('helm', values_file=path)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'production_stack_tpu') or (m == 'yaml' and sys.modules[m] is not None)]\n"
        "assert not bad, bad\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          input=json.dumps([CASES, EXAMPLES]), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    for name, values in CASES:
        jax_r = jax_helm.Renderer(CHART, json.loads(json.dumps(values)), "stack", "prod")
        assert got["texts"][name] == {f: jax_r.render_source(s)
                                      for f, s in jax_r.templates.items()}
        assert got["all"][name] == json.loads(json.dumps(jax_r.render_all()))
    for path in EXAMPLES:
        assert got["files"][path] == json.loads(json.dumps(
            jax_helm.render_chart(CHART, values_file=path)))


# --------------------------------------------------- args on entry points
def _engine_args():
    out = []
    for name, values in CASES:
        for dname, d in _deployments(values).items():
            if dname.endswith("-deployment-engine"):
                out.append((f"{name}:{dname}", _args(d, "engine")))
    return out


ENGINE_ARGS = _engine_args()
# Fields only the port's EngineConfig has.
PORT_ONLY = {"device", "tp_timeout_s"}
# The port's own defaults when the flag is not given (None: no warm-up
# manifest, the card's HBM rate looked up from its name); given, they equal.
PORT_DEFAULTS = {"compilation_cache_dir": "--compilation-cache-dir",
                 "hbm_peak_gbps": "--hbm-peak-gbps"}


@pytest.mark.parametrize("name,args", ENGINE_ARGS, ids=[a[0] for a in ENGINE_ARGS])
def test_chart_engine_args_build_the_jax_engine_config(name, args, monkeypatch):
    """The rendered engine container args build, through the port's server
    parser and ``config_from_args``, an EngineConfig whose every field
    equals the one the JAX server's ``build_engine_from_args`` builds, or
    the same refusal (the speculative dict pairs a draft of another vocab)."""
    monkeypatch.setattr(jax_api, "ServingEngine", lambda cfg: cfg)
    try:
        want = dataclasses.asdict(jax_api.build_engine_from_args(jax_api.parse_args(args)))
    except ValueError as e:
        with pytest.raises(ValueError) as refused:
            port_api.config_from_args(port_api.parse_args(args))
        assert str(refused.value) == str(e)
        return
    got = dataclasses.asdict(port_api.config_from_args(port_api.parse_args(args)))
    assert set(got) - set(want) == PORT_ONLY and set(want) <= set(got)
    for field, flag in PORT_DEFAULTS.items():
        if flag not in args:
            assert got.pop(field) is None
            want.pop(field)
    assert {k: got[k] for k in want} == want
    assert got["device"] == "cuda"


def test_engine_without_max_model_len_gets_the_jax_servers_default(monkeypatch):
    """values-01's engine renders no ``--max-model-len``: the port's server
    must build the JAX server's 2,048 (it built 4,096 before)."""
    args = next(a for n, a in ENGINE_ARGS if n.startswith("values-01"))
    assert "--max-model-len" not in args
    monkeypatch.setattr(jax_api, "ServingEngine", lambda cfg: cfg)
    want = jax_api.build_engine_from_args(jax_api.parse_args(args)).max_model_len
    assert port_api.config_from_args(port_api.parse_args(args)).max_model_len == want == 2048
    assert port_api.parse_args(["--model", "m"]).max_model_len == \
        jax_api.parse_args(["--model", "m"]).max_model_len


def _router_args():
    return [(name, _args(d, "router")) for name, values in CASES
            for dname, d in _deployments(values).items()
            if dname.endswith("-deployment-router")]


ROUTER_ARGS = _router_args()


@pytest.mark.parametrize("name,args", ROUTER_ARGS, ids=[a[0] for a in ROUTER_ARGS])
def test_chart_router_args_rendered_by_the_port_parse_as_the_jax_parser(name, args):
    want = vars(jax_router_parser.parse_args(args))
    assert vars(port_router_parser.parse_args(args)) == want


def _jax_namespace(main, argv, monkeypatch):
    """The Namespace a JAX entry point's ``main`` parses ``argv`` to (its
    parser is built inside ``main``): caught as it parses, before it runs."""
    caught = {}
    orig = argparse.ArgumentParser.parse_args

    class Parsed(Exception):
        pass

    def grab(self, args=None, namespace=None):
        caught["ns"] = orig(self, args, namespace)
        raise Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(Parsed):
        main(argv)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", orig)
    return vars(caught["ns"])


def test_chart_cache_server_args_parse_on_the_port(monkeypatch, capsys):
    """values-06's cache-server args parse with the port's server to the
    JAX parser's Namespace, plus ``--serde naive``, which the chart renders
    and the JAX server's parser refuses."""
    from production_stack_tpu.kv_offload import server as jax_server
    from production_stack_tpu_torch.kv_offload import server as port_server

    values = _load(next(p for p in EXAMPLES if "values-06" in p))
    args = _args(_deployments(values)["stack-deployment-cache-server"], "cache-server")
    i = args.index("--serde")
    assert args[i + 1] == "naive"
    got = vars(port_server.parse_args(args))
    assert got.pop("serde") == "naive"
    assert got == _jax_namespace(jax_server.main, args[:i] + args[i + 2:], monkeypatch)
    with pytest.raises(SystemExit):
        jax_server.main(args)
    assert "unrecognized arguments: --serde naive" in capsys.readouterr().err


@pytest.mark.parametrize("deployment,container,module", [
    ("stack-staticroute-operator", "operator", "controller.__main__"),
    ("stack-lora-controller", "lora-controller", "controller.lora_main")])
def test_chart_controller_args_parse_as_the_jax_ones(deployment, container, module,
                                                     monkeypatch):
    import importlib

    monkeypatch.delenv("WATCH_NAMESPACE", raising=False)
    jax_mod = importlib.import_module(f"production_stack_tpu.{module}")
    port_mod = importlib.import_module(f"production_stack_tpu_torch.{module}")
    args = _args(_deployments(CARD)[deployment], container)
    got = vars(port_mod.parse_args(args))
    assert got == _jax_namespace(jax_mod.main, args, monkeypatch)
    assert got["namespace"] == "prod"


def test_the_smokes_chart_values_start_the_kvtier_engines():
    """chip_smoke.py's router phase renders the chart for its engines: one
    ``nvidia.com/gpu`` each, and the engine container's command and args
    (loopback ``--host`` and ``--port`` in, the smoke's own flags added)
    parse to the Namespace of the hand-written ``kvtier_server_args`` the
    phase started its engines with before."""
    import chip_smoke

    engine, router, _ = chip_smoke.chart_render(chip_smoke.chart_values("llama-3b"))
    c = engine["spec"]["template"]["spec"]["containers"][0]
    assert c["resources"]["requests"]["nvidia.com/gpu"] == "1"
    assert c["resources"]["limits"]["nvidia.com/gpu"] == "1"
    argv = chip_smoke.chart_engine_argv("llama-3b", 3, engine, 1, "cuda")
    assert argv[0] == "pstpu-engine"
    twin = ["--model", "llama-3b", "--served-model-name", "llama-3b",
            "--host", "127.0.0.1", "--port", "1"]
    assert vars(port_api.parse_args(argv[1:])) == vars(port_api.parse_args(
        twin + chip_smoke.kvtier_server_args("bfloat16", 3)))
    rargs = _args(router, "router")
    parsed = port_router_parser.parse_args(rargs)
    assert (parsed.routing_logic, parsed.session_key, parsed.engine_stats_interval,
            parsed.service_discovery, parsed.k8s_namespace) == \
        ("session", "x-user-id", 1, "k8s", "default")
