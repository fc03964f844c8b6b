"""The port as the chart deploys it: an installable package that ships its
kernel source, builds it outside ``site-packages``, and names its own
``pstpu-torch-*`` scripts; and the images under ``docker/torch/`` whose
``pstpu-engine``, ``pstpu-router`` and ``pstpu-cache-server`` are the port.

A wheel is built from a copy of the tree in a temporary directory (never in
the checkout: setuptools writes ``build/`` and ``*.egg-info`` beside the
sources) and installed with ``pip install --target``; every pip call is
offline (``--no-index``). The Dockerfiles are read, not built: building an
image downloads its base image and packages, so the images themselves stay
unverified here. What is held is what a reading can show: every ``COPY``
source exists, the entry point and the chart's rendered command resolve
through the file's own links to a port script, no ``RUN`` line installs
jax, and the image runs as uid 10001.
"""

import configparser
import json
import os
import re
import shutil
import subprocess
import sys
import tomllib
import zipfile

import pytest
import torch

from production_stack_tpu_torch import helm_lite
from production_stack_tpu_torch.ops import paged_attention as pa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCKER = os.path.join(REPO, "docker", "torch")
DOCKERFILES = sorted(f for f in os.listdir(DOCKER) if f.startswith("Dockerfile."))

with open(os.path.join(REPO, "pyproject.toml"), "rb") as _f:
    SCRIPTS = tomllib.load(_f)["project"]["scripts"]

PORT_SCRIPTS = {
    "pstpu-torch-engine": "production_stack_tpu_torch.server.api_server:main",
    "pstpu-torch-router": "production_stack_tpu_torch.router.app:main",
    "pstpu-torch-cache-server": "production_stack_tpu_torch.kv_offload.server:main",
    "pstpu-torch-operator": "production_stack_tpu_torch.controller.__main__:main",
    "pstpu-torch-lora-controller": "production_stack_tpu_torch.controller.lora_main:main",
    "pstpu-torch-launch": "production_stack_tpu_torch.launch:main",
}
JAX_SCRIPTS = {
    "pstpu-router": "production_stack_tpu.router.app:main",
    "pstpu-engine": "production_stack_tpu.server.api_server:main",
    "pstpu-cache-server": "production_stack_tpu.kv_offload.server:main",
}
# The chart's container of each image, by Deployment name suffix.
IMAGE_CONTAINERS = {"engine": ("-deployment-engine", "engine"),
                    "router": ("-deployment-router", "router"),
                    "cache-server": ("-deployment-cache-server", "cache-server")}


def _pip(*args, cwd):
    # Offline and quiet about newer pips: nothing is fetched.
    return subprocess.run([sys.executable, "-m", "pip", "--disable-pip-version-check",
                           *args], cwd=cwd, capture_output=True, text=True,
                          env=dict(os.environ, PIP_DISABLE_PIP_VERSION_CHECK="1"))


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """A wheel of the tree, built from a copy under a temporary directory."""
    root = tmp_path_factory.mktemp("pkg")
    src = root / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(os.path.join(REPO, name), src)
    skip = shutil.ignore_patterns("__pycache__", "*.pyc")
    for pkg in ("production_stack_tpu", "production_stack_tpu_torch"):
        shutil.copytree(os.path.join(REPO, pkg), src / pkg, ignore=skip)
    proc = _pip("wheel", "--no-deps", "--no-build-isolation", "--no-index",
                "-w", str(root / "dist"), str(src), cwd=root)
    assert proc.returncode == 0, proc.stderr
    (path,) = (root / "dist").glob("*.whl")
    return path


@pytest.fixture(scope="module")
def installed(wheel, tmp_path_factory):
    """The wheel installed with ``--target`` (no dependencies): the target
    directory."""
    target = tmp_path_factory.mktemp("target")
    proc = _pip("install", "--no-deps", "--no-index", "--target", str(target),
                str(wheel), cwd=target)
    assert proc.returncode == 0, proc.stderr
    return target


def _run_installed(target, tmp_path, code, env=None, args=()):
    """Run python ``code`` from ``tmp_path`` with the install alone on
    ``PYTHONPATH`` and ``HOME`` / ``XDG_CACHE_HOME`` under ``tmp_path``;
    returns its last stdout line as JSON."""
    base = {k: v for k, v in os.environ.items()
            if k not in ("PYTHONPATH", "XDG_CACHE_HOME", "HOME")}
    base.update(PYTHONPATH=str(target), HOME=str(tmp_path / "home"),
                XDG_CACHE_HOME=str(tmp_path / "xdg"))
    base.update(env or {})
    base = {k: v for k, v in base.items() if v is not None}
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=tmp_path, env=base,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _under(path, root):
    return os.path.realpath(path).startswith(os.path.realpath(str(root)) + os.sep)


# ------------------------------------------------------------ the wheel
def test_the_wheel_ships_the_kernel_source(wheel):
    """Every translation unit ``build_kernels`` compiles and their header,
    byte for byte."""
    with zipfile.ZipFile(wheel) as z:
        for path in (pa.HEADER, *pa.SOURCES):
            shipped = z.read("production_stack_tpu_torch/csrc/" + os.path.basename(path))
            with open(path, "rb") as f:
                assert shipped == f.read(), path


def _wheel_scripts(wheel):
    with zipfile.ZipFile(wheel) as z:
        name = next(n for n in z.namelist() if n.endswith(".dist-info/entry_points.txt"))
        cp = configparser.ConfigParser()
        cp.read_string(z.read(name).decode())
    return dict(cp["console_scripts"])


@pytest.mark.parametrize("script", sorted(PORT_SCRIPTS))
def test_each_port_script_resolves_to_a_callable_of_the_port(wheel, script):
    target = _wheel_scripts(wheel)[script]
    assert target == SCRIPTS[script] == PORT_SCRIPTS[script]
    module, func = target.split(":")
    import importlib

    fn = getattr(importlib.import_module(module), func)
    assert callable(fn) and fn.__module__ == module
    assert module.startswith("production_stack_tpu_torch.")


def test_the_jax_packages_scripts_are_unchanged(wheel):
    got = _wheel_scripts(wheel)
    assert {k: got[k] for k in JAX_SCRIPTS} == JAX_SCRIPTS
    assert set(got) == set(JAX_SCRIPTS) | set(PORT_SCRIPTS)


# ------------------------------------------------------------ the install
LAYOUT = """
import json, os, stat, sys
from production_stack_tpu_torch.ops import paged_attention as pa
from production_stack_tpu_torch import launch
from production_stack_tpu_torch.parallel import mesh
from production_stack_tpu_torch.kv_offload.server import find_native_binary
print(json.dumps({
    "source": pa.SOURCE, "source_exists": os.path.isfile(pa.SOURCE),
    "build_dir": pa.BUILD_DIR, "package": os.path.dirname(os.path.dirname(pa.__file__)),
    "launch_parent": launch._PKG_PARENT, "mesh_parent": mesh._PKG_PARENT,
    "native": find_native_binary(),
    "jax": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                               "production_stack_tpu"))}))
"""


def test_an_install_finds_its_source_and_builds_in_the_users_cache(installed, tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "kv_server"
    fake.write_text("#!/bin/sh\nexit 0\n")
    fake.chmod(0o755)
    got = _run_installed(installed, tmp_path, LAYOUT,
                         env={"PATH": os.pathsep.join([str(bindir), os.environ["PATH"]])})
    assert got["source_exists"] and _under(got["source"], installed)
    assert got["package"] == os.path.join(str(installed), "production_stack_tpu_torch")
    assert got["build_dir"] == os.path.join(str(tmp_path / "xdg"),
                                            "production_stack_tpu_torch", "kernels")
    assert not _under(got["build_dir"], installed)
    # A worker and an engine child import the package from where it lies.
    assert got["mesh_parent"] == got["launch_parent"] == str(installed)
    # No native/build beside an install: the cache server's binary on PATH.
    assert got["native"] == str(fake)
    assert got["jax"] == []


def test_an_install_without_xdg_cache_home_builds_under_home(installed, tmp_path):
    got = _run_installed(installed, tmp_path, LAYOUT, env={"XDG_CACHE_HOME": None})
    assert got["build_dir"] == os.path.join(str(tmp_path / "home"), ".cache",
                                            "production_stack_tpu_torch", "kernels")


def test_a_failed_build_raises_in_an_install(installed, tmp_path):
    """No nvcc: ``build_kernels`` raises, and nothing is left to serve
    from."""
    code = """
import json, os
from production_stack_tpu_torch.ops import paged_attention as pa
try:
    pa.build_kernels()
    print(json.dumps({"raised": None}))
except RuntimeError as e:
    print(json.dumps({"raised": str(e), "built": os.listdir(pa.BUILD_DIR)}))
"""
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("an nvcc is installed here")
    got = _run_installed(installed, tmp_path, code,
                         env={"PATH": "/nonexistent", "CUDA_HOME": str(tmp_path / "none")})
    assert got["raised"] and "nvcc not found" in got["raised"]
    assert got["built"] == []


def test_the_checkout_builds_in_its_own_build_directory():
    assert pa.BUILD_DIR == pa.kernel_build_dir() == os.path.join(REPO, "build",
                                                                 "torch_kernels")
    assert pa.SOURCE == os.path.join(REPO, "production_stack_tpu_torch", "csrc",
                                     "paged_decode.cu")


@pytest.mark.parametrize("script", sorted(PORT_SCRIPTS))
def test_each_installed_script_answers_help_without_jax(installed, tmp_path, script):
    """The script pip wrote, run with ``-X importtime``: ``--help`` exits 0
    and no jax, jaxlib or JAX-package module is imported."""
    path = installed / "bin" / script
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-X", "importtime", str(path), "--help"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env=dict(env, PYTHONPATH=str(installed),
                                   XDG_CACHE_HOME=str(tmp_path / "xdg")))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "usage:" in proc.stdout
    modules = {line.rsplit("|", 1)[1].strip() for line in proc.stderr.splitlines()
               if line.startswith("import time:") and line.count("|") == 2}
    assert PORT_SCRIPTS[script].split(":")[0] in modules
    assert not {m for m in modules if m.split(".")[0] in ("jax", "jaxlib",
                                                         "production_stack_tpu")}


def _smoke_values():
    import chip_smoke

    values = chip_smoke.chart_values("llama-3b")
    values["cacheserverSpec"] = {"enableServer": True,
                                 "repository": "production-stack-tpu-torch/cache-server",
                                 "tag": "latest"}
    values["routerSpec"]["repository"] = "production-stack-tpu-torch/router"
    return values


def _rendered_containers():
    out = {}
    for m in helm_lite.render_chart(os.path.join(REPO, "helm"), _smoke_values(),
                                    release_name="stack", release_namespace="default"):
        if m["kind"] != "Deployment":
            continue
        for image, (suffix, name) in IMAGE_CONTAINERS.items():
            if m["metadata"]["name"].endswith(suffix):
                out[image] = next(c for c in m["spec"]["template"]["spec"]["containers"]
                                  if c["name"] == name)
    assert set(out) == set(IMAGE_CONTAINERS)
    return out


def test_an_installed_server_names_the_package_it_imported(installed, tmp_path):
    """``/debug/kernels`` of a server of the installed port gives the
    install's package directory: a module is read, not mapped, so that
    answer is how a process driving an engine tells which install serves."""
    code = """
import asyncio, json
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.server.api_server import OpenAIServer

async def main():
    server = OpenAIServer(ServingEngine(EngineConfig(
        model="tiny-llama", device="cpu", max_model_len=64)), port=0)
    await server.start()
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
        writer.write(b"GET /debug/kernels HTTP/1.1\\r\\nHost: 127.0.0.1\\r\\n"
                     b"Content-Length: 0\\r\\n\\r\\n")
        await writer.drain()
        raw = await reader.read()
        writer.close()
    finally:
        await server.stop()
        server.engine.shutdown()
    return json.loads(raw.partition(b"\\r\\n\\r\\n")[2])

print(json.dumps(asyncio.run(main())))
"""
    got = _run_installed(installed, tmp_path, code)
    assert got["package_dir"] == os.path.join(str(installed), "production_stack_tpu_torch")
    assert got["launch_counts"] == {} and "decode_steps_total" in got["stats"]


def test_the_rendered_chart_parses_in_the_installed_port(installed, tmp_path):
    """The smoke's chart values, rendered by the port's ``helm_lite``: the
    engine, router and cache-server containers' args parse in the installed
    port's own parsers, to the Namespaces the checkout's parsers give."""
    containers = _rendered_containers()
    code = """
import json, sys
from production_stack_tpu_torch.server.api_server import parse_args as engine
from production_stack_tpu_torch.router.parser import parse_args as router
from production_stack_tpu_torch.kv_offload.server import parse_args as cache
args = json.loads(sys.argv[1])
print(json.dumps({k: vars(f(args[k])) for k, f in
                  (("engine", engine), ("router", router), ("cache-server", cache))},
                 default=str))
"""
    args = {k: [str(a) for a in c["args"]] for k, c in containers.items()}
    got = _run_installed(installed, tmp_path, code, args=[json.dumps(args)])
    from production_stack_tpu_torch.kv_offload.server import parse_args as cache
    from production_stack_tpu_torch.router.parser import parse_args as router
    from production_stack_tpu_torch.server.api_server import parse_args as engine

    want = {k: json.loads(json.dumps(vars(f(args[k])), default=str))
            for k, f in (("engine", engine), ("router", router), ("cache-server", cache))}
    assert got == want
    assert got["engine"]["model"] == "llama-3b" and got["engine"]["device"] == "cuda"
    assert {k: c["command"] for k, c in containers.items()} == {
        "engine": ["pstpu-engine"], "router": ["pstpu-router"],
        "cache-server": ["pstpu-cache-server"]}


# ------------------------------------------------------------ the images
def _instructions(dockerfile):
    """(instruction, argument) pairs, continuation lines joined, comments
    dropped."""
    with open(os.path.join(DOCKER, dockerfile)) as f:
        lines = [line.rstrip("\n") for line in f if not line.lstrip().startswith("#")]
    text = re.sub(r"\\\n\s*", " ", "\n".join(lines))
    return [tuple(line.strip().split(None, 1)) for line in text.splitlines() if line.strip()]


def _links(dockerfile):
    """name -> target of every ``ln -sf TARGET "$bin/NAME"`` in a RUN."""
    out = {}
    for ins, arg in _instructions(dockerfile):
        if ins == "RUN":
            out.update({m.group(2): m.group(1) for m in re.finditer(
                r'ln -sf (\S+) "\$bin/([^"]+)"', arg)})
    return out


def _resolve(name, links):
    seen = set()
    while name in links and name not in seen:
        seen.add(name)
        name = links[name]
    return name


@pytest.mark.parametrize("dockerfile", DOCKERFILES)
def test_every_copy_source_exists(dockerfile):
    copies = [arg.split() for ins, arg in _instructions(dockerfile) if ins == "COPY"]
    sources = [s for c in copies if not c[0].startswith("--from=") for s in c[:-1]]
    assert sources
    for s in sources:
        assert os.path.exists(os.path.join(REPO, s)), s


@pytest.mark.parametrize("dockerfile", DOCKERFILES)
def test_the_entry_point_and_the_charts_command_resolve_to_a_port_script(dockerfile):
    image = dockerfile.split(".", 1)[1]
    ins = _instructions(dockerfile)
    (entry,) = [json.loads(arg) for i, arg in ins if i == "ENTRYPOINT"]
    command = _rendered_containers()[image]["command"]
    links = _links(dockerfile)
    for argv in (entry, command):
        script = _resolve(argv[0], links)
        assert script.startswith("pstpu-torch-") and script in SCRIPTS, (argv, links)
        assert SCRIPTS[script].startswith("production_stack_tpu_torch.")
    # The JAX package's name is the one linked, so the install's own
    # script of that name is not the one found.
    assert entry[0] in JAX_SCRIPTS and entry[0] in links


@pytest.mark.parametrize("dockerfile", DOCKERFILES)
def test_no_run_line_installs_jax_and_the_user_is_10001(dockerfile):
    ins = _instructions(dockerfile)
    runs = [arg for i, arg in ins if i == "RUN"]
    assert not [r for r in runs if re.search(r"jax|\[engine\]", r)]
    users = [arg.split()[-1] for i, arg in ins if i == "RUN" and "useradd" in arg
             and "--uid 10001" in arg]
    last_stage = ins[max(j for j, (i, _) in enumerate(ins) if i == "FROM"):]
    assert [arg for i, arg in last_stage if i == "USER"][-1] in users + ["10001"]


def test_the_engine_image_builds_the_kernel_as_its_user():
    ins = _instructions("Dockerfile.engine")
    base = next(arg for i, arg in ins if i == "FROM")
    assert "devel" in base
    user = max(j for j, (i, _) in enumerate(ins) if i == "USER")
    assert any(i == "RUN" and "build_kernels()" in arg for i, arg in ins[user:])


def test_the_engine_image_installs_the_tokenizers_library():
    """A checkpoint directory's tokenizer needs ``transformers``
    (``engine/tokenizer.py``): without it the engine falls back to the byte
    tokenizer, as the JAX package does, and serves a real checkpoint's
    prompts as bytes. The image installs it and imports it at build."""
    runs = [arg for i, arg in _instructions("Dockerfile.engine") if i == "RUN"]
    installs = [r for r in runs if re.search(r"pip install [^&]*\btransformers\b", r)]
    assert installs, runs
    assert "--no-deps" not in re.search(
        r"pip install [^&]*\btransformers\b", installs[0]).group(0)
    assert any("from transformers import AutoTokenizer" in r for r in runs)


def test_build_sh_builds_every_image():
    with open(os.path.join(DOCKER, "build.sh")) as f:
        text = f.read()
    built = dict(re.findall(r"^build\s+(\S+)\s+(Dockerfile\.\S+)$", text, re.M))
    assert sorted(built.values()) == DOCKERFILES
    assert all(f == f"Dockerfile.{name}" for name, f in built.items())
    assert "production-stack-tpu-torch/${name}" in text


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
def test_an_installed_port_builds_its_kernel_cold_and_loads_it(installed, tmp_path):
    """On the card: the installed port's ``build_kernels()`` compiles the
    shipped source into an empty cache directory, and the library loads."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; the kernel has no CPU mode")
    code = """
import ctypes, json, os
from production_stack_tpu_torch.ops import paged_attention as pa
path, report = pa.build_kernels()
ctypes.CDLL(path)
print(json.dumps({"path": path, "dir": pa.BUILD_DIR, "files": os.listdir(pa.BUILD_DIR)}))
"""
    got = _run_installed(installed, tmp_path, code)
    kdir = os.path.join(str(tmp_path / "xdg"), "production_stack_tpu_torch", "kernels")
    assert got["dir"] == kdir and os.path.dirname(got["path"]) == kdir
    assert os.path.basename(got["path"]) in got["files"]
