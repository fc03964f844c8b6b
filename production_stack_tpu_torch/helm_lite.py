"""helm_lite: render this repo's Helm chart without the helm binary or PyYAML.

The port's counterpart of ``production_stack_tpu/helm_lite.py``: the same
template subset, functions and errors, with ``Chart.yaml``, ``values.yaml``,
values files and the rendered documents read, and ``toYaml`` written,
through the port's own ``yaml_lite`` (the card's machine has no PyYAML).
The chart under ``helm/`` is written in a DOCUMENTED SUBSET of
Go-template/sprig syntax; anything else is a template error:

  * actions with left/right whitespace trimming: ``{{- ... -}}``
  * paths: ``.Values.a.b``, ``$var.a.b``, ``.Release.Name/Namespace``,
    ``.Chart.Name``, ``.`` (current context)
  * ``if`` / ``else if`` / ``else`` / ``end`` with conditions: a path,
    ``not <x>``, ``eq <a> <b>``, ``ne <a> <b>``, ``hasKey <map> "k"``,
    ``gt``/``ge``/``lt``/``le`` (numeric, Go argument order)
  * ``range $var := <list>`` ... ``end`` (no implicit dot rebinding)
  * ``$var := <expr>`` assignment
  * ``include "name" <ctx>`` of ``define`` blocks (helpers)
  * pipelines with: ``default``, ``quote``, ``toYaml``, ``toString``,
    ``indent``, ``nindent``, ``required``, ``printf``, ``join``, ``kindIs``
  * paths inside ``range`` bodies MUST be root-anchored (``$.Values...``):
    real helm rebinds dot to the range element, helm_lite does not — the
    ``$.`` form is the one both renderers agree on
  * literals: double-quoted strings, ints, floats, true/false

Render the chart for port engines on a card's machine:
``render_chart("helm", {"servingEngineSpec": {"modelSpec": [{...,
"requestGPUType": "nvidia.com/gpu", "requestGPU": 1}]}})``.
"""

import json
import os
import re
import shlex
from typing import Any, Dict, List, Optional, Tuple

from production_stack_tpu_torch import yaml_lite

_ACTION_RE = re.compile(r"\{\{(-?)\s*(.*?)\s*(-?)\}\}", re.S)


class TemplateError(Exception):
    pass


def _to_yaml(v: Any) -> str:
    return yaml_lite.safe_dump(v).rstrip("\n")


def _indent(n: int, s: str) -> str:
    pad = " " * n
    return "\n".join(pad + line if line else line for line in s.split("\n"))


def _truthy(v: Any) -> bool:
    """Go-template truthiness: zero values are falsy (incl. numeric 0)."""
    if v is None or v is False:
        return False
    if isinstance(v, (int, float)) and v == 0:
        return False
    if isinstance(v, (dict, list, str)) and len(v) == 0:
        return False
    return True


class _Frame:
    def __init__(self, ctx: Any, variables: Dict[str, Any]):
        self.ctx = ctx
        self.variables = variables


class Renderer:
    def __init__(self, chart_dir: str, values: Dict,
                 release_name: str = "release",
                 release_namespace: str = "default"):
        self.chart_dir = chart_dir
        with open(os.path.join(chart_dir, "Chart.yaml")) as f:
            self.chart = yaml_lite.safe_load(f)
        with open(os.path.join(chart_dir, "values.yaml")) as f:
            base = yaml_lite.safe_load(f) or {}
        self.values = _deep_merge(base, values or {})
        self.release = {"Name": release_name, "Namespace": release_namespace}
        self.defines: Dict[str, str] = {}
        tpl_dir = os.path.join(chart_dir, "templates")
        self.templates: Dict[str, str] = {}
        for fname in sorted(os.listdir(tpl_dir)):
            if not (fname.endswith(".yaml") or fname.endswith(".tpl")):
                continue
            with open(os.path.join(tpl_dir, fname)) as f:
                src = f.read()
            self._collect_defines(src)
            if fname.endswith(".yaml"):
                self.templates[fname] = src

    # ---------------------------------------------------------------- defines
    def _collect_defines(self, src: str) -> None:
        pos = 0
        while True:
            m = re.search(r'\{\{-?\s*define\s+"([^"]+)"\s*-?\}\}', src[pos:])
            if not m:
                return
            start = pos + m.end()
            e = re.search(r"\{\{-?\s*end\s*-?\}\}", src[start:])
            if not e:
                raise TemplateError(f"unterminated define {m.group(1)}")
            self.defines[m.group(1)] = src[start:start + e.start()].strip("\n")
            pos = start + e.end()

    # ----------------------------------------------------------------- public
    def render_all(self) -> Dict[str, List[dict]]:
        """filename -> list of parsed manifest documents."""
        out = {}
        for fname, src in self.templates.items():
            text = self.render_source(src)
            docs = [d for d in yaml_lite.safe_load_all(text) if d]
            if docs:
                out[fname] = docs
        return out

    def manifests(self) -> List[dict]:
        return [d for docs in self.render_all().values() for d in docs]

    def render_source(self, src: str, ctx: Any = None) -> str:
        # Strip define blocks from the body (already collected).
        src = re.sub(
            r'\{\{-?\s*define\s+"[^"]+"\s*-?\}\}.*?\{\{-?\s*end\s*-?\}\}',
            "", src, flags=re.S,
        )
        root = {
            "Values": self.values, "Release": self.release,
            "Chart": {"Name": self.chart.get("name", "chart")},
        }
        frame = _Frame(ctx if ctx is not None else root, {"$": root})
        tokens = self._tokenize(src)
        out, idx = self._render_block(tokens, 0, frame, root)
        if idx != len(tokens):
            raise TemplateError("unbalanced end")
        return out

    # --------------------------------------------------------------- internal
    def _tokenize(self, src: str) -> List[Tuple[str, Any]]:
        tokens: List[Tuple[str, Any]] = []
        pos = 0
        for m in _ACTION_RE.finditer(src):
            text = src[pos:m.start()]
            if m.group(1) == "-":  # left trim: all preceding whitespace
                text = re.sub(r"\s+$", "", text)
            tokens.append(("text", text))
            tokens.append(("action", (m.group(2), m.group(3) == "-")))
            pos = m.end()
        tokens.append(("text", src[pos:]))
        # apply right-trim: an action with trailing '-' eats following whitespace
        fixed: List[Tuple[str, Any]] = []
        trim_next = False
        for kind, val in tokens:
            if kind == "text":
                if trim_next:
                    val = re.sub(r"^\s+", "", val)
                    trim_next = False
                fixed.append((kind, val))
            else:
                expr, rtrim = val
                trim_next = rtrim
                fixed.append((kind, expr))
        return fixed

    def _render_block(self, tokens, idx, frame, root, stop=("end", "else")):
        out: List[str] = []
        while idx < len(tokens):
            kind, val = tokens[idx]
            if kind == "text":
                out.append(val)
                idx += 1
                continue
            expr = val.strip()
            word = expr.split()[0] if expr.split() else ""
            if word in stop:
                return "".join(out), idx
            if word == "if":
                rendered, idx = self._render_if(tokens, idx, frame, root)
                out.append(rendered)
            elif word == "range":
                rendered, idx = self._render_range(tokens, idx, frame, root)
                out.append(rendered)
            elif re.match(r"^\$[A-Za-z_][A-Za-z0-9_]*\s*:=", expr):
                name, rhs = expr.split(":=", 1)
                frame.variables[name.strip()] = self._eval(rhs.strip(), frame, root)
                idx += 1
            elif word == "end" or word == "else":
                return "".join(out), idx
            else:
                v = self._eval(expr, frame, root)
                out.append("" if v is None else str(v))
                idx += 1
        return "".join(out), idx

    def _render_if(self, tokens, idx, frame, root):
        # tokens[idx] is the `if`; branches evaluate lazily.
        cond_expr = tokens[idx][1].strip()[2:].strip()
        chosen = None
        cond = self._eval_cond(cond_expr, frame, root)
        sub, idx = self._render_branch(tokens, idx + 1, frame, root,
                                       evaluate=cond)
        if cond:
            chosen = sub
        while True:
            kind, val = tokens[idx]
            expr = val.strip()
            if expr == "end":
                return (chosen or ""), idx + 1
            if expr.startswith("else if"):
                c2 = False if chosen is not None else self._eval_cond(
                    expr[len("else if"):].strip(), frame, root)
                sub, idx = self._render_branch(tokens, idx + 1, frame, root,
                                               evaluate=c2)
                if c2 and chosen is None:
                    chosen = sub
            elif expr == "else":
                sub, idx = self._render_branch(tokens, idx + 1, frame, root,
                                               evaluate=chosen is None)
                if chosen is None:
                    chosen = sub
            else:
                raise TemplateError(f"unexpected {expr!r} in if")

    def _render_branch(self, tokens, idx, frame, root, evaluate: bool):
        """Render (or skip) tokens until the matching else/else if/end at this
        nesting depth. Returns (text, idx_of_terminator)."""
        if evaluate:
            text, j = self._render_block(tokens, idx, frame, root)
            return text, j
        depth = 0
        j = idx
        while j < len(tokens):
            kind, val = tokens[j]
            if kind == "action":
                w = val.strip().split()[0] if val.strip() else ""
                full = val.strip()
                if w in ("if", "range"):
                    depth += 1
                elif full == "end":
                    if depth == 0:
                        return "", j
                    depth -= 1
                elif (full == "else" or full.startswith("else if")) and depth == 0:
                    return "", j
            j += 1
        raise TemplateError("unterminated if")

    def _render_range(self, tokens, idx, frame, root):
        expr = tokens[idx][1].strip()[len("range"):].strip()
        m = re.match(r"^\$([A-Za-z_][A-Za-z0-9_]*)\s*:=\s*(.+)$", expr)
        if not m:
            raise TemplateError(
                f"range must bind a variable: range $x := <list> (got {expr!r})"
            )
        var, list_expr = "$" + m.group(1), m.group(2)
        seq = self._eval(list_expr, frame, root) or []
        # find body extent by skipping structurally
        _, end_idx = self._render_branch(tokens, idx + 1, frame, root,
                                         evaluate=False)
        if tokens[end_idx][1].strip() != "end":
            raise TemplateError("range body may not contain bare else")
        pieces = []
        for item in seq:
            sub_frame = _Frame(frame.ctx, dict(frame.variables))
            sub_frame.variables[var] = item
            text, j = self._render_block(tokens, idx + 1, sub_frame, root)
            pieces.append(text)
        return "".join(pieces), end_idx + 1

    # ------------------------------------------------------------- expression
    def _eval_cond(self, expr: str, frame, root) -> bool:
        return _truthy(self._eval(expr, frame, root))

    def _eval(self, expr: str, frame, root) -> Any:
        parts = [p.strip() for p in _split_pipeline(expr)]
        value = self._eval_call(parts[0], frame, root)
        for fn in parts[1:]:
            value = self._eval_call(fn, frame, root, piped=value)
        return value

    def _eval_call(self, expr: str, frame, root, piped=..., ):
        try:
            args = shlex.split(expr, posix=False)
        except ValueError as e:
            raise TemplateError(f"bad expression {expr!r}: {e}")
        if not args:
            raise TemplateError(f"empty expression in {expr!r}")
        head, rest = args[0], args[1:]
        if head in _FUNCS:
            vals = [self._atom(a, frame, root) for a in rest]
            if piped is not ...:
                vals.append(piped)
            return _FUNCS[head](self, frame, root, *vals)
        if rest:
            raise TemplateError(f"unknown function {head!r} in {expr!r}")
        if piped is not ...:
            raise TemplateError(f"cannot pipe into non-function {head!r}")
        return self._atom(head, frame, root)

    def _atom(self, tok: str, frame, root) -> Any:
        if tok.startswith('"') and tok.endswith('"'):
            return tok[1:-1]
        if tok in ("true", "false"):
            return tok == "true"
        if re.match(r"^-?\d+$", tok):
            return int(tok)
        if re.match(r"^-?\d+\.\d+$", tok):
            return float(tok)
        if tok == ".":
            return frame.ctx
        if tok.startswith("$"):
            name, _, path = tok.partition(".")
            if name not in frame.variables:
                raise TemplateError(f"undefined variable {name}")
            return _walk(frame.variables[name], path)
        if tok.startswith("."):
            # Top-level names (Values/Release/Chart) resolve against the root
            # context; anything else against the current dot (our templates
            # only rebind dot via include "name" <ctx>).
            head = tok[1:].split(".")[0]
            base = root if head in ("Values", "Release", "Chart") else frame.ctx
            return _walk(base, tok[1:])
        raise TemplateError(f"cannot evaluate {tok!r}")


def _walk(obj: Any, path: str) -> Any:
    if not path:
        return obj
    for part in path.split("."):
        if isinstance(obj, dict):
            obj = obj.get(part)
        else:
            obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def _split_pipeline(expr: str) -> List[str]:
    parts, depth, buf, inq = [], 0, [], False
    for ch in expr:
        if ch == '"':
            inq = not inq
        if ch == "|" and not inq:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    parts.append("".join(buf))
    return parts


def _fn_default(r, frame, root, dflt, value=None):
    return value if _truthy(value) else dflt


def _fn_required(r, frame, root, msg, value=None):
    if not _truthy(value):
        raise TemplateError(f"required value missing: {msg}")
    return value


def _fn_include(r: Renderer, frame, root, name, ctx=None):
    if name not in r.defines:
        raise TemplateError(f"include of undefined template {name!r}")
    return r.render_source(r.defines[name], ctx=ctx)


_FUNCS = {
    "default": _fn_default,
    "quote": lambda r, f, ro, v=None: json.dumps("" if v is None else str(v)),
    "toYaml": lambda r, f, ro, v=None: _to_yaml(v),
    "toString": lambda r, f, ro, v=None: "" if v is None else str(v),
    "indent": lambda r, f, ro, n, v=None: _indent(n, v or ""),
    "nindent": lambda r, f, ro, n, v=None: "\n" + _indent(n, v or ""),
    "required": _fn_required,
    "include": _fn_include,
    "printf": lambda r, f, ro, fmt, *a: fmt % tuple(a),
    "join": lambda r, f, ro, sep, v=None: sep.join(str(x) for x in (v or [])),
    "eq": lambda r, f, ro, a, b=None: a == b,
    "ne": lambda r, f, ro, a, b=None: a != b,
    # Numeric comparisons (Go argument order: ``gt a b`` is a > b). As in
    # real Go templates, comparing nil is a TemplateError — gate optional
    # ints with ``default`` first (no parenthesized sub-expressions here,
    # so bind a ``$var := .Values.x | default 0`` and compare the var).
    "gt": lambda r, f, ro, a, b=None: _as_num(a) > _as_num(b),
    "ge": lambda r, f, ro, a, b=None: _as_num(a) >= _as_num(b),
    "lt": lambda r, f, ro, a, b=None: _as_num(a) < _as_num(b),
    "le": lambda r, f, ro, a, b=None: _as_num(a) <= _as_num(b),
    "not": lambda r, f, ro, v=None: not _truthy(v),
    "hasKey": lambda r, f, ro, m, k=None: isinstance(m, dict) and k in m,
    "kindIs": lambda r, f, ro, kind, v=None: {
        "map": isinstance(v, dict), "string": isinstance(v, str),
        "slice": isinstance(v, list), "bool": isinstance(v, bool),
        "int": isinstance(v, int) and not isinstance(v, bool),
        "float64": isinstance(v, float), "invalid": v is None,
    }.get(kind, False),
}


def _as_num(v: Any) -> float:
    if v is None:
        # Real Go-template/Helm errors on nil comparisons ("invalid type
        # for comparison"). Coercing to 0 here would let a template render
        # in CI that breaks under real `helm template` — the exact class
        # of drift helm_lite exists to catch.
        raise TemplateError(
            "cannot compare nil value (pipe through `default` first)"
        )
    if isinstance(v, bool):
        return float(v)
    try:
        return float(v)
    except (TypeError, ValueError):
        raise TemplateError(f"cannot compare non-numeric value {v!r}")


def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def render_chart(chart_dir: str, values: Optional[Dict] = None,
                 values_file: Optional[str] = None,
                 release_name: str = "release",
                 release_namespace: str = "default") -> List[dict]:
    """Render the chart to a list of manifest dicts (helm template analogue)."""
    v: Dict = {}
    if values_file:
        with open(values_file) as f:
            v = yaml_lite.safe_load(f) or {}
    if values:
        v = _deep_merge(v, values)
    return Renderer(chart_dir, v, release_name, release_namespace).manifests()
