"""gotpl — a Go text/template subset renderer.

The reference renders Stage patch templates with Go's text/template
plus sprig and kwok-specific funcs (reference: pkg/utils/gotpl/
{renderer,funcs}.go). This module implements the subset of the template
language that the entire upstream stage vocabulary uses:

- actions: ``{{ expr }}``, ``{{ $v := expr }}``, ``{{ if }}/{{ else if }}/
  {{ else }}/{{ end }}``, ``{{ range }}`` (incl. ``$i, $v :=`` form),
  ``{{ with }}/{{ else }}/{{ end }}``, trim markers ``{{-``/``-}}``;
- pipelines ``a | F``, function calls with args, parenthesized
  sub-expressions, ``$`` for the root context;
- builtins: or, and, eq, ne, not, index, printf, len;
- sprig-isms used by stages/charts: dict, default;
- kwok funcs (funcs.go:42-117): Quote, Now, StartTime, YAML, Version,
  NodeConditions; environment funcs NodeIP/NodeName/NodePort/
  NodeIPWith/PodIPWith are injected per controller
  (reference node_controller.go:521-531, pod_controller.go:559-615).

Divergence note: field access on a missing map key propagates nil
rather than erroring; nil renders as ``<no value>``. The upstream
templates always guard nilable chains with or/with, so rendered output
is identical for the stage vocabulary.

Rendered output is YAML; ``render_to_json`` mirrors renderer.go:110
ToJSON by YAML-parsing the rendered text.
"""

from __future__ import annotations

import datetime
import json
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import yaml

from kwok_tpu_torch import __version__ as KWOK_TPU_VERSION


class TemplateError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Default funcs (reference funcs.go:42-117)
# ---------------------------------------------------------------------------

# The canonical five node conditions (funcs.go:85-116).
NODE_CONDITIONS: List[Dict[str, str]] = [
    {
        "type": "Ready",
        "status": "True",
        "reason": "KubeletReady",
        "message": "kubelet is posting ready status",
    },
    {
        "type": "MemoryPressure",
        "status": "False",
        "reason": "KubeletHasSufficientMemory",
        "message": "kubelet has sufficient memory available",
    },
    {
        "type": "DiskPressure",
        "status": "False",
        "reason": "KubeletHasNoDiskPressure",
        "message": "kubelet has no disk pressure",
    },
    {
        "type": "PIDPressure",
        "status": "False",
        "reason": "KubeletHasSufficientPID",
        "message": "kubelet has sufficient PID available",
    },
    {
        "type": "NetworkUnavailable",
        "status": "False",
        "reason": "RouteCreated",
        "message": "RouteController created a route",
    },
]


def _fn_quote(s: Any) -> str:
    data = json.dumps(s, separators=(",", ":"))
    if data.startswith('"'):
        return data
    return json.dumps(data)


def _go_now() -> str:
    return (
        datetime.datetime.now(datetime.timezone.utc)
        .isoformat(timespec="microseconds")
        .replace("+00:00", "Z")
    )


_START_TIME = _go_now()


def _fn_yaml(value: Any, indent: int = 0) -> str:
    data = yaml.safe_dump(value, default_flow_style=False, sort_keys=False)
    if indent and indent > 0:
        pad = " " * (indent * 2)
        data = ("\n" + data).replace("\n", "\n" + pad)
    return data


def _fn_printf(fmt: str, *args: Any) -> str:
    # Go verbs -> Python: %v/%s -> %s, %d -> %d, %q -> quoted
    out = []
    i = 0
    ai = 0
    while i < len(fmt):
        c = fmt[i]
        if c == "%" and i + 1 < len(fmt):
            verb = fmt[i + 1]
            if verb == "%":
                out.append("%")
            elif verb in "vs":
                out.append(_to_display(args[ai]))
                ai += 1
            elif verb == "d":
                out.append(str(int(args[ai])))
                ai += 1
            elif verb == "q":
                out.append(_fn_quote(args[ai]))
                ai += 1
            else:
                raise TemplateError(f"unsupported printf verb %{verb}")
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _fn_dict(*pairs: Any) -> Dict[Any, Any]:
    if len(pairs) % 2 != 0:
        raise TemplateError("dict requires an even number of arguments")
    return {pairs[i]: pairs[i + 1] for i in range(0, len(pairs), 2)}


def _is_true(v: Any) -> bool:
    """Go template truthiness: zero values are false."""
    if v is None or v is False:
        return False
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return v != 0
    if isinstance(v, (str, list, dict, tuple)):
        return len(v) > 0
    return True


def _fn_index(col: Any, *keys: Any) -> Any:
    cur = col
    for k in keys:
        if cur is None:
            return None
        if isinstance(cur, dict):
            cur = cur.get(k)
        elif isinstance(cur, (list, tuple, str)):
            i = int(k)
            if i < 0 or i >= len(cur):
                raise TemplateError(f"index out of range: {i}")
            cur = cur[i]
        else:
            raise TemplateError(f"can't index item of type {type(cur).__name__}")
    return cur


def _go_eq(a: Any, *rest: Any) -> bool:
    return any(_json_eq(a, b) for b in rest)


def _json_eq(a: Any, b: Any) -> bool:
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    return a == b


_SPRIG_TABLE: Dict[str, Callable] = {}


def default_funcs() -> Dict[str, Callable]:
    # sprig at large first (reference funcs.go:42-117 pulls in all of
    # sprig.TxtFuncMap); the engine's own builtins and kwok funcs
    # override on name clashes (quote/default keep kwok semantics).
    # The 165-entry sprig table is built once — default_funcs() is on
    # the per-render path, and rebuilding the closures per call was a
    # measured ~34us tax.
    if not _SPRIG_TABLE:
        from kwok_tpu_torch.utils.sprig import sprig_funcs

        _SPRIG_TABLE.update(sprig_funcs())
    funcs = dict(_SPRIG_TABLE)
    funcs.update(
        {
            "Quote": _fn_quote,
            "Now": _go_now,
            "StartTime": lambda: _START_TIME,
            "YAML": _fn_yaml,
            "Version": lambda: KWOK_TPU_VERSION,
            "NodeConditions": lambda: [dict(c) for c in NODE_CONDITIONS],
            # builtins
            "printf": _fn_printf,
            "index": _fn_index,
            "len": lambda v: len(v) if v is not None else 0,
            "not": lambda v: not _is_true(v),
            "eq": _go_eq,
            "ne": lambda a, b: not _json_eq(a, b),
            # sprig-isms with kwok-pinned semantics
            "dict": _fn_dict,
            "default": lambda d, v=None: v if _is_true(v) else d,
        }
    )
    return funcs


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_ACTION_RE = re.compile(r"\{\{-?\s*(.*?)\s*-?\}\}", re.DOTALL)

_STRING_ESCAPES = {
    "n": "\n",
    "t": "\t",
    "r": "\r",
    "a": "\a",
    "b": "\b",
    "f": "\f",
    "v": "\v",
    '"': '"',
    "'": "'",
    "\\": "\\",
}


def _unescape_string(body: str) -> str:
    """Go string-literal escapes, unicode-safe (no byte round-trip)."""

    def repl(m: "re.Match[str]") -> str:
        c = m.group(1)
        if c[0] in "ux":
            return chr(int(c[1:], 16))
        return _STRING_ESCAPES.get(c, c)

    return re.sub(r"\\(u[0-9a-fA-F]{4}|x[0-9a-fA-F]{2}|.)", repl, body)


class _Node:
    pass


class _Text(_Node):
    def __init__(self, text: str):
        self.text = text


class _Output(_Node):
    def __init__(self, pipe):
        self.pipe = pipe


class _Assign(_Node):
    def __init__(self, name: str, pipe):
        self.name = name
        self.pipe = pipe


class _If(_Node):
    def __init__(self, branches, else_body):
        self.branches = branches  # list of (pipe, body)
        self.else_body = else_body


class _Range(_Node):
    def __init__(self, index_var, value_var, pipe, body, else_body):
        self.index_var = index_var
        self.value_var = value_var
        self.pipe = pipe
        self.body = body
        self.else_body = else_body


class _With(_Node):
    def __init__(self, pipe, body, else_body):
        self.pipe = pipe
        self.body = body
        self.else_body = else_body


_EXPR_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<raw>`(?:[^`])*`)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<number>-?\d+(?:\.\d+)?)
  | (?P<op>\||\(|\)|:=|=)
  | (?P<var>\$[A-Za-z0-9_]*)
  | (?P<field>\.[A-Za-z0-9_.]*)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<comma>,)
    """,
    re.VERBOSE,
)


def _tokenize_expr(src: str) -> List[Tuple[str, str]]:
    tokens = []
    pos = 0
    while pos < len(src):
        m = _EXPR_TOKEN_RE.match(src, pos)
        if m is None:
            raise TemplateError(f"bad token at {src[pos:]!r}")
        start = m.start()
        pos = m.end()
        if m.lastgroup != "ws":
            tokens.append((m.lastgroup, m.group(), start))
    return tokens


# Pipeline AST: ("pipe", [command,...]); command: ("call", [term,...])
# term: ("field", path_list) | ("var", name, path_list) | ("lit", v) |
#        ("fn", name) | ("pipe", ...)


class _ExprParser:
    def __init__(self, tokens, src):
        self.toks = tokens
        self.src = src
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        if t is None:
            raise TemplateError(f"unexpected end of action {self.src!r}")
        self.i += 1
        return t

    def parse_pipeline(self):
        cmds = [self.parse_command()]
        while self.peek() is not None and self.peek()[1] == "|":
            self.next()
            cmds.append(self.parse_command())
        return ("pipe", cmds)

    def parse_command(self):
        terms = []
        while True:
            t = self.peek()
            if t is None or t[1] in ("|", ")"):
                break
            terms.append(self.parse_term())
        if not terms:
            raise TemplateError(f"empty command in {self.src!r}")
        return ("call", terms)

    def parse_term(self):
        tok = self.next()
        kind, text = tok[0], tok[1]
        if text == "(":
            pipe = self.parse_pipeline()
            t = self.next()
            if t[1] != ")":
                raise TemplateError(f"expected ) in {self.src!r}")
            nxt = self.peek()
            if (
                nxt is not None
                and nxt[0] == "field"
                and len(nxt) > 2
                and len(t) > 2
                and nxt[2] == t[2] + 1
            ):
                # Go templates allow field access on a parenthesized
                # pipeline, but ONLY when adjacent: `(split "$" .s)._1`
                # is a suffix, `(f .a) .b` is an argument
                self.next()
                return ("suffix", pipe, [p for p in nxt[1].split(".") if p])
            return pipe
        if kind == "field":
            path = [p for p in text.split(".") if p]
            return ("field", path)
        if kind == "var":
            name = text
            path: List[str] = []
            t = self.peek()
            if t is not None and t[0] == "field":
                self.next()
                path = [p for p in t[1].split(".") if p]
            return ("var", name, path)
        if kind == "string":
            return ("lit", _unescape_string(text[1:-1]))
        if kind == "raw":
            return ("lit", text[1:-1])
        if kind == "number":
            return ("lit", float(text) if "." in text else int(text))
        if kind == "ident":
            if text == "true":
                return ("lit", True)
            if text == "false":
                return ("lit", False)
            if text == "nil":
                return ("lit", None)
            return ("fn", text)
        raise TemplateError(f"unexpected token {text!r} in {self.src!r}")


def _split_actions(src: str) -> List[Tuple[str, str]]:
    """Split template into ("text", s) and ("action", body) chunks,
    applying {{- and -}} whitespace trimming."""
    chunks: List[Tuple[str, str]] = []
    pos = 0
    for m in _ACTION_RE.finditer(src):
        text = src[pos : m.start()]
        raw = m.group(0)
        if raw.startswith("{{-"):
            text = text.rstrip()
        chunks.append(("text", text))
        chunks.append(("action", m.group(1)))
        pos = m.end()
        if raw.endswith("-}}"):
            rest = src[pos:]
            stripped = rest.lstrip()
            pos += len(rest) - len(stripped)
    chunks.append(("text", src[pos:]))
    return [c for c in chunks if not (c[0] == "text" and c[1] == "")]


_ASSIGN_RE = re.compile(r"^(\$[A-Za-z0-9_]*)\s*(:=|=)\s*(.*)$", re.DOTALL)
_RANGE_VARS_RE = re.compile(
    r"^(\$[A-Za-z0-9_]*)\s*(?:,\s*(\$[A-Za-z0-9_]*)\s*)?:=\s*(.*)$", re.DOTALL
)


class Template:
    def __init__(self, src: str):
        self.src = src
        chunks = _split_actions(src)
        self.nodes, rest = self._parse_block(chunks, 0, top=True)
        if rest != len(chunks):
            raise TemplateError("unbalanced end in template")

    def _parse_pipe(self, body: str):
        p = _ExprParser(_tokenize_expr(body), body)
        pipe = p.parse_pipeline()
        if p.peek() is not None:
            raise TemplateError(f"trailing tokens in {body!r}")
        return pipe

    def _parse_block(self, chunks, i, top=False, stop=("end",)):
        nodes: List[_Node] = []
        while i < len(chunks):
            kind, body = chunks[i]
            if kind == "text":
                nodes.append(_Text(body))
                i += 1
                continue
            word = body.split(None, 1)[0] if body.strip() else ""
            if word in ("end", "else") and not top:
                return nodes, i
            if word == "if":
                branches = []
                cond = self._parse_pipe(body[2:].strip())
                inner, i = self._parse_block(chunks, i + 1)
                branches.append((cond, inner))
                else_body: List[_Node] = []
                while True:
                    kind2, body2 = chunks[i]
                    w2 = body2.split(None, 1)[0]
                    if w2 == "else":
                        rest = body2[4:].strip()
                        if rest.startswith("if"):
                            cond2 = self._parse_pipe(rest[2:].strip())
                            inner2, i = self._parse_block(chunks, i + 1)
                            branches.append((cond2, inner2))
                            continue
                        else_body, i = self._parse_block(chunks, i + 1)
                        w3 = chunks[i][1].split(None, 1)[0]
                        if w3 != "end":
                            raise TemplateError("expected end after else")
                        i += 1
                        break
                    if w2 == "end":
                        i += 1
                        break
                    raise TemplateError(f"unexpected {w2!r} in if")
                nodes.append(_If(branches, else_body))
                continue
            if word == "range":
                expr = body[5:].strip()
                index_var = value_var = None
                m = _RANGE_VARS_RE.match(expr)
                if m:
                    if m.group(2) is not None:
                        index_var, value_var = m.group(1), m.group(2)
                    else:
                        value_var = m.group(1)
                    expr = m.group(3)
                pipe = self._parse_pipe(expr)
                inner, i = self._parse_block(chunks, i + 1)
                else_body = []
                w2 = chunks[i][1].split(None, 1)[0]
                if w2 == "else":
                    else_body, i = self._parse_block(chunks, i + 1)
                    w2 = chunks[i][1].split(None, 1)[0]
                if w2 != "end":
                    raise TemplateError("expected end after range")
                i += 1
                nodes.append(_Range(index_var, value_var, pipe, inner, else_body))
                continue
            if word == "with":
                pipe = self._parse_pipe(body[4:].strip())
                inner, i = self._parse_block(chunks, i + 1)
                else_body = []
                w2 = chunks[i][1].split(None, 1)[0]
                if w2 == "else":
                    else_body, i = self._parse_block(chunks, i + 1)
                    w2 = chunks[i][1].split(None, 1)[0]
                if w2 != "end":
                    raise TemplateError("expected end after with")
                i += 1
                nodes.append(_With(pipe, inner, else_body))
                continue
            m = _ASSIGN_RE.match(body)
            if m:
                nodes.append(_Assign(m.group(1), self._parse_pipe(m.group(3))))
                i += 1
                continue
            if word in ("end", "else"):
                raise TemplateError(f"unexpected {word!r} at top level")
            nodes.append(_Output(self._parse_pipe(body)))
            i += 1
        if not top:
            raise TemplateError("missing end")
        return nodes, i

    # -- evaluation ---------------------------------------------------------

    def render(self, data: Any, funcs: Optional[Dict[str, Callable]] = None) -> str:
        env = default_funcs()
        if funcs:
            env.update(funcs)
        out: List[str] = []
        variables: Dict[str, Any] = {"$": data}
        self._exec(self.nodes, data, variables, env, out)
        return "".join(out)

    def _exec(self, nodes, dot, variables, env, out):
        for node in nodes:
            if isinstance(node, _Text):
                out.append(node.text)
            elif isinstance(node, _Output):
                v = self._eval_pipe(node.pipe, dot, variables, env)
                out.append(_to_display(v))
            elif isinstance(node, _Assign):
                variables[node.name] = self._eval_pipe(node.pipe, dot, variables, env)
            elif isinstance(node, _If):
                done = False
                for cond, body in node.branches:
                    if _is_true(self._eval_pipe(cond, dot, variables, env)):
                        self._exec(body, dot, variables, env, out)
                        done = True
                        break
                if not done:
                    self._exec(node.else_body, dot, variables, env, out)
            elif isinstance(node, _With):
                v = self._eval_pipe(node.pipe, dot, variables, env)
                if _is_true(v):
                    self._exec(node.body, v, variables, env, out)
                else:
                    self._exec(node.else_body, dot, variables, env, out)
            elif isinstance(node, _Range):
                v = self._eval_pipe(node.pipe, dot, variables, env)
                items: List[Tuple[Any, Any]] = []
                if isinstance(v, dict):
                    items = [(k, v[k]) for k in sorted(v)]
                elif isinstance(v, (list, tuple)):
                    items = list(enumerate(v))
                if items:
                    for k, item in items:
                        scope = dict(variables)
                        if node.index_var and node.value_var:
                            scope[node.index_var] = k
                            scope[node.value_var] = item
                        elif node.value_var:
                            scope[node.value_var] = item
                        self._exec(node.body, item, scope, env, out)
                else:
                    self._exec(node.else_body, dot, variables, env, out)
            else:  # pragma: no cover
                raise TemplateError(f"unknown node {node!r}")

    def _eval_pipe(self, pipe, dot, variables, env):
        _, cmds = pipe
        value = _NO_VALUE
        for cmd in cmds:
            value = self._eval_command(cmd, dot, variables, env, value)
        return value

    def _eval_command(self, cmd, dot, variables, env, piped):
        _, terms = cmd
        head = terms[0]
        args = [self._eval_term(t, dot, variables, env) for t in terms[1:]]
        if piped is not _NO_VALUE:
            args.append(piped)
        if head[0] == "fn":
            name = head[1]
            if name == "or":
                for a in args:
                    if _is_true(a):
                        return a
                return args[-1] if args else None
            if name == "and":
                last = None
                for a in args:
                    last = a
                    if not _is_true(a):
                        return a
                return last
            fn = env.get(name)
            if fn is None:
                raise TemplateError(f"function {name!r} not defined")
            return fn(*args)
        value = self._eval_term(head, dot, variables, env)
        if args:
            if callable(value):
                return value(*args)
            raise TemplateError(f"can't give arguments to non-function {head!r}")
        return value

    def _eval_term(self, term, dot, variables, env):
        kind = term[0]
        if kind == "lit":
            return term[1]
        if kind == "field":
            return _navigate(dot, term[1])
        if kind == "var":
            name, path = term[1], term[2]
            if name == "$":
                base = variables["$"]
            else:
                if name not in variables:
                    raise TemplateError(f"undefined variable {name}")
                base = variables[name]
            return _navigate(base, path)
        if kind == "pipe":
            return self._eval_pipe(term, dot, variables, env)
        if kind == "suffix":
            return _navigate(
                self._eval_pipe(term[1], dot, variables, env), term[2]
            )
        if kind == "fn":
            name = term[1]
            if name == "or":
                return None
            fn = env.get(name)
            if fn is None:
                raise TemplateError(f"function {name!r} not defined")
            return fn()
        raise TemplateError(f"unknown term {term!r}")


class _NoValue:
    def __repr__(self):
        return "<no value>"


_NO_VALUE = _NoValue()


def _navigate(value: Any, path: List[str]) -> Any:
    cur = value
    for p in path:
        if cur is None:
            return None
        if isinstance(cur, dict):
            cur = cur.get(p)
        else:
            return None
    return cur


def _to_display(v: Any) -> str:
    if v is None or v is _NO_VALUE:
        return "<no value>"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def template_read_paths(tpl: "Template") -> set:
    """Conservative static analysis: the set of root-relative object
    paths a template's output can depend on, as tuples of field names.

    Used by the stage compiler to key FSM exploration states: two objects
    agreeing on all read paths render identically (template funcs are
    pure). Unused variable assignments are pruned to a fixpoint first
    (e.g. the zoo's never-referenced ``$origin``/``$root`` bindings), so
    a dead ``index $root.status.containerStatuses $index`` does not drag
    the whole status in. A bare reference to a variable bound to ``.``
    conservatively returns the root path ``()`` (reads everything).

    Reads inside range/with bodies resolve relative to the body's
    source path, which is itself collected — subtree projection
    subsumes them — so only root-context paths and variable-rooted
    paths need recording.
    """
    # 1. count variable uses (excluding their own assignment)
    uses: Dict[str, int] = {}

    def count_pipe(pipe):
        _, cmds = pipe
        for _, terms in cmds:
            for t in terms:
                if t[0] == "var" and t[1] != "$":
                    uses[t[1]] = uses.get(t[1], 0) + 1
                elif t[0] == "pipe":
                    count_pipe(t)
                elif t[0] == "suffix":
                    count_pipe(t[1])

    def count_nodes(nodes):
        for n in nodes:
            if isinstance(n, _Output):
                count_pipe(n.pipe)
            elif isinstance(n, _Assign):
                count_pipe(n.pipe)
            elif isinstance(n, _If):
                for cond, body in n.branches:
                    count_pipe(cond)
                    count_nodes(body)
                count_nodes(n.else_body)
            elif isinstance(n, (_Range, _With)):
                count_pipe(n.pipe)
                count_nodes(n.body)
                count_nodes(n.else_body)

    count_nodes(tpl.nodes)

    # 2. prune assignments of unused variables to a fixpoint
    pruned = dict(uses)
    changed = True
    live_assigns: Dict[str, Any] = {}

    def assigns_of(nodes, out):
        for n in nodes:
            if isinstance(n, _Assign):
                out.setdefault(n.name, []).append(n.pipe)
            elif isinstance(n, _If):
                for _, body in n.branches:
                    assigns_of(body, out)
                assigns_of(n.else_body, out)
            elif isinstance(n, (_Range, _With)):
                assigns_of(n.body, out)
                assigns_of(n.else_body, out)

    all_assigns: Dict[str, list] = {}
    assigns_of(tpl.nodes, all_assigns)
    def count_one(pipe, acc):
        _, cmds = pipe
        for _, terms in cmds:
            for t in terms:
                if t[0] == "var" and t[1] != "$":
                    acc[t[1]] = acc.get(t[1], 0) + 1
                elif t[0] == "pipe":
                    count_one(t, acc)
                elif t[0] == "suffix":
                    count_one(t[1], acc)

    while changed:
        changed = False
        for name in list(all_assigns):
            if pruned.get(name, 0) == 0:
                removed: Dict[str, int] = {}
                for p in all_assigns[name]:
                    count_one(p, removed)
                del all_assigns[name]
                changed = True
                for k, v in removed.items():
                    if pruned.get(k, 0) > 0:
                        pruned[k] = pruned[k] - v
                break

    live_vars = {k for k, v in pruned.items() if v > 0} | set(all_assigns)

    # 3. collect paths: root-context Path terms + live var sources/derefs
    paths: set = set()
    var_sources: Dict[str, Any] = {}  # var -> path tuple or None (opaque)

    def collect_pipe(pipe, root_ctx):
        _, cmds = pipe
        for _, terms in cmds:
            for t in terms:
                if t[0] == "field":
                    if root_ctx:
                        paths.add(tuple(t[1]))
                elif t[0] == "var":
                    name, sub = t[1], tuple(t[2])
                    if name == "$":
                        paths.add(sub)
                    else:
                        src = var_sources.get(name)
                        if src is not None:
                            paths.add(src + sub)
                        elif name in live_vars and name not in var_sources:
                            pass  # range/with-bound: subsumed by source path
                elif t[0] == "pipe":
                    collect_pipe(t, root_ctx)
                elif t[0] == "suffix":
                    collect_pipe(t[1], root_ctx)

    def pipe_as_path(pipe):
        """If a pipeline is a bare path term, return its tuple."""
        _, cmds = pipe
        if len(cmds) == 1 and len(cmds[0][1]) == 1:
            t = cmds[0][1][0]
            if t[0] == "field":
                return tuple(t[1])
        return None

    def walk(nodes, root_ctx):
        for n in nodes:
            if isinstance(n, _Output):
                collect_pipe(n.pipe, root_ctx)
            elif isinstance(n, _Assign):
                if n.name not in all_assigns:
                    continue  # pruned dead assignment
                collect_pipe(n.pipe, root_ctx)
                if root_ctx:
                    var_sources[n.name] = pipe_as_path(n.pipe)
            elif isinstance(n, _If):
                for cond, body in n.branches:
                    collect_pipe(cond, root_ctx)
                    walk(body, root_ctx)
                walk(n.else_body, root_ctx)
            elif isinstance(n, (_Range, _With)):
                collect_pipe(n.pipe, root_ctx)
                # body reads are relative to the (collected) source subtree
                walk(n.body, False)
                walk(n.else_body, root_ctx)

    walk(tpl.nodes, True)
    return paths


class Renderer:
    """Template renderer with an extra func environment
    (reference gotpl/renderer.go:50-118)."""

    def __init__(self, funcs: Optional[Dict[str, Callable]] = None):
        self.funcs = dict(funcs or {})
        self._cache: Dict[str, Template] = {}

    def render(self, template: str, data: Any, extra_funcs: Optional[Dict] = None) -> str:
        tpl = self._cache.get(template)
        if tpl is None:
            tpl = Template(template)
            self._cache[template] = tpl
        env = dict(self.funcs)
        if extra_funcs:
            env.update(extra_funcs)
        return tpl.render(data, env)

    def render_to_json(self, template: str, data: Any, extra_funcs: Optional[Dict] = None) -> Any:
        """Render, then parse the YAML output to a JSON-standard value
        (reference renderer.go:110 ToJSON)."""
        text = self.render(template, data, extra_funcs)
        return yaml.load(text, Loader=_YAML_LOADER)


# the rendered-patch parse is the drain hot path: libyaml's C loader is
# ~20x faster than the pure-Python scanner (bench e2e profile)
_YAML_LOADER = getattr(yaml, "CSafeLoader", yaml.SafeLoader)
