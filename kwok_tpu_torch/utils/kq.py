"""kq — a jq query engine over JSON-standard objects.

The reference drives all Stage selector matchExpressions, weightFrom and
durationFrom expressions through gojq (reference:
pkg/utils/expression/query.go:25-88 — the *whole* language).  kq is an
independent jq interpreter covering the constructs real stages use —
paths, iteration, ``select``, pipes, the alternative operator ``//``,
boolean/comparison/arithmetic operators, array/object construction,
``if/then/elif/else/end``, the ``?`` error suppressor, and the common
builtin functions (length, any, all, map, has, test, split, join,
startswith, contains, ...) — with gojq-compatible semantics:

- results are a stream; ``null`` outputs are dropped from the result
  list (reference: query.go:60-66);
- any evaluation error aborts the query and yields an *empty* result
  (gojq errors are swallowed: query.go:57-59 returns nil, nil);
- iterating a non-iterable (including null/missing) is an error unless
  suppressed with ``?``;
- field access on null/missing yields null, not an error;
- jq's total value order (null < false < true < numbers < strings <
  arrays < objects) backs ``< <= > >=``, sort, min, max;
- ``true != 1`` (no bool/number coercion).

The full-language tail is in too (r04): variables and ``as`` bindings
(including ``[$a, $b]`` / ``{k: $v}`` destructuring patterns),
``reduce``/``foreach``, ``def`` with filter and ``$value`` parameters
(including recursion), ``try``/``catch``, ``label``/``break``, and the
``@format`` strings (@text/@json/@base64/@base64d/@uri/@html/@sh/
@csv/@tsv) — so out-of-subset stages run on the host path, and
selector expressions using them lower as opaque host-evaluated feature
columns on the device path — plus string interpolation ``"\\(e)"``
with bindings visible inside, recursive descent ``..``/``recurse``,
``limit``/``range(a;b;c)``/``while``/``until``, the ``?//`` pattern
alternative operator, destructuring patterns in ``reduce``/``foreach``
sources, ``input``/``inputs`` (``Query.execute(v, inputs=...)``
feeds the rest-of-stream; the default stream is empty, so ``input``
errors at end-of-input like jq), the regex family (``test``/``match``
flags, ``sub``/``gsub`` with filter replacements and named captures in
Oniguruma ``(?<name>)`` syntax, ``capture``, ``splits``,
``split/2``), the entries family
(``to_entries``/``from_entries``/``with_entries``), paths
(``paths``/``leaf_paths``/``getpath``/``del``), and the collection
tail (``group_by``/``unique_by``/``flatten``/``map_values``/
``in``/``inside``/``index``/``rindex``/``indices``/``ltrimstr``/
``rtrimstr``/``trim``/``explode``/``implode``/``utf8bytelength``),
``setpath``/``delpaths``, and the assignment family
(``=``/``|=``/``+=``/``-=``/``*=``/``/=``/``%=``/``//=`` over path
expressions, jq's original-input rhs and first-output update
semantics; ``|= empty`` deletes).  Unbound ``$vars`` and breaks
outside their label are compile errors like jq.

Lhs path-expression subset (assignment targets, ``del``, ``path``):
field/index/iterate navigation (``.a.b``, ``.a[0]``, ``.a[]``),
commas and pipes of those, ``select(cond)`` stages, and the ``?``
suppressor (``.a? = x`` on a scalar yields the input unchanged, like
jq's empty-paths semantics).  Array slices (``.a[1:2]``) are not in
the grammar at all — a slice lhs is a parse error, not a silent
no-op.  Anything else in path position raises jq's "invalid path
expression" (swallowed to an empty result like every other runtime
error).

The AST node classes (Path/Field/Iterate/Pipe/Select/Compare/Literal)
are public shape contracts: the device compiler pattern-matches them to
lower selector expressions (engine/features.py).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Sequence, Tuple


class KqCompileError(ValueError):
    """The query is not valid kq (parse/compile-time)."""


class _KqRuntimeError(Exception):
    """Evaluation error; swallowed by Query.execute (gojq parity).

    ``value`` preserves the original error payload for try/catch
    (jq: ``try error({a: 1}) catch .`` yields the object, not a
    stringification)."""

    def __init__(self, message: str, value: Any = None, has_value: bool = False):
        super().__init__(message)
        self.value = value if has_value else message
        self.has_value = has_value


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<number>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
  | (?P<var>\$[A-Za-z_][A-Za-z0-9_]*)
  | (?P<format>@[a-z0-9]+)
  | (?P<op>\?//|//=|//|\.\.|==|!=|<=|>=|\|=|\+=|-=|\*=|/=|%=|=|<|>|\+|-|\*|/|%|\||\(|\)|\[|\]|\{|\}|\.|,|:|\?|;)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    """,
    re.VERBOSE,
)


def _scan_string(src: str, start: int) -> int:
    """End index (past the closing quote) of the string starting at
    ``src[start] == '"'`` — interpolation-aware: inside ``\\( ... )``
    nested quotes open full inner strings (recursively), so
    ``"\\(.a + "x")"`` is ONE token like jq."""
    i = start + 1
    n = len(src)
    while i < n:
        c = src[i]
        if c == '"':
            return i + 1
        if c == "\\":
            if i + 1 < n and src[i + 1] == "(":
                depth = 1
                i += 2
                while i < n and depth:
                    if src[i] == '"':
                        i = _scan_string(src, i)
                        continue
                    if src[i] == "(":
                        depth += 1
                    elif src[i] == ")":
                        depth -= 1
                    i += 1
                continue
            i += 2
            continue
        i += 1
    raise KqCompileError(f"unterminated string in {src!r}")


def _has_interp(body: str) -> bool:
    """Escape-parity-aware: is there an UNESCAPED ``\\(`` in the string
    body?  (A regex lookbehind cannot count backslashes: ``\\\\\\(``
    is an escaped backslash followed by a live interpolation.)"""
    i = 0
    n = len(body)
    while i < n:
        if body[i] == "\\":
            if i + 1 < n and body[i + 1] == "(":
                return True
            i += 2
            continue
        i += 1
    return False


def _tokenize(src: str) -> List[Tuple[str, str]]:
    tokens: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(src):
        if src[pos] == '"':
            end = _scan_string(src, pos)
            tokens.append(("string", src[pos:end]))
            pos = end
            continue
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise KqCompileError(f"unexpected character {src[pos]!r} at {pos} in {src!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        tokens.append((kind, m.group()))
    return tokens


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Field:
    name: str


@dataclass(frozen=True)
class Iterate:
    pass


@dataclass(frozen=True)
class Index:
    """Array index ``.[0]`` (negative from the end, like jq)."""

    i: int


@dataclass(frozen=True)
class Path:
    """A `.a.b["c"].[]`-style navigation; ops are Field/Iterate/Index."""

    ops: Tuple[Any, ...]
    optional: bool = False  # trailing '?'


@dataclass(frozen=True)
class Literal:
    value: Any


@dataclass(frozen=True)
class Compare:
    left: Any
    op: str  # == != < <= > >=
    right: Any


@dataclass(frozen=True)
class Select:
    cond: Any


@dataclass(frozen=True)
class Pipe:
    stages: Tuple[Any, ...]


@dataclass(frozen=True)
class Comma:
    parts: Tuple[Any, ...]


@dataclass(frozen=True)
class Alternative:
    left: Any
    right: Any


@dataclass(frozen=True)
class BoolOp:
    op: str  # "and" | "or"
    left: Any
    right: Any


@dataclass(frozen=True)
class Arith:
    op: str  # + - * / %
    left: Any
    right: Any


@dataclass(frozen=True)
class Neg:
    expr: Any


@dataclass(frozen=True)
class Func:
    name: str
    args: Tuple[Any, ...]


@dataclass(frozen=True)
class If:
    cond: Any
    then: Any
    orelse: Any  # None -> identity


@dataclass(frozen=True)
class ArrayCons:
    expr: Any  # None -> []


@dataclass(frozen=True)
class ObjectCons:
    entries: Tuple[Tuple[Any, Any], ...]  # (key expr|str, value expr)


@dataclass(frozen=True)
class Optional_:
    """`expr?` — suppress evaluation errors of expr."""

    expr: Any


@dataclass(frozen=True)
class Var:
    """``$x`` — environment lookup (bound by as/reduce/foreach/def)."""

    name: str


@dataclass(frozen=True)
class As:
    """``SRC as $x | BODY`` — bind each output of SRC for BODY."""

    source: Any
    var: str
    body: Any


@dataclass(frozen=True)
class Reduce:
    """``reduce SRC as PATTERN [?// ALT...] (INIT; UPDATE)``.

    ``patterns`` is a tuple of destructuring-pattern trees (see
    AsPattern); the common ``$x`` binding is ``(("$", "x"),)``."""

    source: Any
    patterns: Tuple[Any, ...]
    init: Any
    update: Any


@dataclass(frozen=True)
class Foreach:
    """``foreach SRC as PATTERN [?// ALT...] (INIT; UPDATE[; EXTRACT])``."""

    source: Any
    patterns: Tuple[Any, ...]
    init: Any
    update: Any
    extract: Any  # None -> emit the accumulator


@dataclass(frozen=True)
class Def:
    """``def f(p1; p2): BODY; REST`` — REST sees f in scope."""

    name: str
    params: Tuple[str, ...]  # "$x" value params or bare filter params
    body: Any
    rest: Any


@dataclass(frozen=True)
class Call:
    """Application of a def-defined function."""

    name: str
    args: Tuple[Any, ...]


@dataclass(frozen=True)
class TryCatch:
    """``try BODY [catch HANDLER]`` — HANDLER sees the error message."""

    body: Any
    handler: Any  # None -> swallow


@dataclass(frozen=True)
class Label:
    """``label $out | BODY`` — a scope ``break $out`` jumps out of."""

    name: str
    body: Any


@dataclass(frozen=True)
class Break:
    """``break $out`` — stop producing outputs up to the label."""

    name: str


@dataclass(frozen=True)
class Format:
    """``@base64`` etc. — format the input value as a string."""

    name: str


@dataclass(frozen=True)
class StrInterp:
    """``"a\\(expr)b"`` — string interpolation; parts are literal
    strings and compiled sub-queries (cartesian across parts)."""

    parts: Tuple[Any, ...]


@dataclass(frozen=True)
class Assign:
    """``PATHEXPR op EXPR`` — jq's update/assignment family.  ``op`` is
    one of = |= += -= *= /= %= //=.  The left side must be a path
    expression (jq "Invalid path expression" otherwise)."""

    op: str
    target: Any
    expr: Any


@dataclass(frozen=True)
class AsPattern:
    """``SRC as [$a, $b] | BODY`` / ``SRC as {k: $v} | BODY`` —
    destructuring binds; each pattern is nested lists/dicts with leaf
    ``("$", name)`` markers.  ``patterns`` holds the ``?//``
    alternatives in order (usually just one): jq tries each pattern,
    and on a destructuring *or body* error moves to the next; every
    variable named in any alternative is in scope (null when the
    matching alternative does not bind it)."""

    source: Any
    patterns: Tuple[Any, ...]
    body: Any


#: zero-arg builtins (applied as a filter to each input)
_FUNCS0 = {
    "length", "keys", "values", "type", "tostring", "tonumber", "not",
    "empty", "add", "any", "all", "first", "last", "min", "max", "sort",
    "unique", "floor", "ceil", "ascii_downcase", "ascii_upcase", "abs",
    "reverse", "tojson", "fromjson", "error", "recurse", "input", "inputs",
    "to_entries", "from_entries", "paths", "leaf_paths", "flatten",
    "explode", "implode", "infinite", "nan", "isnan",
    "isinfinite", "isnormal", "utf8bytelength", "trim", "ltrim", "rtrim",
    "now", "todate", "fromdate", "todateiso8601", "fromdateiso8601",
}

#: env key carrying the shared rest-of-inputs iterator for
#: ``input``/``inputs`` (a tuple so it can never collide with a $var
#: name; def closures copy the env, so the iterator is shared)
_INPUTS_KEY = ("inputs",)
#: one-arg builtins
_FUNCS1 = {
    "select", "has", "map", "test", "startswith", "endswith", "contains",
    "split", "join", "any", "all", "sort_by", "min_by", "max_by", "range",
    "error", "recurse", "with_entries", "group_by", "unique_by",
    "ltrimstr", "rtrimstr", "getpath", "flatten", "in", "inside",
    "splits", "index", "rindex", "indices", "capture", "match", "del",
    "map_values", "paths", "delpaths", "path",
}
#: multi-arg builtins: name -> allowed arities beyond 0/1
_FUNCS_N = {
    "limit": {2},
    "range": {2, 3},
    "while": {2},
    "until": {2},
    "test": {2},
    "match": {2},
    "split": {2},
    "splits": {2},
    "sub": {2, 3},
    "gsub": {2, 3},
    "capture": {2},
    "setpath": {2},
}


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]], src: str):
        self.tokens = tokens
        self.src = src
        self.i = 0
        #: lexically-scoped $variables (unbound use is a compile error,
        #: like jq)
        self.var_scope: List[str] = []
        #: def-defined functions in scope as (name, arity); bare filter
        #: params enter with arity 0
        self.fn_scope: List[Tuple[str, int]] = []
        #: >0 while parsing a reduce/foreach source, whose own 'as'
        #: belongs to the construct, not to a Term binding
        self._no_as = 0
        #: lexically-scoped labels (break outside its label is a
        #: compile error, like jq)
        self.label_scope: List[str] = []

    def peek(self) -> Optional[Tuple[str, str]]:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def peek_text(self) -> Optional[str]:
        t = self.peek()
        return t[1] if t else None

    def next(self) -> Tuple[str, str]:
        tok = self.peek()
        if tok is None:
            raise KqCompileError(f"unexpected end of query: {self.src!r}")
        self.i += 1
        return tok

    def expect(self, text: str) -> None:
        tok = self.next()
        if tok[1] != text:
            raise KqCompileError(f"expected {text!r}, got {tok[1]!r} in {self.src!r}")

    # precedence chain: pipe > comma > // > or > and > cmp > add > mul > unary

    def parse_query(self) -> Any:
        node = self.parse_pipe()
        if self.peek() is not None:
            raise KqCompileError(f"trailing tokens in {self.src!r}")
        return node

    def parse_pipe(self) -> Any:
        stages = [self.parse_comma()]
        while self.peek_text() == "|":
            self.next()
            stages.append(self.parse_comma())
        if len(stages) == 1:
            return stages[0]
        return Pipe(tuple(stages))

    def parse_comma(self) -> Any:
        parts = [self.parse_alt()]
        while self.peek_text() == ",":
            self.next()
            parts.append(self.parse_alt())
        if len(parts) == 1:
            return parts[0]
        return Comma(tuple(parts))

    def parse_alt(self) -> Any:
        node = self.parse_assign()
        while self.peek_text() == "//":
            self.next()
            node = Alternative(node, self.parse_assign())
        return node

    _ASSIGN_OPS = ("=", "|=", "+=", "-=", "*=", "/=", "%=", "//=")

    def parse_assign(self) -> Any:
        node = self.parse_or()
        t = self.peek_text()
        if t in self._ASSIGN_OPS:
            self.next()
            rhs = self.parse_or()
            # %nonassoc in jq.y: `.a = .b = 1` is a syntax error
            if self.peek_text() in self._ASSIGN_OPS:
                raise KqCompileError(
                    f"chained assignment in {self.src!r}"
                )
            return Assign(t, node, rhs)
        return node

    def parse_or(self) -> Any:
        node = self.parse_and()
        while self.peek_text() == "or":
            self.next()
            node = BoolOp("or", node, self.parse_and())
        return node

    def parse_and(self) -> Any:
        node = self.parse_cmp()
        while self.peek_text() == "and":
            self.next()
            node = BoolOp("and", node, self.parse_cmp())
        return node

    def parse_cmp(self) -> Any:
        node = self.parse_add()
        tok = self.peek()
        if tok is not None and tok[1] in ("==", "!=", "<", "<=", ">", ">="):
            op = self.next()[1]
            right = self.parse_add()
            node = Compare(node, op, right)
        return node

    def parse_add(self) -> Any:
        node = self.parse_mul()
        while self.peek_text() in ("+", "-"):
            op = self.next()[1]
            node = Arith(op, node, self.parse_mul())
        return node

    def parse_mul(self) -> Any:
        node = self.parse_unary()
        while self.peek_text() in ("*", "/", "%"):
            op = self.next()[1]
            node = Arith(op, node, self.parse_unary())
        return node

    def parse_unary(self) -> Any:
        if self.peek_text() == "-":
            self.next()
            return Neg(self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self) -> Any:
        node = self.parse_primary()
        while True:
            t = self.peek_text()
            if t == "?":
                self.next()
                node = Optional_(node)
            elif t == ".":
                # path suffix on a primary — `$i.name`, `(.a).b.[0]` —
                # jq sugar for `expr | .path`.  (A directly-parsed Path
                # never leaves a '.' behind, so this only triggers on
                # non-path primaries.)
                suffix = self.parse_path()
                node = Pipe((node, suffix))
            else:
                break
        if self.peek_text() == "as" and not self._no_as:
            # jq grammar: Term 'as' Pattern '|' Exp — the source is the
            # TERM, and the body extends maximally to the right
            # (`1, 2 as $x | e` is `1, (2 as $x | e)`)
            self.next()
            patterns = self._parse_patterns()
            names = [n for p in patterns for n in _pattern_vars(p)]
            self.expect("|")
            self.var_scope.extend(names)
            try:
                body = self.parse_pipe()
            finally:
                del self.var_scope[len(self.var_scope) - len(names) :]
            if len(patterns) == 1 and patterns[0][0] == "$":
                return As(node, patterns[0][1], body)
            return AsPattern(node, patterns, body)
        return node

    def _parse_patterns(self) -> Tuple[Any, ...]:
        """One destructuring pattern plus any ``?//`` alternatives."""
        patterns = [self.parse_pattern()]
        while self.peek_text() == "?//":
            self.next()
            patterns.append(self.parse_pattern())
        return tuple(patterns)

    def _parse_call_args(self) -> List[Any]:
        """``( a; b; ... )`` argument list, empty when no paren."""
        args: List[Any] = []
        if self.peek_text() == "(":
            self.next()
            args.append(self.parse_pipe())
            while self.peek_text() == ";":
                self.next()
                args.append(self.parse_pipe())
            self.expect(")")
        return args

    def _builtin_call(self, text: str, args: List[Any]) -> Optional[Any]:
        """Builtin node for (name, arity), or None when unknown."""
        ok = (
            (len(args) == 0 and text in _FUNCS0)
            or (len(args) == 1 and text in _FUNCS1)
            or (len(args) in _FUNCS_N.get(text, ()))
        )
        if not ok:
            return None
        if text == "select":
            return Select(args[0])
        return Func(text, tuple(args))

    def _parse_interp(self, body: str) -> Any:
        """Split a string body on ``\\( ... )`` (paren-balanced, string
        literals inside skipped) and compile the embedded queries with
        THIS parser's scopes, so ``"\\($x)"`` sees its binding."""
        parts: List[Any] = []
        lit: List[str] = []
        i = 0
        n = len(body)
        while i < n:
            if body[i] == "\\" and i + 1 < n and body[i + 1] == "(":
                depth = 1
                j = i + 2
                while j < n and depth:
                    c = body[j]
                    if c == '"':
                        j += 1
                        while j < n and body[j] != '"':
                            j += 2 if body[j] == "\\" else 1
                    elif c == "(":
                        depth += 1
                    elif c == ")":
                        depth -= 1
                    j += 1
                if depth:
                    raise KqCompileError(
                        f"unbalanced interpolation in {self.src!r}"
                    )
                src = body[i + 2 : j - 1]
                if lit:
                    parts.append(_unquote(f'"{"".join(lit)}"'))
                    lit = []
                sub = _Parser(_tokenize(src), src)
                sub.var_scope = self.var_scope
                sub.fn_scope = self.fn_scope
                sub.label_scope = self.label_scope
                parts.append(sub.parse_query())
                i = j
            elif body[i] == "\\":
                lit.append(body[i : i + 2])
                i += 2
            else:
                lit.append(body[i])
                i += 1
        if lit:
            parts.append(_unquote(f'"{"".join(lit)}"'))
        return StrInterp(tuple(parts))

    def parse_pattern(self) -> Any:
        """Destructuring pattern: ``$x`` | ``[p, ...]`` | ``{k: p, $x}``."""
        tok = self.next()
        if tok[0] == "var":
            return ("$", tok[1][1:])
        if tok[1] == "[":
            elems = [self.parse_pattern()]
            while self.peek_text() == ",":
                self.next()
                elems.append(self.parse_pattern())
            self.expect("]")
            return ("arr", tuple(elems))
        if tok[1] == "{":
            entries = []
            while True:
                k = self.next()
                if k[0] == "var":
                    # {$x} shorthand: key "x" binds $x
                    entries.append((k[1][1:], ("$", k[1][1:])))
                elif k[0] in ("ident", "string"):
                    key = _unquote(k[1]) if k[0] == "string" else k[1]
                    self.expect(":")
                    entries.append((key, self.parse_pattern()))
                else:
                    raise KqCompileError(
                        f"bad pattern key {k[1]!r} in {self.src!r}"
                    )
                if self.peek_text() == ",":
                    self.next()
                    continue
                break
            self.expect("}")
            return ("obj", tuple(entries))
        raise KqCompileError(f"bad pattern {tok[1]!r} in {self.src!r}")

    def parse_primary(self) -> Any:
        tok = self.peek()
        if tok is None:
            raise KqCompileError(f"unexpected end of query: {self.src!r}")
        kind, text = tok
        if text == ".":
            return self.parse_path()
        if text == "(":
            self.next()
            # parens reset the reduce/foreach 'as'-suppression: an
            # inner binding like `reduce (.[] as $y | $y) as $x (...)`
            # is fully parenthesized and unambiguous
            saved_no_as, self._no_as = self._no_as, 0
            try:
                node = self.parse_pipe()
            finally:
                self._no_as = saved_no_as
            self.expect(")")
            return node
        if text == "[":
            self.next()
            if self.peek_text() == "]":
                self.next()
                return ArrayCons(None)
            node = self.parse_pipe()
            self.expect("]")
            return ArrayCons(node)
        if text == "{":
            return self.parse_object()
        if kind == "string":
            self.next()
            body = text[1:-1]
            if _has_interp(body):
                return self._parse_interp(body)
            return Literal(_unquote(text))
        if kind == "number":
            self.next()
            is_float = "." in text or "e" in text or "E" in text
            return Literal(float(text) if is_float else int(text))
        if kind == "var":
            self.next()
            name = text[1:]
            if name not in self.var_scope:
                raise KqCompileError(f"${name} is not defined in {self.src!r}")
            return Var(name)
        if kind == "format":
            self.next()
            name = text[1:]
            if name not in _FORMATS:
                raise KqCompileError(f"unknown format @{name} in {self.src!r}")
            return Format(name)
        if kind == "ident":
            if text == "if":
                return self.parse_if()
            if text == "reduce":
                return self.parse_reduce()
            if text == "foreach":
                return self.parse_foreach()
            if text == "def":
                return self.parse_def()
            if text == "try":
                return self.parse_try()
            if text == "label":
                self.next()
                tok = self.next()
                if tok[0] != "var":
                    raise KqCompileError(
                        f"'label' needs a $name in {self.src!r}"
                    )
                lbl = tok[1][1:]
                self.expect("|")
                self.label_scope.append(lbl)
                try:
                    body = self.parse_pipe()
                finally:
                    self.label_scope.pop()
                return Label(lbl, body)
            if text == "break":
                self.next()
                tok = self.next()
                if tok[0] != "var" or tok[1][1:] not in self.label_scope:
                    raise KqCompileError(
                        f"break outside its label in {self.src!r}"
                    )
                return Break(tok[1][1:])
            if text in ("true", "false", "null"):
                self.next()
                return Literal({"true": True, "false": False, "null": None}[text])
            # def-defined functions shadow builtins per (name, arity);
            # an arity not def'd falls through to the builtin of that
            # arity (jq resolves map/1 past a user def map/0)
            if any(n == text for n, _ in self.fn_scope):
                self.next()
                args = self._parse_call_args()
                if (text, len(args)) in self.fn_scope:
                    return Call(text, tuple(args))
                node = self._builtin_call(text, args)
                if node is not None:
                    return node
                raise KqCompileError(
                    f"{text}/{len(args)} is not defined in {self.src!r}"
                )
            if text in _FUNCS0 or text in _FUNCS1 or text in _FUNCS_N:
                self.next()
                args = self._parse_call_args()
                node = self._builtin_call(text, args)
                if node is None:
                    raise KqCompileError(
                        f"{text}/{len(args)} is not defined in {self.src!r}"
                    )
                return node
            raise KqCompileError(f"unsupported function {text!r} in {self.src!r}")
        if text == "..":
            self.next()
            return Func("recurse", ())
        raise KqCompileError(f"unexpected token {text!r} in {self.src!r}")

    def _parse_as_binding(self, kw: str) -> Tuple[Any, Tuple[Any, ...]]:
        """Shared ``KW SRC as PATTERN [?// ALT...]`` prefix of
        reduce/foreach — full destructuring patterns, like jq's
        grammar (gojq behind reference query.go:33 accepts them)."""
        self.expect(kw)
        self._no_as += 1
        try:
            source = self.parse_postfix()
        finally:
            self._no_as -= 1
        self.expect("as")
        return source, self._parse_patterns()

    def parse_reduce(self) -> Any:
        source, patterns = self._parse_as_binding("reduce")
        names = [n for p in patterns for n in _pattern_vars(p)]
        self.expect("(")
        init = self.parse_pipe()
        self.expect(";")
        self.var_scope.extend(names)
        try:
            update = self.parse_pipe()
        finally:
            del self.var_scope[len(self.var_scope) - len(names) :]
        self.expect(")")
        return Reduce(source, patterns, init, update)

    def parse_foreach(self) -> Any:
        source, patterns = self._parse_as_binding("foreach")
        names = [n for p in patterns for n in _pattern_vars(p)]
        self.expect("(")
        init = self.parse_pipe()
        self.expect(";")
        self.var_scope.extend(names)
        try:
            update = self.parse_pipe()
            extract = None
            if self.peek_text() == ";":
                self.next()
                extract = self.parse_pipe()
        finally:
            del self.var_scope[len(self.var_scope) - len(names) :]
        self.expect(")")
        return Foreach(source, patterns, init, update, extract)

    def parse_def(self) -> Any:
        self.expect("def")
        tok = self.next()
        if tok[0] != "ident":
            raise KqCompileError(f"bad def name {tok[1]!r} in {self.src!r}")
        name = tok[1]
        params: List[str] = []
        if self.peek_text() == "(":
            self.next()
            while True:
                p = self.next()
                if p[0] == "var":
                    params.append(p[1])  # keep the $ to mark value params
                elif p[0] == "ident":
                    params.append(p[1])
                else:
                    raise KqCompileError(
                        f"bad def parameter {p[1]!r} in {self.src!r}"
                    )
                if self.peek_text() == ";":
                    self.next()
                    continue
                break
            self.expect(")")
        self.expect(":")
        # body scope: $params are variables, bare params are 0-ary
        # filters, and the function itself is visible (recursion)
        n_vars = 0
        n_fns = 1
        self.fn_scope.append((name, len(params)))
        for p in params:
            if p.startswith("$"):
                self.var_scope.append(p[1:])
                n_vars += 1
            else:
                self.fn_scope.append((p, 0))
                n_fns += 1
        try:
            body = self.parse_pipe()
        finally:
            del self.var_scope[len(self.var_scope) - n_vars :]
            del self.fn_scope[len(self.fn_scope) - n_fns :]
        self.expect(";")
        self.fn_scope.append((name, len(params)))
        try:
            rest = self.parse_pipe()
        finally:
            self.fn_scope.pop()
        return Def(name, tuple(params), body, rest)

    def parse_try(self) -> Any:
        self.expect("try")
        body = self.parse_postfix()
        handler = None
        if self.peek_text() == "catch":
            self.next()
            handler = self.parse_postfix()
        return TryCatch(body, handler)

    def parse_if(self) -> Any:
        self.expect("if")
        cond = self.parse_pipe()
        self.expect("then")
        then = self.parse_pipe()
        tok = self.peek()
        if tok is not None and tok[1] == "elif":
            # rewrite elif as nested if
            self.next()
            # re-parse as if-chain: build manually
            sub_cond = self.parse_pipe()
            self.expect("then")
            sub_then = self.parse_pipe()
            rest = self._finish_if(sub_cond, sub_then)
            return If(cond, then, rest)
        if tok is not None and tok[1] == "else":
            self.next()
            orelse = self.parse_pipe()
            self.expect("end")
            return If(cond, then, orelse)
        self.expect("end")
        return If(cond, then, None)

    def _finish_if(self, cond: Any, then: Any) -> Any:
        tok = self.peek()
        if tok is not None and tok[1] == "elif":
            self.next()
            sub_cond = self.parse_pipe()
            self.expect("then")
            sub_then = self.parse_pipe()
            return If(cond, then, self._finish_if(sub_cond, sub_then))
        if tok is not None and tok[1] == "else":
            self.next()
            orelse = self.parse_pipe()
            self.expect("end")
            return If(cond, then, orelse)
        self.expect("end")
        return If(cond, then, None)

    def parse_object(self) -> Any:
        self.expect("{")
        entries: List[Tuple[Any, Any]] = []
        if self.peek_text() != "}":
            while True:
                tok = self.next()
                if tok[0] == "ident":
                    key: Any = tok[1]
                elif tok[0] == "string":
                    key = _unquote(tok[1])
                elif tok[1] == "(":
                    key = self.parse_pipe()
                    self.expect(")")
                else:
                    raise KqCompileError(f"bad object key {tok[1]!r} in {self.src!r}")
                if self.peek_text() == ":":
                    self.next()
                    val = self.parse_alt()
                else:
                    if not isinstance(key, str):
                        raise KqCompileError(f"shorthand needs ident key in {self.src!r}")
                    val = Path((Field(key),))
                entries.append((key, val))
                if self.peek_text() == ",":
                    self.next()
                    continue
                break
        self.expect("}")
        return ObjectCons(tuple(entries))

    def parse_path(self) -> Path:
        ops: List[Any] = []
        self.expect(".")
        while True:
            tok = self.peek()
            if tok is None:
                break
            kind, text = tok
            if kind == "ident":
                # identifiers that are keywords/operators end the path
                if text in ("and", "or", "then", "else", "elif", "end", "as"):
                    break
                self.next()
                ops.append(Field(text))
            elif text == "[":
                self.next()
                nxt = self.next()
                if nxt[1] == "]":
                    ops.append(Iterate())
                elif nxt[0] == "string":
                    self.expect("]")
                    ops.append(Field(_unquote(nxt[1])))
                elif nxt[0] == "number" and "." not in nxt[1]:
                    self.expect("]")
                    ops.append(Index(int(nxt[1])))
                elif nxt[1] == "-" and self.peek() and self.peek()[0] == "number":
                    num = self.next()[1]
                    self.expect("]")
                    ops.append(Index(-int(num)))
                else:
                    raise KqCompileError(
                        f"unsupported index {nxt[1]!r} in {self.src!r}"
                    )
            elif text == ".":
                # `.a.b` / `.a.[]` — separator between segments
                self.next()
                nxt = self.peek()
                if nxt is None or (nxt[0] != "ident" and nxt[1] != "["):
                    raise KqCompileError(f"dangling '.' in {self.src!r}")
            else:
                break
        if self.peek_text() == "?":
            self.next()
            return Path(tuple(ops), optional=True)
        return Path(tuple(ops))


def _unquote(s: str) -> str:
    body = s[1:-1]
    if _has_interp(body):
        # silently rendering "\(e)" as a literal would be wrong output
        # — interpolation is only wired for value position, so fail
        # loudly where it is not (object keys, path brackets)
        raise KqCompileError(f"interpolation not supported here: {s!r}")
    return body.replace('\\"', '"').replace("\\\\", "\\")


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def _truthy(v: Any) -> bool:
    # jq: false and null are falsy; everything else truthy.
    return v is not None and v is not False


_TYPE_ORDER = {"null": 0, "boolean": 1, "number": 2, "string": 3, "array": 4, "object": 5}


def _jq_type(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, list):
        return "array"
    if isinstance(v, dict):
        return "object"
    raise _KqRuntimeError(f"non-JSON value {type(v).__name__}")


def _jq_cmp(a: Any, b: Any) -> int:
    """jq's total value order."""
    ta, tb = _jq_type(a), _jq_type(b)
    if ta != tb:
        return -1 if _TYPE_ORDER[ta] < _TYPE_ORDER[tb] else 1
    if ta in ("null",):
        return 0
    if ta == "boolean":
        return (a > b) - (a < b)
    if ta in ("number", "string"):
        return (a > b) - (a < b)
    if ta == "array":
        for x, y in zip(a, b):
            c = _jq_cmp(x, y)
            if c:
                return c
        return (len(a) > len(b)) - (len(a) < len(b))
    # object: compare sorted keys, then values in key order
    ka, kb = sorted(a), sorted(b)
    c = _jq_cmp(ka, kb)
    if c:
        return c
    for k in ka:
        c = _jq_cmp(a[k], b[k])
        if c:
            return c
    return 0


def _arith(op: str, a: Any, b: Any) -> Any:
    if op == "+":
        if a is None:
            return b
        if b is None:
            return a
        if isinstance(a, bool) or isinstance(b, bool):
            raise _KqRuntimeError("boolean + boolean")
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            return a + b
        if isinstance(a, str) and isinstance(b, str):
            return a + b
        if isinstance(a, list) and isinstance(b, list):
            return a + b
        if isinstance(a, dict) and isinstance(b, dict):
            out = dict(a)
            out.update(b)
            return out
        raise _KqRuntimeError(f"cannot add {_jq_type(a)} and {_jq_type(b)}")
    if op == "-":
        if isinstance(a, (int, float)) and isinstance(b, (int, float)) and not (
            isinstance(a, bool) or isinstance(b, bool)
        ):
            return a - b
        if isinstance(a, list) and isinstance(b, list):
            return [x for x in a if x not in b]
        raise _KqRuntimeError(f"cannot subtract {_jq_type(b)} from {_jq_type(a)}")
    if op == "*":
        if isinstance(a, (int, float)) and isinstance(b, (int, float)) and not (
            isinstance(a, bool) or isinstance(b, bool)
        ):
            return a * b
        if isinstance(a, dict) and isinstance(b, dict):
            return _deep_merge(a, b)
        raise _KqRuntimeError(f"cannot multiply {_jq_type(a)} and {_jq_type(b)}")
    if op == "/":
        if isinstance(a, str) and isinstance(b, str):
            return a.split(b)
        if isinstance(a, (int, float)) and isinstance(b, (int, float)) and not (
            isinstance(a, bool) or isinstance(b, bool)
        ):
            if b == 0:
                raise _KqRuntimeError("division by zero")
            out = a / b
            return out
        raise _KqRuntimeError(f"cannot divide {_jq_type(a)} by {_jq_type(b)}")
    if op == "%":
        if isinstance(a, (int, float)) and isinstance(b, (int, float)) and not (
            isinstance(a, bool) or isinstance(b, bool)
        ):
            if int(b) == 0:
                raise _KqRuntimeError("modulo by zero")
            return int(math.fmod(int(a), int(b)))
        raise _KqRuntimeError(f"cannot mod {_jq_type(a)} by {_jq_type(b)}")
    raise _KqRuntimeError(f"unknown operator {op}")


def _deep_merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        if isinstance(out.get(k), dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _eval(node: Any, value: Any, env: dict) -> Iterator[Any]:
    if isinstance(node, Literal):
        yield node.value
    elif isinstance(node, Path):
        if node.optional:
            # stream-then-swallow, like `try` (jq: `e?` is `try e`)
            it = _eval_path(node.ops, 0, value)
            while True:
                try:
                    out = next(it)
                except (StopIteration, _KqRuntimeError):
                    return
                yield out
        else:
            yield from _eval_path(node.ops, 0, value)
    elif isinstance(node, Pipe):
        yield from _eval_pipe(node.stages, 0, value, env)
    elif isinstance(node, Comma):
        for part in node.parts:
            yield from _eval(part, value, env)
    elif isinstance(node, Select):
        for out in _eval(node.cond, value, env):
            if _truthy(out):
                yield value
    elif isinstance(node, Compare):
        for lv in _eval(node.left, value, env):
            for rv in _eval(node.right, value, env):
                if node.op == "==":
                    yield _json_equal(lv, rv)
                elif node.op == "!=":
                    yield not _json_equal(lv, rv)
                else:
                    c = _jq_cmp(lv, rv)
                    yield {
                        "<": c < 0,
                        "<=": c <= 0,
                        ">": c > 0,
                        ">=": c >= 0,
                    }[node.op]
    elif isinstance(node, Alternative):
        got = False
        try:
            for out in _eval(node.left, value, env):
                if _truthy(out):
                    got = True
                    yield out
        except _KqRuntimeError:
            pass
        if not got:
            yield from _eval(node.right, value, env)
    elif isinstance(node, BoolOp):
        for lv in _eval(node.left, value, env):
            lt = _truthy(lv)
            if node.op == "and" and not lt:
                yield False
            elif node.op == "or" and lt:
                yield True
            else:
                for rv in _eval(node.right, value, env):
                    yield _truthy(rv)
    elif isinstance(node, Arith):
        for lv in _eval(node.left, value, env):
            for rv in _eval(node.right, value, env):
                yield _arith(node.op, lv, rv)
    elif isinstance(node, Neg):
        for v in _eval(node.expr, value, env):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise _KqRuntimeError(f"cannot negate {_jq_type(v)}")
            yield -v
    elif isinstance(node, If):
        for c in _eval(node.cond, value, env):
            if _truthy(c):
                yield from _eval(node.then, value, env)
            elif node.orelse is not None:
                yield from _eval(node.orelse, value, env)
            else:
                yield value
    elif isinstance(node, ArrayCons):
        if node.expr is None:
            yield []
        else:
            yield list(_eval(node.expr, value, env))
    elif isinstance(node, ObjectCons):
        yield from _eval_object(node.entries, 0, value, {}, env)
    elif isinstance(node, Optional_):
        # jq defines `e?` as `try e`: stream outputs until the error,
        # then swallow it (not discard-the-whole-prefix)
        it = _eval(node.expr, value, env)
        while True:
            try:
                out = next(it)
            except StopIteration:
                return
            except _KqRuntimeError:
                return
            yield out
    elif isinstance(node, Func):
        yield from _eval_func(node, value, env)
    elif isinstance(node, Var):
        try:
            yield env[node.name]
        except KeyError:
            raise _KqRuntimeError(f"${node.name} is not defined")
    elif isinstance(node, As):
        for bound in _eval(node.source, value, env):
            yield from _eval(node.body, value, {**env, node.var: bound})
    elif isinstance(node, Reduce):
        for acc0 in _eval(node.init, value, env):
            acc = acc0
            for x in _eval(node.source, value, env):
                acc = _fold_bind_step(node.update, acc, node.patterns, x, env)
            yield acc
    elif isinstance(node, Foreach):
        pats = node.patterns
        for acc0 in _eval(node.init, value, env):
            acc = acc0
            for x in _eval(node.source, value, env):
                if len(pats) == 1:
                    e2 = dict(env)
                    _bind_pattern(pats[0], x, e2)
                    acc = _fold_step(node.update, acc, e2)
                    if node.extract is None:
                        yield acc
                    else:
                        yield from _eval(node.extract, acc, e2)
                else:
                    acc, outs = _foreach_alt_step(node, acc, x, env)
                    yield from outs
    elif isinstance(node, Def):
        env2 = dict(env)
        env2[("fn", node.name, len(node.params))] = (node.params, node.body, env2)
        yield from _eval(node.rest, value, env2)
    elif isinstance(node, Call):
        yield from _eval_call(node, value, env)
    elif isinstance(node, TryCatch):
        it = _eval(node.body, value, env)
        while True:
            try:
                out = next(it)
            except StopIteration:
                return
            except _KqRuntimeError as exc:
                if node.handler is not None:
                    yield from _eval(node.handler, exc.value, env)
                return
            yield out
    elif isinstance(node, Label):
        it = _eval(node.body, value, env)
        while True:
            try:
                out = next(it)
            except StopIteration:
                return
            except _KqBreak as brk:
                if brk.name != node.name:
                    raise
                return
            yield out
    elif isinstance(node, Break):
        raise _KqBreak(node.name)
    elif isinstance(node, Format):
        yield _apply_format(node.name, value)
    elif isinstance(node, StrInterp):

        def build(i: int, acc: str):
            if i == len(node.parts):
                yield acc
                return
            part = node.parts[i]
            if isinstance(part, str):
                yield from build(i + 1, acc + part)
                return
            for out in _eval(part, value, env):
                yield from build(
                    i + 1,
                    acc + (out if isinstance(out, str) else _apply_format("text", out)),
                )

        yield from build(0, "")
    elif isinstance(node, Assign):
        pths = list(_collect_ast_paths(node.target, value, env))
        if node.op == "=":
            # rhs is evaluated against the ORIGINAL input; one output
            # per rhs output, all paths set to the same value (jq)
            for v in _eval(node.expr, value, env):
                out = value
                for pth in pths:
                    out = _setpath(out, pth, v)
                yield out
        elif node.op == "|=":
            # per-path update with the FIRST output of the filter on
            # the current value; an empty update deletes the path.
            # Deletions are batched (index-safe) — GOJQ semantics, the
            # engine the reference embeds (query.go:33); jq 1.7 itself
            # shifts indices mid-reduce, a documented jq bug gojq fixed.
            out = value
            dels = []
            for pth in pths:
                cur = _getpath(out, pth)
                nv = next(iter(_eval(node.expr, cur, env)), _MISSING_V)
                if nv is _MISSING_V:
                    dels.append(pth)
                else:
                    out = _setpath(out, pth, nv)
            if dels:
                out = _delpaths(out, dels)
            yield out
        else:
            arith_op = node.op[:-1]  # "+", "-", "*", "/", "%", "//"
            for v in _eval(node.expr, value, env):
                out = value
                for pth in pths:
                    cur = _getpath(out, pth)
                    if arith_op == "//":
                        nv = cur if cur is not None and cur is not False else v
                    else:
                        nv = _arith(arith_op, cur, v)
                    out = _setpath(out, pth, nv)
                yield out
    elif isinstance(node, AsPattern):
        pats = node.patterns
        if len(pats) == 1:
            for bound in _eval(node.source, value, env):
                e2 = dict(env)
                _bind_pattern(pats[0], bound, e2)
                yield from _eval(node.body, value, e2)
        else:
            for bound in _eval(node.source, value, env):
                yield from _alt_bind_outputs(
                    pats, bound, env, lambda e2: _eval(node.body, value, e2)
                )
    else:  # pragma: no cover
        raise _KqRuntimeError(f"unknown node {node!r}")


def _eval_func_n(node: Func, value: Any, env: dict) -> Iterator[Any]:
    """Multi-arg builtins: limit/2, range/2-3, while/2, until/2, plus
    the regex family (test/split/splits with flags, sub/gsub with a
    filter replacement, capture)."""
    name, args = node.name, node.args
    if name in ("test", "capture", "match", "split", "splits") and len(args) == 2:
        if not isinstance(value, str):
            raise _KqRuntimeError(f"{name} on non-string")
        for pat in _eval(args[0], value, env):
            for fl in _eval(args[1], value, env):
                if fl is not None and not isinstance(fl, str):
                    raise _KqRuntimeError("regex flags must be a string")
                rx, g = _regex(pat, fl)
                if name == "test":
                    yield rx.search(value) is not None
                elif name == "split":
                    yield _regex_split(value, rx)
                else:
                    yield from _regex_stream(name, value, pat, fl)
        return
    if name == "setpath" and len(args) == 2:
        for pth in _eval(args[0], value, env):
            if not isinstance(pth, list):
                raise _KqRuntimeError("setpath path must be an array")
            for v in _eval(args[1], value, env):
                yield _setpath(value, pth, v)
        return
    if name in ("sub", "gsub"):
        for pat in _eval(args[0], value, env):
            flags_out = (
                [None]
                if len(args) < 3
                else list(_eval(args[2], value, env))
            )
            for fl in flags_out:
                if fl is not None and not isinstance(fl, str):
                    raise _KqRuntimeError("regex flags must be a string")
                yield from _sub_impl(
                    value,
                    pat,
                    fl,
                    lambda cap: _eval(args[1], cap, env),
                    name == "gsub",
                )
        return
    if name == "limit":
        for n in _eval(args[0], value, env):
            if isinstance(n, bool) or not isinstance(n, (int, float)):
                raise _KqRuntimeError("limit count must be a number")
            n = int(n)
            if n <= 0:
                continue
            emitted = 0
            for out in _eval(args[1], value, env):
                yield out
                emitted += 1
                if emitted >= n:
                    break
        return
    if name == "range":
        exprs = [list(_eval(a, value, env)) for a in args]
        import itertools

        for combo in itertools.product(*exprs):
            for v in combo:
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise _KqRuntimeError("range over non-number")
            start, stop = combo[0], combo[1]
            step = combo[2] if len(combo) > 2 else 1
            if step == 0:
                continue
            cur = start
            while (cur < stop) if step > 0 else (cur > stop):
                yield cur
                cur += step
        return
    if name in ("while", "until"):
        cond, update = args[0], args[1]

        def gen(x):
            # jq: def while(c; u): if c then ., (u | while(c; u))
            #     def until(c; u): if c then . else (u | until(c; u))
            for c in _eval(cond, x, env):
                if name == "while":
                    if _truthy(c):
                        yield x
                        for nx in _eval(update, x, env):
                            yield _Recur(nx)
                else:
                    if _truthy(c):
                        yield x
                    else:
                        for nx in _eval(update, x, env):
                            yield _Recur(nx)

        yield from _trampoline(gen, value)
        return
    raise _KqRuntimeError(f"unknown function {name}/{len(args)}")


class _Recur:
    """Trampoline marker: 'descend into this value' (loop builtins run
    on an explicit stack, not Python recursion — jq's TCO means
    while/until/recurse must handle unbounded iteration counts)."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


def _trampoline(gen, x0) -> Iterator[Any]:
    """Depth-first preorder over generators that yield values (passed
    through) and _Recur markers (descend): recursion order without
    Python stack frames."""
    stack = [gen(x0)]
    while stack:
        try:
            item = next(stack[-1])
        except StopIteration:
            stack.pop()
            continue
        if type(item) is _Recur:
            stack.append(gen(item.value))
        else:
            yield item


class _KqBreak(Exception):
    """Control-flow escape for label/break (never leaves Query.execute:
    an unmatched break is a compile error)."""

    def __init__(self, name: str):
        super().__init__(name)
        self.name = name


def _bind_pattern(pattern, value, env: dict) -> None:
    kind = pattern[0]
    if kind == "$":
        env[pattern[1]] = value
        return
    if kind == "arr":
        if value is None:
            value = []
        if not isinstance(value, list):
            raise _KqRuntimeError(
                f"cannot destructure {_jq_type(value)} as an array"
            )
        for i, sub in enumerate(pattern[1]):
            _bind_pattern(sub, value[i] if i < len(value) else None, env)
        return
    if value is None:
        value = {}
    if not isinstance(value, dict):
        raise _KqRuntimeError(
            f"cannot destructure {_jq_type(value)} as an object"
        )
    for key, sub in pattern[1]:
        _bind_pattern(sub, value.get(key), env)


def _csv_cell(v: Any, quote: str) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return _num_str(v)
    if isinstance(v, str):
        return quote + v.replace(quote, quote + quote) + quote
    raise _KqRuntimeError(f"{_jq_type(v)} is not valid in a csv row")


def _num_str(v: Any) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return str(v)


def _apply_format(name: str, value: Any) -> Any:
    import base64 as _b64
    import json as _json
    import urllib.parse as _url

    if name == "text":
        return value if isinstance(value, str) else _json.dumps(value)
    s = value if isinstance(value, str) else _json.dumps(value)
    if name == "json":
        return _json.dumps(value, separators=(",", ":"))
    if name == "base64":
        return _b64.b64encode(s.encode()).decode()
    if name == "base64d":
        try:
            return _b64.b64decode(s.encode() + b"==").decode()
        except Exception:
            raise _KqRuntimeError(f"{s!r} is not valid base64")
    if name == "uri":
        return _url.quote(s, safe="")
    if name == "html":
        return (
            s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
            .replace("'", "&#39;").replace('"', "&quot;")
        )
    if name == "sh":
        if isinstance(value, list):
            return " ".join(_sh_word(x) for x in value)
        return "'" + s.replace("'", "'\\''") + "'"
    if name == "csv":
        if not isinstance(value, list):
            raise _KqRuntimeError("@csv needs an array input")
        return ",".join(_csv_cell(v, '"') for v in value)
    if name == "tsv":
        if not isinstance(value, list):
            raise _KqRuntimeError("@tsv needs an array input")
        out = []
        for v in value:
            if isinstance(v, str):
                out.append(
                    v.replace("\\", "\\\\").replace("\t", "\\t").replace("\n", "\\n")
                )
            elif v is None:
                out.append("")
            elif isinstance(v, bool):
                out.append("true" if v else "false")
            elif isinstance(v, (int, float)):
                out.append(_num_str(v))
            else:
                raise _KqRuntimeError(
                    f"{_jq_type(v)} is not valid in a tsv row"
                )
        return "\t".join(out)
    raise _KqRuntimeError(f"unknown format @{name}")


def _sh_word(v: Any) -> str:
    """One @sh shell word: strings quoted, scalars via tostring, and
    composites are an error (jq parity)."""
    if isinstance(v, str):
        return "'" + v.replace("'", "'\\''") + "'"
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return _num_str(v)
    raise _KqRuntimeError(f"{_jq_type(v)} can not be escaped for shell")


_FORMATS = {"text", "json", "base64", "base64d", "uri", "html", "sh", "csv", "tsv"}


def _to_entries(value: Any) -> list:
    if not isinstance(value, dict):
        raise _KqRuntimeError("to_entries over non-object")
    return [{"key": k, "value": v} for k, v in value.items()]


def _from_entries(value: Any) -> dict:
    if not isinstance(value, list):
        raise _KqRuntimeError("from_entries over non-array")
    out: dict = {}
    for e in value:
        if not isinstance(e, dict):
            raise _KqRuntimeError("from_entries element is not an object")
        # jq: key = .key // .k // .name // .Name (null/false FALL
        # THROUGH, unlike presence checks); value uses has()
        k = None
        for kk in ("key", "k", "name", "Name"):
            cand = e.get(kk)
            if cand is not None and cand is not False:
                k = cand
                break
        v = None
        for vk in ("value", "v"):
            if vk in e:
                v = e[vk]
                break
        if k is None:
            raise _KqRuntimeError("from_entries element has no key")
        if isinstance(k, bool):
            k = "true" if k else "false"
        elif isinstance(k, (int, float)):
            k = _num_str(k)
        elif not isinstance(k, str):
            raise _KqRuntimeError("from_entries key is not a scalar")
        out[k] = v
    return out


def _all_paths_vals(value: Any, prefix: tuple = ()):
    """Yield (path, sub-value) pairs, jq paths order (document order,
    parents before children; the root [] excluded)."""
    if isinstance(value, dict):
        for k, v in value.items():
            yield list(prefix) + [k], v
            yield from _all_paths_vals(v, prefix + (k,))
    elif isinstance(value, list):
        for i, v in enumerate(value):
            yield list(prefix) + [i], v
            yield from _all_paths_vals(v, prefix + (i,))


def _all_paths(value: Any):
    for p, _v in _all_paths_vals(value):
        yield p


def _getpath(value: Any, path: list) -> Any:
    cur = value
    for seg in path:
        if cur is None:
            return None
        if isinstance(cur, dict):
            if not isinstance(seg, str):
                raise _KqRuntimeError("cannot index object with number")
            cur = cur.get(seg)
        elif isinstance(cur, list):
            if isinstance(seg, bool) or not isinstance(seg, (int, float)):
                raise _KqRuntimeError("cannot index array with string")
            i = int(seg)
            n = len(cur)
            if i < 0:
                i += n
            cur = cur[i] if 0 <= i < n else None
        else:
            raise _KqRuntimeError(
                f"cannot index {_jq_type(cur)} with path segment"
            )
    return cur


def _flatten(value: Any, depth: float) -> list:
    if not isinstance(value, list):
        raise _KqRuntimeError("flatten over non-array")
    out: list = []
    for v in value:
        if isinstance(v, list) and depth > 0:
            out.extend(_flatten(v, depth - 1))
        else:
            out.append(v)
    return out


def _collect_ast_paths(node: Any, value: Any, env: Optional[dict] = None):
    """Paths addressed by a path expression (the subset del() and the
    assignment family use: ``.a.b``, ``.a[0]``, ``.a[]``, commas and
    pipes of those, ``select(cond)`` stages, and the ``?`` suppressor
    — ``.a?``/``(expr)?`` drops error branches instead of aborting, so
    ``.a? = x`` on a scalar input yields the input unchanged like jq).
    Raises for non-path expressions like jq's "Invalid path
    expression"; slices are not in the grammar (see the module
    docstring's lhs-subset note)."""
    env = env or {}
    if isinstance(node, Comma):
        for part in node.parts:
            yield from _collect_ast_paths(part, value, env)
        return
    if isinstance(node, Pipe):
        def rec(stages, prefix, val):
            if not stages:
                yield list(prefix)
                return
            for sub in _collect_ast_paths(stages[0], val, env):
                yield from rec(
                    stages[1:], list(prefix) + sub, _getpath(val, sub)
                )

        yield from rec(list(node.stages), [], value)
        return
    if isinstance(node, Optional_):
        # `(expr)?` — suppress path-collection errors: the erroring
        # branches contribute no paths (jq: `paths(.a?)` on 5 is empty)
        try:
            yield from list(_collect_ast_paths(node.expr, value, env))
        except _KqRuntimeError:
            return
        return
    if isinstance(node, Select):
        # `select(cond)` in path position addresses the identity path
        # for every truthy cond output — the lhs shape
        # `(.a | select(. == null)) = x` uses
        for out in _eval(node.cond, value, env):
            if out is not None and out is not False:
                yield []
        return
    if not isinstance(node, Path):
        raise _KqRuntimeError("invalid path expression")
    optional = node.optional
    prefixes: List[tuple] = [()]
    cur_vals: List[Any] = [value]
    for op in node.ops:
        nxt_p: List[tuple] = []
        nxt_v: List[Any] = []
        for pref, cur in zip(prefixes, cur_vals):
            if isinstance(op, Field):
                if cur is not None and not isinstance(cur, dict):
                    if optional:
                        continue  # `?`: drop the erroring branch
                    # keep the path: _setpath raises the jq error
                nxt_p.append(pref + (op.name,))
                nxt_v.append(cur.get(op.name) if isinstance(cur, dict) else None)
            elif isinstance(op, Index):
                if cur is not None and not isinstance(cur, list) and optional:
                    continue
                nxt_p.append(pref + (op.i,))
                nxt_v.append(
                    cur[op.i]
                    if isinstance(cur, list) and -len(cur) <= op.i < len(cur)
                    else None
                )
            elif isinstance(op, Iterate):
                if isinstance(cur, dict):
                    for k, v in cur.items():
                        nxt_p.append(pref + (k,))
                        nxt_v.append(v)
                elif isinstance(cur, list):
                    for i, v in enumerate(cur):
                        nxt_p.append(pref + (i,))
                        nxt_v.append(v)
                elif cur is None:
                    continue
                elif optional:
                    continue  # `.a[]?` over a non-iterable: no paths
                else:
                    raise _KqRuntimeError(
                        f"cannot iterate over {_jq_type(cur)}"
                    )
            else:
                raise _KqRuntimeError("invalid path expression")
        prefixes, cur_vals = nxt_p, nxt_v
    for pref in prefixes:
        yield list(pref)


def _kq_deep_copy(x: Any) -> Any:
    t = type(x)
    if t is dict:
        return {k: _kq_deep_copy(v) for k, v in x.items()}
    if t is list:
        return [_kq_deep_copy(v) for v in x]
    return x


def _setpath(value: Any, path: list, newval: Any) -> Any:
    """jq setpath: copy-on-write along the path, creating objects/array
    slots as needed (null-padded like jq)."""
    if not path:
        return newval
    seg = _norm_seg(path[0])
    if isinstance(seg, str):
        if value is None:
            base: Any = {}
        elif isinstance(value, dict):
            base = dict(value)
        else:
            raise _KqRuntimeError(
                f"cannot set field of {_jq_type(value)}"
            )
        base[seg] = _setpath(base.get(seg), path[1:], newval)
        return base
    i = seg
    if value is None:
        lst: list = []
    elif isinstance(value, list):
        lst = list(value)
    else:
        raise _KqRuntimeError(f"cannot index {_jq_type(value)} with number")
    if i < 0:
        i += len(lst)
        if i < 0:
            raise _KqRuntimeError("out of bounds negative array index")
    while len(lst) <= i:
        lst.append(None)
    lst[i] = _setpath(lst[i], path[1:], newval)
    return lst


def _norm_seg(seg: Any) -> Any:
    """Validate/normalize a path segment: strings stay, numbers
    truncate to int (jq numbers are doubles), anything else —
    including bools — is an invalid path segment."""
    if isinstance(seg, str):
        return seg
    if not isinstance(seg, bool) and isinstance(seg, (int, float)):
        return int(seg)
    raise _KqRuntimeError(f"invalid path segment {_jq_type(seg)}")


def _p_key(path: list):
    # total-order sortable key across str/int segments
    return tuple(
        (0, seg, "") if isinstance(seg, int) else (1, 0, seg) for seg in path
    )


def _delpaths(value: Any, paths: List[list]) -> Any:
    """Delete paths (longest/rightmost first so indices stay valid)."""
    norm = [[_norm_seg(seg) for seg in path] for path in paths]
    out = _kq_deep_copy(value)
    for path in sorted(norm, key=lambda p: (len(p), _p_key(p)), reverse=True):
        cur = out
        ok = True
        for seg in path[:-1]:
            if isinstance(cur, dict) and isinstance(seg, str) and seg in cur:
                cur = cur[seg]
            elif isinstance(cur, list) and isinstance(seg, int) and 0 <= seg < len(cur):
                cur = cur[seg]
            else:
                ok = False
                break
        if not ok or not path:
            continue
        last = path[-1]
        if isinstance(cur, dict) and isinstance(last, str):
            cur.pop(last, None)
        elif isinstance(cur, list) and isinstance(last, int):
            if -len(cur) <= last < len(cur):
                del cur[last]
    return out


_RE_FLAG_MAP = {"i": re.IGNORECASE, "x": re.VERBOSE, "s": re.DOTALL, "m": re.MULTILINE}

#: map_values' "empty output deletes" sentinel
_MISSING_V = object()


def _indices(value: Any, needle: Any) -> list:
    """jq indices: substring starts (string), element or subsequence
    starts (array)."""
    out: list = []
    if isinstance(value, str):
        if not isinstance(needle, str) or not needle:
            raise _KqRuntimeError("indices needle must be a non-empty string")
        i = value.find(needle)
        while i != -1:
            out.append(i)
            i = value.find(needle, i + 1)
        return out
    if isinstance(value, list):
        if isinstance(needle, list):
            if not needle:
                return []
            n = len(needle)
            for i in range(len(value) - n + 1):
                if all(_json_equal(value[i + j], needle[j]) for j in range(n)):
                    out.append(i)
            return out
        for i, v in enumerate(value):
            if _json_equal(v, needle):
                out.append(i)
        return out
    if value is None:
        return []
    raise _KqRuntimeError(f"cannot get indices of {_jq_type(value)}")


def _regex(pattern: Any, flags: Any):
    """Compile a jq regex + flag string; returns (compiled, global)."""
    if not isinstance(pattern, str):
        raise _KqRuntimeError("regex must be a string")
    g = False
    f = 0
    for ch in flags or "":
        if ch == "g":
            g = True
        elif ch in _RE_FLAG_MAP:
            f |= _RE_FLAG_MAP[ch]
        elif ch == "n":
            pass  # ignore-empty-matches: harmless to ignore
        else:
            raise _KqRuntimeError(f"unsupported regex flag {ch!r}")
    # jq speaks Oniguruma: named groups are (?<name>...), which Python
    # spells (?P<name>...).  Leave lookbehinds (?<=, (?<! alone.
    translated = re.sub(r"\(\?<(?![=!])", "(?P<", pattern)
    try:
        return re.compile(translated, f), g
    except re.error as exc:
        raise _KqRuntimeError(f"bad regex: {exc}") from exc


def _capture_obj(m: "re.Match") -> dict:
    out = {}
    for name, idx in (m.re.groupindex or {}).items():
        out[name] = m.group(idx)
    return out


def _sub_impl(value, pat, flags, repl_eval, global_) -> Iterator[str]:
    """sub/gsub: the replacement is a FILTER evaluated with the capture
    object as input (jq lets it interpolate named groups).  Iterative —
    multi-output replacements fan out via itertools.product like jq's
    stream semantics, without one generator frame per match."""
    import itertools

    if not isinstance(value, str):
        raise _KqRuntimeError("sub on non-string")
    rx, g2 = _regex(pat, flags)
    global_ = global_ or g2
    matches = []
    pos = 0
    while pos <= len(value):
        m = rx.search(value, pos)
        if m is None:
            break
        matches.append(m)
        if not global_:
            break
        pos = m.end() if m.end() > m.start() else m.start() + 1
    if not matches:
        yield value
        return
    option_sets = []
    for m in matches:
        opts = list(repl_eval(_capture_obj(m)))
        if not all(isinstance(o, str) for o in opts):
            raise _KqRuntimeError("sub replacement must be a string")
        if not opts:
            return  # empty replacement stream -> no outputs (jq)
        option_sets.append(opts)
    for combo in itertools.product(*option_sets):
        out = []
        last = 0
        for m, rep in zip(matches, combo):
            out.append(value[last:m.start()])
            out.append(rep)
            last = max(m.end(), last)
        out.append(value[last:])
        yield "".join(out)


def _regex_split(value: str, rx) -> list:
    """Split on regex matches WITHOUT interleaving capture groups
    (Python re.split would; jq never does)."""
    out = []
    last = 0
    pos = 0
    while pos <= len(value):
        m = rx.search(value, pos)
        if m is None:
            break
        out.append(value[last:m.start()])
        last = m.end()
        pos = m.end() if m.end() > m.start() else m.start() + 1
    out.append(value[last:])
    return out


def _regex_stream(name: str, value: str, pat: Any, fl: Any):
    """Shared machinery for capture/match (per-match objects, honoring
    the g flag) and splits (group-free splitting) — both arities route
    here so their semantics cannot drift apart."""
    rx, g = _regex(pat, fl)
    if name == "splits":
        yield from _regex_split(value, rx)
        return
    shape = _capture_obj if name == "capture" else _match_obj
    pos = 0
    while pos <= len(value):
        m = rx.search(value, pos)
        if m is None:
            break
        yield shape(m)
        if not g:
            break
        pos = m.end() if m.end() > m.start() else m.start() + 1


def _match_obj(m: "re.Match") -> dict:
    names = {idx: name for name, idx in (m.re.groupindex or {}).items()}
    captures = []
    for i in range(1, (m.re.groups or 0) + 1):
        g = m.group(i)
        captures.append(
            {
                "offset": m.start(i) if g is not None else -1,
                "length": len(g) if g is not None else 0,
                "string": g,
                "name": names.get(i),
            }
        )
    return {
        "offset": m.start(),
        "length": len(m.group(0)),
        "string": m.group(0),
        "captures": captures,
    }


def _pattern_vars(pattern) -> List[str]:
    kind = pattern[0]
    if kind == "$":
        return [pattern[1]]
    if kind == "arr":
        return [n for sub in pattern[1] for n in _pattern_vars(sub)]
    return [n for _, sub in pattern[1] for n in _pattern_vars(sub)]


def _alt_bind_outputs(
    patterns: Tuple[Any, ...], bound: Any, env: dict, run
) -> Iterator[Any]:
    """The jq ``?//`` protocol, shared by as/reduce/foreach: try each
    alternative in order; a destructuring or evaluation error moves to
    the next (only the last alternative's errors propagate).  Every
    variable named in any alternative is in scope, null when the
    matching pattern does not bind it.  ``run(e2)`` returns the body's
    output iterator; evaluation stays lazy, and — like jq's
    backtracking — outputs already yielded before a mid-stream error
    stand while the next alternative re-runs the body from the start."""
    allvars = [n for p in patterns for n in _pattern_vars(p)]
    last = len(patterns) - 1
    for i, pat in enumerate(patterns):
        e2 = dict(env)
        for n in allvars:
            e2[n] = None
        try:
            _bind_pattern(pat, bound, e2)
        except _KqRuntimeError:
            if i == last:
                raise
            continue
        it = run(e2)
        erred = False
        while True:
            try:
                out = next(it)
            except StopIteration:
                break
            except _KqRuntimeError:
                if i == last:
                    raise
                erred = True
                break
            yield out
        if not erred:
            return


def _fold_bind_step(
    update: Any, acc: Any, patterns: Tuple[Any, ...], x: Any, env: dict
) -> Any:
    """One reduce step with destructuring: bind ``x`` via the first
    ``?//`` alternative whose destructuring AND update succeed (errors
    of the last alternative propagate)."""
    if len(patterns) == 1:
        e2 = dict(env)
        _bind_pattern(patterns[0], x, e2)
        return _fold_step(update, acc, e2)

    def run(e2):
        # generator so the update's error raises inside the retry
        # protocol's next(), not at run() call time
        yield _fold_step(update, acc, e2)

    out = acc
    for out in _alt_bind_outputs(patterns, x, env, run):
        pass
    return out


def _foreach_alt_step(node: "Foreach", acc: Any, x: Any, env: dict):
    """One foreach step under ``?//`` alternatives: returns the new
    accumulator and this step's outputs (one step's output set is
    collected so the accumulator can advance; the *source* stream
    stays lazy)."""
    box = {"acc": acc}

    def run(e2):
        new_acc = _fold_step(node.update, acc, e2)
        box["acc"] = new_acc
        if node.extract is None:
            yield new_acc
        else:
            yield from _eval(node.extract, new_acc, e2)

    outs = list(_alt_bind_outputs(node.patterns, x, env, run))
    return box["acc"], outs


def _fold_step(update: Any, acc: Any, env: dict) -> Any:
    """One reduce/foreach step: the accumulator becomes the LAST output
    of the update filter (jq folds this way; empty output -> null,
    jq 1.6 behavior)."""
    out = None
    for out in _eval(update, acc, env):
        pass
    return out


def _eval_call(node: Call, value: Any, env: dict) -> Iterator[Any]:
    fn = env.get(("fn", node.name, len(node.args)))
    if fn is None:
        raise _KqRuntimeError(f"{node.name}/{len(node.args)} is not defined")
    params, body, def_env = fn

    def bind(i: int, bound: dict) -> Iterator[Any]:
        if i == len(params):
            call_env = dict(def_env)
            # recursion: the function sees itself
            call_env[("fn", node.name, len(params))] = fn
            call_env.update(bound)
            yield from _eval(body, value, call_env)
            return
        p, arg = params[i], node.args[i]
        if p.startswith("$"):
            # value parameter: cartesian over the argument's outputs
            # (jq semantics), evaluated in the CALLER's environment
            for v in _eval(arg, value, env):
                bound[p[1:]] = v
                yield from bind(i + 1, bound)
            return
        # bare filter parameter: a 0-ary closure over the caller env
        bound[("fn", p, 0)] = ((), arg, env)
        yield from bind(i + 1, bound)

    yield from bind(0, {})


def _eval_object(entries, i, value, acc, env) -> Iterator[Any]:
    if i == len(entries):
        yield dict(acc)
        return
    key, val = entries[i]
    keys = [key] if isinstance(key, str) else list(_eval(key, value, env))
    for k in keys:
        if not isinstance(k, str):
            raise _KqRuntimeError("object key must be a string")
        for v in _eval(val, value, env):
            acc[k] = v
            yield from _eval_object(entries, i + 1, value, acc, env)


def _eval_func(node: Func, value: Any, env: dict) -> Iterator[Any]:
    name = node.name
    if len(node.args) >= 2:
        yield from _eval_func_n(node, value, env)
        return
    if name == "recurse":
        # jq: def recurse(f): ., (f | recurse(f));  `..` is recurse/0
        # with f = .[]? (children of arrays/objects, never an error)
        def gen(x):
            yield x
            if node.args:
                for nx in _eval(node.args[0], x, env):
                    yield _Recur(nx)
            elif isinstance(x, list):
                for nx in x:
                    yield _Recur(nx)
            elif isinstance(x, dict):
                for nx in x.values():
                    yield _Recur(nx)

        yield from _trampoline(gen, value)
        return
    if node.args:
        arg = node.args[0]
        if name == "has":
            for k in _eval(arg, value, env):
                if isinstance(value, dict) and isinstance(k, str):
                    yield k in value
                elif isinstance(value, list) and isinstance(k, int):
                    yield 0 <= k < len(value)
                else:
                    raise _KqRuntimeError(f"cannot check has() on {_jq_type(value)}")
        elif name == "map":
            if not isinstance(value, list):
                raise _KqRuntimeError("map over non-array")
            out = []
            for item in value:
                out.extend(_eval(arg, item, env))
            yield out
        elif name in ("any", "all"):
            if not isinstance(value, list):
                raise _KqRuntimeError(f"{name} over non-array")
            results = []
            for item in value:
                results.extend(_truthy(v) for v in _eval(arg, item, env))
            yield any(results) if name == "any" else all(results)
        elif name in ("test", "startswith", "endswith", "split"):
            if not isinstance(value, str):
                raise _KqRuntimeError(f"{name} on non-string")
            for pat in _eval(arg, value, env):
                if not isinstance(pat, str):
                    raise _KqRuntimeError(f"{name} pattern must be a string")
                if name == "test":
                    yield re.search(pat, value) is not None
                elif name == "startswith":
                    yield value.startswith(pat)
                elif name == "endswith":
                    yield value.endswith(pat)
                else:
                    yield value.split(pat)
        elif name == "contains":
            for b in _eval(arg, value, env):
                yield _contains(value, b)
        elif name == "join":
            if not isinstance(value, list):
                raise _KqRuntimeError("join over non-array")
            for sep in _eval(arg, value, env):
                if not isinstance(sep, str):
                    raise _KqRuntimeError("join separator must be a string")
                yield sep.join(
                    "" if x is None else (x if isinstance(x, str) else _tostring(x))
                    for x in value
                )
        elif name in ("sort_by", "min_by", "max_by"):
            if not isinstance(value, list):
                raise _KqRuntimeError(f"{name} over non-array")
            import functools

            def key_of(item):
                return list(_eval(arg, item, env))

            decorated = [(key_of(x), x) for x in value]
            cmp = functools.cmp_to_key(lambda p, q: _jq_cmp(p[0], q[0]))
            if name == "sort_by":
                yield [x for _, x in sorted(decorated, key=cmp)]
            elif not decorated:
                yield None
            elif name == "min_by":
                yield min(decorated, key=cmp)[1]
            else:
                yield max(decorated, key=cmp)[1]
        elif name == "range":
            for n in _eval(arg, value, env):
                if isinstance(n, bool) or not isinstance(n, (int, float)):
                    raise _KqRuntimeError("range over non-number")
                i = 0
                while i < n:
                    yield i
                    i += 1
        elif name == "error":
            for msg in _eval(arg, value, env):
                raise _KqRuntimeError(str(msg), msg, True)
        elif name == "with_entries":
            # to_entries | map(f) | from_entries
            entries = _to_entries(value)
            mapped = []
            for e in entries:
                mapped.extend(_eval(arg, e, env))
            yield _from_entries(mapped)
        elif name == "group_by":
            if not isinstance(value, list):
                raise _KqRuntimeError("group_by over non-array")
            import functools

            keyed = [(list(_eval(arg, v, env)), v) for v in value]
            keyed.sort(
                key=functools.cmp_to_key(lambda p, q: _jq_cmp(p[0], q[0]))
            )
            out = []
            for i, (k, v) in enumerate(keyed):
                if i and _json_equal(k, keyed[i - 1][0]):
                    out[-1].append(v)
                else:
                    out.append([v])
            yield out
        elif name == "unique_by":
            if not isinstance(value, list):
                raise _KqRuntimeError("unique_by over non-array")
            import functools

            keyed = [(list(_eval(arg, v, env)), v) for v in value]
            keyed.sort(
                key=functools.cmp_to_key(lambda p, q: _jq_cmp(p[0], q[0]))
            )
            out = []
            for i, (k, v) in enumerate(keyed):
                if not (i and _json_equal(k, keyed[i - 1][0])):
                    out.append(v)
            yield out
        elif name == "map_values":
            # .[] |= f : first output of f per value; empty deletes
            if isinstance(value, dict):
                out = {}
                for k, v in value.items():
                    res = next(iter(_eval(arg, v, env)), _MISSING_V)
                    if res is not _MISSING_V:
                        out[k] = res
                yield out
            elif isinstance(value, list):
                outl = []
                for v in value:
                    res = next(iter(_eval(arg, v, env)), _MISSING_V)
                    if res is not _MISSING_V:
                        outl.append(res)
                yield outl
            else:
                raise _KqRuntimeError("map_values over non-iterable")
        elif name in ("ltrimstr", "rtrimstr"):
            for pre in _eval(arg, value, env):
                if not isinstance(value, str) or not isinstance(pre, str):
                    yield value
                elif name == "ltrimstr":
                    yield value[len(pre):] if value.startswith(pre) else value
                else:
                    yield value[: -len(pre)] if pre and value.endswith(pre) else value
        elif name == "getpath":
            for pth in _eval(arg, value, env):
                if not isinstance(pth, list):
                    raise _KqRuntimeError("getpath arg must be an array")
                yield _getpath(value, pth)
        elif name == "flatten":
            for d in _eval(arg, value, env):
                if isinstance(d, bool) or not isinstance(d, (int, float)) or d < 0:
                    raise _KqRuntimeError("flatten depth must be a number >= 0")
                yield _flatten(value, d)
        elif name == "in":
            for xs in _eval(arg, value, env):
                if isinstance(xs, dict):
                    yield isinstance(value, str) and value in xs
                elif isinstance(xs, list):
                    yield (
                        not isinstance(value, bool)
                        and isinstance(value, (int, float))
                        and 0 <= int(value) < len(xs)
                    )
                else:
                    raise _KqRuntimeError(f"cannot check in() on {_jq_type(xs)}")
        elif name == "inside":
            for b in _eval(arg, value, env):
                yield _contains(b, value)
        elif name == "splits":
            if not isinstance(value, str):
                raise _KqRuntimeError("splits on non-string")
            for pat in _eval(arg, value, env):
                yield from _regex_stream("splits", value, pat, None)
        elif name in ("index", "rindex", "indices"):
            for needle in _eval(arg, value, env):
                idxs = _indices(value, needle)
                if name == "indices":
                    yield idxs
                elif name == "index":
                    yield idxs[0] if idxs else None
                else:
                    yield idxs[-1] if idxs else None
        elif name in ("capture", "match"):
            if not isinstance(value, str):
                raise _KqRuntimeError(f"{name} on non-string")
            for pat in _eval(arg, value, env):
                yield from _regex_stream(name, value, pat, None)
        elif name == "del":
            pths = list(_collect_ast_paths(arg, value, env))
            yield _delpaths(value, pths)
        elif name == "path":
            for pth in _collect_ast_paths(arg, value, env):
                yield pth
        elif name == "delpaths":
            for plist in _eval(arg, value, env):
                if not isinstance(plist, list) or not all(
                    isinstance(pp, list) for pp in plist
                ):
                    raise _KqRuntimeError("delpaths arg must be an array of paths")
                yield _delpaths(value, plist)
        elif name == "paths":
            for p, node_val in _all_paths_vals(value):
                if any(_truthy(x) for x in _eval(arg, node_val, env)):
                    yield p
        else:  # pragma: no cover
            raise _KqRuntimeError(f"unknown function {name}")
        return

    # zero-arg builtins
    if name == "error":
        # jq: the input becomes the error (try error catch . round-trip
        # preserves the VALUE, not a stringification)
        raise _KqRuntimeError(str(value), value, True)
    if name == "length":
        if value is None:
            yield 0
        elif isinstance(value, bool):
            raise _KqRuntimeError("boolean has no length")
        elif isinstance(value, (int, float)):
            yield abs(value)
        elif isinstance(value, (str, list, dict)):
            yield len(value)
        else:
            raise _KqRuntimeError("no length")
    elif name == "keys":
        if isinstance(value, dict):
            yield sorted(value)
        elif isinstance(value, list):
            yield list(range(len(value)))
        else:
            raise _KqRuntimeError("keys on non-object")
    elif name == "values":
        if isinstance(value, dict):
            yield [value[k] for k in sorted(value)]
        elif isinstance(value, list):
            yield list(value)
        else:
            raise _KqRuntimeError("values on non-object")
    elif name == "type":
        yield _jq_type(value)
    elif name == "tostring":
        yield value if isinstance(value, str) else _tostring(value)
    elif name == "tonumber":
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            yield value
        elif isinstance(value, str):
            try:
                yield float(value) if "." in value or "e" in value.lower() else int(value)
            except ValueError:
                raise _KqRuntimeError(f"cannot parse {value!r} as number") from None
        else:
            raise _KqRuntimeError(f"cannot parse {_jq_type(value)} as number")
    elif name == "not":
        yield not _truthy(value)
    elif name == "empty":
        return
    elif name == "input":
        it = env.get(_INPUTS_KEY)
        if it is None:
            raise _KqRuntimeError("No more inputs")
        try:
            yield next(it)
        except StopIteration:
            raise _KqRuntimeError("No more inputs") from None
    elif name == "inputs":
        it = env.get(_INPUTS_KEY)
        if it is not None:
            yield from it
    elif name == "to_entries":
        yield _to_entries(value)
    elif name == "from_entries":
        yield _from_entries(value)
    elif name == "paths":
        yield from _all_paths(value)
    elif name == "leaf_paths":
        for p, v in _all_paths_vals(value):
            if not isinstance(v, (dict, list)):
                yield p
    elif name == "flatten":
        yield _flatten(value, float("inf"))
    elif name == "explode":
        if not isinstance(value, str):
            raise _KqRuntimeError("explode on non-string")
        yield [ord(c) for c in value]
    elif name == "implode":
        if not isinstance(value, list):
            raise _KqRuntimeError("implode on non-array")
        try:
            yield "".join(chr(int(c)) for c in value)
        except (TypeError, ValueError) as exc:
            raise _KqRuntimeError(f"implode: {exc}") from exc
    elif name == "infinite":
        yield float("inf")
    elif name == "nan":
        yield float("nan")
    elif name == "isnan":
        yield isinstance(value, float) and math.isnan(value)
    elif name == "isinfinite":
        yield isinstance(value, float) and math.isinf(value)
    elif name == "isnormal":
        yield (
            isinstance(value, (int, float))
            and not isinstance(value, bool)
            and not math.isnan(value)
            and not math.isinf(value)
            and value != 0
        )
    elif name == "utf8bytelength":
        if not isinstance(value, str):
            raise _KqRuntimeError("utf8bytelength on non-string")
        yield len(value.encode("utf-8"))
    elif name in ("trim", "ltrim", "rtrim"):
        if not isinstance(value, str):
            raise _KqRuntimeError(f"{name} on non-string")
        yield (
            value.strip()
            if name == "trim"
            else value.lstrip() if name == "ltrim" else value.rstrip()
        )
    elif name == "now":
        import time as _time

        yield _time.time()
    elif name in ("todate", "todateiso8601"):
        import datetime as _dt

        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise _KqRuntimeError("todate requires a number")
        try:
            t = _dt.datetime.fromtimestamp(value, _dt.timezone.utc)
        except (ValueError, OverflowError, OSError) as exc:
            raise _KqRuntimeError(f"todate: {exc}") from exc
        yield t.strftime("%Y-%m-%dT%H:%M:%SZ")
    elif name in ("fromdate", "fromdateiso8601"):
        import datetime as _dt

        if not isinstance(value, str):
            raise _KqRuntimeError("fromdate requires a string")
        try:
            t = _dt.datetime.strptime(value, "%Y-%m-%dT%H:%M:%SZ")
        except ValueError:
            # tolerate fractional seconds (k8s timestamps carry them)
            try:
                t = _dt.datetime.strptime(value, "%Y-%m-%dT%H:%M:%S.%fZ")
            except ValueError as exc:
                raise _KqRuntimeError(f"fromdate: {exc}") from exc
        yield int(t.replace(tzinfo=_dt.timezone.utc).timestamp())
    elif name == "add":
        if not isinstance(value, list):
            raise _KqRuntimeError("add over non-array")
        acc: Any = None
        for item in value:
            acc = _arith("+", acc, item)
        yield acc
    elif name in ("any", "all"):
        if not isinstance(value, list):
            raise _KqRuntimeError(f"{name} over non-array")
        yield any(_truthy(v) for v in value) if name == "any" else all(
            _truthy(v) for v in value
        )
    elif name == "first":
        if not isinstance(value, list):
            raise _KqRuntimeError("first over non-array")
        if not value:
            raise _KqRuntimeError("first of empty array")
        yield value[0]
    elif name == "last":
        if not isinstance(value, list):
            raise _KqRuntimeError("last over non-array")
        if not value:
            raise _KqRuntimeError("last of empty array")
        yield value[-1]
    elif name in ("min", "max"):
        if not isinstance(value, list):
            raise _KqRuntimeError(f"{name} over non-array")
        if not value:
            yield None
        else:
            import functools

            key = functools.cmp_to_key(_jq_cmp)
            yield (min if name == "min" else max)(value, key=key)
    elif name in ("sort", "unique"):
        if not isinstance(value, list):
            raise _KqRuntimeError(f"{name} over non-array")
        import functools

        key = functools.cmp_to_key(_jq_cmp)
        out = sorted(value, key=key)
        if name == "unique":
            dedup: List[Any] = []
            for x in out:
                if not dedup or not _json_equal(dedup[-1], x):
                    dedup.append(x)
            out = dedup
        yield out
    elif name == "reverse":
        if isinstance(value, list):
            yield list(reversed(value))
        elif isinstance(value, str):
            yield value[::-1]
        else:
            raise _KqRuntimeError("reverse on non-array")
    elif name in ("floor", "ceil", "abs"):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise _KqRuntimeError(f"{name} on non-number")
        yield {
            "floor": math.floor,
            "ceil": math.ceil,
            "abs": abs,
        }[name](value)
    elif name in ("ascii_downcase", "ascii_upcase"):
        if not isinstance(value, str):
            raise _KqRuntimeError(f"{name} on non-string")
        yield value.lower() if name == "ascii_downcase" else value.upper()
    elif name == "tojson":
        import json as _json

        yield _json.dumps(value, separators=(",", ":"))
    elif name == "fromjson":
        import json as _json

        if not isinstance(value, str):
            raise _KqRuntimeError("fromjson on non-string")
        try:
            yield _json.loads(value)
        except ValueError:
            raise _KqRuntimeError("invalid json") from None
    else:  # pragma: no cover
        raise _KqRuntimeError(f"unknown function {name}")


def _tostring(v: Any) -> str:
    import json as _json

    return _json.dumps(v, separators=(",", ":"))


def _contains(a: Any, b: Any) -> bool:
    if isinstance(a, str) and isinstance(b, str):
        return b in a
    if isinstance(a, list) and isinstance(b, list):
        return all(any(_contains(x, y) for x in a) for y in b)
    if isinstance(a, dict) and isinstance(b, dict):
        return all(k in a and _contains(a[k], v) for k, v in b.items())
    return _json_equal(a, b)


def _eval_pipe(stages: Sequence[Any], i: int, value: Any, env: dict) -> Iterator[Any]:
    if i == len(stages):
        yield value
        return
    for out in _eval(stages[i], value, env):
        yield from _eval_pipe(stages, i + 1, out, env)


def _eval_path(ops: Sequence[Any], i: int, value: Any) -> Iterator[Any]:
    if i == len(ops):
        yield value
        return
    op = ops[i]
    if isinstance(op, Field):
        if value is None:
            yield from _eval_path(ops, i + 1, None)
        elif isinstance(value, dict):
            yield from _eval_path(ops, i + 1, value.get(op.name))
        else:
            raise _KqRuntimeError(
                f"cannot index {type(value).__name__} with {op.name!r}"
            )
    elif isinstance(op, Index):
        if value is None:
            yield from _eval_path(ops, i + 1, None)
        elif isinstance(value, list):
            n = len(value)
            j = op.i if op.i >= 0 else n + op.i
            yield from _eval_path(ops, i + 1, value[j] if 0 <= j < n else None)
        else:
            raise _KqRuntimeError(f"cannot index {type(value).__name__} with number")
    else:  # Iterate
        if isinstance(value, list):
            for item in value:
                yield from _eval_path(ops, i + 1, item)
        elif isinstance(value, dict):
            for item in value.values():
                yield from _eval_path(ops, i + 1, item)
        else:
            raise _KqRuntimeError(f"cannot iterate over {type(value).__name__}")


def _json_equal(a: Any, b: Any) -> bool:
    # Avoid bool == int coercion surprises (jq: true != 1).
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    return a == b


class Query:
    """Compiled kq query (reference: expression.Query, query.go:28-49)."""

    def __init__(self, src: str):
        self.src = src
        self._ast = _Parser(_tokenize(src), src).parse_query()

    def execute(
        self, value: Any, inputs: Optional[Sequence[Any]] = None
    ) -> Optional[List[Any]]:
        """Run the query; returns the non-null output stream.

        Mirrors reference query.go:48-68: errors swallow the whole result
        (returns None), null outputs are dropped.

        ``inputs`` is the rest-of-stream for ``input``/``inputs`` (jq
        reads them from the file stream after the current document; the
        stage engine evaluates one document, so the default stream is
        empty — ``input`` then errors like jq at end of input).
        """
        out: List[Any] = []
        env: dict = {}
        if inputs is not None:
            env[_INPUTS_KEY] = iter(inputs)
        try:
            for v in _eval(self._ast, value, env):
                if v is None:
                    continue
                out.append(v)
        except (_KqRuntimeError, RecursionError):
            return None
        return out


def compile_query(src: str) -> Query:
    return Query(src)
