"""Sprig-at-large template functions for the gotpl engine.

The reference template env pulls in the whole sprig library
(reference pkg/utils/gotpl/funcs.go:42-117 ``sprig.TxtFuncMap()``), so
wild user stages may call any of it.  This module implements the sprig
v3 surface stages realistically use — strings, math, lists, dicts,
encodings, regex, dates, type/kind introspection, paths, semver —
with sprig's exact argument orders (collection/subject LAST, so
pipelines read naturally: ``{{ .v | b64enc }}``,
``{{ trimPrefix "p-" .name }}``).

Known divergences (documented, small): ``must*`` variants alias their
plain forms (the engine already surfaces errors), the crypto subset is
the checksum trio, and network/OS escape hatches (``getHostByName``)
return zero values instead of doing I/O.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import json
import math
import os
import posixpath
import random
import re
import uuid
from typing import Any, Callable, Dict, List

import yaml

#: randomness seam for the rand*/shuffle template funcs: an explicit
#: instance (never the module-global ``random`` state) so seeded runs
#: — chaos plans, the DST harness — fully determine
#: template randomness.  Default is an unseeded instance, matching
#: sprig's process-global behavior for ordinary use.
_RNG = random.Random()


def set_default_rng(rng: random.Random) -> "random.Random":
    """Seed the template-function randomness (one rng per process; the
    DST harness calls this per simulation run).  Returns the previous
    rng so a scoped caller can restore it afterwards."""
    global _RNG
    prev, _RNG = _RNG, rng
    return prev


# ---------------------------------------------------------------- helpers


def _to_str(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    return str(v)


def _to_int(v: Any) -> int:
    if v is None or v == "":
        return 0
    if isinstance(v, bool):
        return int(v)
    try:
        return int(v)
    except (TypeError, ValueError):
        try:
            return int(float(v))
        except (TypeError, ValueError):
            return 0


def _to_float(v: Any) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return 0.0


def _is_empty(v: Any) -> bool:
    if v is None or v is False:
        return True
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return v == 0
    if isinstance(v, (str, list, dict, tuple)):
        return len(v) == 0
    return False


_GO_LAYOUT = [
    # longest tokens first: Go reference time -> strftime
    ("2006", "%Y"), ("01", "%m"), ("02", "%d"), ("15", "%H"),
    ("04", "%M"), ("05", "%S"), ("Jan", "%b"), ("January", "%B"),
    ("Mon", "%a"), ("Monday", "%A"), ("Z07:00", "%:z"), ("-07:00", "%:z"),
    ("Z0700", "%z"), ("-0700", "%z"), ("PM", "%p"), ("pm", "%p"),
    ("03", "%I"), ("06", "%y"),
]


def _go_layout_to_strftime(layout: str) -> str:
    out = layout
    for go, st in sorted(_GO_LAYOUT, key=lambda p: -len(p[0])):
        out = out.replace(go, st)
    return out


def _as_datetime(t: Any) -> datetime.datetime:
    if isinstance(t, datetime.datetime):
        return t
    if isinstance(t, (int, float)) and not isinstance(t, bool):
        return datetime.datetime.fromtimestamp(t, datetime.timezone.utc)
    if isinstance(t, str):
        s = t.replace("Z", "+00:00")
        try:
            return datetime.datetime.fromisoformat(s)
        except ValueError:
            pass
        raise ValueError(f"cannot parse time {t!r}")
    raise ValueError(f"cannot interpret {type(t).__name__} as a time")


def _fmt_date(layout: str, t: Any) -> str:
    st = _go_layout_to_strftime(layout)
    dt = _as_datetime(t)
    out = dt.strftime(st.replace("%:z", "%z"))
    if "%:z" in st:  # Go's Z07:00 / colon zone form
        z = dt.strftime("%z") or "+0000"
        colon = f"{z[:3]}:{z[3:]}"
        out = dt.strftime(st.replace("%:z", "\x00")).replace(
            "\x00", "Z" if z in ("+0000", "") else colon
        )
    return out


_SEMVER_RE = re.compile(
    r"^v?(\d+)\.(\d+)\.(\d+)(?:-([0-9A-Za-z.-]+))?(?:\+[0-9A-Za-z.-]+)?$"
)


def _semver_tuple(v: str):
    m = _SEMVER_RE.match(v.strip())
    if not m:
        raise ValueError(f"invalid semver {v!r}")
    return (int(m.group(1)), int(m.group(2)), int(m.group(3)), m.group(4))


def _semver_cmp(a: str, b: str) -> int:
    ta, tb = _semver_tuple(a), _semver_tuple(b)
    if ta[:3] != tb[:3]:
        return -1 if ta[:3] < tb[:3] else 1
    # a pre-release sorts before the release
    pa, pb = ta[3], tb[3]
    if pa == pb:
        return 0
    if pa is None:
        return 1
    if pb is None:
        return -1
    return -1 if pa < pb else 1


def _semver_compare(constraint: str, version: str) -> bool:
    constraint = constraint.strip()
    for part in constraint.split(","):
        part = part.strip()
        if not part:
            continue
        if part in ("*", "x", "X"):
            _semver_tuple(version)  # still validates the version
            continue
        m = re.match(r"^(>=|<=|!=|>|<|=|\^|~)?\s*(.+)$", part)
        op, ref = m.group(1) or "=", m.group(2)
        # wildcard ranges: 1.x / 1.2.x act like ~ on the fixed prefix
        wild = re.fullmatch(r"v?(\d+)(?:\.(\d+))?\.[xX*]", ref)
        if wild:
            vt = _semver_tuple(version)
            if int(wild.group(1)) != vt[0]:
                return False
            if wild.group(2) is not None and int(wild.group(2)) != vt[1]:
                return False
            continue
        c = _semver_cmp(version, ref)  # invalid syntax raises (sprig
        # surfaces constraint errors rather than silently failing)
        if op == "!=":
            if c == 0:
                return False
            continue
        if op == "=" and c != 0:
            return False
        if op == ">" and c <= 0:
            return False
        if op == "<" and c >= 0:
            return False
        if op == ">=" and c < 0:
            return False
        if op == "<=" and c > 0:
            return False
        if op == "^":  # same major, >= ref
            if c < 0 or _semver_tuple(version)[0] != _semver_tuple(ref)[0]:
                return False
        if op == "~":  # same major.minor, >= ref
            if c < 0 or _semver_tuple(version)[:2] != _semver_tuple(ref)[:2]:
                return False
    return True


def _kind_of(v: Any) -> str:
    if v is None:
        return "invalid"
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, float):
        return "float64"
    if isinstance(v, str):
        return "string"
    if isinstance(v, (list, tuple)):
        return "slice"
    if isinstance(v, dict):
        return "map"
    return type(v).__name__


def _deep_merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            _deep_merge(dst[k], v)
        elif k not in dst:  # sprig merge: dst wins on conflicts
            dst[k] = v
    return dst


def _words(s: str) -> List[str]:
    s = re.sub(r"([a-z0-9])([A-Z])", r"\1 \2", s)
    return [w for w in re.split(r"[^A-Za-z0-9]+", s) if w]


def _regex_split(pattern: str, s: str, n: int = -1) -> List[str]:
    parts = re.split(pattern, s)
    if n >= 0:
        # Go's Split(n): at most n substrings (remainder unsplit)
        out = []
        rest = s
        for _ in range(n - 1):
            m = re.search(pattern, rest)
            if not m:
                break
            out.append(rest[: m.start()])
            rest = rest[m.end() :]
        out.append(rest)
        return out
    return parts


# ----------------------------------------------------------------- table


def sprig_funcs() -> Dict[str, Callable]:
    """The function table, merged under the engine's own builtins."""
    funcs: Dict[str, Callable] = {
        # strings -------------------------------------------------------
        "upper": lambda s: _to_str(s).upper(),
        "lower": lambda s: _to_str(s).lower(),
        "title": lambda s: _to_str(s).title(),
        "untitle": lambda s: _to_str(s)[:1].lower() + _to_str(s)[1:],
        "trim": lambda s: _to_str(s).strip(),
        "trimAll": lambda cut, s: _to_str(s).strip(cut),
        "trimPrefix": lambda p, s: _to_str(s).removeprefix(p),
        "trimSuffix": lambda p, s: _to_str(s).removesuffix(p),
        "repeat": lambda n, s: _to_str(s) * _to_int(n),
        "substr": lambda a, b, s: _to_str(s)[
            _to_int(a) : (len(_to_str(s)) if _to_int(b) < 0 else _to_int(b))
        ],
        "trunc": lambda n, s: (
            _to_str(s)[: _to_int(n)]
            if _to_int(n) >= 0
            else _to_str(s)[_to_int(n) :]
        ),
        "abbrev": lambda n, s: (
            _to_str(s)
            if len(_to_str(s)) <= _to_int(n)
            else _to_str(s)[: max(_to_int(n) - 3, 0)] + "..."
        ),
        "initials": lambda s: "".join(w[0] for w in _to_str(s).split()),
        "contains": lambda sub, s: sub in _to_str(s),
        "hasPrefix": lambda p, s: _to_str(s).startswith(p),
        "hasSuffix": lambda p, s: _to_str(s).endswith(p),
        "replace": lambda old, new, s: _to_str(s).replace(old, new),
        "snakecase": lambda s: "_".join(w.lower() for w in _words(_to_str(s))),
        "kebabcase": lambda s: "-".join(w.lower() for w in _words(_to_str(s))),
        "camelcase": lambda s: "".join(
            w.capitalize() for w in _words(_to_str(s))
        ),
        "nospace": lambda s: re.sub(r"\s", "", _to_str(s)),
        "swapcase": lambda s: _to_str(s).swapcase(),
        "shuffle": lambda s: "".join(
            _RNG.sample(_to_str(s), len(_to_str(s)))
        ),
        "wrap": lambda n, s: "\n".join(
            _to_str(s)[i : i + _to_int(n)]
            for i in range(0, len(_to_str(s)), max(_to_int(n), 1))
        ),
        "cat": lambda *a: " ".join(_to_str(x) for x in a),
        "indent": lambda n, s: "\n".join(
            " " * _to_int(n) + line for line in _to_str(s).split("\n")
        ),
        "nindent": lambda n, s: "\n" + "\n".join(
            " " * _to_int(n) + line for line in _to_str(s).split("\n")
        ),
        "squote": lambda *a: " ".join(f"'{_to_str(x)}'" for x in a),
        "quote": lambda *a: " ".join(json.dumps(_to_str(x)) for x in a),
        "splitList": lambda sep, s: _to_str(s).split(sep),
        "split": lambda sep, s: {
            f"_{i}": part for i, part in enumerate(_to_str(s).split(sep))
        },
        "splitn": lambda sep, n, s: {
            f"_{i}": part
            for i, part in enumerate(_to_str(s).split(sep, _to_int(n) - 1))
        },
        "join": lambda sep, l: sep.join(
            _to_str(x) for x in (l if isinstance(l, (list, tuple)) else [l])
        ),
        "sortAlpha": lambda l: sorted(_to_str(x) for x in l),
        "toString": _to_str,
        "toStrings": lambda l: [_to_str(x) for x in l],
        "randAlphaNum": lambda n: "".join(
            _RNG.choices(
                "0123456789abcdefghijklmnopqrstuvwxyz"
                "ABCDEFGHIJKLMNOPQRSTUVWXYZ",
                k=_to_int(n),
            )
        ),
        "randAlpha": lambda n: "".join(
            _RNG.choices(
                "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ",
                k=_to_int(n),
            )
        ),
        "randNumeric": lambda n: "".join(
            _RNG.choices("0123456789", k=_to_int(n))
        ),
        # math ----------------------------------------------------------
        "add": lambda *a: sum(_to_int(x) for x in a),
        "add1": lambda v: _to_int(v) + 1,
        "sub": lambda a, b: _to_int(a) - _to_int(b),
        "mul": lambda *a: math.prod(_to_int(x) for x in a),
        # Go integer semantics: truncate toward zero, remainder takes
        # the dividend's sign (Python's // floors instead)
        "div": lambda a, b: int(_to_int(a) / _to_int(b)),
        "mod": lambda a, b: _to_int(a) - int(_to_int(a) / _to_int(b)) * _to_int(b),
        "max": lambda *a: max(_to_int(x) for x in a),
        "min": lambda *a: min(_to_int(x) for x in a),
        "addf": lambda *a: sum(_to_float(x) for x in a),
        "subf": lambda a, b: _to_float(a) - _to_float(b),
        "mulf": lambda *a: math.prod(_to_float(x) for x in a),
        "divf": lambda a, b: _to_float(a) / _to_float(b),
        "maxf": lambda *a: max(_to_float(x) for x in a),
        "minf": lambda *a: min(_to_float(x) for x in a),
        "floor": lambda v: float(math.floor(_to_float(v))),
        "ceil": lambda v: float(math.ceil(_to_float(v))),
        "round": lambda v, p=0: round(_to_float(v), _to_int(p)),
        "seq": lambda *a: " ".join(str(i) for i in _seq_range(*a)),
        "until": lambda n: list(range(_to_int(n))),
        "untilStep": lambda start, stop, step: list(
            range(_to_int(start), _to_int(stop), _to_int(step) or 1)
        ),
        "atoi": _to_int,
        "int": _to_int,
        "int64": _to_int,
        "float64": _to_float,
        "toDecimal": lambda v: int(_to_str(v), 8),
        # lists ---------------------------------------------------------
        "list": lambda *a: list(a),
        "tuple": lambda *a: list(a),
        "first": lambda l: l[0] if l else None,
        "rest": lambda l: list(l[1:]),
        "last": lambda l: l[-1] if l else None,
        "initial": lambda l: list(l[:-1]),
        "append": lambda l, v: list(l or []) + [v],
        "prepend": lambda l, v: [v] + list(l or []),
        "concat": lambda *ls: [x for l in ls for x in (l or [])],
        "reverse": lambda l: list(reversed(l)),
        "uniq": _uniq,
        "without": lambda l, *vs: [x for x in l if x not in vs],
        "has": lambda v, l: v in (l or []),
        "compact": lambda l: [x for x in l if not _is_empty(x)],
        "slice": lambda l, *ab: list(
            l[_to_int(ab[0]) if ab else 0 : _to_int(ab[1]) if len(ab) > 1 else len(l)]
        ),
        "chunk": lambda n, l: [
            list(l[i : i + _to_int(n)]) for i in range(0, len(l), max(_to_int(n), 1))
        ],
        # dicts ---------------------------------------------------------
        "get": lambda d, k: (d or {}).get(k, ""),
        "set": _dict_set,
        "unset": _dict_unset,
        "hasKey": lambda d, k: k in (d or {}),
        "keys": lambda *ds: [k for d in ds for k in (d or {})],
        "values": lambda *ds: [v for d in ds for v in (d or {}).values()],
        "pluck": lambda k, *ds: [d[k] for d in ds if isinstance(d, dict) and k in d],
        "pick": lambda d, *ks: {k: d[k] for k in ks if k in (d or {})},
        "omit": lambda d, *ks: {k: v for k, v in (d or {}).items() if k not in ks},
        "merge": lambda dst, *srcs: _merge_all(dst, srcs),
        "mergeOverwrite": lambda dst, *srcs: _merge_overwrite(dst, srcs),
        "deepCopy": lambda v: json.loads(json.dumps(v)),
        "dig": _dig,
        # encodings -----------------------------------------------------
        "b64enc": lambda s: base64.b64encode(_to_str(s).encode()).decode(),
        "b64dec": lambda s: base64.b64decode(_to_str(s).encode()).decode(),
        "b32enc": lambda s: base64.b32encode(_to_str(s).encode()).decode(),
        "b32dec": lambda s: base64.b32decode(_to_str(s).encode()).decode(),
        "toJson": lambda v: json.dumps(v, separators=(",", ":")),
        "toRawJson": lambda v: json.dumps(v, separators=(",", ":")),
        "toPrettyJson": lambda v: json.dumps(v, indent=2),
        "fromJson": lambda s: json.loads(s),
        "toYaml": lambda v: yaml.safe_dump(v, default_flow_style=False).rstrip("\n"),
        "fromYaml": lambda s: yaml.safe_load(s),
        "sha256sum": lambda s: hashlib.sha256(_to_str(s).encode()).hexdigest(),
        "sha1sum": lambda s: hashlib.sha1(_to_str(s).encode()).hexdigest(),
        "md5sum": lambda s: hashlib.md5(_to_str(s).encode()).hexdigest(),
        "uuidv4": lambda: str(uuid.uuid4()),
        # flow / defaults ----------------------------------------------
        "empty": _is_empty,
        "coalesce": lambda *a: next((x for x in a if not _is_empty(x)), None),
        "ternary": lambda t, f, cond: t if cond else f,
        "fail": _fail,
        # regex ---------------------------------------------------------
        "regexMatch": lambda pat, s: re.search(pat, _to_str(s)) is not None,
        "regexFind": lambda pat, s: (
            (re.search(pat, _to_str(s)) or _EMPTY_MATCH).group(0)
        ),
        "regexFindAll": lambda pat, s, n: (
            [m.group(0) for m in re.finditer(pat, _to_str(s))][
                : None if _to_int(n) < 0 else _to_int(n)
            ]
        ),
        "regexReplaceAll": lambda pat, s, repl: re.sub(
            pat, _go_repl(repl), _to_str(s)
        ),
        "regexSplit": lambda pat, s, n: _regex_split(pat, _to_str(s), _to_int(n)),
        # dates ---------------------------------------------------------
        "now": lambda: datetime.datetime.now(datetime.timezone.utc),
        "date": _fmt_date,
        "dateInZone": _date_in_zone,
        "unixEpoch": lambda t: int(_as_datetime(t).timestamp()),
        "toDate": _to_date,
        "duration": lambda secs: f"{_to_int(secs)}s",
        "htmlDate": lambda t: _fmt_date("2006-01-02", t),
        # type introspection -------------------------------------------
        "kindOf": _kind_of,
        "kindIs": lambda k, v: _kind_of(v) == k,
        "typeOf": _kind_of,
        "typeIs": lambda k, v: _kind_of(v) == k,
        "deepEqual": _deep_equal,
        # paths ---------------------------------------------------------
        "base": posixpath.basename,
        "dir": posixpath.dirname,
        "clean": posixpath.normpath,
        "ext": lambda p: posixpath.splitext(p)[1],
        "isAbs": posixpath.isabs,
        # os (sprig exposes these; harmless reads) ----------------------
        "env": lambda name: os.environ.get(name, ""),
        "expandenv": os.path.expandvars,
        "getHostByName": lambda name: "",  # no network I/O by design
        # semver --------------------------------------------------------
        "semverCompare": _semver_compare,
        "semver": lambda v: dict(
            zip(
                ("Major", "Minor", "Patch", "Prerelease"),
                _semver_tuple(v),
            )
        ),
    }
    # sprig's must* variants surface errors; the engine already raises,
    # so they alias the plain forms
    for name in (
        "fromJson", "toDate", "uuidv4", "regexMatch", "regexFind",
        "regexFindAll", "regexReplaceAll", "regexSplit", "merge",
        "mergeOverwrite", "deepCopy", "first", "rest", "last", "initial",
        "append", "prepend", "reverse", "uniq", "without", "has",
        "compact", "slice", "chunk", "fromYaml", "toJson", "toYaml",
    ):
        funcs["must" + name[0].upper() + name[1:]] = funcs[name]
    return funcs


class _EmptyMatch:
    @staticmethod
    def group(_i: int) -> str:
        return ""


_EMPTY_MATCH = _EmptyMatch()


def _go_repl(repl: str) -> str:
    """Go regexp replacement syntax ($1) -> Python (\\1)."""
    return re.sub(r"\$(\d+)", r"\\\1", re.sub(r"\$\{(\d+)\}", r"\\\1", repl))


def _seq_range(*a) -> range:
    a = [_to_int(x) for x in a]
    if len(a) == 1:
        return range(1, a[0] + 1) if a[0] >= 1 else range(1, a[0] - 1, -1)
    if len(a) == 2:
        step = 1 if a[1] >= a[0] else -1
        return range(a[0], a[1] + step, step)
    if len(a) == 3:
        start, step, stop = a  # bash seq order: FIRST INCREMENT LAST
        if step == 0:
            return range(0)
        return range(start, stop + (1 if step > 0 else -1), step)
    return range(0)


def _uniq(l):
    out = []
    for x in l:
        if x not in out:
            out.append(x)
    return out


def _dict_set(d: dict, k: str, v: Any) -> dict:
    d[k] = v
    return d


def _dict_unset(d: dict, k: str) -> dict:
    d.pop(k, None)
    return d


def _merge_all(dst: dict, srcs) -> dict:
    for src in srcs:
        _deep_merge(dst, src or {})
    return dst


def _merge_overwrite(dst: dict, srcs) -> dict:
    for src in srcs:
        for k, v in (src or {}).items():
            if isinstance(dst.get(k), dict) and isinstance(v, dict):
                _merge_overwrite(dst[k], [v])
            else:
                dst[k] = v
    return dst


def _dig(*args):
    """dig key1 key2 ... default dict (sprig arg order)."""
    *keys, default, d = args
    cur = d
    for k in keys:
        if not isinstance(cur, dict) or k not in cur:
            return default
        cur = cur[k]
    return cur


def _fail(msg: str):
    raise ValueError(f"template fail: {msg}")


def _to_date(layout: str, s: str) -> datetime.datetime:
    """sprig toDate: parse with the Go layout (strict, errors surface)."""
    st = _go_layout_to_strftime(layout).replace("%:z", "%z")
    try:
        return datetime.datetime.strptime(_to_str(s), st)
    except ValueError:
        return _as_datetime(s)  # ISO fallback; raises when unparseable


def _date_in_zone(layout: str, t: Any, zone: str) -> str:
    import zoneinfo

    dt = _as_datetime(t)
    if zone and zone.upper() != "UTC":
        try:
            dt = dt.astimezone(zoneinfo.ZoneInfo(zone))
        except (KeyError, zoneinfo.ZoneInfoNotFoundError):
            raise ValueError(f"unknown time zone {zone!r}")
    return _fmt_date(layout, dt)


def _deep_equal(a: Any, b: Any) -> bool:
    """Go reflect.DeepEqual semantics: bools never equal ints (the
    engine's own eq uses the same guard)."""
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if isinstance(a, dict) and isinstance(b, dict):
        return set(a) == set(b) and all(_deep_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(
            _deep_equal(x, y) for x, y in zip(a, b)
        )
    return a == b
