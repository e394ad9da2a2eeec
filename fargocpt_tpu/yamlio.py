"""Reader and writer for the YAML subset the setups and output dumps use.

The package reads setup files and writes its output metadata without
PyYAML.  The subset covers what the shipped setups, the reference-golden
configs and ``output.py``'s dumps contain:

  * block mappings and block sequences (also a sequence at its parent
    key's indentation, and ``- key: value`` items that open a mapping);
  * plain, single-quoted and double-quoted scalars, comments;
  * one-line flow sequences and mappings (``[a, b]``, ``{k: v}``).

Plain scalars resolve to exactly the types ``yaml.safe_load`` gives (YAML
1.1 rules): ``yes``/``No``/``on``/``off`` are booleans, ``1e-5`` (no dot)
stays a string while ``1.0e-5`` is a float, ``0x1f``/``017``/``1:30`` are
ints.  Anything outside the subset — anchors, aliases, tags, block
scalars, multi-line scalars, several documents, complex keys, tabs as
indentation — raises :class:`YamlSubsetError` naming the line; nothing is
misread silently.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path

__all__ = ["YamlSubsetError", "loads", "load_file", "dumps"]


class YamlSubsetError(ValueError):
    """Input outside the supported YAML subset, or malformed."""


# --- scalar resolution (PyYAML's YAML 1.1 implicit resolvers) -------------
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "true", "on"}
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")


def _sexagesimal(sign, value, cast):
    digits = [cast(part) for part in value.split(":")]
    digits.reverse()
    base, out = 1, 0
    for d in digits:
        out += d * base
        base *= 60
    return sign * out


def _resolve_plain(text: str):
    """Typed value of a plain scalar, as ``yaml.safe_load`` resolves it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if ":" in v:
            return _sexagesimal(sign, v, int)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return _sexagesimal(sign, v, float)
        return sign * float(v)
    if _TIMESTAMP.match(text):
        raise ValueError("timestamps are outside the supported subset")
    return text


# --- line handling ---------------------------------------------------------
class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no, indent, text):
        self.no, self.indent, self.text = no, indent, text


def _strip_comment(s: str) -> str:
    """``s`` without its trailing comment.  A quote opens a quoted scalar
    only where a scalar can start; inside plain scalars quotes are
    literal, and ``#`` starts a comment only after whitespace."""
    start = True          # a scalar may start here
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if start and c in "'\"":
            i += 1
            while i < n:
                if s[i] == "\\" and c == '"':
                    i += 2
                    continue
                if s[i] == c:
                    if c == "'" and i + 1 < n and s[i + 1] == "'":
                        i += 2
                        continue
                    break
                i += 1
            i += 1
            start = False
            continue
        if c == "#" and (i == 0 or s[i - 1] in " \t"):
            return s[:i].rstrip()
        if c in " \t":
            pass
        elif c in "[{,":
            start = True
        elif c in "-:?" and (i + 1 == n or s[i + 1] == " "):
            start = True
        else:
            start = False
        i += 1
    return s.rstrip()


def _logical_lines(text: str, source: str) -> list[_Line]:
    out = []
    for no, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise YamlSubsetError(f"{source}:{no}: tab used for indentation")
        body = _strip_comment(body)
        if not body:
            continue
        if body in ("---", "...") or body.startswith("--- ") \
                or body.startswith("%"):
            if body == "---" and not out:
                continue               # one leading document marker
            raise YamlSubsetError(
                f"{source}:{no}: directives and multiple documents are "
                "outside the supported YAML subset")
        out.append(_Line(no, len(raw) - len(raw.lstrip(" ")), body))
    return out


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _split_key(text: str):
    """(key, rest) for a ``key: value`` line, else None."""
    if text[0] in "'\"":
        end = _quoted_end(text, 0)
        if end is None:
            return None
        after = text[end:]
        if after == ":" or after.startswith(": "):
            return text[:end], after[1:].strip()
        return None
    if text[0] in "[{":
        return None
    m = re.search(r":( |$)", text)
    if m is None:
        return None
    return text[:m.start()].rstrip(), text[m.end():].strip()


def _quoted_end(text: str, i: int):
    """Index just past the quoted scalar starting at ``text[i]``."""
    q = text[i]
    j = i + 1
    while j < len(text):
        if q == '"' and text[j] == "\\":
            j += 2
            continue
        if text[j] == q:
            if q == "'" and j + 1 < len(text) and text[j + 1] == "'":
                j += 2
                continue
            return j + 1
        j += 1
    return None


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


def _unquote(token: str) -> str:
    if token[0] == "'":
        return token[1:-1].replace("''", "'")
    body, out, i = token[1:-1], [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in _HEX:
            k = _HEX[e]
            out.append(chr(int(body[i + 2:i + 2 + k], 16)))
            i += 2 + k
        else:
            raise ValueError(f"unknown escape \\{e}")
    return "".join(out)


class _Parser:
    def __init__(self, lines: list[_Line], source: str):
        self.lines = lines
        self.source = source
        self.i = 0

    def fail(self, line: _Line, msg: str):
        raise YamlSubsetError(f"{self.source}:{line.no}: {msg}")

    def cur(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    # -- block structure ---------------------------------------------------
    def block(self, indent: int):
        line = self.cur()
        if _is_item(line.text):
            return self.seq(indent)
        if _split_key(line.text) is not None:
            return self.mapping(indent)
        self.i += 1
        return self.scalar(line.text, line)

    def seq(self, indent: int) -> list:
        out = []
        while True:
            line = self.cur()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                self.fail(line, "unexpected indentation")
            if not _is_item(line.text):
                return out
            rest = line.text[1:].lstrip(" ")
            col = indent + len(line.text) - len(rest)
            if not rest:
                self.i += 1
                nxt = self.cur()
                out.append(self.block(nxt.indent)
                           if nxt is not None and nxt.indent > indent
                           else None)
            elif _is_item(rest) or _split_key(rest) is not None:
                # the item opens a nested block at the item's content column
                self.lines[self.i] = _Line(line.no, col, rest)
                out.append(self.block(col))
            else:
                self.i += 1
                out.append(self.scalar(rest, line))
                self.no_continuation(indent, line)

    def mapping(self, indent: int) -> dict:
        out = {}
        while True:
            line = self.cur()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                self.fail(line, "unexpected indentation")
            if _is_item(line.text):
                return out
            kv = _split_key(line.text)
            if kv is None:
                self.fail(line, "expected 'key: value' (multi-line scalars "
                          "are outside the supported YAML subset)")
            key = self.scalar(kv[0], line)
            if isinstance(key, (list, dict)):
                self.fail(line, "complex keys are outside the subset")
            self.i += 1
            if kv[1]:
                out[key] = self.scalar(kv[1], line)
                self.no_continuation(indent, line)
                continue
            nxt = self.cur()
            if nxt is not None and nxt.indent > indent:
                out[key] = self.block(nxt.indent)
            elif nxt is not None and nxt.indent == indent \
                    and _is_item(nxt.text):
                out[key] = self.seq(indent)
            else:
                out[key] = None

    def no_continuation(self, indent: int, line: _Line):
        nxt = self.cur()
        if nxt is not None and nxt.indent > indent:
            self.fail(nxt, "multi-line scalars are outside the supported "
                      "YAML subset")

    # -- scalars and flow collections --------------------------------------
    def scalar(self, text: str, line: _Line):
        c = text[0]
        if c in "&*!|>%@`?":
            self.fail(line, f"{text!r}: anchors, aliases, tags, block "
                      "scalars and complex keys are outside the supported "
                      "YAML subset")
        try:
            if c in "[{":
                value, end = self.flow(text, 0, line)
                if text[end:].strip():
                    self.fail(line, f"trailing text after {text[:end]!r}")
                return value
            if c in "'\"":
                end = _quoted_end(text, 0)
                if end is None:
                    self.fail(line, "unterminated quoted scalar (multi-line "
                              "scalars are outside the supported subset)")
                if text[end:].strip():
                    self.fail(line, f"trailing text after {text[:end]!r}")
                return _unquote(text[:end])
            if ": " in text:
                self.fail(line, f"{text!r}: mapping value in a scalar")
            return _resolve_plain(text)
        except ValueError as e:
            if isinstance(e, YamlSubsetError):
                raise
            self.fail(line, str(e))

    def flow(self, s: str, i: int, line: _Line):
        """Parse the flow node at ``s[i]``; return (value, index past it)."""
        i = _skip_ws(s, i)
        if i >= len(s):
            self.fail(line, "unterminated flow collection")
        c = s[i]
        if c == "[":
            out, i = [], _skip_ws(s, i + 1)
            while True:
                if i < len(s) and s[i] == "]":
                    return out, i + 1
                v, i = self.flow(s, i, line)
                out.append(v)
                i = self.flow_sep(s, i, "]", line)
        if c == "{":
            out, i = {}, _skip_ws(s, i + 1)
            while True:
                if i < len(s) and s[i] == "}":
                    return out, i + 1
                k, i = self.flow(s, i, line)
                i = _skip_ws(s, i)
                if i < len(s) and s[i] == ":":
                    v, i = self.flow(s, i + 1, line)
                else:
                    v = None
                out[k] = v
                i = self.flow_sep(s, i, "}", line)
        if c in "'\"":
            end = _quoted_end(s, i)
            if end is None:
                self.fail(line, "unterminated quoted scalar")
            return _unquote(s[i:end]), end
        if c in "&*!|>%@`":
            self.fail(line, f"{c!r} is outside the supported YAML subset")
        j = i
        while j < len(s) and s[j] not in ",[]{}" and not (
                s[j] == ":" and (j + 1 == len(s) or s[j + 1] in " ,]}")):
            j += 1
        return _resolve_plain(s[i:j].strip()), j

    def flow_sep(self, s: str, i: int, close: str, line: _Line) -> int:
        i = _skip_ws(s, i)
        if i < len(s) and s[i] == ",":
            return _skip_ws(s, i + 1)
        if i < len(s) and s[i] == close:
            return i
        self.fail(line, "malformed flow collection (multi-line flow "
                  "collections are outside the supported subset)")


def _skip_ws(s: str, i: int) -> int:
    while i < len(s) and s[i] == " ":
        i += 1
    return i


def loads(text: str, source: str = "<string>"):
    """Parse ``text``; returns what ``yaml.safe_load`` returns for it."""
    lines = _logical_lines(text, source)
    if not lines:
        return None
    p = _Parser(lines, source)
    value = p.block(lines[0].indent)
    if p.i < len(lines):
        p.fail(lines[p.i], "unexpected indentation")
    return value


def load_file(path) -> object:
    path = Path(path)
    return loads(path.read_text(), str(path))


# --- writer ----------------------------------------------------------------
def _float_text(x: float) -> str:
    if math.isnan(x):
        return ".nan"
    if math.isinf(x):
        return ".inf" if x > 0 else "-.inf"
    t = repr(x).lower()
    if "." not in t and "e" in t:
        t = t.replace("e", ".0e", 1)
    return t


def _scalar_text(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _float_text(v)
    if not isinstance(v, str):
        raise TypeError(f"cannot represent {type(v).__name__} in YAML")
    if not v.isprintable():
        return json.dumps(v)
    plain_ok = (v and v == v.strip() and v[0] not in _INDICATORS
                and ": " not in v and " #" not in v and not v.endswith(":"))
    if plain_ok:
        try:
            plain_ok = _resolve_plain(v) == v
        except ValueError:
            plain_ok = False
    return v if plain_ok else "'" + v.replace("'", "''") + "'"


def _emit(obj, indent: int, out: list, sort_keys: bool):
    pad = " " * indent
    if isinstance(obj, dict):
        items = sorted(obj.items(), key=lambda kv: str(kv[0])) \
            if sort_keys else obj.items()
        for k, v in items:
            key = _scalar_text(k)
            if isinstance(v, dict) and v:
                out.append(f"{pad}{key}:")
                _emit(v, indent + 2, out, sort_keys)
            elif isinstance(v, list) and v:
                out.append(f"{pad}{key}:")
                _emit(v, indent, out, sort_keys)
            else:
                out.append(f"{pad}{key}: {_inline(v)}")
    elif isinstance(obj, list):
        for v in obj:
            if isinstance(v, (dict, list)) and v:
                sub: list = []
                _emit(v, indent + 2, sub, sort_keys)
                sub[0] = f"{pad}- {sub[0][indent + 2:]}"
                out.extend(sub)
            else:
                out.append(f"{pad}- {_inline(v)}")
    else:
        out.append(pad + _scalar_text(obj))


def _inline(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, list):
        return "[]"
    return _scalar_text(v)


def dumps(data, sort_keys: bool = True) -> str:
    """Block-style YAML for dicts/lists of scalars; ``loads`` (and
    ``yaml.safe_load``) read it back to an equal value."""
    if isinstance(data, (dict, list)) and not data:
        return _inline(data) + "\n"
    out: list = []
    _emit(data, 0, out, sort_keys)
    return "\n".join(out) + "\n"
