"""A reader and a writer for the subset of YAML the port's files use.

The machine with the card has no PyYAML, so the port reads the conf tree
and the tracking store's ``meta.yaml`` files, and writes the latter and the
``config.yaml`` artifacts, with this module. ``load`` resolves scalars as
PyYAML's ``safe_load`` does (YAML 1.1's implicit types: ``1.0e-6`` is a
float but ``1e-6`` a string, ``yes``/``on`` are booleans, ``0o``-less
``017`` is octal), and ``dump`` writes what ``safe_dump`` would read back
as the same data (block style, sorted keys, quotes where a plain scalar
would resolve to another type).

The subset:

- block mappings and block sequences by indentation (a sequence may sit at
  its key's own indentation, as ``safe_dump`` writes it), ``- key: value``
  items, comments (``#`` at the start of a line or after a space);
- flow sequences and mappings on one line (``[x]``, ``{}``,
  ``{a: 1, b: [2]}``);
- plain scalars (folded over more-indented lines), single-quoted scalars
  and double-quoted scalars with their escapes;
- the implicit types null, bool, int (decimal, ``0b``, octal, ``0x``,
  sexagesimal), float and date.

Anchors, aliases, tags, block scalars (``|``, ``>``), directives and
several documents raise ``YAMLSubsetError``.
"""

from __future__ import annotations

import datetime
import math
import numbers
import re
from typing import Any, List, Tuple

__all__ = ["YAMLSubsetError", "load", "dump"]


class YAMLSubsetError(ValueError):
    """Text outside the subset this module reads."""


# ------------------------------------------------------------ scalars

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                           "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False",
                                 "FALSE", "off", "Off", "OFF")})
_NULL = {"", "~", "null", "Null", "NULL"}
# PyYAML's implicit resolvers (resolver.py), YAML 1.1
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_DATE = re.compile(r"^([0-9]{4})-([0-9]{1,2})-([0-9]{1,2})$")


def _sexagesimal(text: str, cast):
    value, base = 0, 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def _int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1.0 if text[0] == "-" else 1.0
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * math.inf
    if text == ".nan":
        return math.nan
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def resolve_plain(text: str) -> Any:
    """A plain scalar's value under YAML 1.1's implicit types."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    m = _DATE.match(text)
    if m:
        return datetime.date(*(int(g) for g in m.groups()))
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


def _double_quoted(text: str, i: int) -> Tuple[str, int]:
    """The double-quoted scalar opening at text[i]; (value, index past the
    closing quote). Line breaks fold as YAML folds them."""
    out, i = [], i + 1
    while True:
        if i >= len(text):
            raise YAMLSubsetError("unclosed double-quoted scalar")
        c = text[i]
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            i += 1
            e = text[i] if i < len(text) else ""
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 1
            elif e in _HEX:
                n = _HEX[e]
                out.append(chr(int(text[i + 1:i + 1 + n], 16)))
                i += 1 + n
            elif e == "\n":  # an escaped line break joins the lines
                i += 1
                while i < len(text) and text[i] in " \t":
                    i += 1
            else:
                raise YAMLSubsetError(f"unknown escape \\{e}")
            continue
        if c == "\n":
            # fold: trailing blanks go, one break is a space, each further
            # empty line a newline
            while out and out[-1] in " \t":
                out.pop()
            breaks = 0
            while i < len(text) and text[i] in " \t\n":
                breaks += text[i] == "\n"
                i += 1
            out.append(" " if breaks == 1 else "\n" * (breaks - 1))
            continue
        out.append(c)
        i += 1


def _single_quoted(text: str, i: int) -> Tuple[str, int]:
    out, i = [], i + 1
    while True:
        j = text.find("'", i)
        if j < 0:
            raise YAMLSubsetError("unclosed single-quoted scalar")
        out.append(text[i:j])
        if text[j + 1:j + 2] == "'":
            out.append("'")
            i = j + 2
            continue
        return "".join(out), j + 1


def _strip_comment(text: str) -> str:
    """A plain value without its trailing comment (``#`` after a space)."""
    m = re.search(r"(^|[ \t])#", text)
    return (text[:m.start()] if m else text).strip()


def _rest_is_blank(text: str, i: int) -> None:
    rest = text[i:].strip()
    if rest and not rest.startswith("#"):
        raise YAMLSubsetError(f"unexpected text after a value: {rest!r}")


# ------------------------------------------------------------ flow


def _flow(text: str, i: int) -> Tuple[Any, int]:
    """The flow node starting at text[i] (after blanks); (value, end)."""
    while i < len(text) and text[i] in " \t":
        i += 1
    if i >= len(text):
        raise YAMLSubsetError("unclosed flow collection")
    c = text[i]
    if c == "[":
        return _flow_seq(text, i + 1)
    if c == "{":
        return _flow_map(text, i + 1)
    if c == '"':
        return _double_quoted(text, i)
    if c == "'":
        return _single_quoted(text, i)
    m = re.compile(r"[^,\[\]{}]*").match(text, i)
    j = m.end()
    # a ':' followed by a blank ends a flow mapping's key
    k = re.compile(r":(?=[ \t]|$)").search(text, i, j)
    if k:
        j = k.start()
    return resolve_plain(text[i:j].strip()), j


def _skip(text: str, i: int) -> int:
    while i < len(text) and text[i] in " \t":
        i += 1
    return i


def _flow_seq(text: str, i: int):
    out = []
    while True:
        i = _skip(text, i)
        if i < len(text) and text[i] == "]":
            return out, i + 1
        value, i = _flow(text, i)
        i = _skip(text, i)
        if i < len(text) and text[i] == ":":  # a single-pair mapping
            v, i = _flow(text, i + 1)
            value = {value: v}
            i = _skip(text, i)
        out.append(value)
        if i < len(text) and text[i] == ",":
            i += 1
        elif i >= len(text) or text[i] != "]":
            raise YAMLSubsetError("expected ',' or ']' in a flow sequence")


def _flow_map(text: str, i: int):
    out = {}
    while True:
        i = _skip(text, i)
        if i < len(text) and text[i] == "}":
            return out, i + 1
        key, i = _flow(text, i)
        i = _skip(text, i)
        if i < len(text) and text[i] == ":":
            value, i = _flow(text, i + 1)
            i = _skip(text, i)
        else:
            value = None
        out[key] = value
        if i < len(text) and text[i] == ",":
            i += 1
        elif i >= len(text) or text[i] != "}":
            raise YAMLSubsetError("expected ',' or '}' in a flow mapping")


# ------------------------------------------------------------ block

_KEY = re.compile(r"""^(?P<key>"(?:[^"\\]|\\.)*"|'(?:[^']|'')*'|[^#'"\[\]{},]
                      (?:[^:#]|:(?![ \t]|$)|(?<![ \t])\#)*?)
                      [ \t]*:(?:[ \t]+|$)""", re.X)


def _inline(text: str) -> Any:
    """The value written on one line after ``key:`` or ``- ``."""
    text = text.strip()
    if not text:
        return None
    c = text[0]
    if c in "[{\"'":
        value, i = _flow(text, 0)
        _rest_is_blank(text, i)
        return value
    if c in "&*!|>%@`":
        raise YAMLSubsetError(f"unsupported YAML: {text!r}")
    return resolve_plain(_strip_comment(text))


def _key(text: str) -> Any:
    text = text.strip()
    if text[:1] == '"':
        return _double_quoted(text, 0)[0]
    if text[:1] == "'":
        return _single_quoted(text, 0)[0]
    return resolve_plain(text)


class _Lines:
    """The document's content lines as (indent, text, raw)."""

    def __init__(self, text: str):
        self.items: List[Tuple[int, str]] = []
        for raw in text.splitlines():
            if "\t" in raw[:len(raw) - len(raw.lstrip(" \t"))]:
                raise YAMLSubsetError("tabs in indentation")
            body = raw.strip()
            if not body or body.startswith("#"):
                continue
            if body.startswith(("---", "...", "%")):
                raise YAMLSubsetError(f"unsupported YAML: {body!r}")
            self.items.append((len(raw) - len(raw.lstrip(" ")), raw.strip()))
        self.i = 0

    def peek(self):
        return self.items[self.i] if self.i < len(self.items) else None


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines: _Lines, indent: int) -> Any:
    line = lines.peek()
    if line is None:
        return None
    if _is_item(line[1]):
        return _sequence(lines, line[0])
    if _KEY.match(line[1]):
        return _mapping(lines, line[0])
    return _plain_lines(lines, indent - 1)


def _plain_lines(lines: _Lines, indent: int) -> Any:
    """A scalar on the current line, folded with the more-indented plain
    lines after it."""
    ind, text = lines.peek()
    lines.i += 1
    value = text.strip()
    if value[:1] in "\"'":
        # a quoted scalar that goes on over the next lines
        raw = [value]
        while True:
            try:
                return _inline(" ".join(raw) if value[0] == "'" else
                               "\n".join(raw))
            except YAMLSubsetError:
                nxt = lines.peek()
                if nxt is None or nxt[0] <= indent:
                    raise
                raw.append(nxt[1])
                lines.i += 1
    parts = [value]
    while True:
        nxt = lines.peek()
        if nxt is None or nxt[0] <= indent or value[:1] in "[{":
            break
        parts.append(nxt[1])
        lines.i += 1
    if len(parts) == 1:
        return _inline(value)
    return resolve_plain(" ".join(_strip_comment(p) for p in parts))


def _value_after(lines: _Lines, indent: int, rest: str, seq_ok: bool) -> Any:
    """The value of a key or an item at ``indent`` whose own line holds
    ``rest`` after the indicator."""
    if rest.strip() and not rest.strip().startswith("#"):
        lines.items[lines.i - 1] = (indent + 1, rest.strip())
        lines.i -= 1
        return _plain_lines(lines, indent)
    nxt = lines.peek()
    if nxt is None:
        return None
    if nxt[0] > indent:
        return _block(lines, nxt[0])
    if seq_ok and nxt[0] == indent and _is_item(nxt[1]):
        return _sequence(lines, indent)
    return None


def _mapping(lines: _Lines, indent: int) -> dict:
    out = {}
    while True:
        line = lines.peek()
        if line is None or line[0] < indent:
            return out
        if line[0] > indent:
            raise YAMLSubsetError(f"bad indentation: {line[1]!r}")
        m = _KEY.match(line[1])
        if not m or _is_item(line[1]):
            return out if _is_item(line[1]) else _fail(line)
        lines.i += 1
        key = _key(m.group("key"))
        out[key] = _value_after(lines, indent, line[1][m.end():], True)


def _fail(line):
    raise YAMLSubsetError(f"cannot read {line[1]!r}")


def _sequence(lines: _Lines, indent: int) -> list:
    out = []
    while True:
        line = lines.peek()
        if line is None or line[0] != indent or not _is_item(line[1]):
            if line is not None and line[0] > indent:
                _fail(line)
            return out
        rest = line[1][1:]
        body = rest.strip()
        if body and not body.startswith("#") and (
                _is_item(body) or _KEY.match(body) and body[0] not in "[{"):
            # the item's own block starts on this line, two columns in
            col = indent + 1 + len(rest) - len(rest.lstrip(" "))
            lines.items[lines.i] = (col, body)
            out.append(_block(lines, col))
            continue
        lines.i += 1
        out.append(_value_after(lines, indent, rest, False))


def load(text: str) -> Any:
    """The document in ``text`` (None when it holds no content)."""
    lines = _Lines(text)
    if lines.peek() is None:
        return None
    value = _block(lines, lines.peek()[0])
    if lines.peek() is not None:
        _fail(lines.peek())
    return value


# ------------------------------------------------------------ writer

_PLAIN_START = set("-?:,[]{}#&*!|>'\"%@` ")


def _scalar(value) -> str:
    if value is None:
        return "null"
    if value is True:
        return "true"
    if value is False:
        return "false"
    if isinstance(value, numbers.Integral):
        return str(int(value))
    if isinstance(value, numbers.Real):
        value = float(value)
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = float.__repr__(value).lower()
        if "." not in text and "e" in text:  # 1e-05 -> 1.0e-05, as PyYAML
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, datetime.date):
        return value.isoformat()
    text = str(value)
    plain = (text and (text[0] not in _PLAIN_START or text[:1] == "-"
                       and text[1:2] not in ("", " "))
             and text[-1] != " "
             and ": " not in text and " #" not in text
             and not text.endswith(":") and text.isprintable()
             and text.isascii() and resolve_plain(text) == text
             and isinstance(resolve_plain(text), str))
    if plain:
        return text
    if text.isprintable() and text.isascii():
        return "'" + text.replace("'", "''") + "'"
    out = []
    for c in text:
        if c in ('"', "\\"):
            out.append("\\" + c)
        elif c == "\n":
            out.append("\\n")
        elif c == "\t":
            out.append("\\t")
        elif c.isprintable() and c.isascii():
            out.append(c)
        elif ord(c) <= 0xFF:
            out.append(f"\\x{ord(c):02X}")
        elif ord(c) <= 0xFFFF:
            out.append(f"\\u{ord(c):04X}")
        else:
            out.append(f"\\U{ord(c):08X}")
    return '"' + "".join(out) + '"'


def _emit(value, indent: int, out: List[str], in_item: bool = False):
    pad = " " * indent
    if isinstance(value, dict):
        first = True
        for key in sorted(value, key=_sort_key):
            v = value[key]
            lead = "" if (in_item and first) else pad
            first = False
            k = _scalar(key)
            if isinstance(v, dict) and v:
                out.append(f"{lead}{k}:")
                _emit(v, indent + 2, out)
            elif isinstance(v, (list, tuple)) and v:
                out.append(f"{lead}{k}:")
                _emit(v, indent, out)
            else:
                out.append(f"{lead}{k}: {_inline_value(v)}")
        return
    for item in value:
        if isinstance(item, dict) and item:
            out.append(f"{pad}- ")
            body: List[str] = []
            _emit(item, indent + 2, body, in_item=True)
            out[-1] += body[0]
            out.extend(body[1:])
        elif isinstance(item, (list, tuple)) and item:
            out.append(f"{pad}- ")
            body = []
            _emit(item, indent + 2, body)
            out[-1] += body[0].lstrip(" ")
            out.extend(body[1:])
        else:
            out.append(f"{pad}- {_inline_value(item)}")


def _sort_key(key):
    return (str(type(key)), key) if not isinstance(key, str) else ("", key)


def _inline_value(value) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[]"
    return _scalar(value)


def dump(data) -> str:
    """``data`` (dicts, lists, str, int, float, bool, None, dates) as block
    YAML with sorted keys, as ``yaml.safe_dump`` lays it out."""
    if not isinstance(data, (dict, list, tuple)) or not data:
        return _inline_value(data) + "\n"
    out: List[str] = []
    _emit(data, 0, out)
    return "\n".join(out) + "\n"
