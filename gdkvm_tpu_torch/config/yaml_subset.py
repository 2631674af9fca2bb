"""A reader and writer for the subset of YAML that the repo's configs use.

The port must run where PyYAML is not installed, so it reads
``configs/*.yaml`` and a run's ``config.yaml`` itself.  On the subset below
:func:`load` returns exactly what ``yaml.safe_load`` returns; everything
else raises ``ValueError`` naming the line.

The subset:

- block mappings nested by indentation (spaces only);
- block sequences of scalars (``- 32``, at the key's indent or deeper) and
  flow sequences of scalars on one line (``[16, 32, 48, 64]``);
- full-line and trailing comments;
- ``null`` / ``~`` / an empty value; ``true`` / ``false``;
- decimal ints (``-1``); floats with a dot (``1.0e-4``, ``0.5``, ``.inf``);
- single-quoted, double-quoted and plain strings on one line.

Refused on purpose, because PyYAML (YAML 1.1) reads them as something other
than what their writer most likely meant: ``1e-4`` and ``1.0e4`` (strings:
its floats need a dot and a signed exponent), ``yes/no/on/off`` (bools),
``010`` (octal 8), ``1_000``, ``0x10``, ``1:30`` (sexagesimal) and dates.
Also refused: tabs, anchors and aliases, tags, block scalars, flow
mappings, nested or multi-line flow sequences, sequences of mappings,
multi-line scalars, complex keys, duplicate keys, document markers and
directives.

:func:`dump` writes a nested mapping in block style, as
``yaml.safe_dump(..., sort_keys=False)`` does; ``yaml.safe_load`` and
:func:`load` of its output give the mapping back (tuples as lists).
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

_NULLS = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE"}
_FALSE = {"false", "False", "FALSE"}
_REFUSED_BOOLS = {"yes", "Yes", "YES", "no", "No", "NO",
                  "on", "On", "ON", "off", "Off", "OFF"}

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)\Z")
_FLOAT = re.compile(r"(?:[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9]+(?:[eE][-+][0-9]+)?)\Z")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)\Z")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)\Z")
# What PyYAML's resolver reads as an int, a float or a timestamp.
_YAML11_INT = re.compile(
    r"(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)\Z")
_YAML11_FLOAT = re.compile(
    r"(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*)\Z")
_TIMESTAMP = re.compile(
    r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}"
    r"(?:(?:[Tt]|[ \t]+)[0-9]{1,2}:[0-9]{2}:[0-9]{2}(?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?)?\Z")

_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ",
            "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _err(line: int, msg: str) -> ValueError:
    return ValueError(f"line {line}: {msg}")


def _python_number(text: str) -> bool:
    """Whether Python reads ``text`` (which holds a digit) as a number."""
    if not any(c.isdigit() for c in text):
        return False
    try:
        float(text.replace("_", ""))
        return True
    except ValueError:
        pass
    try:
        int(text.replace("_", ""), 0)
        return True
    except ValueError:
        return False


def _resolve_plain(text: str, line: int) -> Any:
    """The value of a plain (unquoted) scalar."""
    if text in _NULLS:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if text in _REFUSED_BOOLS:
        raise _err(line, f"{text!r} is a bool in YAML 1.1; write true/false, "
                         f"or quote it to mean the string")
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if _INF.match(text):
        return -math.inf if text[0] == "-" else math.inf
    if _NAN.match(text):
        return math.nan
    if _YAML11_INT.match(text) or _YAML11_FLOAT.match(text):
        raise _err(line, f"number {text!r} is outside the supported subset "
                         f"(YAML 1.1 reads octal, hex, binary, underscores and "
                         f"sexagesimal); write a plain decimal, or quote it")
    if _python_number(text):
        raise _err(line, f"{text!r} is a string in YAML 1.1 (a float needs a "
                         f"dot and a signed exponent, as in 1.0e-4); write it "
                         f"so, or quote it to mean the string")
    if _TIMESTAMP.match(text):
        raise _err(line, f"{text!r} is a timestamp in YAML 1.1; quote it")
    if text in ("<<", "="):
        raise _err(line, f"{text!r} (merge key / value tag) is not supported")
    first = text[0]
    if first in "&*":
        raise _err(line, "anchors and aliases are not supported")
    if first == "!":
        raise _err(line, "tags are not supported")
    if first in "|>":
        raise _err(line, "block scalars are not supported")
    if first == "{":
        raise _err(line, "flow mappings are not supported")
    if first in "%@`[]},":
        raise _err(line, f"a plain scalar cannot start with {first!r}")
    if first in "?-:" and (len(text) == 1 or text[1] == " "):
        raise _err(line, f"{text!r}: complex keys and nested sequence entries "
                         f"are not supported")
    return text


def _scan_quoted(s: str, i: int, line: int) -> Tuple[str, int]:
    """The quoted scalar that opens at ``s[i]`` → (its value, the index
    after its closing quote)."""
    quote = s[i]
    out: List[str] = []
    i += 1
    while i < len(s):
        c = s[i]
        if quote == "'":
            if c == "'":
                if s[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(c)
            i += 1
            continue
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            esc = s[i + 1:i + 2]
            if esc in _HEX_ESCAPES:
                n = _HEX_ESCAPES[esc]
                digits = s[i + 2:i + 2 + n]
                if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    raise _err(line, f"bad \\{esc} escape")
                out.append(chr(int(digits, 16)))
                i += 2 + n
                continue
            if esc not in _ESCAPES:
                raise _err(line, f"unsupported escape \\{esc}" if esc else
                           "a quoted scalar must end on its line")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        out.append(c)
        i += 1
    raise _err(line, "a quoted scalar must end on its line")


def _rest_is_blank(s: str, i: int, line: int) -> None:
    """Only spaces, or a comment after at least one space, may follow."""
    rest = s[i:]
    if rest.strip() == "":
        return
    if rest[0] == " " and rest.lstrip().startswith("#"):
        return
    raise _err(line, f"unexpected text {rest.strip()!r} after a value")


def _plain_end(s: str, i: int, stops: str = "") -> int:
    """Index where the plain scalar starting at ``s[i]`` ends: at a comment
    (``#`` after a space), at one of ``stops`` (a flow sequence's ``,`` and
    ``]``), or at the end of the line."""
    j = i
    while j < len(s):
        c = s[j]
        if c in stops:
            break
        if c == "#" and j > i and s[j - 1] == " ":
            break
        j += 1
    return j


def _parse_flow_seq(s: str, i: int, line: int) -> Tuple[list, int]:
    """The flow sequence that opens at ``s[i]`` → (list, index after ``]``)."""
    items: list = []
    i += 1
    expect_item = True
    while True:
        while i < len(s) and s[i] == " ":
            i += 1
        if i >= len(s) or s[i] == "#":
            raise _err(line, "a flow sequence must close on its line")
        c = s[i]
        if c == "]":
            return items, i + 1
        if c == ",":
            if expect_item:
                raise _err(line, "empty entry in a flow sequence")
            expect_item = True
            i += 1
            continue
        if not expect_item:
            raise _err(line, "missing ',' in a flow sequence")
        if c in "[{":
            raise _err(line, "nested flow collections are not supported")
        if c in "'\"":
            val, i = _scan_quoted(s, i, line)
        else:
            j = _plain_end(s, i, ",]")
            text = s[i:j].rstrip()
            if ": " in text or text.endswith(":") or "[" in text or "{" in text \
                    or "}" in text:
                raise _err(line, "flow mappings are not supported")
            val, i = _resolve_plain(text, line), j
        items.append(val)
        expect_item = False


def _parse_value(s: str, i: int, line: int) -> Any:
    """The scalar or flow sequence in ``s[i:]`` (leading spaces allowed)."""
    while i < len(s) and s[i] == " ":
        i += 1
    if i >= len(s) or s[i] == "#":
        return None
    c = s[i]
    if c in "'\"":
        val, j = _scan_quoted(s, i, line)
        _rest_is_blank(s, j, line)
        return val
    if c == "[":
        val, j = _parse_flow_seq(s, i, line)
        _rest_is_blank(s, j, line)
        return val
    if c == "-" and s[i + 1:i + 2] in ("", " "):
        raise _err(line, "a sequence entry is not allowed here")
    j = _plain_end(s, i)
    text = s[i:j].rstrip()
    if ": " in text or text.endswith(":"):
        raise _err(line, "a mapping is not allowed in a value on the key's line")
    return _resolve_plain(text, line)


def _split_key(s: str, line: int) -> Tuple[Any, int]:
    """The key that ``s`` starts with → (key, index after its ``:``)."""
    if s[0] in "'\"":
        key, j = _scan_quoted(s, 0, line)
        while j < len(s) and s[j] == " ":
            j += 1
        if s[j:j + 1] != ":" or s[j + 1:j + 2] not in ("", " "):
            raise _err(line, "expected ':' after a quoted key")
        return key, j + 1
    j = 0
    while j < len(s):
        if s[j] == ":" and s[j + 1:j + 2] in ("", " "):
            text = s[:j].rstrip()
            if text == "":
                raise _err(line, "empty key")
            key = _resolve_plain(text, line)
            if isinstance(key, float) and key != key:
                raise _err(line, "a NaN key is not supported")
            return key, j + 1
        if s[j] == "#" and j > 0 and s[j - 1] == " ":
            break
        j += 1
    raise _err(line, f"expected 'key: value', got {s.strip()!r}")


def _is_entry(s: str) -> bool:
    return s == "-" or s.startswith("- ")


class _Parser:
    def __init__(self, text: str) -> None:
        self.lines: List[Tuple[int, int, str]] = []     # (number, indent, content)
        for no, raw in enumerate(text.split("\n"), 1):
            raw = raw[:-1] if raw.endswith("\r") else raw
            body = raw.lstrip(" ")
            if body == "" or body.startswith("#"):
                if "\t" in raw and not body.startswith("#"):
                    raise _err(no, "tabs are not allowed")
                continue
            if "\t" in raw:
                raise _err(no, "tabs are not allowed")
            if body.startswith(("---", "...")) and body[3:4] in ("", " "):
                raise _err(no, "document markers are not supported")
            if body.startswith("%"):
                raise _err(no, "directives are not supported")
            self.lines.append((no, len(raw) - len(body), body.rstrip(" ")))
        self.pos = 0

    def peek(self):
        return self.lines[self.pos] if self.pos < len(self.lines) else None

    def parse(self) -> Any:
        first = self.peek()
        if first is None:
            return None
        if first[1] != 0:
            raise _err(first[0], "the document must start at column 0")
        out = self.block(0)
        left = self.peek()
        if left is not None:
            raise _err(left[0], "unexpected indentation")
        return out

    def block(self, indent: int) -> Any:
        no, _, body = self.peek()
        if _is_entry(body):
            return self.sequence(indent)
        return self.mapping(indent)

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            cur = self.peek()
            if cur is None or cur[1] < indent:
                return out
            no, ind, body = cur
            if ind > indent:
                raise _err(no, "unexpected indentation")
            if not _is_entry(body):
                return out          # a key at the sequence's indent ends it
            rest = body[1:]
            stripped = rest.lstrip(" ")
            if _is_entry(stripped):
                raise _err(no, "nested sequences are not supported")
            self.pos += 1
            val = _parse_value(rest, 0, no)
            nxt = self.peek()
            if nxt is not None and nxt[1] > indent:
                raise _err(nxt[0], "a sequence entry must be a scalar on one line")
            out.append(val)

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            cur = self.peek()
            if cur is None or cur[1] < indent:
                return out
            no, ind, body = cur
            if ind > indent:
                raise _err(no, "unexpected indentation")
            if _is_entry(body):
                raise _err(no, "a sequence entry is not allowed here")
            key, after = _split_key(body, no)
            if key in out:
                raise _err(no, f"duplicate key {key!r}")
            self.pos += 1
            val = _parse_value(body, after, no)
            nxt = self.peek()
            rest = body[after:].lstrip(" ")
            if rest == "" or rest.startswith("#"):
                # An empty value: a nested block, or null.
                if nxt is not None and nxt[1] > indent:
                    val = self.block(nxt[1])
                elif nxt is not None and nxt[1] == indent and _is_entry(nxt[2]):
                    val = self.sequence(indent)
            elif nxt is not None and nxt[1] > indent:
                raise _err(nxt[0], "unexpected indentation (a scalar must "
                                   "stay on its key's line)")
            out[key] = val


def load(text: str) -> Any:
    """Parse a document of the subset → what ``yaml.safe_load`` gives (None
    for an empty one).  Raises ``ValueError`` with the line number on
    anything outside the subset."""
    return _Parser(text).parse()


# ------------------------------------------------------------------ writer

_PLAIN_SAFE = re.compile(r"[A-Za-z_/][A-Za-z0-9_/.\-]*\Z")


def _dump_float(x: float) -> str:
    if x != x:
        return ".nan"
    if x in (math.inf, -math.inf):
        return ".inf" if x > 0 else "-.inf"
    text = repr(x).lower()
    if "." not in text and "e" in text:
        # YAML 1.1 floats need a dot: 1e-05 → 1.0e-05.
        text = text.replace("e", ".0e", 1)
    return text


def _dump_str(s: str) -> str:
    if _PLAIN_SAFE.match(s):
        try:
            if _resolve_plain(s, 0) == s:
                return s
        except ValueError:
            pass
    if all(" " <= c <= "~" for c in s):
        return "'" + s.replace("'", "''") + "'"
    out = []
    for c in s:
        cp = ord(c)
        if c in '"\\':
            out.append("\\" + c)
        elif " " <= c <= "~":
            out.append(c)
        elif cp <= 0xFF:
            out.append(f"\\x{cp:02x}")
        elif cp <= 0xFFFF:
            out.append(f"\\u{cp:04x}")
        else:
            out.append(f"\\U{cp:08x}")
    return '"' + "".join(out) + '"'


def _dump_scalar(x: Any) -> str:
    if x is None:
        return "null"
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, int):
        return str(x)
    if isinstance(x, float):
        return _dump_float(x)
    if isinstance(x, str):
        return _dump_str(x)
    raise ValueError(f"cannot write {type(x).__name__} {x!r}: not a scalar")


def _dump_mapping(d: dict, indent: int, out: List[str]) -> None:
    pad = " " * indent
    for key, val in d.items():
        k = _dump_scalar(key)
        if isinstance(val, dict):
            if not val:
                raise ValueError(f"cannot write the empty mapping at {key!r}")
            out.append(f"{pad}{k}:")
            _dump_mapping(val, indent + 2, out)
        elif isinstance(val, (list, tuple)):
            if not val:
                out.append(f"{pad}{k}: []")
                continue
            out.append(f"{pad}{k}:")
            out.extend(f"{pad}- {_dump_scalar(item)}" for item in val)
        else:
            out.append(f"{pad}{k}: {_dump_scalar(val)}")


def dump(obj: dict) -> str:
    """A nested mapping (str, int, float, bool and None leaves, lists or
    tuples of them) as block-style YAML, keys in the mapping's order."""
    if not isinstance(obj, dict):
        raise ValueError(f"dump writes a mapping, got {type(obj).__name__}")
    if not obj:
        return "{}\n"
    out: List[str] = []
    _dump_mapping(obj, 0, out)
    return "\n".join(out) + "\n"
