"""A parser for the subset of YAML that ``conf/`` uses, giving what
``yaml.safe_load`` gives on it (the JAX ``utils/config.py`` uses PyYAML,
which the port does not depend on).

The subset: block mappings and block sequences (``- item``, an item may
open a mapping, ``- key: value``); flow sequences and flow mappings,
nested and spread over lines, trailing commas allowed; comments; plain,
single- and double-quoted scalars, resolved as YAML 1.1 resolves them
(null ``~``/``null``, the booleans ``true``/``false``/``yes``/``no``/
``on``/``off`` in their three cases, decimal ints, floats with a dot and
``.inf``/``.nan``; anything else a string, so ``1e-3`` and ``inf`` are
strings, as PyYAML reads them). Anchors, aliases, tags, block scalars,
documents markers, multi-line plain scalars, timestamps, and the octal,
hex, binary and sexagesimal numbers raise :class:`YamlSubsetError`.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {
    **{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
    **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")},
}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$"
)
# YAML 1.1 forms that PyYAML resolves and this subset does not take.
_OUTSIDE = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)$"
)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/",
            "\\": "\\", "N": "\x85", "_": "\xa0"}


class YamlSubsetError(ValueError):
    """Text outside the YAML subset this parser takes."""


def resolve_plain(text: str) -> Any:
    """A plain scalar as YAML 1.1 resolves it (PyYAML's implicit tags)."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _OUTSIDE.match(text):
        raise YamlSubsetError(f"scalar {text!r} is outside the YAML subset")
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v.startswith("-") else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * float(v)
    if text[0] in "&*!|>%@`" or text.startswith("--- ") or text == "---":
        raise YamlSubsetError(f"{text!r}: anchors, aliases, tags and block scalars are not supported")
    return text


def _quoted(s: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``s[i]``; returns (value, end)."""
    q = s[i]
    out, j = [], i + 1
    while j < len(s):
        c = s[j]
        if q == "'" and c == "'":
            if s[j + 1 : j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == '"':
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = s[j + 1 : j + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
                continue
            width = {"x": 2, "u": 4, "U": 8}.get(e)
            if width is None:
                raise YamlSubsetError(f"unknown escape \\{e} in {s!r}")
            out.append(chr(int(s[j + 2 : j + 2 + width], 16)))
            j += 2 + width
            continue
        out.append(c)
        j += 1
    raise YamlSubsetError(f"unterminated quoted scalar in {s!r}")


def _strip_comment(line: str) -> str:
    """The line without its comment (a ``#`` at the start or after a
    space, outside quotes)."""
    i, quote = 0, None
    while i < len(line):
        c = line[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 2
                continue
            if c == quote:
                if quote == "'" and line[i + 1 : i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _depth(s: str) -> int:
    """Open flow brackets left at the end of ``s``, outside quotes."""
    depth, i = 0, 0
    while i < len(s):
        c = s[i]
        if c in "'\"" and (i == 0 or s[i - 1] in " \t[{,:"):
            _, i = _quoted(s, i)
            continue
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        i += 1
    return depth


# -- flow context -------------------------------------------------------------


def _flow(s: str, i: int) -> Tuple[Any, int]:
    """The flow node starting at or after ``s[i]``; returns (value, end)."""
    while i < len(s) and s[i] in " \t":
        i += 1
    if i >= len(s):
        raise YamlSubsetError(f"missing value in {s!r}")
    c = s[i]
    if c in "'\"":
        return _quoted(s, i)
    if c == "[":
        items, i = [], i + 1
        while True:
            while i < len(s) and s[i] in " \t":
                i += 1
            if s[i : i + 1] == "]":
                return items, i + 1
            item, i = _flow(s, i)
            while i < len(s) and s[i] in " \t":
                i += 1
            if s[i : i + 1] == ":":
                raise YamlSubsetError(f"single-pair mappings in flow sequences are not supported: {s!r}")
            items.append(item)
            if s[i : i + 1] == ",":
                i += 1
            elif s[i : i + 1] != "]":
                raise YamlSubsetError(f"expected ',' or ']' at {i} in {s!r}")
    if c == "{":
        out, i = {}, i + 1
        while True:
            while i < len(s) and s[i] in " \t":
                i += 1
            if s[i : i + 1] == "}":
                return out, i + 1
            key, i = _flow(s, i)
            while i < len(s) and s[i] in " \t":
                i += 1
            if s[i : i + 1] == ":":
                value, i = _flow(s, i + 1)
            else:
                value = None
            out[key] = value
            while i < len(s) and s[i] in " \t":
                i += 1
            if s[i : i + 1] == ",":
                i += 1
            elif s[i : i + 1] != "}":
                raise YamlSubsetError(f"expected ',' or '}}' at {i} in {s!r}")
    j = i
    while j < len(s) and s[j] not in ",]}" and not (s[j] == ":" and s[j + 1 : j + 2] in (" ", ",", "]", "}", "")):
        j += 1
    return resolve_plain(s[i:j].strip()), j


def _inline(text: str) -> Any:
    """A value written on the line of its key or dash."""
    if text[0] in "[{'\"":
        value, end = _flow(text, 0)
        if text[end:].strip():
            raise YamlSubsetError(f"unexpected text after {text[:end]!r}: {text[end:]!r}")
        return value
    return resolve_plain(text)


# -- block context ------------------------------------------------------------


def _split_key(text: str) -> Tuple[str, str] | None:
    """(key, rest) of a ``key: value`` line, or None when it has no
    mapping indicator outside quotes and brackets."""
    i, depth = 0, 0
    if text[0] in "'\"":
        _, i = _quoted(text, 0)
    while i < len(text):
        c = text[i]
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth == 0 and text[i + 1 : i + 2] in (" ", "\t", ""):
            return text[:i].strip(), text[i + 1 :].strip()
        i += 1
    return None


def _key(text: str) -> Any:
    return _quoted(text, 0)[0] if text[:1] in "'\"" else resolve_plain(text)


class _Lines:
    def __init__(self, text: str):
        self.items: List[Tuple[int, str]] = []
        pending = None
        for raw in text.splitlines():
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise YamlSubsetError("tabs in indentation are not YAML")
            line = _strip_comment(raw)
            if pending is not None:
                pending = (pending[0], pending[1] + " " + line.strip())
                if _depth(pending[1]) <= 0:
                    self.items.append(pending)
                    pending = None
                continue
            if not line.strip():
                continue
            if line.strip() in ("---", "...") or line.startswith("%"):
                raise YamlSubsetError("document markers and directives are not supported")
            entry = (len(line) - len(line.lstrip(" ")), line.strip())
            if _depth(entry[1]) > 0:
                pending = entry
            else:
                self.items.append(entry)
        if pending is not None:
            raise YamlSubsetError(f"unclosed flow collection: {pending[1]!r}")
        self.i = 0

    def peek(self):
        return self.items[self.i] if self.i < len(self.items) else None


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines: _Lines, indent: int) -> Any:
    first = lines.peek()
    if _is_item(first[1]):
        return _sequence(lines, indent)
    if first[1][0] in "[{'\"" or _split_key(first[1]) is None:
        # A node alone on the line below its key.
        lines.i += 1
        value = _inline(first[1])
        if (nxt := lines.peek()) is not None and nxt[0] >= indent:
            raise YamlSubsetError(f"unexpected {nxt[1]!r} after {first[1]!r}")
        return value
    return _mapping(lines, indent)


def _value_after(lines: _Lines, indent: int, rest: str, dash: bool = False) -> Any:
    """The value of a key (or dash) at ``indent`` whose line ends with ``rest``."""
    if rest:
        value = _inline(rest)
        nxt = lines.peek()
        if nxt is not None and nxt[0] > indent:
            raise YamlSubsetError(f"multi-line plain scalars are not supported: {nxt[1]!r}")
        return value
    nxt = lines.peek()
    if nxt is not None and (nxt[0] > indent or (not dash and nxt[0] == indent and _is_item(nxt[1]))):
        return _block(lines, nxt[0])
    return None


def _mapping(lines: _Lines, indent: int) -> dict:
    out: dict = {}
    while (line := lines.peek()) is not None and line[0] == indent:
        if _is_item(line[1]):
            break
        split = _split_key(line[1])
        if split is None:
            raise YamlSubsetError(f"expected 'key: value', got {line[1]!r}")
        lines.i += 1
        out[_key(split[0])] = _value_after(lines, indent, split[1])
    if (line := lines.peek()) is not None and line[0] > indent:
        raise YamlSubsetError(f"bad indentation at {line[1]!r}")
    return out


def _sequence(lines: _Lines, indent: int) -> list:
    out: list = []
    while (line := lines.peek()) is not None and line[0] == indent and _is_item(line[1]):
        rest = line[1][1:].strip()
        if rest and rest[0] not in "[{'\"" and _split_key(rest) is not None:
            # "- key: value" opens a mapping whose keys sit two columns in.
            lines.items[lines.i] = (indent + 2, rest)
            out.append(_mapping(lines, indent + 2))
            continue
        lines.i += 1
        out.append(_value_after(lines, indent, rest, dash=True))
    if (line := lines.peek()) is not None and line[0] > indent:
        raise YamlSubsetError(f"bad indentation at {line[1]!r}")
    return out


def load(text: str) -> Any:
    """The document in ``text`` as ``yaml.safe_load`` reads it."""
    lines = _Lines(text)
    first = lines.peek()
    if first is None:
        return None
    if len(lines.items) == 1 and _split_key(first[1]) is None and not _is_item(first[1]):
        return _inline(first[1])
    value = _block(lines, first[0])
    if lines.peek() is not None:
        raise YamlSubsetError(f"bad indentation at {lines.peek()[1]!r}")
    return value
