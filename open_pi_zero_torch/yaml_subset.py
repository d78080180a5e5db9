"""A reader for the subset of YAML that the repo's configs use, with no
YAML package (the card's machine has none).

What it reads, with PyYAML ``safe_load``'s (YAML 1.1) results:
  - block mappings, nested by indentation (spaces only), one ``key: value``
    per line; a key with no value and nothing more indented under it is
    None;
  - flow sequences ``[a, b]`` and flow mappings ``{k: v}`` on one line,
    nested in each other;
  - single- and double-quoted scalars, which stay strings;
  - plain scalars resolved as YAML 1.1 resolves them: ``~``, ``null`` and
    the empty value are None; ``yes``/``no``/``on``/``off``/``true``/
    ``false`` (three casings each) are booleans; ints in decimal, octal
    (``0``-prefixed), hex, binary and base 60; floats only with a dot
    (``1e-6`` is the string "1e-6", ``1.0e-6`` a float) or ``.inf`` /
    ``.nan``; everything else a string;
  - ``#`` comments, at the start of a line or after a space.

Anything else (block sequences, multi-line scalars or flow collections,
anchors, aliases, tags, block scalars, directives, documents, duplicate
keys, timestamps, keys that resolve to no string) raises ``YamlError``
with the file and line: the reader never guesses.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

__all__ = ["YamlError", "load", "load_file", "parse_scalar_document"]


class YamlError(ValueError):
    """YAML outside the subset, or malformed, with where it was found."""

    def __init__(self, msg: str, source: str = "<string>", line: Optional[int] = None):
        where = source if line is None else f"{source}:{line}"
        super().__init__(f"{where}: {msg}")


# YAML 1.1's implicit resolvers, as PyYAML's resolver.py writes them
_BOOL = {
    **{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
    **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")},
}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"
)
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)
_TIMESTAMP = re.compile(
    r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+)[0-9][0-9]?"
    r":[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$"
)
_INDICATORS = set("[]{},#&*!|>'\"%@`")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, cast):
    sign = -1 if text.startswith("-") else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + cast(part)
    return sign * value


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t.startswith("-") else 1
    body = t.lstrip("+-")
    if ":" in body:
        return _sexagesimal(t, int)
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if body != "0" and body.startswith("0"):
        return sign * int(body, 8)
    return sign * int(body)


def _float(text: str) -> float:
    t = text.replace("_", "").lower()
    sign = -1.0 if t.startswith("-") else 1.0
    body = t.lstrip("+-")
    if body == ".inf":
        return sign * float("inf")
    if body == ".nan":
        return float("nan")
    if ":" in body:
        return _sexagesimal(t, float)
    return sign * float(body)


def resolve_plain(text: str, source: str = "<string>", line: Optional[int] = None) -> Any:
    """A plain scalar's value, as YAML 1.1 resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    if _TIMESTAMP.match(text) or text in ("=", "<<"):
        raise YamlError(f"{text!r} resolves to a type outside the subset", source, line)
    return text


class _Inline:
    """A cursor over one line's value: a scalar or a flow collection."""

    def __init__(self, text: str, source: str, line: Optional[int]):
        self.text, self.pos, self.source, self.line = text, 0, source, line

    def fail(self, msg: str):
        raise YamlError(msg, self.source, self.line)

    def skip_spaces(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def at_comment(self) -> bool:
        """A '#' at the start of the line or after a space: the rest of the
        line is a comment."""
        return self.peek() == "#" and (self.pos == 0 or self.text[self.pos - 1] in " \t")

    def at_end(self) -> bool:
        return not self.peek() or self.at_comment()

    def value(self, flow: bool) -> Any:
        self.skip_spaces()
        c = self.peek()
        if c == "[":
            return self.sequence()
        if c == "{":
            return self.mapping()
        if c in ("'", '"'):
            return self.quoted()
        return self.plain(flow)

    def plain(self, flow: bool, key: bool = False) -> Any:
        start = self.pos
        c = self.peek()
        nxt = self.text[self.pos + 1 : self.pos + 2]
        if c in _INDICATORS or (c and c in "-?:" and nxt in ("", " ", "\t") + ((",", "[", "]", "{", "}") if flow else ())):
            self.fail(f"a plain scalar cannot start with {c!r} here")
        stops = ",[]{}" if flow else ""
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c in stops or self.at_comment():
                break
            if c == ":" and self.text[self.pos + 1 : self.pos + 2] in ("", " ", "\t") + (tuple(stops) if flow else ()):
                if key:
                    break
                self.fail("a mapping inside a plain value is outside the subset")
            self.pos += 1
        return resolve_plain(self.text[start : self.pos].rstrip(" \t"), self.source, self.line)

    def quoted(self) -> str:
        quote = self.peek()
        self.pos += 1
        out: List[str] = []
        while True:
            if self.pos >= len(self.text):
                self.fail("a quoted scalar must close on its line")
            c = self.text[self.pos]
            if c == quote:
                if quote == "'" and self.text[self.pos + 1 : self.pos + 2] == "'":
                    out.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return "".join(out)
            if c == "\\" and quote == '"':
                esc = self.text[self.pos + 1 : self.pos + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    self.pos += 2
                    continue
                if esc in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[esc]
                    digits = self.text[self.pos + 2 : self.pos + 2 + n]
                    if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                        self.fail(f"bad escape \\{esc}{digits}")
                    out.append(chr(int(digits, 16)))
                    self.pos += 2 + n
                    continue
                self.fail(f"unknown escape \\{esc}")
            out.append(c)
            self.pos += 1

    def sequence(self) -> list:
        self.pos += 1  # [
        out = []
        while True:
            self.skip_spaces()
            if self.peek() == "]":
                self.pos += 1
                return out
            if self.at_end():
                self.fail("a flow sequence must close on its line")
            out.append(self.value(flow=True))
            self.skip_spaces()
            c = self.peek()
            if c == ",":
                self.pos += 1
            elif c != "]":
                self.fail(f"expected ',' or ']' in a flow sequence, got {c!r}")

    def mapping(self) -> dict:
        self.pos += 1  # {
        out: dict = {}
        while True:
            self.skip_spaces()
            if self.peek() == "}":
                self.pos += 1
                return out
            if self.at_end():
                self.fail("a flow mapping must close on its line")
            key = self.key(flow=True)
            self.skip_spaces()
            if self.peek() != ":":
                self.fail("a flow mapping entry needs 'key: value'")
            self.pos += 1
            self.skip_spaces()
            value = None if self.peek() in (",", "}") else self.value(flow=True)
            if key in out:
                self.fail(f"duplicate key {key!r}")
            out[key] = value
            self.skip_spaces()
            c = self.peek()
            if c == ",":
                self.pos += 1
            elif c != "}":
                self.fail(f"expected ',' or '}}' in a flow mapping, got {c!r}")

    def key(self, flow: bool) -> str:
        c = self.peek()
        key = self.quoted() if c in ("'", '"') else self.plain(flow, key=True)
        if not isinstance(key, str) or not key:
            self.fail(f"key {key!r} does not resolve to a string")
        return key

    def end(self):
        self.skip_spaces()
        if not self.at_end():
            self.fail(f"unexpected {self.text[self.pos:]!r} after the value")


def _lines(text: str, source: str) -> List[Tuple[int, int, str]]:
    """(line number, indent, content) of every line that holds more than a
    comment."""
    out = []
    for n, raw in enumerate(text.splitlines(), 1):
        body = raw.rstrip()
        if not body.strip() or body.lstrip(" \t").startswith("#"):
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t"):
            raise YamlError("tabs in indentation are outside the subset", source, n)
        if body.startswith(("---", "...", "%")):
            raise YamlError("documents and directives are outside the subset", source, n)
        out.append((n, len(body) - len(stripped), stripped))
    return out


def _block(lines, i: int, indent: int, source: str) -> Tuple[dict, int]:
    """The block mapping whose keys sit at ``indent``, from ``lines[i]``;
    returns it and the index of the first line after it."""
    out: dict = {}
    while i < len(lines):
        n, ind, content = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise YamlError("unexpected indentation", source, n)
        if content.startswith("- ") or content == "-":
            raise YamlError("block sequences are outside the subset", source, n)
        cur = _Inline(content, source, n)
        key = cur.key(flow=False)
        cur.skip_spaces()
        if cur.peek() != ":":
            raise YamlError("expected 'key: value'", source, n)
        cur.pos += 1
        cur.skip_spaces()
        if key in out:
            raise YamlError(f"duplicate key {key!r}", source, n)
        i += 1
        if not cur.at_end():
            if cur.peek() in "&*!|>":
                raise YamlError(f"{cur.peek()!r} (anchor, alias, tag or block scalar) is outside the subset",
                                source, n)
            out[key] = cur.value(flow=False)
            cur.end()
            if i < len(lines) and lines[i][1] > indent:
                raise YamlError("a value that goes on to the next line is outside the subset",
                                source, lines[i][0])
        elif i < len(lines) and lines[i][1] > indent:
            out[key], i = _block(lines, i, lines[i][1], source)
        else:
            if i < len(lines) and lines[i][1] == indent and lines[i][2].startswith("-"):
                raise YamlError("block sequences are outside the subset", source, lines[i][0])
            out[key] = None
    return out, i


def load(text: str, source: str = "<string>") -> Any:
    """The document in ``text``: a mapping, or None when it holds nothing."""
    lines = _lines(text, source)
    if not lines:
        return None
    if lines[0][1] != 0:
        raise YamlError("the document must start at column 0", source, lines[0][0])
    out, i = _block(lines, 0, 0, source)
    if i != len(lines):
        raise YamlError("unexpected indentation", source, lines[i][0])
    return out


def load_file(path: str) -> Any:
    with open(path) as f:
        return load(f.read(), path)


def parse_scalar_document(text: str, source: str = "<string>") -> Any:
    """A one-line document that is a value, not a mapping: a scalar or a
    flow collection (the value of a ``key=value`` override)."""
    body = text.strip()
    if "\n" in body:
        raise YamlError("a value on more than one line is outside the subset", source)
    if body[:1] in ("&", "*", "!", "|", ">", "%") or body.startswith(("---", "...")):
        raise YamlError(f"{body[:1]!r} is outside the subset", source)
    cur = _Inline(body, source, None)
    if body.startswith("- ") or body == "-":
        cur.fail("block sequences are outside the subset")
    value = None if cur.at_end() else cur.value(flow=False)
    cur.end()
    return value
