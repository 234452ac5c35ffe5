"""Protobuf text-format parser (no protobuf runtime dependency).

The reference system's public API is a pair of text-format protobuf files
(`model.conf`, `cluster.conf`) read by ``ReadProtoFromTextFile``
(reference: src/utils/common.cc:56-64). This module parses that syntax into
plain nested Python structures; ``singa_tpu.config.schema`` then applies
typed field definitions and defaults.

Supported syntax (everything the reference configs use, plus the common
text-format extras):

  key: value            # scalar field (int/float/bool/enum-ident/"string")
  key { ... }           # sub-message
  key: { ... }          # sub-message, colon form
  repeated fields       # same key occurring multiple times accumulates
  # line comments       # anywhere, including inside messages

Values are returned as Python ints/floats/bools/strings; enum identifiers
(e.g. ``kSGD``, ``MAX``) are returned as strings and resolved by the schema
layer.
"""

from __future__ import annotations

import re
from typing import Any

_TOKEN_RE = re.compile(
    r"""
    \s+
  | \#[^\n]*                          # comment
  | (?P<brace>[{}])
  | (?P<colon>:)
  | (?P<string>"(?:\\.|[^"\\])*")
  | (?P<number>[-+]?(?:\.\d+|\d+\.?\d*)(?:[eE][-+]?\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.]*)
    """,
    re.VERBOSE,
)

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\", "'": "'"}


class TextProtoError(ValueError):
    """Raised on malformed text-format input."""


def _unquote(tok: str) -> str:
    body = tok[1:-1]
    out = []
    i = 0
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            nxt = body[i + 1]
            if nxt in _ESCAPES:
                out.append(_ESCAPES[nxt])
                i += 2
                continue
            if nxt in "01234567":  # octal escape (max 3 octal digits)
                j = i + 1
                while j < len(body) and j < i + 4 and body[j] in "01234567":
                    j += 1
                # protobuf truncates a 3-digit octal escape to one byte
                out.append(chr(int(body[i + 1 : j], 8) & 0xFF))
                i = j
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _tokenize_spans(text: str) -> list[tuple[str, Any, int, int]]:
    """Lex text-format input into (kind, value, line, col) tokens.

    ``line`` is 1-based, ``col`` 1-based (editor convention; diagnostics
    render them as ``path:LINE:COL``). The span points at the token's
    first character in the ORIGINAL text — for strings that is the
    opening quote, before unescaping."""
    tokens: list[tuple[str, Any, int, int]] = []
    pos = 0
    line = 1
    bol = 0  # offset of the current line's first character
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            line = text.count("\n", 0, pos) + 1
            raise TextProtoError(
                f"unexpected character {text[pos]!r} at line {line}"
            )
        start = m.start()  # == pos: the regex alternation is anchored
        col = start - bol + 1
        pos = m.end()
        if m.lastgroup is None:
            # whitespace / comment: advance the line counter through it
            nl = text.count("\n", start, pos)
            if nl:
                line += nl
                bol = text.rfind("\n", start, pos) + 1
            continue
        val = m.group(m.lastgroup)
        if m.lastgroup == "string":
            tokens.append(("string", _unquote(val), line, col))
        elif m.lastgroup == "number":
            if re.search(r"[.eE]", val):
                tokens.append(("number", float(val), line, col))
            else:
                tokens.append(("number", int(val), line, col))
        elif m.lastgroup == "ident":
            if val == "true":
                tokens.append(("bool", True, line, col))
            elif val == "false":
                tokens.append(("bool", False, line, col))
            else:
                tokens.append(("ident", val, line, col))
        else:
            tokens.append((m.lastgroup, val, line, col))
    return tokens


def tokenize(text: str) -> list[tuple[str, Any]]:
    """Lex text-format input into (kind, value) tokens."""
    return [(kind, val) for kind, val, _, _ in _tokenize_spans(text)]


#: message-nesting bound: real confs are ~4 deep; the recursive-descent
#: parser must fail with TextProtoError, not RecursionError, on
#: pathological input (tests/test_textproto_fuzz.py)
_MAX_DEPTH = 100


class FieldLoc:
    """(line, col) spans for one field occurrence: where the key token
    sits, where the value token sits (None for message blocks), and —
    for message values — the sub-message's own {field: [FieldLoc]} tree,
    parallel to the parse tree. Spans are 1-based."""

    __slots__ = ("key", "value", "sub")

    def __init__(self, key, value=None, sub=None):
        self.key = key        # (line, col) of the field-name token
        self.value = value    # (line, col) of the scalar value token
        self.sub = sub        # {fname: [FieldLoc]} for message values

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FieldLoc(key={self.key}, value={self.value})"


class _Parser:
    def __init__(self, tokens: list[tuple[str, Any, int, int]]):
        self.tokens = tokens
        self.pos = 0
        self.depth = 0
        #: parallel loc tree for the most recent parse_message call
        self.locs: dict[str, list[FieldLoc]] = {}

    def peek(self) -> tuple[str, Any] | None:
        if self.pos < len(self.tokens):
            return self.tokens[self.pos][:2]
        return None

    def peek_span(self) -> tuple[int, int]:
        kind, val, line, col = self.tokens[self.pos]
        return line, col

    def next(self) -> tuple[str, Any]:
        tok = self.peek()
        if tok is None:
            raise TextProtoError("unexpected end of input")
        self.pos += 1
        return tok

    def parse_message(self, *, toplevel: bool = False) -> dict[str, list[Any]]:
        """Parse fields until '}' (or EOF at top level).

        Every field maps to a *list* of occurrences; the schema layer decides
        whether a field is repeated (keep the list), a scalar (take the last
        occurrence), or a non-repeated message (merge occurrences field-wise,
        matching protobuf text-format merge semantics). After the call,
        ``self.locs`` holds the parallel {field: [FieldLoc]} span tree.
        """
        self.depth += 1
        if self.depth > _MAX_DEPTH:
            raise TextProtoError(
                f"message nesting deeper than {_MAX_DEPTH} levels"
            )
        try:
            fields, locs = self._parse_fields(toplevel=toplevel)
            self.locs = locs
            return fields
        finally:
            self.depth -= 1

    def _parse_fields(
        self, *, toplevel: bool
    ) -> tuple[dict[str, list[Any]], dict[str, list[FieldLoc]]]:
        fields: dict[str, list[Any]] = {}
        locs: dict[str, list[FieldLoc]] = {}
        while True:
            tok = self.peek()
            if tok is None:
                if toplevel:
                    return fields, locs
                raise TextProtoError("unexpected end of input: missing '}'")
            if tok == ("brace", "}"):
                if toplevel:
                    raise TextProtoError("unbalanced '}' at top level")
                self.next()
                return fields, locs
            key_span = self.peek_span()
            kind, name = self.next()
            if kind != "ident":
                raise TextProtoError(f"expected field name, got {name!r}")
            floc = FieldLoc(key_span)
            tok = self.peek()
            if tok == ("colon", ":"):
                self.next()
                tok = self.peek()
                if tok == ("brace", "{"):
                    self.next()
                    value: Any = self.parse_message()
                    floc.sub = self.locs
                else:
                    if tok is not None:
                        floc.value = self.peek_span()
                    vkind, value = self.next()
                    if vkind not in ("string", "number", "bool", "ident"):
                        raise TextProtoError(
                            f"bad value for field {name!r}: {value!r}"
                        )
            elif tok == ("brace", "{"):
                self.next()
                value = self.parse_message()
                floc.sub = self.locs
            else:
                raise TextProtoError(
                    f"expected ':' or '{{' after field {name!r}"
                )
            fields.setdefault(name, []).append(value)
            locs.setdefault(name, []).append(floc)


def parse(text: str) -> dict[str, list[Any]]:
    """Parse text-format protobuf into {field: [occurrences...]}."""
    return _Parser(_tokenize_spans(text)).parse_message(toplevel=True)


def parse_with_locs(
    text: str,
) -> tuple[dict[str, list[Any]], dict[str, list[FieldLoc]]]:
    """Parse like :func:`parse`, additionally returning the parallel
    {field: [FieldLoc]} span tree: one FieldLoc per occurrence, in the
    same order as the parse tree's occurrence lists, with ``sub`` trees
    for message values. netlint threads these spans into Diagnostic
    locations (``path:LINE:COL``) so findings point at the offending
    token instead of a grep'd needle."""
    p = _Parser(_tokenize_spans(text))
    tree = p.parse_message(toplevel=True)
    return tree, p.locs


def parse_file(path: str) -> dict[str, list[Any]]:
    with open(path, "r", encoding="utf-8") as f:
        return parse(f.read())
