"""Textual pass-pipeline syntax (the ``hls.compile`` front end, DESIGN.md §6).

An MLIR-style comma-separated pipeline string maps one-to-one onto a list of
``transforms.Pass`` objects:

    "normalize,fuse{shift=true,min_core_fraction=0.5},tile{sizes=8,8},unroll{factor=2}"

Grammar (whitespace allowed around every token):

    pipeline :=  [ pass ("," pass)* ]
    pass     :=  NAME [ "{" param ("," param)* "}" ]
    param    :=  KEY "=" value ("," value)*       # extra bare values extend
    value    :=  INT | FLOAT | "true" | "false" | IDENT

so ``tile{sizes=8,8}`` parses ``sizes`` as the list ``[8, 8]`` (a comma
inside braces extends the previous key's value list).  Pass names come from
``transforms.PASS_TAGS``; parameter validation is each pass's ``build()``.

``parse_pipeline`` and ``print_pipeline`` round-trip:

    parse(print(parse(text)))  ==structurally==  parse(text)

(asserted by the property tests in tests/test_api.py).  Errors are
``PipelineSyntaxError`` carrying the source position and a caret line —
the compile front end shows them verbatim.
"""
from __future__ import annotations

import re
from typing import Sequence

from .transforms import PASS_TAGS, Pass, TransformError


class PipelineSyntaxError(ValueError):
    """A malformed pipeline string, with the offending source position."""

    def __init__(self, message: str, text: str, pos: int):
        self.message = message
        self.text = text
        self.pos = pos
        caret = " " * pos + "^"
        super().__init__(
            f"{message}\n  at position {pos}:\n    {text}\n    {caret}")


_NAME = re.compile(r"[A-Za-z_][A-Za-z_0-9.]*")
_VALUE = re.compile(r"[^,={}\s]+")


class _Cursor:
    def __init__(self, text: str):
        self.text = text
        self.i = 0

    def skip_ws(self) -> None:
        while self.i < len(self.text) and self.text[self.i].isspace():
            self.i += 1

    def peek(self) -> str:
        self.skip_ws()
        return self.text[self.i] if self.i < len(self.text) else ""

    def expect(self, ch: str, what: str) -> None:
        if self.peek() != ch:
            got = repr(self.peek()) if self.peek() else "end of input"
            raise PipelineSyntaxError(
                f"expected '{ch}' {what}, got {got}", self.text, self.i)
        self.i += 1

    def match_re(self, rx: re.Pattern, what: str) -> str:
        self.skip_ws()
        m = rx.match(self.text, self.i)
        if not m:
            got = repr(self.text[self.i]) if self.i < len(self.text) \
                else "end of input"
            raise PipelineSyntaxError(
                f"expected {what}, got {got}", self.text, self.i)
        self.i = m.end()
        return m.group(0)

    def done(self) -> bool:
        self.skip_ws()
        return self.i >= len(self.text)


def _typed(tok: str):
    """int / float / bool / bare identifier."""
    if re.fullmatch(r"-?\d+", tok):
        return int(tok)
    try:
        return float(tok)
    except ValueError:
        pass
    if tok == "true":
        return True
    if tok == "false":
        return False
    return tok


def _parse_params(cur: _Cursor) -> dict:
    """The ``{...}`` parameter block.  A bare value (no ``=``) extends the
    previous key's value list, so ``sizes=8,8`` is ``{"sizes": [8, 8]}``."""
    params: dict = {}
    last_key = None
    cur.expect("{", "to open the parameter block")
    if cur.peek() == "}":
        cur.i += 1
        return params
    while True:
        start = cur.i
        cur.skip_ws()
        start = cur.i
        tok = cur.match_re(_VALUE, "a parameter (key=value)")
        if cur.peek() == "=":
            cur.i += 1
            key = tok
            if not _NAME.fullmatch(key):
                raise PipelineSyntaxError(
                    f"invalid parameter name {key!r}", cur.text, start)
            if key in params:
                raise PipelineSyntaxError(
                    f"duplicate parameter {key!r}", cur.text, start)
            val = _typed(cur.match_re(_VALUE, f"a value for '{key}'"))
            params[key] = val
            last_key = key
        else:
            # bare value: extend the previous key's list
            if last_key is None:
                raise PipelineSyntaxError(
                    f"value {tok!r} has no parameter name (write key=value)",
                    cur.text, start)
            prev = params[last_key]
            if not isinstance(prev, list):
                prev = params[last_key] = [prev]
            prev.append(_typed(tok))
        nxt = cur.peek()
        if nxt == ",":
            cur.i += 1
            continue
        if nxt == "}":
            cur.i += 1
            return params
        got = repr(nxt) if nxt else "end of input"
        raise PipelineSyntaxError(
            f"expected ',' or '}}' in the parameter block, got {got}",
            cur.text, cur.i)


def parse_pipeline(text: str) -> list[Pass]:
    """Parse a textual pass pipeline into ``Pass`` objects.

    Raises ``PipelineSyntaxError`` (with the source position) on malformed
    syntax, unknown pass names, and invalid pass parameters.
    """
    if not isinstance(text, str):
        raise TypeError(f"pipeline must be a string, got {type(text).__name__}")
    cur = _Cursor(text)
    passes: list[Pass] = []
    if cur.done():
        return passes
    while True:
        cur.skip_ws()
        start = cur.i
        name = cur.match_re(_NAME, "a pass name")
        cls = PASS_TAGS.get(name)
        if cls is None:
            raise PipelineSyntaxError(
                f"unknown pass {name!r} (known: {', '.join(sorted(PASS_TAGS))})",
                text, start)
        params = _parse_params(cur) if cur.peek() == "{" else {}
        try:
            passes.append(cls.build(params))
        except TransformError as e:
            raise PipelineSyntaxError(str(e), text, start) from e
        if cur.done():
            return passes
        cur.expect(",", "between passes")
        if cur.done():
            raise PipelineSyntaxError(
                "trailing ',' with no pass after it", text, len(text) - 1)


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        s = repr(v)
        return s
    return str(v)


def _fmt_param(key: str, val) -> str:
    if isinstance(val, (list, tuple)):
        return f"{key}=" + ",".join(_fmt_value(x) for x in val)
    return f"{key}={_fmt_value(val)}"


def print_pipeline(passes: Sequence[Pass]) -> str:
    """The textual form of a pass list; inverse of ``parse_pipeline``."""
    out = []
    for ps in passes:
        if not isinstance(ps, Pass):
            raise TypeError(f"not a Pass: {ps!r}")
        params = ps.params()
        if params:
            body = ",".join(_fmt_param(k, v) for k, v in params.items())
            out.append(f"{ps.tag}{{{body}}}")
        else:
            out.append(ps.tag)
    return ",".join(out)
