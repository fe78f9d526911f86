"""Read the YAML subset of ``configs/*.yaml`` without PyYAML.

The GPU host has no PyYAML, so the port reads its configs with this parser.
It takes exactly what the configs use and raises ``ValueError`` on anything
else rather than guess:

- ``key: value`` lines with a plain scalar: an int (``64``), a float
  (``0.0001``, ``1.5e-3``, ``1e-4``), ``true``/``false``, ``null``/``~`` or
  an empty value (None), a plain string (``cosine``), or a quoted string
  (``'.'``, ``"a b"``);
- flow lists of such scalars, ``[64, 64, 64]``;
- one level of nested mapping: ``predict:`` followed by indented
  ``key: value`` lines;
- full-line and trailing comments (``#`` after whitespace).

Anchors, aliases, tags, block scalars (``|``, ``>``), block lists
(``- item``), flow mappings, nested lists, deeper nesting, and scalars whose
YAML 1.1 and 1.2 readings differ (``yes``/``no``/``on``/``off``, ints with a
leading zero) raise.  On every file of ``configs/`` the result equals
``yaml.safe_load``'s.  One reading differs from PyYAML's: ``1e-4`` (an
exponent without a dot) is a float here, as in YAML 1.2, where PyYAML's
YAML 1.1 reads it as a string.
"""

from __future__ import annotations

import re

_KEY = re.compile(r"^([A-Za-z_][\w\-]*)\s*:(?:\s+(.*)|\s*)$")
_INT = re.compile(r"^[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^[-+]?(\d+\.\d*|\.\d+|\d+)([eE][-+]?\d+)?$")
_AMBIGUOUS = {"yes", "no", "on", "off", "y", "n"}


def _strip_comment(line: str) -> str:
    """``line`` without a trailing ``# ...`` comment outside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _scalar(text: str, where: str):
    t = text.strip()
    if t == "" or t in ("null", "Null", "NULL", "~"):
        return None
    if t[0] in "'\"":
        q = t[0]
        if len(t) < 2 or t[-1] != q:
            raise ValueError(f"{where}: unterminated or multi-line string {t!r}")
        body = t[1:-1]
        if q == "'":
            if "'" in body.replace("''", ""):
                raise ValueError(f"{where}: stray quote in {t!r}")
            return body.replace("''", "'")
        if "\\" in body or '"' in body:
            raise ValueError(f"{where}: escapes in double-quoted strings are not read: {t!r}")
        return body
    if t in ("true", "True", "TRUE"):
        return True
    if t in ("false", "False", "FALSE"):
        return False
    if t.lower() in _AMBIGUOUS:
        raise ValueError(f"{where}: {t!r} reads differently in YAML 1.1 and 1.2; quote it")
    if _INT.match(t):
        return int(t)
    if re.match(r"^[-+]?0[0-9]+$", t):
        raise ValueError(f"{where}: {t!r} has a leading zero (octal in YAML 1.1)")
    if _FLOAT.match(t):
        return float(t)
    if t[0] in "&*!|>%@`{}[],-?:" or ": " in t or t.endswith(":"):
        raise ValueError(f"{where}: unsupported YAML {t!r}")
    return t


def _value(text: str, where: str):
    t = text.strip()
    if t.startswith("["):
        if not t.endswith("]"):
            raise ValueError(f"{where}: unterminated or multi-line list {t!r}")
        body = t[1:-1].strip()
        if "[" in body or "]" in body or "{" in body:
            raise ValueError(f"{where}: nested collections are not read: {t!r}")
        return [] if body == "" else [_scalar(item, where) for item in body.split(",")]
    return _scalar(t, where)


def loads(text: str, name: str = "<string>") -> dict:
    """Parse a config from ``text``; ``name`` labels errors."""
    out: dict = {}
    nested, nested_indent = None, 0  # the mapping that indented lines fill
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{lineno}"
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"{where}: tab in indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        if line.strip() in ("---", "...") and indent == 0:
            raise ValueError(f"{where}: document markers are not read")
        m = _KEY.match(line.strip())
        if m is None:
            raise ValueError(f"{where}: not a 'key: value' line: {line.strip()!r}")
        key, rest = m.group(1), m.group(2)
        if indent == 0:
            if key in out:
                raise ValueError(f"{where}: duplicate key {key!r}")
            if rest is None:
                nested = out[key] = {}
            else:
                nested = None
                out[key] = _value(rest, where)
        else:
            if nested is None:
                raise ValueError(f"{where}: indented line outside a mapping")
            if rest is None:
                raise ValueError(f"{where}: mappings deeper than one level are not read")
            if nested and indent != nested_indent:
                raise ValueError(f"{where}: inconsistent indentation")
            nested_indent = indent
            if key in nested:
                raise ValueError(f"{where}: duplicate key {key!r}")
            nested[key] = _value(rest, where)
    # an empty nested block reads as null, as in YAML
    return {k: (None if isinstance(v, dict) and not v else v) for k, v in out.items()}


def load(path: str) -> dict:
    """Parse the config file at ``path``."""
    with open(path) as f:
        return loads(f.read(), path)
