"""The subset of YAML that the mission configs use: one parser and one
emitter, so that the port needs no YAML package.

Parsed: `#` comments, block mappings, block sequences (also nested on one
line, `- - 0`, and at the indentation of their key), flow sequences
(`[0.2, 0.2, 0.2]`, `[[0, 0, 1, 0], ...]`), and plain or quoted scalars,
which resolve as PyYAML's `safe_load` resolves them (YAML 1.1): null, bools
(`true`, `yes`, `on`, ... in their three spellings), decimal ints, floats
(with a dot, as YAML 1.1 requires, or `.inf` / `.nan`), else a string.
Anything else (flow mappings, anchors, tags, block scalars, several
documents) raises ValueError.
"""

from __future__ import annotations

import math
import re

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
# PyYAML's resolver patterns; its binary, octal, hex, sexagesimal and
# timestamp forms, which the configs never use, are refused (`_OTHER`)
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_OTHER = re.compile(
    r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}|<<$|=$"
)
_UNSUPPORTED = tuple("{&*!|>%@`")


def scalar(text: str):
    """A plain or quoted scalar, resolved as `yaml.safe_load` resolves it."""
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] == "'":
        return s[1:-1].replace("''", "'")
    if len(s) >= 2 and s[0] == s[-1] == '"':
        if "\\" in s:
            raise ValueError(f"escapes in double-quoted scalars are not supported: {s}")
        return s[1:-1]
    if s.startswith(_UNSUPPORTED) or _OTHER.match(s):
        raise ValueError(f"unsupported YAML: {s}")
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return -math.inf if s[0] == "-" else math.inf
    if _NAN.match(s):
        return math.nan
    return s


def _flow(text: str, pos: int = 0):
    """The flow sequence starting at text[pos] == '['. Returns (list, the
    position after its ']')."""
    items, pos, item = [], pos + 1, ""
    while pos < len(text):
        c = text[pos]
        if c == "[":
            if item.strip():
                raise ValueError(f"unsupported flow sequence: {text}")
            sub, pos = _flow(text, pos)
            items.append(sub)
            item = None  # this item is done; only a comma or ']' may follow
            continue
        if c in ",]":
            if item is not None and (item.strip() or c == ","):
                items.append(scalar(item))
            if c == "]":
                return items, pos + 1
            item = ""
        elif item is None:
            if not c.isspace():
                raise ValueError(f"unsupported flow sequence: {text}")
        else:
            item += c
        pos += 1
    raise ValueError(f"unclosed flow sequence: {text}")


def value(text: str):
    """A scalar or a flow sequence (the value of a key, a sequence item or a
    command-line override)."""
    s = text.strip()
    if s == "{}":
        return {}
    if s.startswith("["):
        out, end = _flow(s)
        if s[end:].strip():
            raise ValueError(f"text after a flow sequence: {s}")
        return out
    return scalar(s)


def _strip_comment(line: str) -> str:
    """`line` without a comment: a `#` that starts the line or follows a
    space, outside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            quote = None if c == quote else quote
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def _lines(text: str) -> list[list]:
    out = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line.strip() in ("---", "...") or "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"unsupported YAML line: {raw!r}")
        out.append([len(line) - len(line.lstrip(" ")), line.strip()])
    return out


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _key(content: str):
    """(key, rest) of a `key: rest` line, or None."""
    m = re.match(r"([^\s'\"\[\]{}#:,-][^:#]*?|-[^\s:#][^:#]*?):(?:\s+|$)(.*)$", content)
    return (m.group(1), m.group(2)) if m else None


def _block(lines: list, i: int, indent: int):
    """The block node whose lines start at lines[i], at `indent`. Returns
    (node, the index of the first line after it)."""
    if _is_item(lines[i][1]):
        out = []
        while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
            rest = lines[i][1][1:].lstrip()
            if not rest:  # the item's node starts on the next, deeper line
                if i + 1 < len(lines) and lines[i + 1][0] > indent:
                    node, i = _block(lines, i + 1, lines[i + 1][0])
                else:
                    node, i = None, i + 1
            elif _is_item(rest) or _key(rest):
                # a node on the item's own line: read it as a line at the
                # column where it starts
                col = indent + len(lines[i][1]) - len(rest)
                lines[i] = [col, rest]
                node, i = _block(lines, i, col)
            else:
                node, i = value(rest), i + 1
            out.append(node)
        return out, i
    out = {}
    while i < len(lines) and lines[i][0] == indent and not _is_item(lines[i][1]):
        kv = _key(lines[i][1])
        if kv is None:
            raise ValueError(f"expected `key: value`, got {lines[i][1]!r}")
        key, rest = kv
        key = scalar(key)
        if key in out:
            raise ValueError(f"duplicate key {key!r}")
        i += 1
        if rest:
            out[key] = value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (lines[i][0] == indent and _is_item(lines[i][1]))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def loads(text: str):
    """The document `text` holds (None for an empty one)."""
    lines = _lines(text)
    if not lines:
        return None
    node, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return node


# --------------------------------------------------------------------------
# emitter
# --------------------------------------------------------------------------


def _emit_scalar(v) -> str:
    if isinstance(v, (dict, list)):  # empty: a non-empty one is a block
        return "{}" if isinstance(v, dict) else "[]"
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r and "." not in r:  # YAML 1.1 reads a float only with a dot
            r = r.replace("e", ".0e")
        return r
    if isinstance(v, str):
        plain = (
            v == v.strip()
            and v
            and not v.startswith(("-", "?", ":", ",", "[", "]", "#", "'", '"', *_UNSUPPORTED))
            and not _OTHER.match(v)
            and ": " not in v
            and " #" not in v
            and not v.endswith(":")
            and scalar(v) == v
        )
        return v if plain else "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot emit {type(v).__name__}")


def _emit(node, indent: int, out: list) -> None:
    pad = " " * indent
    if isinstance(node, dict):
        for k in sorted(node, key=str):
            v = node[k]
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}{_emit_scalar(k)}:")
                _emit(v, indent + 2 if isinstance(v, dict) else indent, out)
            else:
                out.append(f"{pad}{_emit_scalar(k)}: {_emit_scalar(v)}")
    else:
        for v in node:
            if isinstance(v, (dict, list)) and v:
                sub = []
                _emit(v, indent + 2, sub)
                out.append(f"{pad}- {sub[0].lstrip()}")
                out.extend(sub[1:])
            else:
                out.append(f"{pad}- {_emit_scalar(v)}")


def dumps(node: dict) -> str:
    """`node` (nested dicts, lists and scalars) as block YAML, keys sorted,
    that `loads` (and `yaml.safe_load`) read back as `node`."""
    out: list[str] = []
    _emit(node, 0, out)
    return "\n".join(out) + "\n"
