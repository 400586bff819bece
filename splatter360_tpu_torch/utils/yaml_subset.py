"""A reader of the YAML subset that the repository's configs use.

config.load_config reads YAML with PyYAML where it is installed; the card's
machine has no PyYAML, and there this reader gives the same values as
yaml.safe_load for the subset: block mappings nested by indentation (spaces
only), flow lists of scalars (`[512, 1024]`, `[]`), plain, single- and
double-quoted scalars (no escapes), comments, and the empty flow mapping
`{}`. Plain scalars resolve as PyYAML's YAML 1.1 rules do: null (`~`,
`null`, empty), booleans (`true`, `yes`, `on`, ...), decimal integers and
floats (`2.0e-4` is a float, `1e-4` a string). Anything else (block
sequences, anchors, tags, multi-line scalars, octal/hex/sexagesimal numbers,
dates, nested flow collections, escapes) raises ValueError naming the line,
so no file outside the subset is read with another meaning.
"""

from __future__ import annotations

import re

_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?")
_INF_NAN = {".inf": float("inf"), ".Inf": float("inf"), ".INF": float("inf"),
            "+.inf": float("inf"), "+.Inf": float("inf"), "+.INF": float("inf"),
            "-.inf": float("-inf"), "-.Inf": float("-inf"), "-.INF": float("-inf")}
_NAN = {".nan", ".NaN", ".NAN"}
# forms PyYAML resolves to other types (binary, octal, hex, sexagesimal
# numbers, dates, merge keys): outside the subset
_REFUSED = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
                      r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                      r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=")
_INDICATORS = "&*!|>%@`{}?"


class _Error(ValueError):
    pass


def _strip_comment(text: str) -> str:
    """Drop a `#` comment that starts the text or follows whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t[,"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _scalar(text: str, where: str):
    t = text.strip()
    if t[:1] in "'\"":
        q = t[0]
        if len(t) < 2 or t[-1] != q or q in t[1:-1] or (q == '"' and "\\" in t):
            raise _Error(f"{where}: quoted scalar outside the subset: {t!r}")
        return t[1:-1]
    if t[:1] in _INDICATORS or t[:1] == "[" or t == "-" or t.startswith("- "):
        raise _Error(f"{where}: {t!r} is outside the YAML subset")
    if t in _NULL:
        return None
    if t in _TRUE:
        return True
    if t in _FALSE:
        return False
    if _REFUSED.fullmatch(t) and not _INT.fullmatch(t):
        raise _Error(f"{where}: {t!r} is outside the YAML subset")
    if _INT.fullmatch(t):
        return int(t.replace("_", ""))
    if _FLOAT.fullmatch(t):
        return float(t.replace("_", ""))
    if t in _INF_NAN:
        return _INF_NAN[t]
    if t in _NAN:
        return float("nan")
    if ": " in t or t.endswith(":") or " #" in t:
        raise _Error(f"{where}: {t!r} is outside the YAML subset")
    return t


def _value(text: str, where: str):
    t = text.strip()
    if t.startswith("["):
        if not t.endswith("]") or "[" in t[1:] or "]" in t[:-1] or "{" in t:
            raise _Error(f"{where}: flow list outside the subset: {t!r}")
        inner = t[1:-1].strip()
        return [] if not inner else [_scalar(x, where) for x in inner.split(",")]
    if t.startswith("{"):
        if t.replace(" ", "") != "{}":
            raise _Error(f"{where}: flow mappings other than {{}} are outside the subset")
        return {}
    return _scalar(t, where)


def _split_key(content: str, where: str):
    """'key: value' / 'key:' -> (key, rest) or None when not a mapping entry."""
    if content.endswith(":"):
        key, rest = content[:-1], ""
    elif ": " in content:
        key, rest = content.split(": ", 1)
    else:
        return None
    key = key.strip()
    if not key or key[0] in _INDICATORS + "[]'\"-#":
        raise _Error(f"{where}: mapping key {key!r} is outside the YAML subset")
    return key, rest


def safe_load(text: str):
    """yaml.safe_load for the subset above."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"line {n}"
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise _Error(f"{where}: tab indentation is outside the subset")
        content = _strip_comment(raw)
        if not content.strip():
            continue
        if content.strip() in ("---", "..."):
            raise _Error(f"{where}: document markers are outside the subset")
        lines.append((len(content) - len(content.lstrip(" ")), content.strip(), where))
    if not lines:
        return None
    if _split_key(lines[0][1], lines[0][2]) is None:
        if len(lines) > 1:
            raise _Error(f"{lines[1][2]}: multi-line scalars are outside the subset")
        return _value(lines[0][1], lines[0][2])
    out, pos = _mapping(lines, 0, lines[0][0])
    if pos != len(lines):
        raise _Error(f"{lines[pos][2]}: unexpected indentation")
    return out


def _mapping(lines, pos: int, indent: int):
    out: dict = {}
    while pos < len(lines):
        ind, content, where = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise _Error(f"{where}: unexpected indentation")
        if content.startswith("- ") or content == "-":
            raise _Error(f"{where}: block sequences are outside the subset")
        entry = _split_key(content, where)
        if entry is None:
            raise _Error(f"{where}: expected `key: value`, got {content!r}")
        key, rest = entry
        if key in out:
            raise _Error(f"{where}: duplicate key {key!r}")
        pos += 1
        if rest.strip():
            out[key] = _value(rest, where)
        elif pos < len(lines) and lines[pos][0] > indent:
            out[key], pos = _mapping(lines, pos, lines[pos][0])
        else:
            out[key] = None
    return out, pos
