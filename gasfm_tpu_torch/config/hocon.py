"""Minimal HOCON-subset parser and config tree: the port's own copy of the
JAX package's config/hocon.py, unchanged but for this sentence.

The reference uses pyhocon for its `.conf` files (reference:
code/main.py:56-109, code/confs/*.conf). pyhocon is not available in this
environment, so this module implements the HOCON subset those files (and our
own configs) actually use:

- ``key = value`` and ``key : value`` assignments
- nested objects ``name { ... }`` (with or without ``=``)
- dotted keys ``a.b.c = v``
- lists ``[a, b]`` including newline-separated multi-line lists
- strings (quoted and unquoted), ints, floats, booleans, ``null``
- ``#`` and ``//`` comments
- later assignments override earlier ones; objects merge

The public API mirrors the pyhocon surface the reference relies on:
``ConfigTree.get_int/get_float/get_bool/get_string/get_list/get_config/get``
with optional defaults, plus ``put`` for programmatic overrides
(reference: code/multiple_scenes_learning.py:120-129) and flattening/schema
checking (reference: code/utils/general_utils.py:249-296).
"""

from __future__ import annotations

import copy as _copy
import io
import re
from typing import Any, Dict, Iterator, List, Optional, Tuple

_UNSET = object()


class ConfigMissingError(KeyError):
    pass


class ConfigTree:
    """An ordered, nested mapping with dotted-path access."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self._data: Dict[str, Any] = {}
        if data:
            for k, v in data.items():
                self.put(k, _wrap(v))

    # -- core access ------------------------------------------------------

    def get(self, path: str, default: Any = _UNSET) -> Any:
        node: Any = self
        for part in path.split("."):
            if isinstance(node, ConfigTree) and part in node._data:
                node = node._data[part]
            else:
                if default is _UNSET:
                    raise ConfigMissingError(f"No configuration setting found for key {path!r}")
                return default
        return node

    def put(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            child = node._data.get(part)
            if not isinstance(child, ConfigTree):
                child = ConfigTree()
                node._data[part] = child
            node = child
        value = _wrap(value)
        existing = node._data.get(parts[-1])
        if isinstance(existing, ConfigTree) and isinstance(value, ConfigTree):
            existing.merge(value)
        else:
            node._data[parts[-1]] = value

    def merge(self, other: "ConfigTree") -> None:
        for k, v in other._data.items():
            if isinstance(v, ConfigTree) and isinstance(self._data.get(k), ConfigTree):
                self._data[k].merge(v)
            else:
                self._data[k] = _copy.deepcopy(v)

    # -- typed getters (pyhocon-compatible surface) -----------------------

    def get_int(self, path: str, default: Any = _UNSET) -> Optional[int]:
        v = self.get(path, default)
        return None if v is None else int(v)

    def get_float(self, path: str, default: Any = _UNSET) -> Optional[float]:
        v = self.get(path, default)
        return None if v is None else float(v)

    def get_bool(self, path: str, default: Any = _UNSET) -> Optional[bool]:
        v = self.get(path, default)
        if v is None:
            return None
        if isinstance(v, str):
            return v.strip().lower() in ("true", "yes", "on", "1")
        return bool(v)

    def get_string(self, path: str, default: Any = _UNSET) -> Optional[str]:
        v = self.get(path, default)
        return None if v is None else str(v)

    def get_list(self, path: str, default: Any = _UNSET) -> Optional[list]:
        v = self.get(path, default)
        if v is None:
            return None
        if not isinstance(v, list):
            raise TypeError(f"Key {path!r} is not a list: {v!r}")
        return v

    def get_config(self, path: str, default: Any = _UNSET) -> "ConfigTree":
        v = self.get(path, default)
        if v is not None and not isinstance(v, ConfigTree):
            raise TypeError(f"Key {path!r} is not a config object: {v!r}")
        return v

    # -- misc -------------------------------------------------------------

    def __contains__(self, path: str) -> bool:
        return self.get(path, None) is not None or self._has(path)

    def _has(self, path: str) -> bool:
        node: Any = self
        for part in path.split("."):
            if isinstance(node, ConfigTree) and part in node._data:
                node = node._data[part]
            else:
                return False
        return True

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self._data.items():
            out[k] = v.to_dict() if isinstance(v, ConfigTree) else _copy.deepcopy(v)
        return out

    def flatten(self, prefix: str = "") -> Dict[str, Any]:
        """Flatten to {dotted.path: leaf_value}."""
        out: Dict[str, Any] = {}
        for k, v in self._data.items():
            p = f"{prefix}{k}"
            if isinstance(v, ConfigTree):
                if not v._data:
                    out[p] = {}
                else:
                    out.update(v.flatten(p + "."))
            else:
                out[p] = v
        return out

    def copy(self) -> "ConfigTree":
        return _copy.deepcopy(self)

    def __deepcopy__(self, memo):
        new = ConfigTree()
        for k, v in self._data.items():
            new._data[k] = _copy.deepcopy(v, memo)
        return new

    def __repr__(self):
        return f"ConfigTree({self.to_dict()!r})"

    def __eq__(self, other):
        return isinstance(other, ConfigTree) and self.to_dict() == other.to_dict()

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ConfigTree":
        return _wrap(d)


def _wrap(v: Any) -> Any:
    if isinstance(v, ConfigTree):
        return v
    if isinstance(v, dict):
        t = ConfigTree()
        for k, val in v.items():
            t.put(str(k), _wrap(val))
        return t
    if isinstance(v, (list, tuple)):
        return [_wrap(x) for x in v]
    return v


# ---------------------------------------------------------------------------
# Tokenizer / parser
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[ \t\r]+)
  | (?P<comment>(\#|//)[^\n]*)
  | (?P<newline>\n)
  | (?P<lbrace>\{) | (?P<rbrace>\})
  | (?P<lbracket>\[) | (?P<rbracket>\])
  | (?P<comma>,)
  | (?P<assign>[=:])
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<bareword>[^\s{}\[\],=:\#]+)
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> Iterator[Tuple[str, str]]:
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ValueError(f"HOCON tokenize error at position {pos}: {text[pos:pos+40]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        yield kind, m.group()
    yield "eof", ""


class _Parser:
    def __init__(self, text: str):
        self.tokens: List[Tuple[str, str]] = list(_tokenize(text))
        self.i = 0

    def peek(self) -> Tuple[str, str]:
        return self.tokens[self.i]

    def next(self) -> Tuple[str, str]:
        t = self.tokens[self.i]
        self.i += 1
        return t

    def skip_newlines(self):
        while self.peek()[0] in ("newline", "comma"):
            self.next()

    def parse_root(self) -> ConfigTree:
        tree = ConfigTree()
        self.skip_newlines()
        if self.peek()[0] == "lbrace":
            return self.parse_object()
        # Braceless root object
        while self.peek()[0] != "eof":
            self.parse_entry(tree)
            self.skip_newlines()
        return tree

    def parse_object(self) -> ConfigTree:
        assert self.next()[0] == "lbrace"
        tree = ConfigTree()
        self.skip_newlines()
        while self.peek()[0] != "rbrace":
            if self.peek()[0] == "eof":
                raise ValueError("Unexpected EOF inside object")
            self.parse_entry(tree)
            self.skip_newlines()
        self.next()  # rbrace
        return tree

    def parse_entry(self, tree: ConfigTree):
        kind, tok = self.next()
        if kind == "string":
            key = _unquote(tok)
        elif kind == "bareword":
            key = tok
        else:
            raise ValueError(f"Expected key, got {kind} {tok!r}")
        # Object value may start on the same line or after newlines.
        save = self.i
        while self.peek()[0] == "newline":
            self.next()
        if self.peek()[0] != "lbrace":
            self.i = save
        kind, tok = self.peek()
        if kind == "lbrace":
            value = self.parse_object()
        elif kind == "assign":
            self.next()
            self.skip_ws_newline_before_value()
            value = self.parse_value()
        else:
            raise ValueError(f"Expected '=' / ':' / '{{' after key {key!r}, got {kind} {tok!r}")
        tree.put(key, value)

    def skip_ws_newline_before_value(self):
        # HOCON allows the value on the next line only for objects/arrays; in
        # practice values follow on the same line. Tolerate a newline before
        # '{' or '['.
        while self.peek()[0] == "newline":
            save = self.i
            self.next()
            if self.peek()[0] in ("lbrace", "lbracket"):
                return
            self.i = save
            return

    def parse_value(self) -> Any:
        kind, tok = self.peek()
        if kind == "lbrace":
            return self.parse_object()
        if kind == "lbracket":
            return self.parse_list()
        if kind == "string":
            self.next()
            out = _unquote(tok)
            # adjacent string concatenation is not supported (unused)
            return out
        if kind == "bareword":
            # Unquoted value: may span multiple barewords until newline
            words = [self.next()[1]]
            while self.peek()[0] == "bareword":
                words.append(self.next()[1])
            return _convert_scalar(" ".join(words))
        raise ValueError(f"Unexpected value token {kind} {tok!r}")

    def parse_list(self) -> list:
        assert self.next()[0] == "lbracket"
        items: list = []
        self.skip_newlines()
        while self.peek()[0] != "rbracket":
            if self.peek()[0] == "eof":
                raise ValueError("Unexpected EOF inside list")
            items.append(self.parse_value())
            self.skip_newlines()
        self.next()  # rbracket
        return items


def _unquote(tok: str) -> str:
    body = tok[1:-1]
    return body.encode().decode("unicode_escape")


_INT_RE = re.compile(r"^[+-]?\d+$")
_FLOAT_RE = re.compile(r"^[+-]?(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?$")


def _convert_scalar(s: str) -> Any:
    ls = s.lower()
    if ls == "true":
        return True
    if ls == "false":
        return False
    if ls in ("null", "none"):
        return None
    if _INT_RE.match(s):
        return int(s)
    if _FLOAT_RE.match(s) and not _INT_RE.match(s):
        return float(s)
    return s


# ---------------------------------------------------------------------------
# Public factory API (pyhocon ConfigFactory-compatible surface)
# ---------------------------------------------------------------------------


class ConfigFactory:
    @staticmethod
    def parse_string(text: str) -> ConfigTree:
        return _Parser(text).parse_root()

    @staticmethod
    def parse_file(path: str) -> ConfigTree:
        with io.open(path, "r", encoding="utf-8") as f:
            return ConfigFactory.parse_string(f.read())

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> ConfigTree:
        return ConfigTree.from_dict(d)


def merge_external_params(conf: ConfigTree, params: List[str]) -> ConfigTree:
    """Merge CLI override strings like ``train.lr=0.001`` into ``conf``.

    Mirrors the reference's ``parse_external_params`` + tree merge
    (reference: code/main.py:56-72,97-104).
    """
    for p in params:
        override = ConfigFactory.parse_string(p)
        conf.merge(override)
    return conf


def detect_schema_discrepancies(conf: ConfigTree, ref_conf: ConfigTree) -> List[str]:
    """Return config keys present in ``conf`` but absent from the reference
    schema tree — used to reject typo'd keys (reference:
    code/general_utils.py:264-296, code/main.py:106-109)."""
    ref_keys = set(ref_conf.flatten().keys())
    bad = []
    for key in conf.flatten().keys():
        if key not in ref_keys:
            bad.append(key)
    return sorted(bad)
