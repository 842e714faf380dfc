"""Config tokenizer: ordered (name, value) pairs from ``key = value`` text.

Capability parity with the reference's ConfigReaderBase
(``src/utils/config.h:20-189``): whitespace-separated tokens around ``=``,
``#`` line comments, double-quoted single-line strings with backslash
escapes, single-quoted multi-line strings.  Config order matters — the same
key may appear many times (e.g. repeated ``layer[..]`` lines, per-section
``iter`` keys), so the output is a list, not a dict.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

ConfigPairs = List[Tuple[str, str]]


class ConfigError(ValueError):
    pass


def _tokenize(text: str) -> Iterator[str]:
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch == "#":
            while i < n and text[i] not in "\r\n":
                i += 1
        elif ch in " \t\r\n":
            i += 1
        elif ch == '"':
            i += 1
            buf = []
            while True:
                if i >= n:
                    raise ConfigError("unterminated string in config")
                c = text[i]
                if c == "\\":
                    i += 1
                    if i >= n:
                        raise ConfigError("unterminated escape in config")
                    buf.append(text[i])
                    i += 1
                elif c == '"':
                    i += 1
                    break
                elif c in "\r\n":
                    raise ConfigError("unterminated string in config")
                else:
                    buf.append(c)
                    i += 1
            yield '"' + "".join(buf)  # marker prefix: quoted token
        elif ch == "'":
            i += 1
            buf = []
            while True:
                if i >= n:
                    raise ConfigError("unterminated string in config")
                c = text[i]
                if c == "\\":
                    i += 1
                    buf.append(text[i])
                    i += 1
                elif c == "'":
                    i += 1
                    break
                else:
                    buf.append(c)
                    i += 1
            yield '"' + "".join(buf)
        elif ch == "=":
            i += 1
            yield "="
        else:
            j = i
            while j < n and text[j] not in " \t\r\n=#'\"":
                j += 1
            yield text[i:j]
            i = j


def _unmark(tok: str) -> str:
    return tok[1:] if tok.startswith('"') else tok


def parse_config_string(text: str) -> ConfigPairs:
    """Parse config text into an ordered list of (name, value) pairs."""
    toks = list(_tokenize(text))
    pairs: ConfigPairs = []
    i = 0
    while i < len(toks):
        name = toks[i]
        if name == "=":
            raise ConfigError("config line starts with '='")
        if i + 2 >= len(toks) or toks[i + 1] != "=":
            raise ConfigError(f"expected 'name = value' near {_unmark(name)!r}")
        val = toks[i + 2]
        if val == "=":
            raise ConfigError(f"missing value for {_unmark(name)!r}")
        pairs.append((_unmark(name), _unmark(val)))
        i += 3
    return pairs


def parse_config_file(path: str) -> ConfigPairs:
    with open(path, "r") as f:
        return parse_config_string(f.read())


def parse_keyval_args(args: List[str]) -> ConfigPairs:
    """Parse CLI ``key=value`` overrides (reference: cxxnet_main.cpp:67-72)."""
    pairs: ConfigPairs = []
    for a in args:
        if "=" not in a:
            raise ConfigError(f"CLI override must be key=value, got {a!r}")
        k, v = a.split("=", 1)
        pairs.append((k.strip(), v.strip()))
    return pairs
