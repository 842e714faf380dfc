"""Declared-key schema and lint findings (the JAX package's
``analysis/schema.py``): the vocabulary of ``task = check``.

The config surface is the framework's API (``name = value`` pairs) and
the reference's worst contract rule is that unknown keys are silently
ignored (``layers/base.py`` Layer.set_param).  The lint pass needs every
subsystem to *declare* the keys it consumes; :class:`KeySpec` is the
declaration record and :class:`Finding` the structured lint result.
This module imports nothing of the package: layers, iterators, updaters,
the engine and the trainer all import it to declare their keys without
cycles through ``analysis/``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

#: finding severities, most severe first; an ``error`` finding makes
#: ``task = check`` exit 1
SEVERITIES = ("error", "warn", "info")


@dataclasses.dataclass(frozen=True)
class KeySpec:
    """One accepted config key.

    ``kind`` drives value validation: ``int`` / ``float`` parse checks
    (with optional ``lo``/``hi`` range), ``enum`` membership in
    ``choices``, ``str``/``path`` accept anything.  ``soft = True``
    downgrades a value violation from error to warn (for keys whose
    consumer deliberately tolerates odd spellings, e.g.
    ``output_format``).  ``check`` overrides everything: a callable
    ``val -> error message or None`` (the engine options reuse their own
    validators through it).
    """

    name: str
    kind: str = "str"  # str | path | int | float | enum
    choices: Tuple[str, ...] = ()
    lo: Optional[float] = None
    hi: Optional[float] = None
    soft: bool = False
    help: str = ""
    check: Optional[Callable[[str], Optional[str]]] = None


def K(name: str, kind: str = "str", **kw) -> KeySpec:
    """Terse KeySpec constructor for declaration tables."""
    return KeySpec(name=name, kind=kind, **kw)


@dataclasses.dataclass
class Finding:
    """One structured lint result."""

    severity: str          # error | warn | info
    key: str               # offending config key ("" for graph findings)
    message: str
    suggestion: str = ""   # did-you-mean replacement, when one exists
    scope: str = ""        # "global" | "iter:<name>" | "layer:<type>" | "jaxpr"

    def to_dict(self) -> dict:
        d = {"severity": self.severity, "key": self.key,
             "message": self.message}
        if self.suggestion:
            d["suggestion"] = self.suggestion
        if self.scope:
            d["scope"] = self.scope
        return d

    def format(self) -> str:
        loc = f" [{self.scope}]" if self.scope else ""
        key = f" {self.key}:" if self.key else ""
        sugg = f" (did you mean {self.suggestion!r}?)" if self.suggestion \
            else ""
        return f"{self.severity:5s}{loc}{key} {self.message}{sugg}"


def check_value(spec: KeySpec, val: str) -> Optional[Tuple[str, str]]:
    """Validate ``val`` against ``spec``; returns (severity, message) on a
    violation, None when the value is acceptable."""
    if spec.check is not None:
        msg = spec.check(val)
        return (("warn" if spec.soft else "error"), msg) if msg else None
    if spec.kind == "int":
        try:
            x = int(val)
        except ValueError:
            return ("warn" if spec.soft else "error",
                    f"expected an integer, got {val!r}")
        return _range_check(spec, x)
    if spec.kind == "float":
        try:
            x = float(val)
        except ValueError:
            return ("warn" if spec.soft else "error",
                    f"expected a number, got {val!r}")
        return _range_check(spec, x)
    if spec.kind == "enum":
        if val not in spec.choices:
            return ("warn" if spec.soft else "error",
                    f"expected one of {'/'.join(spec.choices)}, got {val!r}")
    return None


def _range_check(spec: KeySpec, x) -> Optional[Tuple[str, str]]:
    # range violations are warnings: the parse succeeded, the consumer may
    # still clamp or tolerate the value — the type error above is the hard
    # contract
    if spec.lo is not None and x < spec.lo:
        return ("warn", f"value {x} below minimum {spec.lo}")
    if spec.hi is not None and x > spec.hi:
        return ("warn", f"value {x} above maximum {spec.hi}")
    return None


def edit_distance(a: str, b: str, limit: int = 4) -> int:
    """Levenshtein distance with an early-out band (small strings only)."""
    if a == b:
        return 0
    if abs(len(a) - len(b)) > limit:
        return limit + 1
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        if min(cur) > limit:
            return limit + 1
        prev = cur
    return prev[-1]


def did_you_mean(name: str, candidates) -> str:
    """Closest declared key within a length-scaled edit distance, or ''."""
    limit = 2 if len(name) >= 5 else (1 if len(name) >= 3 else 0)
    if limit == 0:
        return ""
    best, best_d = "", limit + 1
    for c in candidates:
        d = edit_distance(name, c, limit)
        if d < best_d or (d == best_d and c < best):
            best, best_d = c, d
    return best if best_d <= limit else ""
