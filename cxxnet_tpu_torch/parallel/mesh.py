"""Device selection and mesh specs: the parsing half of the JAX
package's ``parallel/mesh.py``.

``dev = cpu | gpu | gpu:0 | gpu:0-3 | gpu:1,3`` and ``mesh =
data:4,model:2`` parse here, for the trainer (``nnet/trainer.py``
``resolve_device``) and the config lint alike.  No mesh is built: the
multi-GPU plane, which shards a batch over the ids a ``dev`` lists, is
not ported (ROADMAP.md), so the trainer refuses a ``dev`` of several ids
and a ``mesh`` of more than one device by name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List


def parse_device_spec(dev: str) -> Dict:
    """Parse ``dev = cpu | gpu | gpu:0 | gpu:0-3 | gpu:1,3`` (reference
    nnet_impl-inl.hpp:32-51 parses the gpu:0-3 form): ``{"platform",
    "ids"}``, ``ids`` None without a ``:`` suffix."""
    dev = dev.strip()
    if ":" not in dev:
        return {"platform": dev, "ids": None}
    platform, rng = dev.split(":", 1)
    ids: List[int] = []
    for part in rng.split(","):
        try:
            if "-" in part:
                a, b = part.split("-")
                ids.extend(range(int(a), int(b) + 1))
            else:
                ids.append(int(part))
        except ValueError:
            raise ValueError(f"dev suffix {rng!r}: expected i, i-j or "
                             "i,j") from None
    return {"platform": platform, "ids": ids}


#: mesh axis names with semantics: ``data`` shards the batch, ``model``
#: fullc / moe weights, ``seq`` ring attention, ``expert`` MoE dispatch,
#: ``pipe`` pipeline stages.  An unknown axis name would shard nothing,
#: so parse rejects it with a suggestion.
KNOWN_AXES = ("data", "model", "seq", "expert", "pipe")


@dataclasses.dataclass
class MeshSpec:
    """Named mesh axes, e.g. {"data": 4, "model": 2}."""

    axes: Dict[str, int]

    @classmethod
    def parse(cls, s: str) -> "MeshSpec":
        """Parse ``mesh = data:4,model:2``.  Raises ``ValueError`` on
        unknown or duplicate axis names and non-positive sizes."""
        axes: Dict[str, int] = {}
        for part in s.split(","):
            name, sep, size = part.partition(":")
            name = name.strip()
            if not sep:
                raise ValueError(
                    f"mesh axis {part.strip()!r}: expected name:size")
            if name not in KNOWN_AXES:
                from ..analysis.schema import did_you_mean
                sugg = did_you_mean(name, KNOWN_AXES)
                raise ValueError(
                    f"unknown mesh axis {name!r} (axes with semantics: "
                    f"{', '.join(KNOWN_AXES)})"
                    + (f"; did you mean {sugg!r}?" if sugg else ""))
            if name in axes:
                raise ValueError(f"duplicate mesh axis {name!r}")
            try:
                n = int(size)
            except ValueError:
                raise ValueError(
                    f"mesh axis {name}: size {size.strip()!r} is not an "
                    "integer") from None
            if n < 1:
                raise ValueError(f"mesh axis {name}: size must be >= 1, "
                                 f"got {n}")
            axes[name] = n
        return cls(axes)

    @property
    def size(self) -> int:
        n = 1
        for v in self.axes.values():
            n *= v
        return n

    def axis_size(self, name: str) -> int:
        """Size of ``name`` (1 when the axis is absent)."""
        return self.axes.get(name, 1)
