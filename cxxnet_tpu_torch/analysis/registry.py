"""Declared-key registry: the accepted config keys, gathered from the
code (the JAX package's ``analysis/registry.py`` over the port).

Every subsystem that consumes ``name = value`` pairs declares its keys
next to its ``set_param`` (``LAYER_PARAM_KEYS`` / ``extra_config_keys``
in the layers, ``config_keys`` on the iterator stages, ``HYPER_KEYS`` in
the updaters, ``TRAINER_KEYS`` / ``TASK_KEYS`` in the trainer and the
CLI driver, ``engine.key_specs()`` for the lowering options).  This
module assembles them into matchable scopes:

* :func:`global_scope`: keys legal outside any section.  Globals reach
  every layer, updater and iterator, so this is the union of
  everything (a key known anywhere is never a global typo);
* :func:`layer_scope`: the keys a ``layer[..] = type`` section takes,
  the type's own and the per-layer updater overrides;
* :func:`iterator_scope`: the keys a ``data`` / ``eval`` / ``pred``
  section takes for its ``iter =`` chain.

A declared name ending in ``[*]`` is a numbered or templated key
(``extra_data_shape[0]``, ``metric[field,node]``, ``label_vec[0,4)``)
and matches structurally.  Layer types the port does not implement
(``layers/registry.NOT_PORTED``) have no scope: their keys go unlinted,
and the type itself is the lint's not-ported error.
"""

from __future__ import annotations

import functools
import re
from typing import Dict, List, Optional, Sequence, Tuple

from .schema import KeySpec

# weight-tag prefixes for tag-scoped hyper overrides (``wmat:lr``,
# ``bias:wd``, updater/param.h:100-105), the zoo's extra tags included
TAG_PREFIXES = ("wmat", "bias", "gate", "wmat2", "bias2",
                "wqkv", "wout", "bqkv", "wpos")

# templated key name -> full-match regex
_TEMPLATES = {
    "extra_data_shape[*]": r"extra_data_shape\[\d+\]",
    "metric[*]": r"metric\[[^\]]+\]",
    "label_vec[*]": r"label_vec\[\d+,\d+\)",
}


class KeyScope:
    """A matchable set of declared keys."""

    def __init__(self, name: str, specs: Sequence[KeySpec]):
        self.name = name
        self._exact: Dict[str, List[KeySpec]] = {}
        self._patterns: List[Tuple[re.Pattern, KeySpec]] = []
        for sp in specs:
            if sp.name.endswith("[*]") or sp.name in _TEMPLATES:
                pat = _TEMPLATES.get(
                    sp.name, re.escape(sp.name[:-3]) + r"\[[^\]]*\]")
                self._patterns.append((re.compile(pat + r"\Z"), sp))
            else:
                self._exact.setdefault(sp.name, []).append(sp)

    def match(self, key: str) -> List[KeySpec]:
        """Specs accepting ``key``, honoring templates and the tag-scoped
        ``wmat:`` / ``bias:`` spellings.  Empty list = undeclared."""
        got = self._exact.get(key)
        if got:
            return got
        for pat, sp in self._patterns:
            if pat.match(key):
                return [sp]
        head, _, tail = key.partition(":")
        if tail and head in TAG_PREFIXES:
            return self.match(tail)
        return []

    def names(self) -> List[str]:
        """Exact key names (did-you-mean candidates)."""
        return sorted(self._exact)


def _netcfg_keys() -> Tuple[KeySpec, ...]:
    from ..updater.updaters import _UPDATERS
    from .schema import K
    return (
        K("netconfig", "enum", choices=("start", "end")),
        K("updater", "enum", choices=tuple(sorted(_UPDATERS))),
        K("sync", "str"),
        K("input_shape", "str", help="c,y,x"),
        K("extra_data_num", "int", lo=0),
        K("extra_data_shape[*]", "str", help="c,y,x"),
        K("label_vec[*]", "str", help="label field name for columns [a,b)"),
    )


def _all_iterator_keys() -> Tuple[KeySpec, ...]:
    from ..io import factory
    out: List[KeySpec] = []
    seen = set()
    stages = [c for classes in factory.ITER_STAGES.values() for c in classes]
    for cls in stages:
        for sp in cls.config_keys:
            if (cls.__name__, sp.name) not in seen:
                seen.add((cls.__name__, sp.name))
                out.append(sp)
    return tuple(out)


def _all_layer_keys() -> Tuple[KeySpec, ...]:
    from ..layers import registry as lreg
    from ..layers.base import LAYER_PARAM_KEYS
    out: List[KeySpec] = list(LAYER_PARAM_KEYS)
    for name, entry in lreg._REGISTRY.items():
        if name in lreg.PLUGIN_TYPES:
            # a plugin's keys are its section's only, never global keys
            # (the JAX package registers it through a factory, which its
            # global scope does not read)
            continue
        for klass in entry.__mro__:
            out.extend(klass.__dict__.get("extra_config_keys", ()))
    return tuple(out)


@functools.lru_cache(maxsize=1)
def global_scope() -> KeyScope:
    from .. import engine
    from ..main import TASK_KEYS
    from ..nnet.trainer import TRAINER_KEYS
    from ..updater.updaters import HYPER_KEYS
    specs = (tuple(TASK_KEYS) + tuple(TRAINER_KEYS) + engine.key_specs()
             + tuple(HYPER_KEYS) + _netcfg_keys() + _all_iterator_keys()
             + _all_layer_keys())
    return KeyScope("global", specs)


@functools.lru_cache(maxsize=64)
def layer_scope(type_name: str) -> Optional[KeyScope]:
    """Scope of one layer section, or None for a type the port does not
    implement: the caller then skips the section's key lint rather than
    guess."""
    from ..updater.updaters import HYPER_KEYS
    specs = _layer_type_specs(type_name)
    if specs is None:
        return None
    return KeyScope(f"layer:{type_name}", tuple(specs) + tuple(HYPER_KEYS))


def _layer_type_specs(type_name: str) -> Optional[List[KeySpec]]:
    """The keys a layer type takes; a ``pairtest-<master>-<slave>``
    takes the union of its sides' (it broadcasts an untagged key to
    both)."""
    from ..layers import registry as lreg
    if type_name.startswith("pairtest-"):
        rest = type_name[len("pairtest-"):]
        if "-" not in rest:
            return None
        master, slave = rest.split("-", 1)
        m, s = _layer_type_specs(master), _layer_type_specs(slave)
        if m is None or s is None:
            return None
        return list(m) + list(s)
    entry = lreg._REGISTRY.get(type_name)
    if entry is None:
        return None
    return list(entry.config_keys())


def layer_key_match(type_name: str, key: str) -> List[KeySpec]:
    """The specs accepting ``key`` in a ``type_name`` layer section,
    a pairtest's ``master:`` / ``slave:`` routing prefixes honoured."""
    scope = layer_scope(type_name)
    if scope is None:
        return []
    head, _, tail = key.partition(":")
    if tail and head in ("master", "slave") \
            and type_name.startswith("pairtest-"):
        return layer_key_match(type_name, tail) or scope.match(key)
    return scope.match(key)


def iterator_scope(chain: Tuple[str, ...]) -> KeyScope:
    from ..io import factory
    specs: List[KeySpec] = []
    for t in chain:
        for cls in factory.iter_stage_classes(t) or ():
            specs.extend(cls.config_keys)
    return KeyScope("iter:" + "+".join(chain), specs)


def known_anywhere(key: str) -> bool:
    return bool(global_scope().match(key))
