"""Building the system under test from a configuration file: its net
config text (inline lines, or the model zoo's builder call that the file
names) and its keys, through the program's own config parser, trainer
and iterator factory, as its command line builds them."""

from __future__ import annotations

from typing import Dict, List, Tuple

Pairs = List[Tuple[str, str]]


def net_text(cfg: dict) -> str:
    """The configuration's ``netconfig`` block and input lines."""
    if "netconfig" in cfg:
        return "\n".join(cfg["netconfig"]) + "\n"
    from cxxnet_tpu_torch.models import zoo
    b = cfg["builder"]
    return getattr(zoo, b["name"])(**b["args"])


def conf_text(cfg: dict, keys: Dict[str, object], data: Pairs = ()) -> str:
    """A whole config: a ``data = train`` section over ``data`` (iterator
    pairs), the net, the configuration's keys, then ``keys``."""
    lines = []
    if data:
        lines.append("data = train")
        lines += [f"{k} = {v}" for k, v in data]
        lines.append("iter = end")
    lines.append(net_text(cfg))
    merged = {**cfg.get("keys", {}), **keys}
    lines += [f"{k} = {v}" for k, v in merged.items()]
    return "\n".join(lines) + "\n"


def split_sections(pairs: Pairs) -> Tuple[Pairs, Pairs]:
    """(the ``data`` section's iterator pairs, the global pairs), as the
    command line's section scanner divides them."""
    section, glob, inside = [], [], False
    for k, v in pairs:
        if k == "data":
            inside = True
            continue
        if inside and k == "iter" and v == "end":
            inside = False
            continue
        (section if inside else glob).append((k, v))
    return section, glob


def build(text: str):
    """``(trainer, data chain or None)`` of a config text: the trainer
    built and initialised on its device (``dev``), the train chain made
    and initialised with the global keys."""
    from cxxnet_tpu_torch.io.factory import create_iterator, init_iterator
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    pairs = parse_config_string(text)
    section, glob = split_sections(pairs)
    tr = NetTrainer()
    for k, v in pairs:
        tr.set_param(k, v)
    tr.init_model()
    chain = None
    if section:
        chain = init_iterator(create_iterator(section), glob)
    return tr, chain
