"""Seeded inputs the benchmark hands to the program and to the plain
reference alike: weights drawn on the device in a few large calls, in
the type they are served in, and the seeds of the other streams.

A leaf spec is ``{"name": "layer/tag", "shape": [...], "init":
["normal", sigma] | ["uniform", a] | ["const", value]}``.  Every normal
leaf is a slice of one ``randn`` call and every uniform leaf a slice of
one ``rand`` call, so the weights of a seed are the same on every run on
the same kind of device, whatever reads them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

#: the streams one ``--seed`` feeds
STREAMS = ("weights", "data", "docs", "program", "sample")


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of ``stream`` derived from the run's ``--seed`` (any
    whole number, also past 32 bits)."""
    k = STREAMS.index(stream) + 1
    return (int(seed) * 1_000_003 + k * 7_919) % (2 ** 63 - 1)


def program_seed(seed: int) -> int:
    """The ``seed`` key handed to the program (it seeds the program's own
    generator: dropout masks), kept within 31 bits."""
    return stream_seed(seed, "program") % (2 ** 31 - 1)


def make(specs: Sequence[dict], seed: int, device, dtype) -> Dict[str, object]:
    """``{name: tensor}`` of every leaf, on ``device`` in ``dtype``."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, "weights"))
    out: Dict[str, object] = {}
    for kind, draw in (("normal", torch.randn), ("uniform", torch.rand)):
        leaves: List[dict] = [s for s in specs if s["init"][0] == kind]
        total = sum(_numel(s["shape"]) for s in leaves)
        if not total:
            continue
        buf = draw(total, generator=gen, device=device, dtype=dtype)
        at = 0
        for s in leaves:
            n = _numel(s["shape"])
            v = buf[at:at + n].view(tuple(s["shape"]))
            at += n
            a = float(s["init"][1])
            out[s["name"]] = v * a if kind == "normal" else v * (2 * a) - a
        del buf
    for s in specs:
        if s["init"][0] == "const":
            out[s["name"]] = torch.full(tuple(s["shape"]), float(s["init"][1]),
                                        device=device, dtype=dtype)
    return {s["name"]: out[s["name"]] for s in specs}


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def program_leaves(trainer) -> Dict[str, object]:
    """``{"layer/tag": parameter}`` of a program's trainer, keyed by the
    layer names of its net config."""
    return {f"{pkey.split('-', 1)[1]}/{tag}": p
            for pkey, group in trainer.params.items()
            for tag, p in group.items()}


def install(trainer, weights: Dict[str, object]) -> None:
    """Write the benchmark's weights into the program's parameters in
    place, before its first step (its optimizer state, float32 masters
    included, is made from them then).  Every leaf of the program has to
    be given, at its shape."""
    import torch
    leaves = program_leaves(trainer)
    missing = sorted(set(leaves) - set(weights))
    extra = sorted(set(weights) - set(leaves))
    if missing or extra:
        raise ValueError(f"weights do not match the program's leaves: "
                         f"missing {missing[:8]}, unknown {extra[:8]}")
    with torch.no_grad():
        for name, p in leaves.items():
            w = weights[name]
            if tuple(p.shape) != tuple(w.shape):
                raise ValueError(f"{name}: program shape {tuple(p.shape)}, "
                                 f"benchmark shape {tuple(w.shape)}")
            p.copy_(w)
    if trainer.opt_state is not None:
        raise RuntimeError("weights installed after the optimizer state was "
                           "made")
