"""Per-leaf weight / grad / update norms: the reference's updater
monitor (the JAX package's ``monitor/ingraph.py``).

``monitor = 1``: on each ``monitor_interval``-th step the trainer keeps
a copy of the weights before the update (:func:`snapshot`; the updaters
and the fused adam kernel write the weights in place) and takes three
float32 norms per parameter leaf (:func:`group_stats`): ``||w||``,
``||dw||`` (the summed gradient of an ``update_period`` window) and
``||w_new - w||``, the actual update, so momentum, adam and the learning
rate are in it (0 on a micro-step of ``update_period > 1`` that applies
nothing).  On every other step, and at ``monitor = 0``, none of this
runs.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def iter_param_leaves(params) -> List[Tuple[str, torch.Tensor]]:
    """``(name, leaf)`` pairs named ``"<param_key>/<tag>"`` in the
    params' order (nested groups join their tag path with ``:``), the
    JAX package's ``iter_param_leaves``."""
    out = []

    def walk(group, path):
        for tag, p in group.items():
            if isinstance(p, dict):
                walk(p, f"{path}:{tag}")
            else:
                out.append((f"{path}:{tag}", p))

    for pkey, group in params.items():
        for tag, p in group.items():
            if isinstance(p, dict):
                walk(p, f"{pkey}/{tag}")
            else:
                out.append((f"{pkey}/{tag}", p))
    return out


def snapshot(params) -> Dict[str, torch.Tensor]:
    """Detached copies of every leaf (the weights before an update)."""
    return {name: p.detach().clone() for name, p in iter_param_leaves(params)}


def _norm(x: torch.Tensor) -> torch.Tensor:
    """The float32 2-norm, the leaf read once (no float32 copy)."""
    return torch.linalg.vector_norm(x.detach(), dtype=torch.float32)


def group_stats(before: Dict[str, torch.Tensor], grads, params
                ) -> Dict[str, torch.Tensor]:
    """Per-leaf ``[||w||, ||dw||, ||w_new - w||]`` (float32, on the
    device) from :func:`snapshot`'s ``before``, the gradient tree and the
    updated params."""
    flat_g = dict(iter_param_leaves(grads))
    flat_n = dict(iter_param_leaves(params))
    return {name: torch.stack([_norm(w), _norm(flat_g[name]),
                               _norm(flat_n[name].detach().float()
                                     - w.float())])
            for name, w in before.items()}


def to_host(stats: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """:func:`group_stats`' output on the host, in one copy (one device
    sync for every leaf)."""
    names = list(stats)
    host = torch.stack([stats[n] for n in names]).cpu().numpy()
    return dict(zip(names, host))


def unpack_stats(host_stats) -> Dict[str, Dict[str, float]]:
    """Host view of one step's stats: per-leaf ``{w_norm, g_norm,
    u_norm, u_ratio}`` floats."""
    out = {}
    for name, v in host_stats.items():
        w, g, u = (float(v[0]), float(v[1]), float(v[2]))
        out[name] = {"w_norm": w, "g_norm": g, "u_norm": u,
                     "u_ratio": u / (w + 1e-12)}
    return out
