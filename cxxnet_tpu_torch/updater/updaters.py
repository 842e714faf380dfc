"""Optimizers (updaters): sgd / nag / adam with LR + momentum schedules,
the JAX package's ``updater/updaters.py`` in PyTorch.

Reference: ``src/updater/sgd_updater-inl.hpp``, ``nag_updater-inl.hpp``,
``adam_updater-inl.hpp``, ``param.h`` (UpdaterParam schedules and
tag-scoped overrides like ``wmat:lr``).

Each updater is a per-tensor transition in plain torch under
``torch.no_grad``, as the JAX package's is plain XLA: the arithmetic
runs in float32, optimizer state is float32 whatever the model dtype,
and a parameter that is not float32 carries a float32 master copy
(``w32``) in its state: the update applies to the master and the
working parameter becomes its cast.  Unlike the JAX package's pure
functions, :meth:`Updater.apply` writes the new state and parameter in
place (no second copy of the optimizer state on the card).  Under
``fused_update = 1`` adam takes the fused kernel of
:mod:`..ops.fused_adam` where its gate admits the tensor.  Schedules
are evaluated from the update counter (the reference's
``epoch_counter``, the number of updates).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..analysis.schema import K
from ..ops.fused_adam import fused_adam_pallas, fused_adam_supported

State = Dict[str, torch.Tensor]

#: keys UpdaterHyper.set_param consumes (global, per-layer, or
#: tag-scoped ``wmat:lr``: the registry matches the tagged spellings
#: through its tag prefixes)
HYPER_KEYS = (
    K("lr", "float", lo=0.0), K("eta", "float", lo=0.0),
    K("wd", "float"), K("momentum", "float"),
    K("clip_gradient", "float", lo=0.0),
    K("momentum_schedule", "int", lo=0, hi=1),
    K("base_momentum", "float"), K("final_momentum", "float"),
    K("saturation_epoch", "int", lo=0),
    K("beta1", "float"), K("beta2", "float"),
    K("lr:schedule", "enum",
      choices=("constant", "expdecay", "polydecay", "factor")),
    K("lr:gamma", "float"), K("lr:alpha", "float"),
    K("lr:step", "int", lo=1), K("lr:factor", "float"),
    K("lr:minimum_lr", "float"), K("lr:start_epoch", "int", lo=0),
    K("eta:schedule", "enum",
      choices=("constant", "expdecay", "polydecay", "factor")),
    K("eta:gamma", "float"), K("eta:alpha", "float"),
    K("eta:step", "int", lo=1), K("eta:factor", "float"),
    K("eta:minimum_lr", "float"), K("eta:start_epoch", "int", lo=0),
)


@dataclasses.dataclass
class UpdaterHyper:
    """Hyperparameters of one (layer, tag) weight group (UpdaterParam
    parity).  Tag-scoped keys (``wmat:lr``, ``bias:wd``) override the
    globals for that tag only (reference updater/param.h:100-105)."""

    tag: str = "wmat"
    base_lr: float = 0.01
    wd: float = 0.0
    momentum: float = 0.9
    clip_gradient: float = 0.0
    # lr schedule: 0 constant, 1 expdecay, 2 polydecay, 3 factor
    lr_schedule: int = 0
    lr_step: int = 1
    lr_gamma: float = 0.5
    lr_alpha: float = 0.5
    lr_factor: float = 0.1
    lr_minimum: float = 1e-5
    start_epoch: int = 0
    # momentum schedule
    momentum_schedule: int = 0
    base_momentum: float = 0.5
    final_momentum: float = 0.9
    saturation_epoch: int = 0
    # adam decay rates (the reference stores beta as the decay rate)
    beta1: float = 0.1
    beta2: float = 0.001

    def set_param(self, name: str, val: str) -> None:
        # tag-prefix stripping: "wmat:lr" applies only when tag == "wmat"
        if name.startswith(self.tag + ":"):
            name = name[len(self.tag) + 1:]
        elif ":" in name and name.split(":", 1)[0] in ("wmat", "bias"):
            return  # scoped to a different tag
        if name in ("lr", "eta"):
            self.base_lr = float(val)
        elif name == "wd":
            self.wd = float(val)
        elif name == "momentum":
            self.momentum = float(val)
        elif name == "clip_gradient":
            self.clip_gradient = float(val)
        elif name == "momentum_schedule":
            self.momentum_schedule = int(val)
        elif name == "base_momentum":
            self.base_momentum = float(val)
        elif name == "final_momentum":
            self.final_momentum = float(val)
        elif name == "saturation_epoch":
            self.saturation_epoch = int(val)
        elif name == "beta1":
            self.beta1 = float(val)
        elif name == "beta2":
            self.beta2 = float(val)
        elif name.startswith("lr:") or name.startswith("eta:"):
            sub = name.split(":", 1)[1]
            if sub == "schedule":
                m = {"constant": 0, "expdecay": 1, "polydecay": 2, "factor": 3}
                if val not in m:
                    raise ValueError(f"unknown lr schedule {val!r}")
                self.lr_schedule = m[val]
            elif sub == "gamma":
                self.lr_gamma = float(val)
            elif sub == "alpha":
                self.lr_alpha = float(val)
            elif sub == "step":
                self.lr_step = int(val)
            elif sub == "factor":
                self.lr_factor = float(val)
            elif sub == "minimum_lr":
                self.lr_minimum = float(val)
            elif sub == "start_epoch":
                self.start_epoch = int(val)

    def schedule(self, epoch: int) -> Tuple[float, float]:
        """``(lr, momentum)`` at update ``epoch`` (ScheduleEpoch)."""
        e = float(epoch)
        if self.lr_schedule == 0:
            lr = self.base_lr
        elif self.lr_schedule == 1:
            lr = self.base_lr * math.pow(self.lr_gamma, e / self.lr_step)
        elif self.lr_schedule == 2:
            lr = self.base_lr * math.pow(
                1.0 + math.floor(e / self.lr_step) * self.lr_gamma,
                -self.lr_alpha)
        elif self.lr_schedule == 3:
            lr = self.base_lr * math.pow(self.lr_factor,
                                         math.floor(e / self.lr_step))
        else:
            raise ValueError("unknown lr schedule type")
        lr = max(lr, self.lr_minimum)
        if e < self.start_epoch:
            lr = self.base_lr
        mom = self.momentum
        if self.momentum_schedule and self.saturation_epoch:
            mom = mom + ((self.final_momentum - self.base_momentum)
                         / self.saturation_epoch * e + self.base_momentum)
        if self.momentum_schedule:
            mom = min(mom, self.final_momentum)
        return lr, mom

    def clip(self, g: torch.Tensor) -> torch.Tensor:
        """NaN-zeroing clip (sgd_updater-inl.hpp:15-22)."""
        if self.clip_gradient == 0.0:
            return g
        g = torch.nan_to_num(g, nan=0.0, posinf=math.inf, neginf=-math.inf)
        return g.clamp(-self.clip_gradient, self.clip_gradient)


class Updater:
    """Per-tensor optimizer over float32 arithmetic and state."""

    name = ""

    def init_state(self, p: torch.Tensor) -> State:
        return {}

    def make_state(self, p: torch.Tensor) -> State:
        """Full optimizer state for one tensor: the subclass's state plus
        the float32 master copy of a reduced-precision parameter."""
        s = self.init_state(p)
        if p.dtype != torch.float32:
            s["w32"] = p.detach().float().clone()
        return s

    @staticmethod
    def _zeros(p: torch.Tensor) -> torch.Tensor:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    @torch.no_grad()
    def apply(self, p: torch.Tensor, g: torch.Tensor, state: State,
              hyper: UpdaterHyper, epoch: int,
              fused: bool = False) -> torch.Tensor:
        """One update of ``p`` by gradient ``g``; writes ``state`` and
        ``p`` in place and returns ``p``.  ``fused`` (``fused_update =
        1``) matters only to adam, the one updater with a fused kernel."""
        master = state.get("w32")
        p32 = master if master is not None else p.float()
        sub = {k: v for k, v in state.items() if k != "w32"}
        q = self._apply32(p32, g.float(), sub, hyper, epoch)
        if master is not None:
            master.copy_(q)
        p.copy_(q)
        return p

    def _apply32(self, p: torch.Tensor, g: torch.Tensor, state: State,
                 hyper: UpdaterHyper, epoch: int) -> torch.Tensor:
        """New float32 value of ``p``; updates the float32 ``state``
        tensors in place."""
        raise NotImplementedError


class SGDUpdater(Updater):
    """Momentum SGD: m = mom*m - lr*(clip(g) + wd*w); w += m
    (sgd_updater-inl.hpp:73-84)."""

    name = "sgd"

    def init_state(self, p):
        return {"m": self._zeros(p)}

    def _apply32(self, p, g, state, hyper, epoch):
        lr, mom = hyper.schedule(epoch)
        g = hyper.clip(g)
        m = mom * state["m"] - lr * (g + hyper.wd * p)
        state["m"].copy_(m)
        return p + m


class NAGUpdater(Updater):
    """Nesterov momentum via old-momentum correction
    (nag_updater-inl.hpp:65-72): w += (1+mom)*m_new - mom*m_old."""

    name = "nag"

    def init_state(self, p):
        return {"m": self._zeros(p)}

    def _apply32(self, p, g, state, hyper, epoch):
        lr, mom = hyper.schedule(epoch)
        g = hyper.clip(g)
        m_old = state["m"].clone()
        m = mom * m_old - lr * (g + hyper.wd * p)
        state["m"].copy_(m)
        return p + (1 + mom) * m - mom * m_old


class AdamUpdater(Updater):
    """Adam with the reference's decay parameterization
    (adam_updater-inl.hpp:73-82): beta1 / beta2 config values are the
    decay rates (defaults 0.1 / 0.001), ``grad -= wd*w`` (note the sign),
    and lr_t = lr * sqrt(1-(1-d2)^t) / (1-(1-d1)^t), t = epoch + 1, with
    the base lr (no schedule, as in the JAX package)."""

    name = "adam"

    def init_state(self, p):
        return {"m1": self._zeros(p), "m2": self._zeros(p)}

    @staticmethod
    def lr_t(hyper: UpdaterHyper, epoch: int) -> float:
        """Bias-corrected step size (adam_updater-inl.hpp:79-81), in
        float32 as the JAX package computes it: ``1 - (1 - d2)^t``
        cancels at small t, so float64 here would differ from it by up
        to ~1e-5 relative."""
        f32 = np.float32
        t = f32(epoch) + f32(1.0)
        fix1 = f32(1.0) - np.power(f32(1.0 - hyper.beta1), t)
        fix2 = f32(1.0) - np.power(f32(1.0 - hyper.beta2), t)
        return float(f32(hyper.base_lr) * np.sqrt(fix2) / fix1)

    @torch.no_grad()
    def apply(self, p, g, state, hyper, epoch, fused=False):
        """Under ``fused``, a bf16 tensor with a float32 master that the
        JAX package's gate admits (:func:`fused_adam_supported`) takes one
        sweep of the fused kernel (same state keys ``m1`` / ``m2`` /
        ``w32``, same ``lr_t``); every other tensor the unfused update."""
        if fused and "w32" in state and fused_adam_supported(p):
            fused_adam_pallas(g.contiguous(), state["m1"], state["m2"],
                              state["w32"], self.lr_t(hyper, epoch),
                              d1=hyper.beta1, d2=hyper.beta2, wd=hyper.wd,
                              clip=hyper.clip_gradient, out=p)
            return p
        return super().apply(p, g, state, hyper, epoch)

    def _apply32(self, p, g, state, hyper, epoch):
        d1, d2 = hyper.beta1, hyper.beta2
        g = hyper.clip(g)
        if hyper.wd > 0.0:
            g = g - hyper.wd * p
        m1, m2 = state["m1"], state["m2"]
        m1.add_(g - m1, alpha=d1)
        m2.add_(torch.square(g) - m2, alpha=d2)
        return p - self.lr_t(hyper, epoch) * (m1 / (torch.sqrt(m2) + 1e-8))


_UPDATERS = {u.name: u for u in (SGDUpdater(), NAGUpdater(), AdamUpdater())}


def create_updater(name: str) -> Updater:
    """Factory (reference CreateUpdater, updater_impl-inl.hpp)."""
    if name not in _UPDATERS:
        raise ValueError(f"unknown updater {name!r}; known: "
                         f"{sorted(_UPDATERS)}")
    return _UPDATERS[name]
