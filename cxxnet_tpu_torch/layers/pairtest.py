"""PairTest layer: differential testing of two layer implementations.

The JAX package's ``layers/pairtest.py`` in PyTorch.  Reference:
``src/layer/pairtest_layer-inl.hpp`` — ``layer[..] =
pairtest-<master>-<slave>`` runs both layers on the same inputs each
step and reports where they diverge (relative error > 1e-5, :194).  Four
things are compared, as in the reference:

* forward outputs (``CmpResult(..., "Forward")``, :89-93);
* propagated input gradients (:110-117);
* weight gradients (``Cmp("After-Backprop:grad")``, :108);
* weights before each forward (``Cmp("Before-Forward:weight")``, :78):
  both sides are updated from their own gradients (:122-125), so weight
  drift integrates any gradient difference.

The master drives the graph.  The slave reads detached inputs, and its
outputs join the master's as ``m + (s - s.detach())``: numerically the
master's value, while the slave's parameters receive the cotangent the
master receives, so both sides' weight gradients are real and the
updater steps both.  Non-finite slave values are zeroed out of that
term: a broken slave is reported, not allowed to poison the master's
graph.  Both sides draw the same randomness: the slave (and the probe
below) run on a generator cloned from the state the master started
from.

The gradient comparison runs a probe cotangent backward through
detached copies of both sides with ``torch.autograd.grad``
(:func:`probe_vjp_compare`), so no graph of it reaches the step's own
backward.  Every diagnostic is a 0-d float32 tensor on the layer's
device, collected in ``ctx.diagnostics`` and read on the host only
where the trainer's caller prints them (``print_step``).

Parameters and buffers sit in the layer's group under ``master/<tag>``
and ``slave/<tag>``: a snapshot holds them at ``params/<key>/master/
<tag>``, as the JAX package's nested groups are stored.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from .base import ForwardContext, Layer, Params, Shape4

PAIRTEST_RTOL = 1e-5  # reference threshold, pairtest_layer-inl.hpp:194

#: seed of each pairtest layer's probe-cotangent generator (the JAX
#: package folds 7331 + i into the step's key for its probes)
PROBE_SALT = 7331


def relative_error(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Max elementwise ``|a - b| / max(|a|, |b|)`` as a 0-d float32
    tensor (0 where both are ~0, inf where either is NaN)."""
    a = a.detach().float()
    b = b.detach().float()
    denom = torch.maximum(a.abs(), b.abs())
    err = (a - b).abs() / denom.clamp_min(1e-20)
    err = torch.where(denom < 1e-20, torch.zeros_like(err), err)
    err = torch.where(a.isnan() | b.isnan(),
                      torch.full_like(err, float("inf")), err)
    return err.max() if err.numel() else err.new_zeros(())


def tree_relative_error(a: Dict[str, torch.Tensor],
                        b: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Max relative error over the matching tags of two groups."""
    errs = [relative_error(a[t], b[t]) for t in sorted(a) if t in b]
    if not errs:
        return torch.zeros(())
    return torch.stack(errs).max()


def sum_losses(ctx: ForwardContext) -> Optional[torch.Tensor]:
    return sum(ctx.losses[1:], ctx.losses[0]) if ctx.losses else None


def side(group: Dict[str, torch.Tensor], name: str) -> Dict[str, torch.Tensor]:
    """The ``master`` or ``slave`` half of a pairtest group, tags
    unprefixed."""
    pre = name + "/"
    return {t[len(pre):]: v for t, v in group.items() if t.startswith(pre)}


def joined(m: Dict[str, torch.Tensor], s: Dict[str, torch.Tensor]
           ) -> Dict[str, torch.Tensor]:
    out = {f"master/{t}": v for t, v in m.items()}
    out.update({f"slave/{t}": v for t, v in s.items()})
    return out


def clone_generator(gen: Optional[torch.Generator],
                    state: Optional[torch.Tensor]
                    ) -> Optional[torch.Generator]:
    """A new generator on ``gen``'s device holding ``state``."""
    if gen is None:
        return None
    g = torch.Generator(device=gen.device)
    g.set_state(state)
    return g


def probe_vjp_compare(master: Layer, slave: Layer, mp: Params, sp: Params,
                      mb: Params, sb: Params, inputs: List[torch.Tensor],
                      make_ctx, probe: Optional[torch.Generator]
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                 Optional[torch.Tensor],
                                 Optional[torch.Tensor], torch.Tensor,
                                 torch.Tensor]:
    """Shared core of the After-Backprop comparisons
    (pairtest_layer-inl.hpp:95-118), used by :class:`PairTestLayer` and
    :func:`cxxnet_tpu_torch.testing.diff_layers`.

    Runs master and slave forward on detached copies of ``inputs`` and
    their parameters, then backward under ONE probe cotangent (standard
    normal draws from ``probe``, or ones when ``probe`` is None; plus
    the real loss cotangent 1 for loss layers).  ``make_ctx()`` must
    return a fresh :class:`ForwardContext` whose generator holds the
    same state on every call, so both sides draw the same randomness.
    Returns ``(m_out, s_out, m_loss, s_loss, in_grad_rel_err,
    wgrad_rel_err)``, all detached."""

    def run(layer, p, bufs):
        ctx = make_ctx()
        pp = {t: v.detach().requires_grad_(v.is_floating_point())
              for t, v in p.items()}
        xs = [x.detach().requires_grad_(x.is_floating_point())
              for x in inputs]
        outs, _ = layer.forward_buffers(pp, bufs, xs, ctx)
        return pp, xs, [o.float() for o in outs], sum_losses(ctx)

    with torch.enable_grad():
        mpp, mxs, m_o, m_loss = run(master, mp, mb)
        spp, sxs, s_o, s_loss = run(slave, sp, sb)
        cots = [torch.ones_like(o) if probe is None else
                torch.randn(o.shape, generator=probe, device=probe.device,
                            dtype=torch.float32).to(o.device) for o in m_o]

        def grads(outs, loss, pp, xs):
            roots, rc = [], []
            for o, c in zip(outs, cots):
                if o.requires_grad:
                    roots.append(o)
                    rc.append(c)
            if loss is not None and loss.requires_grad:
                roots.append(loss)
                rc.append(torch.ones_like(loss))
            leaves = [x for x in xs if x.requires_grad] + \
                [pp[t] for t in sorted(pp) if pp[t].requires_grad]
            if not roots or not leaves:
                return ([torch.zeros_like(x) for x in xs],
                        {t: torch.zeros_like(v) for t, v in pp.items()})
            g = torch.autograd.grad(roots, leaves, rc, allow_unused=True)
            it = iter(g)
            dx = [(next(it) if x.requires_grad else None) for x in xs]
            dw = {t: (next(it) if pp[t].requires_grad else None)
                  for t in sorted(pp)}
            dx = [torch.zeros_like(x) if d is None else d
                  for x, d in zip(xs, dx)]
            dw = {t: torch.zeros_like(pp[t]) if d is None else d
                  for t, d in dw.items()}
            return dx, dw

        dxm, dwm = grads(m_o, m_loss, mpp, mxs)
        dxs, dws = grads(s_o, s_loss, spp, sxs)
    in_err = torch.stack([relative_error(a, b)
                          for a, b in zip(dxm, dxs)]).max()
    w_err = tree_relative_error(dwm, dws) if dwm \
        else torch.zeros((), device=in_err.device)
    return ([o.detach() for o in m_o], [o.detach() for o in s_o],
            None if m_loss is None else m_loss.detach(),
            None if s_loss is None else s_loss.detach(), in_err, w_err)


class PairTestLayer(Layer):
    type_names = ("pairtest",)

    def __init__(self, master: Layer, slave: Layer):
        super().__init__()
        self.master = master
        self.slave = slave
        self._probe: Optional[torch.Generator] = None

    @property
    def is_loss(self) -> bool:  # type: ignore[override]
        return self.master.is_loss

    @property
    def takes_ids(self) -> bool:  # type: ignore[override]
        return self.master.takes_ids

    @property
    def tag(self) -> str:
        """The diagnostics' key prefix: the layer's name, else its
        type."""
        return self.name or (f"pairtest-{self.master.type_names[0]}"
                             f"-{self.slave.type_names[0]}")

    def set_param(self, name: str, val: str) -> None:
        # master:/slave: prefixed keys go to one side (reference :127-136)
        if name.startswith("master:"):
            self.master.set_param(name[len("master:"):], val)
        elif name.startswith("slave:"):
            self.slave.set_param(name[len("slave:"):], val)
        else:
            self.master.set_param(name, val)
            self.slave.set_param(name, val)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        m = self.master.infer_shapes(in_shapes)
        s = self.slave.infer_shapes(in_shapes)
        assert m == s, \
            f"pairtest: master/slave output shapes differ: {m} vs {s}"
        return m

    def init_params(self, gen: torch.Generator, in_shapes: List[Shape4],
                    dtype=torch.float32) -> Params:
        # master -> slave weight copy at init (reference InitModel:137-141):
        # both sides take the same tags (true for the native layers and
        # the torch plugin)
        mp = self.master.init_params(gen, in_shapes, dtype)
        return joined(mp, {t: v.clone() for t, v in mp.items()})

    def init_buffers(self, in_shapes: List[Shape4],
                     device: torch.device) -> Params:
        return joined(self.master.init_buffers(in_shapes, device),
                      self.slave.init_buffers(in_shapes, device))

    def forward(self, params: Params, inputs: List[torch.Tensor],
                ctx: ForwardContext) -> List[torch.Tensor]:
        return self.forward_buffers(params, {}, inputs, ctx)[0]

    def _probe_generator(self, rng: Optional[torch.Generator]
                         ) -> Optional[torch.Generator]:
        """The layer's probe-cotangent stream: a generator of its own on
        the step generator's device, seeded once with
        :data:`PROBE_SALT` (a seed read from the step's generator would
        cost a host sync a step on the card)."""
        if rng is None:
            return None
        if self._probe is None or self._probe.device != rng.device:
            self._probe = torch.Generator(device=rng.device)
            self._probe.manual_seed(PROBE_SALT)
        return self._probe

    @staticmethod
    def _child_ctx(ctx: ForwardContext, rng: Optional[torch.Generator]
                   ) -> ForwardContext:
        """Fresh losses and diagnostics, the given generator."""
        return dataclasses.replace(ctx, losses=[], diagnostics={}, rng=rng)

    def forward_buffers(self, params: Params, buffers: Params,
                        inputs: List[torch.Tensor], ctx: ForwardContext
                        ) -> Tuple[List[torch.Tensor], Params]:
        mp, sp = side(params, "master"), side(params, "slave")
        mb, sb = side(buffers, "master"), side(buffers, "slave")
        tag = self.tag
        diag = ctx.diagnostics
        state0 = None if ctx.rng is None else ctx.rng.get_state()

        # Before-Forward:weight — drift of the updated weights (:78)
        if mp and sp:
            diag[f"{tag}:weight_rel_err"] = tree_relative_error(mp, sp)

        # the master draws from the step's generator (its consumption
        # carries on), the slave from a clone of the state it started at
        mctx = self._child_ctx(ctx, ctx.rng)
        m_out, m_buf = self.master.forward_buffers(mp, mb, inputs, mctx)
        sctx = self._child_ctx(ctx, clone_generator(ctx.rng, state0))
        s_in = [x.detach() for x in inputs]
        s_out, s_buf = self.slave.forward_buffers(sp, sb, s_in, sctx)
        # the master's losses train; the slave's are measured only
        ctx.losses.extend(mctx.losses)
        diag.update(mctx.diagnostics)

        diag[f"{tag}:fwd_rel_err"] = torch.stack(
            [relative_error(a, b) for a, b in zip(m_out, s_out)]).max()
        if mctx.losses or sctx.losses:
            ml, sl = sum_losses(mctx), sum_losses(sctx)
            zero = torch.zeros((), device=m_out[0].device)
            diag[f"{tag}:loss_rel_err"] = relative_error(
                zero if ml is None else ml, zero if sl is None else sl)

        if ctx.train:
            def make_ctx() -> ForwardContext:
                return self._child_ctx(ctx, clone_generator(ctx.rng, state0))
            *_, in_err, w_err = probe_vjp_compare(
                self.master, self.slave, mp, sp, mb, sb, list(inputs),
                make_ctx, self._probe_generator(ctx.rng))
            diag[f"{tag}:in_grad_rel_err"] = in_err
            diag[f"{tag}:wgrad_rel_err"] = w_err

        outs = []
        for m, s in zip(m_out, s_out):
            s = torch.where(torch.isfinite(s), s, torch.zeros_like(s))
            outs.append(m + (s - s.detach()))
        return outs, joined(m_buf, s_buf)
