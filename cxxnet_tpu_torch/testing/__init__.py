"""Differential-testing harness (host-side form of the PairTest layer).

The JAX package's ``testing/__init__.py`` in PyTorch.  The reference
validates a new layer implementation by wiring ``layer[..] =
pairtest-<master>-<slave>`` into a config
(``src/layer/pairtest_layer-inl.hpp``); :func:`diff_layers` is the
direct programmatic equivalent for tests and notebooks: build both
layers, copy the master's weights to the slave, run forward and a
probe-cotangent backward through each, and return the relative errors
of the outputs, input gradients and weight gradients.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..engine import EngineOptions
from ..layers.base import ForwardContext, LabelInfo, Layer, Shape4
from ..layers.pairtest import (PAIRTEST_RTOL, clone_generator,
                               probe_vjp_compare, relative_error)

__all__ = ["diff_layers", "PAIRTEST_RTOL"]


def diff_layers(master: Layer, slave: Layer, in_shapes: Sequence[Shape4],
                *, gen: Optional[torch.Generator] = None,
                dtype=torch.float32, train: bool = True,
                labels: Optional[Dict[str, np.ndarray]] = None,
                loss_scale: float = 1.0,
                opts: Optional[EngineOptions] = None,
                inputs: Optional[List[torch.Tensor]] = None,
                params: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, float]:
    """Compare two layer implementations on random inputs.

    Returns ``{"fwd_rel_err", "in_grad_rel_err", "wgrad_rel_err",
    "loss_rel_err"}`` (the latter two 0.0 when the layers own no params
    / emit no loss).  Mirrors pairtest_layer-inl.hpp:75-118: outputs,
    input grads and weight grads under one shared cotangent, the slave's
    weights copied from the master's first (:137-141).

    ``gen`` (a ``torch.Generator``, seeded 0 when None) takes the place
    of the JAX package's PRNG key: it draws the inputs (standard normal),
    the master's parameters, the probe cotangents and, from its state
    after those, the layers' random masks, on its own device.  ``inputs``
    and ``params`` (the master's, by tag) may be given instead of drawn,
    e.g. carried across from the JAX package."""
    if gen is None:
        gen = torch.Generator()
        gen.manual_seed(0)
    dev = gen.device
    in_shapes = [tuple(s) for s in in_shapes]
    if inputs is None:
        inputs = [torch.randn(s, generator=gen, device=dev,
                              dtype=torch.float32).to(dtype)
                  for s in in_shapes]
    m_shapes = master.infer_shapes(list(in_shapes))
    s_shapes = slave.infer_shapes(list(in_shapes))
    assert m_shapes == s_shapes, \
        f"diff_layers: output shapes differ: {m_shapes} vs {s_shapes}"
    mp = master.init_params(gen, list(in_shapes), dtype) \
        if params is None else dict(params)
    sp = {t: v.clone() for t, v in mp.items()}  # master -> slave copy
    mb = master.init_buffers(list(in_shapes), dev)
    sb = slave.init_buffers(list(in_shapes), dev)
    probe = torch.Generator(device=dev)
    probe.manual_seed(int(torch.randint(0, 2 ** 62, (), generator=gen,
                                        device=dev)))
    state = gen.get_state()
    label_info = None
    if labels is not None:
        label_info = LabelInfo(fields={
            k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
            for k, v in labels.items()})
    opts = opts or EngineOptions()

    def ctx() -> ForwardContext:
        return ForwardContext(train=train, opts=opts, labels=label_info,
                              loss_scale=loss_scale,
                              rng=clone_generator(gen, state))

    m_out, s_out, m_loss, s_loss, in_err, w_err = probe_vjp_compare(
        master, slave, mp, sp, mb, sb, list(inputs), ctx, probe)
    zero = torch.zeros(())
    return {
        "fwd_rel_err": float(torch.stack(
            [relative_error(a, b) for a, b in zip(m_out, s_out)]).max()),
        "loss_rel_err": float(relative_error(
            zero if m_loss is None else m_loss.cpu(),
            zero if s_loss is None else s_loss.cpu())),
        "in_grad_rel_err": float(in_err),
        "wgrad_rel_err": float(w_err),
    }
