"""Engine options: the JAX package's lowering switches, same keys,
defaults, environment variables and validation (``cxxnet_tpu/engine.py``
``_DEFS``), so a conf reads the same in both packages.

Unlike the JAX package's process-global ``opts``, every trainer owns an
:class:`EngineOptions` and the forward pass reads it from its
:class:`~cxxnet_tpu_torch.layers.base.ForwardContext`, so two trainers in
one process cannot change each other's kernels.

Options the port acts on (every value the JAX package takes):

| key               | values            | meaning on the port                |
|-------------------|-------------------|------------------------------------|
| flash_attn        | 1 (default), 0    | 0 = plain torch attention instead  |
|                   |                   | of the hand-written flash kernels  |
| pallas_ln         | 1 (default), x, 0 | 0 = plain torch layernorm; x = the |
|                   |                   | kernels, backward from the input   |
| pool_layout       | nchw (default),   | hwcn = every max pool through the  |
|                   | chwn, hwcn        | all-ties pool kernels; chwn = the  |
|                   |                   | same lowering as nchw on the card  |
| pool_bwd          | sas (default),    | eq / gather = the all-ties pool    |
|                   | eq, gather, auto  | kernels (one function); sas = the  |
|                   |                   | one-winner plain torch pool; auto  |
|                   |                   | = all-ties through the kernels     |
|                   |                   | where ``ops.nn.hwcn_pool_ok``      |
|                   |                   | holds (on the card), else sas      |
| pool_relu_reorder | 1 (default), 0    | relu before a max pool moves after |
|                   |                   | it (and a conv bias with it)       |
| pool_relu_fuse    | 0 (default), 1    | 1 = relu(max pool) through the     |
|                   |                   | relu-fused all-ties pool kernels   |
|                   |                   | where ``ops.nn.hwcn_pool_ok``      |
|                   |                   | holds, else the configured pool    |
|                   |                   | and relu                           |
| pallas_lrn        | band (default),   | 1 = the LRN kernels; hwcn = the    |
|                   | bandconv, hwcn,   | (H, W, C, N) LRN kernels where the |
|                   | 1, 0              | shape fits their gate; the others  |
|                   |                   | the plain torch LRN (one function) |
| fast_wgrad        | s2d (default),    | the conv1 class (stride >= 2, cin  |
|                   | hwcn, pallas, off | <= 4, ungrouped) takes dW and db   |
|                   |                   | from one wgrad: hwcn = the wgrad   |
|                   |                   | kernel; pallas = the same kernel   |
|                   |                   | at stride 1 over the space-to-     |
|                   |                   | depth input; s2d = torch's; off =  |
|                   |                   | plain autograd                     |
| fused_update      | 0 (default), 1    | 1 = adam on a bf16 tensor with a   |
|                   |                   | float32 master whose size is a     |
|                   |                   | multiple of 8192 in one fused      |
|                   |                   | update kernel                      |
| group_conv        | fgc (default),    | split = the same lowering as fgc   |
|                   | split             | on the card (one grouped conv)     |
| conv1_fwd         | conv (default),   | s2d = the fast-wgrad conv class's  |
|                   | s2d               | forward through the space-to-depth |
|                   |                   | identity                           |
| relu_vjp          | out (default),    | out = relu's gradient masked by    |
|                   | xla               | its output; xla = max(x, 0)'s (half|
|                   |                   | the gradient at x == 0)            |
| conv_sibling_fuse | 0 (default), 1    | 1 = convs of one input and one     |
|                   |                   | geometry run as one conv (the      |
|                   |                   | trainer's ``_fuse_sibling_convs``) |
| concat_virtual    | 0 (default), 1    | 1 = a ch_concat stays a list of    |
|                   |                   | segments (``layers.base.ChSegs``)  |
|                   |                   | that convs and pools consume       |

One gate reads the device, as the JAX package's reads its backend: the
pool gate ``ops.nn.hwcn_pool_ok`` of ``pool_bwd = auto`` and
``pool_relu_fuse = 1`` holds only for a tensor on the card.  Elsewhere
the CPU and the card build the same graph, and only the kernel-or-plain
choice inside a wrapper follows the tensor's device.  The ``dp_*``
options drive the data-parallel plane (``parallel/overlap.py``) as in
the JAX package:

| key             | values           | meaning on the port                |
|-----------------|------------------|------------------------------------|
| dp_overlap      | 0 (default), 1   | 1 = bucketed gradient reductions   |
|                 |                  | issued from the backward           |
| dp_bucket_mb    | 4 (default), > 0 | a bucket's parameter MiB           |
| dp_reduce_dtype | f32 (default),   | the reductions' wire dtype         |
|                 | bf16             |                                    |
| dp_reduce_at    | apply (default), | with update_period > 1: reduce     |
|                 | step             | once per apply, or every step      |
"""

from __future__ import annotations

import os
from typing import Dict


def _is_positive_float(val: str) -> bool:
    try:
        return float(val) > 0.0
    except ValueError:
        return False


_is_positive_float.expected = "a positive float"

_DEFS = {
    # name: (env var, default, valid values — a tuple of spellings or a
    # predicate for free-form numerics); flash_attn's env var is an
    # inverted bool, special-cased in EngineOptions.__init__
    "pool_bwd": ("CXXNET_POOL_BWD", "sas", ("sas", "eq", "gather", "auto")),
    "pool_layout": ("CXXNET_POOL_LAYOUT", "nchw", ("nchw", "chwn", "hwcn")),
    "fast_wgrad": ("CXXNET_FAST_WGRAD", "s2d",
                   ("s2d", "hwcn", "pallas", "off")),
    "group_conv": ("CXXNET_GROUP_CONV", "fgc", ("fgc", "split")),
    "conv1_fwd": ("CXXNET_CONV1_FWD", "conv", ("conv", "s2d")),
    "pallas_lrn": ("CXXNET_PALLAS_LRN", "band",
                   ("band", "bandconv", "hwcn", "1", "0")),
    "relu_vjp": ("CXXNET_RELU_VJP", "out", ("out", "xla")),
    "pool_relu_reorder": ("CXXNET_POOL_RELU_REORDER", "1", ("1", "0")),
    "pool_relu_fuse": ("CXXNET_POOL_RELU_FUSE", "0", ("1", "0")),
    "conv_sibling_fuse": ("CXXNET_CONV_SIBLING_FUSE", "0", ("1", "0")),
    "concat_virtual": ("CXXNET_CONCAT_VIRTUAL", "0", ("1", "0")),
    "flash_attn": ("CXXNET_NO_FLASH_ATTN", "1", ("1", "0")),
    "pallas_ln": ("CXXNET_PALLAS_LN", "1", ("1", "x", "0")),
    "fused_update": ("CXXNET_FUSED_UPDATE", "0", ("1", "0")),
    "dp_overlap": ("CXXNET_DP_OVERLAP", "0", ("1", "0")),
    "dp_bucket_mb": ("CXXNET_DP_BUCKET_MB", "4", _is_positive_float),
    "dp_reduce_dtype": ("CXXNET_DP_REDUCE_DTYPE", "f32", ("f32", "bf16")),
    "dp_reduce_at": ("CXXNET_DP_REDUCE_AT", "apply", ("apply", "step")),
}


def _check(name: str, val: str, where: str) -> None:
    if not _valid(name, val):
        raise ValueError(f"{where} = {val}: expected {_expectation(name)}")


def _valid(name: str, val: str) -> bool:
    valid = _DEFS[name][2]
    return valid(val) if callable(valid) else val in valid


def _expectation(name: str) -> str:
    valid = _DEFS[name][2]
    if callable(valid):
        return getattr(valid, "expected", valid.__name__)
    return f"one of {valid}"


def is_engine_option(name: str) -> bool:
    return name in _DEFS


class EngineOptions:
    """One trainer's option values; environment variables set the
    defaults and a config key wins over them."""

    def __init__(self):
        for name, (env, default, _) in _DEFS.items():
            if name == "flash_attn":
                # the env var is an opt-OUT (CXXNET_NO_FLASH_ATTN=1)
                val = "0" if os.environ.get(env) else "1"
            else:
                val = os.environ.get(env, default)
            _check(name, val, f"env {env}")
            setattr(self, name, val)

    def set(self, name: str, val: str) -> None:
        if name not in _DEFS:
            raise ValueError(f"unknown engine option {name!r}")
        _check(name, val, f"engine option {name}")
        setattr(self, name, val)

    def snapshot(self) -> Dict[str, str]:
        return {k: getattr(self, k) for k in _DEFS}


def key_specs():
    """The options as lint KeySpecs (``analysis/registry.py``): the value
    check is the ``_valid`` the runtime enforces, so the lint and
    :meth:`EngineOptions.set` never disagree on a spelling."""
    from .analysis.schema import KeySpec

    def make_check(name):
        def check(val):
            if not _valid(name, val):
                return f"expected {_expectation(name)}"
            return None
        return check

    return tuple(
        KeySpec(name=name, kind="str", check=make_check(name),
                help=f"engine option (env {env}, default {default!r})")
        for name, (env, default, _) in _DEFS.items())
