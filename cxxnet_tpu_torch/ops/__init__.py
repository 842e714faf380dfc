"""Hand-written kernels and their plain PyTorch versions.

Each wrapper launches its CUDA kernel for a CUDA tensor (or raises) and
runs the plain version for a CPU tensor; ``<wrapper>.launches`` counts
kernel launches (:func:`launch_counts` reads them all).  Kernels build
from ``csrc/`` at first use (:mod:`.build`).
"""

from __future__ import annotations

from typing import Dict

_FLASH_FWD = ("flash_fwd_kernel", "flash_fwd_wgmma_kernel")
_FLASH_BWD = (("flash_bwd_delta_kernel",),
              ("flash_bwd_dq_kernel", "flash_bwd_dq_wgmma_kernel"),
              ("flash_bwd_dkv_kernel", "flash_bwd_dkv_wgmma_kernel",
               "flash_bwd_dkv_wide_kernel"))
_LRN_FWD = ("lrn_fwd_kernel", "lrn_fwd_window_kernel")
_LRN_BWD = ("lrn_bwd_kernel", "lrn_bwd_window_kernel")
_WGRAD = (("conv_wgrad_partial_kernel", "conv_wgrad_wgmma_kernel"),
          ("conv_wgrad_reduce_kernel", "conv_wgrad_wgmma_reduce_kernel"))

#: every kernel wrapper with a launch counter, as (module, wrapper,
#: kernels): ``kernels`` holds one tuple for each kernel that every
#: launch puts on the card exactly once, naming the ``__global__``
#: functions it may be (one a route).  The profile window's lost-event
#: guard (monitor/trace.py) holds a trace's events of each tuple against
#: the launches.  ``lnb_rowstats_kernel`` runs only on the layernorm
#: backward's stream route (beside ``lnb_strip_kernel``), so no tuple
#: holds it.
WRAPPERS = (
    ("flash_attention", "flash_attention_fwd", (_FLASH_FWD,)),
    ("flash_attention", "flash_attention_bwd", _FLASH_BWD),
    ("flash_attention", "flash_attention_seg_fwd", (_FLASH_FWD,)),
    ("flash_attention", "flash_attention_seg_bwd", _FLASH_BWD),
    ("layernorm", "layernorm_fwd",
     (("layernorm_fwd_kernel", "layernorm_fwd_warp_kernel"),)),
    ("layernorm", "layernorm_bwd",
     (("lnb_reg_kernel", "lnb_strip_kernel"), ("lnb_colsum_kernel",))),
    ("lrn", "lrn_fwd", (_LRN_FWD,)), ("lrn", "lrn_bwd", (_LRN_BWD,)),
    ("lrn", "lrn_hwcn_fwd", (_LRN_FWD,)), ("lrn", "lrn_hwcn_bwd", (_LRN_BWD,)),
    ("pool", "max_pool_fwd",
     (("max_pool_fwd_kernel", "max_pool_fwd_cells_kernel"),)),
    ("pool", "max_pool_bwd",
     (("max_pool_bwd_kernel", "max_pool_bwd_cells_kernel"),)),
    ("conv_wgrad", "conv_wgrad_hwcn_pallas", _WGRAD),
    ("conv_wgrad", "conv_wgrad_s2d_pallas", _WGRAD),
    ("fused_adam", "fused_adam_pallas", (("fused_adam_kernel",),)),
)


def wrapper_fn(name: str):
    """The wrapper function named ``name`` (one of :data:`WRAPPERS`)."""
    import importlib
    (module,) = [m for m, fn, _ in WRAPPERS if fn == name]
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def launch_counts() -> Dict[str, int]:
    """``{wrapper: launches}`` of every kernel wrapper."""
    return {fn: wrapper_fn(fn).launches for _, fn, _ in WRAPPERS}


def reset_launches() -> None:
    """Set every wrapper's launch counters to 0."""
    for _, fn, _ in WRAPPERS:
        wrapper_fn(fn).launches = 0
    wrapper_fn("max_pool_bwd").relu_launches = 0
