"""Row LayerNorm forward: the hand-written CUDA kernel
(``csrc/layernorm_fwd.cu``) and its plain PyTorch version.

Replaces the JAX package's Pallas ``_ln_fwd_res`` (pallas_kernels.py),
the forward half of ``layernorm_pallas``: ``(rows, d)`` input, ``(d,)``
gamma / beta, two-pass float32 variance; returns ``y`` in x's dtype and
``mean`` / ``rstd`` as ``(rows, 1)`` float32.  Forward only: the
backward kernels come with the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build

#: largest row the kernel keeps in shared memory (float32 per element)
MAX_D = (232448 - 256) // 4


def layernorm_fwd_plain(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, eps: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch (two-pass float32 moments)."""
    x32 = x.float()
    mean = x32.mean(dim=1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (x32 - mean) * rstd * gamma.float() + beta.float()
    return y.to(x.dtype), mean, rstd


def layernorm_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, mean, rstd)`` for ``(rows, d)`` x.  A CUDA tensor goes
    through the CUDA kernel (or raises); a CPU tensor through
    :func:`layernorm_fwd_plain`."""
    if x.device.type == "cpu":
        return layernorm_fwd_plain(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm_fwd: no kernel for {x.device}")
    if x.dim() != 2:
        raise ValueError(f"layernorm_fwd: expected (rows, d), got {x.shape}")
    rows, d = x.shape
    if gamma.shape != (d,) or beta.shape != (d,):
        raise ValueError(f"layernorm_fwd: gamma {tuple(gamma.shape)} / beta "
                         f"{tuple(beta.shape)} do not match d = {d}")
    if not 1 <= d <= MAX_D or rows < 1:
        raise ValueError(f"layernorm_fwd: shape {tuple(x.shape)} out of "
                         f"range (d up to {MAX_D})")
    if x.dtype not in build.DTYPE_CODES or gamma.dtype != beta.dtype \
            or gamma.dtype not in build.DTYPE_CODES:
        raise ValueError(f"layernorm_fwd: dtypes x {x.dtype}, gamma "
                         f"{gamma.dtype}, beta {beta.dtype}: expected "
                         "float32 or bfloat16, gamma and beta alike")
    if not (x.is_contiguous() and gamma.is_contiguous()
            and beta.is_contiguous()):
        raise ValueError("layernorm_fwd: x, gamma, beta must be contiguous")
    if not (gamma.device == beta.device == x.device):
        raise ValueError("layernorm_fwd: x, gamma, beta on different devices")
    lib = build.LIBRARY.get()
    y = torch.empty_like(x)
    mean = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    err = lib.cxn_layernorm_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), rows, d, float(eps),
        build.DTYPE_CODES[x.dtype], build.DTYPE_CODES[gamma.dtype],
        build.stream_handle(x.device))
    build.check(err, "layernorm_fwd")
    layernorm_fwd.launches += 1
    return y, mean, rstd


#: launches of the CUDA kernel (not of the plain version)
layernorm_fwd.launches = 0
