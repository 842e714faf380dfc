"""One-sweep adam update of a bf16 parameter with a float32 master: the
hand-written CUDA kernel (``csrc/fused_adam.cu``), its plain PyTorch
version and the gate that admits a tensor to it.

Replaces the JAX package's Pallas ``fused_adam_pallas``
(``_fused_adam_kernel``, pallas_kernels.py), the ``fused_update = 1``
branch of its ``AdamUpdater.apply``: the bf16 gradient's NaN-zeroing
clip, ``g - wd * w`` (the reference adam's sign, skipped for wd <= 0),
the moments with the reference's decay rates d1 / d2, the float32 master
``w -= lr_t * m1 / (sqrt(m2) + 1e-8)`` and its bf16 cast, in one pass
over the tensor.  Unlike the JAX function, the wrapper writes m1, m2,
the master and the bf16 parameter in place (no second copy of the
optimizer state on the card).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build

#: the JAX package's row width; an admitted tensor tiles as (8k, 1024)
FU_LANES = 1024
EPS = 1e-8


def fused_adam_supported(p: torch.Tensor) -> bool:
    """Tensors the fused update takes: bf16 working parameters (else
    there is no master to fuse) whose size is a multiple of 8 x 1024 —
    the JAX package's gate without its TPU-backend test, so both
    packages fuse the same tensors."""
    return p.dtype == torch.bfloat16 and p.numel() % (8 * FU_LANES) == 0


def fused_adam_plain(g: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor,
                     w32: torch.Tensor, lr_t: float, d1: float, d2: float,
                     wd: float = 0.0, clip: float = 0.0
                     ) -> Tuple[torch.Tensor, ...]:
    """The update in plain PyTorch, float32 math: returns new ``(p (bf16),
    m1, m2, w32)`` and leaves its inputs as they were."""
    g = g.float()
    if clip:
        g = torch.where(torch.isnan(g), 0.0, g).clamp(-clip, clip)
    if wd > 0.0:
        g = g - wd * w32
    m1 = m1 + d1 * (g - m1)
    m2 = m2 + d2 * (torch.square(g) - m2)
    w = w32 - lr_t * (m1 / (torch.sqrt(m2) + EPS))
    return w.to(torch.bfloat16), m1, m2, w


def _check(g, m1, m2, w32, out) -> None:
    n = out.numel()
    for name, t, dtype in (("g", g, torch.bfloat16), ("m1", m1, torch.float32),
                           ("m2", m2, torch.float32),
                           ("w32", w32, torch.float32),
                           ("param", out, torch.bfloat16)):
        if (t.dtype != dtype or t.numel() != n or t.device != out.device
                or not t.is_contiguous()):
            raise ValueError(f"fused_adam: {name} {t.dtype} {tuple(t.shape)}"
                             f" on {t.device}: expected contiguous {dtype} "
                             f"of {n} elements on {out.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_adam: {name} is not 16-byte aligned")
    if n == 0 or n % 8:
        raise ValueError(f"fused_adam: {n} elements: expected a positive "
                         "multiple of 8")


def fused_adam_pallas(g: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor,
                      w32: torch.Tensor, lr_t: float, *, d1: float,
                      d2: float, wd: float = 0.0, clip: float = 0.0,
                      out: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One adam step of the bf16 parameter ``out`` from gradient ``g``:
    writes m1, m2, w32 and ``out`` in place and returns them as ``(out,
    m1, m2, w32)``.  CUDA tensors go through the CUDA kernel (or raise);
    CPU tensors through :func:`fused_adam_plain`.  Gate with
    :func:`fused_adam_supported`."""
    if out.device.type in build.PLAIN_DEVICES:
        new = fused_adam_plain(g, m1, m2, w32, lr_t, d1, d2, wd, clip)
        for dst, src in zip((out, m1, m2, w32), new):
            dst.copy_(src)
        return out, m1, m2, w32
    if out.device.type != "cuda":
        raise ValueError(f"fused_adam: no kernel for {out.device}")
    _check(g, m1, m2, w32, out)
    err = build.LIBRARY.get().cxn_fused_adam(
        g.data_ptr(), m1.data_ptr(), m2.data_ptr(), w32.data_ptr(),
        out.data_ptr(), out.numel(), float(lr_t), float(d1), float(d2),
        float(wd), float(clip), build.stream_handle(out.device))
    build.check(err, "fused_adam")
    fused_adam_pallas.launches += 1
    return out, m1, m2, w32


#: launches of the CUDA kernel (not of the plain version)
fused_adam_pallas.launches = 0
