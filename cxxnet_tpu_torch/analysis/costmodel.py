"""Analytic per-layer cost model and the card's peaks (the JAX
package's ``analysis/costmodel.py`` with the H100's tables).

One place for the numbers the perf tooling needs: the layer-attribution
roofline columns (``monitor/attribution.py``), the OOM pre-flight's
capacity (``analysis/memmodel.py``) and ``chip_smoke.py``'s kernel
bounds.  The model is deliberately COARSE, with the JAX package's
conventions:

* conv / fullc: ``2 * MACs`` forward; everything else is counted as one
  flop per input+output element (elementwise and reduction layers are
  bound by bytes, not flops);
* bytes: activations in + out + parameters, 4 bytes each (a per-layer
  ranking aid, not a calibrated simulator);
* training multiplier 3x (forward + input grad + weight grad).

Shapes come from the built :class:`~..nnet.net.Network` (batch
included), keyed by :func:`~..layers.base.conn_scope_name`, the names
layer attribution joins on.

The tables hold the card the port runs on, keyed by the name
``torch.cuda.get_device_name()`` gives: the NVIDIA H100 SXM5 (data
sheet, dense): bf16 tensor cores 989e12 flop/s, float32 CUDA cores
67e12 flop/s, HBM3 3.35e12 B/s and 80e9 B.
"""

from __future__ import annotations

from typing import Dict, Optional

H100 = "NVIDIA H100 80GB HBM3"

#: dense bf16 tensor-core peak per card (flop/s)
PEAK_FLOPS = {H100: 989e12}

#: float32 peak of the CUDA cores per card (flop/s), for float32 kernels
PEAK_FLOPS_F32 = {H100: 67e12}

#: memory bandwidth per card (bytes/s)
PEAK_BW = {H100: 3.35e12}

#: memory capacity per card (bytes): the denominator of the OOM
#: pre-flight and of the mem_profile capacity column
HBM_BYTES = {H100: 80e9}

#: the short names ``mem_chip`` takes for each card
ALIASES = {H100: ("h100",)}

TRAIN_FLOP_MULT = 3.0  # forward + dgrad + wgrad


def _lookup(table: Dict[str, float], device_name: str) -> Optional[float]:
    return next((v for k, v in table.items() if k in device_name), None)


def peak_flops(device_name: str) -> Optional[float]:
    """The card's bf16 peak, or None for unknown names (the CPU):
    callers leave MFU columns out rather than report against a made-up
    peak."""
    return _lookup(PEAK_FLOPS, device_name)


def peak_bw(device_name: str) -> Optional[float]:
    return _lookup(PEAK_BW, device_name)


def hbm_bytes(device_name: str, device=None) -> Optional[float]:
    """The card's memory capacity, or None for unknown names.  Given a
    CUDA ``device``, the capacity CUDA reports
    (``torch.cuda.get_device_properties(device).total_memory``) wins
    over the table."""
    if getattr(device, "type", None) == "cuda":
        import torch
        return float(torch.cuda.get_device_properties(device).total_memory)
    return _lookup(HBM_BYTES, device_name)


def resolve_chip(selector: str) -> Optional[str]:
    """Resolve a card selector (``h100``, a full device name, a name
    containing one) to its table key, or None.  Case-insensitive; a
    selector resolves only when it names exactly one card, so a typo or
    an accelerator the tables do not hold (``v5e``, ``gpu``) returns
    None and the caller warns instead of checking against the wrong
    capacity."""
    s = " ".join(selector.strip().lower().split())
    if not s:
        return None
    hits = {k for k in HBM_BYTES
            if k.lower() in s or s in (k.lower(),) + ALIASES.get(k, ())}
    return hits.pop() if len(hits) == 1 else None


def _elems(shape) -> float:
    n = 1.0
    for d in shape:
        n *= d
    return n


def layer_costs(net, train: bool = True) -> Dict[str, Dict[str, float]]:
    """Per-connection analytic cost: scope -> {flops, bytes} per STEP
    (the batch is in the node shapes).  Shared connections get their own
    entry (they run separately even though their parameters alias)."""
    from ..layers.base import conn_scope_name
    from ..layers.conv import ConvolutionLayer
    from ..layers.fullc import FullConnectLayer
    mult = TRAIN_FLOP_MULT if train else 1.0
    out: Dict[str, Dict[str, float]] = {}
    for i, conn in enumerate(net.connections):
        l = conn.layer  # noqa: E741
        in_elems = sum(_elems(net.node_shapes[n]) for n in conn.nindex_in)
        out_elems = sum(_elems(net.node_shapes[n])
                        for n in conn.nindex_out)
        param_elems = 0.0
        if isinstance(l, ConvolutionLayer):
            n, co, oh, ow = net.node_shapes[conn.nindex_out[0]]
            ci = net.node_shapes[conn.nindex_in[0]][1]
            p = l.param
            macs = (n * co * oh * ow * (ci // p.num_group)
                    * p.kernel_height * p.kernel_width)
            flops = 2.0 * macs
            param_elems = (co * (ci // p.num_group)
                           * p.kernel_height * p.kernel_width)
        elif isinstance(l, FullConnectLayer):
            shp_in = net.node_shapes[conn.nindex_in[0]]
            nin = shp_in[1] * shp_in[2] * shp_in[3]
            nout = l.param.num_hidden
            flops = 2.0 * shp_in[0] * nin * nout
            param_elems = float(nin) * nout
        else:
            flops = in_elems + out_elems
        out[conn_scope_name(i, conn)] = {
            "flops": mult * flops,
            "bytes": (mult / 2.0) * 4.0 * (in_elems + out_elems
                                           + param_elems),
        }
    return out
