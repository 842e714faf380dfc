"""Plain PyTorch reference of the AlexNet of the configuration, in
float32 with TF32 off: five convolutions (conv2, conv4 and conv5 in two
groups), ReLU after each, 3 x 3 / 2 max pooling after conv1, conv2 and
conv5 (a clipped tail window, which at these sizes is torch's floor
pooling), cross-channel LRN after the first two pools, three fully
connected layers with ReLU and dropout after fc6 and fc7, and a softmax
cross-entropy whose batch loss is the mean over rows.

LRN: ``y = x * (knorm + alpha / n * sum x^2) ^ -beta`` over the channels
``[c - n // 2, c + n - 1 - n // 2]``.  Dropout keeps an element where a
uniform draw is below ``1 - threshold`` and scales it by ``1 /
(1 - threshold)``; the draws come from a ``torch.Generator`` on the
card seeded with the program's seed, one ``rand`` of the layer's output
shape a layer in layer order, as the configuration states them.  SGD:
``m = momentum * m - lr * (g + wd * w); w += m``, with the tag's lr and
wd.  Input: ``uint8`` pixels minus the per-channel mean.

Imports nothing of the program.  ``quant`` rounds every conv and matmul
operand (a lower precision's control); ``rows`` keeps a subset of each
batch (a planted fault).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

#: (name, cin, cout, kernel, stride, pad, groups)
CONVS = (("conv1", 3, 96, 11, 4, 0, 1), ("conv2", 96, 256, 5, 1, 2, 2),
         ("conv3", 256, 384, 3, 1, 1, 1), ("conv4", 384, 384, 3, 1, 1, 2),
         ("conv5", 384, 256, 3, 1, 1, 2))
FCS = (("fc6", 9216, 4096), ("fc7", 4096, 4096), ("fc8", 4096, 1000))


def leaf_specs(cfg: dict) -> List[dict]:
    """Every weight as the program's layers name it, with the
    configuration's xavier rule (uniform, a = sqrt(3 / (fan_in +
    fan_out)), fans over a group) and its ``init_bias``."""
    m = cfg["model"]
    bias = m["init_bias"]
    out = []
    for name, cin, cout, k, _, _, g in CONVS:
        a = math.sqrt(3.0 / (cin // g * k * k + cout // g * k * k))
        out += [{"name": f"{name}/wmat", "shape": [cout, cin // g, k, k],
                 "init": ["uniform", a]},
                {"name": f"{name}/bias", "shape": [cout],
                 "init": ["const", bias.get(name, 0.0)]}]
    for name, nin, nout in FCS:
        nout = m["num_class"] if name == "fc8" else nout
        a = math.sqrt(3.0 / (nin + nout))
        out += [{"name": f"{name}/wmat", "shape": [nout, nin],
                 "init": ["uniform", a]},
                {"name": f"{name}/bias", "shape": [nout],
                 "init": ["const", bias.get(name, 0.0)]}]
    return out


def geometry(cfg: dict, n: int) -> dict:
    """The shapes the per-layer metrics bound: each conv's input and
    output, each pool's and each LRN's (NCHW, ``n`` rows)."""
    side = cfg["model"]["input_side"]
    convs, pools, lrns = [], [], []
    for name, cin, cout, k, st, pad, g in CONVS:
        o = (side + 2 * pad - k) // st + 1
        convs.append({"name": name, "n": n, "cin": cin, "cout": cout,
                      "h": side, "oh": o, "k": k, "groups": g})
        side = o
        if name in ("conv1", "conv2", "conv5"):
            po = min(side - 3 + 2 - 1, side - 1) // 2 + 1
            pools.append({"in": n * cout * side * side,
                          "out": n * cout * po * po, "k": 3})
            side = po
            if name != "conv5":
                lrns.append({"numel": n * cout * side * side,
                             "nsize": cfg["model"]["lrn"]["local_size"]})
    fcs = [(nin, m) for _, nin, m in FCS[:-1]] + [(FCS[-1][1],
                                                   cfg["model"]["num_class"])]
    return {"convs": convs, "pools": pools, "lrns": lrns, "fcs": fcs}


def forward_flops(cfg: dict, n: int) -> float:
    """Conv and fullc operations (2 x MACs) of a forward over ``n``."""
    geo = geometry(cfg, n)
    f = sum(2.0 * c["n"] * c["cout"] * c["oh"] ** 2 * (c["cin"] / c["groups"])
            * c["k"] ** 2 for c in geo["convs"])
    return f + sum(2.0 * n * a * b for a, b in geo["fcs"])


def train_flops(cfg: dict, n: int) -> float:
    """Forward, weight gradients and input gradients of every layer but
    conv1, whose input is the data."""
    geo = geometry(cfg, n)
    conv1 = geo["convs"][0]
    c1 = 2.0 * conv1["n"] * conv1["cout"] * conv1["oh"] ** 2 \
        * conv1["cin"] * conv1["k"] ** 2
    return 3.0 * forward_flops(cfg, n) - c1


def _lrn(x, n, alpha, beta, knorm):
    lo = n // 2
    sq = F.pad(x * x, (0, 0, 0, 0, lo, n - 1 - lo))
    c = x.shape[1]
    acc = sum(sq[:, i:i + c] for i in range(n))
    return x * torch.pow(knorm + alpha / n * acc, -beta)


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
            masks: Optional[Sequence[torch.Tensor]] = None,
            quant: Optional[Callable] = None) -> torch.Tensor:
    """Logits of a normalised float32 batch; ``masks`` (a training
    forward) are fc6's and fc7's dropout masks, already scaled."""
    q = quant or (lambda t: t)
    m = cfg["model"]
    lrn = m["lrn"]
    h = x
    for name, _, _, _, st, pad, g in CONVS:
        h = F.relu(F.conv2d(q(h), q(p[f"{name}/wmat"]), p[f"{name}/bias"],
                            stride=st, padding=pad, groups=g))
        if name in ("conv1", "conv2", "conv5"):
            h = F.max_pool2d(h, 3, 2)
            if name != "conv5":
                h = _lrn(h, lrn["local_size"], lrn["alpha"], lrn["beta"],
                         lrn["knorm"])
    h = h.reshape(h.shape[0], -1)
    for i, (name, _, _) in enumerate(FCS):
        h = F.linear(q(h), q(p[f"{name}/wmat"]), p[f"{name}/bias"])
        if name != "fc8":
            h = F.relu(h)
            if masks is not None:
                h = h * masks[i]
    return h


def dropout_masks(gen: torch.Generator, n: int, cfg: dict, device
                  ) -> List[torch.Tensor]:
    """One step's masks of fc6 and fc7, drawn in layer order."""
    keep = 1.0 - cfg["model"]["dropout"]
    out = []
    for _ in range(2):
        u = torch.rand((n, 1, 1, 4096), generator=gen, device=device)
        out.append((u < keep).float().reshape(n, 4096) * (1.0 / keep))
    return out


def part_norms(name: str, t: torch.Tensor) -> Dict[str, float]:
    """The float32 norm of a leaf (each holds one parameter)."""
    return {name: float(torch.linalg.vector_norm(t.float()))}


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tensors.items()}


def sgd_hypers(cfg: dict) -> dict:
    """The configuration's SGD keys: momentum, and lr / wd by tag."""
    k = cfg["keys"]
    return {"momentum": float(k["momentum"]),
            "wmat": {"lr": float(k["wmat:lr"]), "wd": float(k["wmat:wd"])},
            "bias": {"lr": float(k["bias:lr"]), "wd": float(k["bias:wd"])}}


def normalise(data: torch.Tensor, cfg: dict) -> torch.Tensor:
    """uint8 pixels minus the configuration's per-channel mean."""
    mean = torch.tensor([float(v) for v in
                         str(cfg["keys"]["mean_value"]).split(",")],
                        dtype=torch.float32, device=data.device)
    return data.float() - mean.view(1, -1, 1, 1)


def train(weights: Dict[str, torch.Tensor], batches: Sequence[dict],
          cfg: dict, dropout_seed: int,
          quant: Optional[Callable] = None,
          rows: Optional[Sequence[int]] = None) -> dict:
    """Steps of the configuration's SGD from ``weights`` over ``batches``
    (``data`` uint8 (n, 3, s, s), ``label`` (n,) on the card): each step's
    loss, each leaf's gradient norm at the first step, and each leaf's
    change after the last."""
    dev = next(iter(weights.values())).device
    p = {k: v.detach().float().clone().requires_grad_(True)
         for k, v in weights.items()}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    opt = sgd_hypers(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(dropout_seed)
    losses, grad_norms = [], None
    for t, b in enumerate(batches):
        n = b["data"].shape[0]
        masks = dropout_masks(gen, n, cfg, dev)
        use = torch.arange(n, device=dev) if rows is None \
            else torch.as_tensor(list(rows), device=dev)
        x = normalise(b["data"][use], cfg)
        logits = forward(p, x, cfg, [mk[use] for mk in masks], quant)
        loss = F.cross_entropy(logits, b["label"][use].long())
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if t == 0:
                grad_norms = norms({k: v.grad for k, v in p.items()})
            for k, v in p.items():
                h = opt[k.split("/")[1]]
                mom[k].mul_(opt["momentum"]).sub_(
                    h["lr"] * (v.grad + h["wd"] * v))
                v.add_(mom[k])
                v.grad = None
    with torch.no_grad():
        change = norms({k: v - weights[k].float() for k, v in p.items()})
    return {"losses": losses, "grad_norms": grad_norms, "change": change}


@torch.no_grad()
def predict(weights: Dict[str, torch.Tensor], data: torch.Tensor, cfg: dict,
            quant: Optional[Callable] = None, block: int = 64
            ) -> torch.Tensor:
    """Softmax rows of a uint8 batch, ``block`` rows at a time."""
    p = {k: v.float() for k, v in weights.items()}
    out = [torch.softmax(forward(p, normalise(data[i:i + block], cfg), cfg,
                                 quant=quant), dim=-1)
           for i in range(0, data.shape[0], block)]
    return torch.cat(out)
