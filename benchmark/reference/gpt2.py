"""Plain PyTorch reference of a GPT-2-style pre-LN decoder LM trained on
document-packed rows, in float32 with TF32 off: token and learned
absolute position embeddings, ``n_layer`` blocks of LayerNorm -> causal
multi-head attention (biased qkv and output projections) -> residual,
LayerNorm -> GELU (tanh form) FFN -> residual, a final LayerNorm and an
untied head; the loss of a row is the mean cross-entropy over its valid
targets (-1 marks none), and a batch's loss the mean over its rows.

Packed rows (the configuration's ``pack_split = 1``): the documents are
one stream, cut into rows of ``seq``; a target is the next token of the
stream when it belongs to the same document (across a row's end too); a
row numbers its documents 1.. in order (0: padding); attention keeps a
query's keys of its own document at or before it; positions count from
each document's start and stop at ``seq - 1``.

Adam as the configuration states it: decay rates ``d1`` / ``d2`` (beta1
= 1 - d1, beta2 = 1 - d2), ``lr_t = eta * sqrt(1 - (1 - d2)^t) / (1 -
(1 - d1)^t)``, ``w -= lr_t * m1 / (sqrt(m2) + eps)``.

Imports nothing of the program.  ``quant`` rounds every matmul operand
(a lower precision's control); ``rows`` keeps a subset of each batch
(a planted fault).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def dims(cfg: dict) -> dict:
    m = cfg["model"]
    return {"d": m["n_embd"], "L": m["n_layer"], "H": m["n_head"],
            "ffn": m["n_inner"], "S": m["n_positions"], "V": m["vocab_size"],
            "eps": m["layer_norm_epsilon"], "sigma": m["initializer_range"]}


def leaf_specs(cfg: dict) -> List[dict]:
    """Every weight, named as the program's layers, with GPT-2's init:
    normal(0, sigma) weights, residual projections sigma / sqrt(2 L),
    zero biases, unit LayerNorm gains."""
    g = dims(cfg)
    d, L, V, S, f, s = g["d"], g["L"], g["V"], g["S"], g["ffn"], g["sigma"]
    s_res = s / math.sqrt(2 * L)

    def w(name, shape, sig):
        return {"name": name, "shape": list(shape), "init": ["normal", sig]}

    def c(name, shape, v):
        return {"name": name, "shape": list(shape), "init": ["const", v]}

    out = [w("embed/wmat", (V, d), s), w("embed/wpos", (S, d), s)]
    for i in range(L):
        out += [c(f"l{i}_ln1/wmat", (d,), 1.0), c(f"l{i}_ln1/bias", (d,), 0.0),
                w(f"l{i}_att/wqkv", (3 * d, d), s),
                c(f"l{i}_att/bqkv", (3 * d,), 0.0),
                w(f"l{i}_att/wout", (d, d), s_res),
                c(f"l{i}_att/bout", (d,), 0.0),
                c(f"l{i}_ln2/wmat", (d,), 1.0), c(f"l{i}_ln2/bias", (d,), 0.0),
                w(f"l{i}_ffn1/wmat", (f, d), s),
                c(f"l{i}_ffn1/bias", (f,), 0.0),
                w(f"l{i}_ffn2/wmat", (d, f), s_res),
                c(f"l{i}_ffn2/bias", (d,), 0.0)]
    out += [c("final_ln/wmat", (d,), 1.0), c("final_ln/bias", (d,), 0.0),
            w("head/wmat", (V, d), s)]
    return out


def matmul_params(cfg: dict) -> int:
    """Weights that multiply activations (embeddings, gains and biases
    excluded): 12 d^2 a block plus the head."""
    g = dims(cfg)
    return g["L"] * (4 * g["d"] ** 2 + 2 * g["d"] * g["ffn"]) \
        + g["V"] * g["d"]


#: stored leaves that hold several parameters along their first axis:
#: the attention's fused q, k, v projections and biases
PARTS = {"wqkv": ("q", "k", "v"), "bqkv": ("q", "k", "v")}


def part_norms(name: str, t: torch.Tensor) -> Dict[str, float]:
    """The float32 norm of each parameter a stored leaf holds (the key's
    bias, whose gradient softmax cancels, apart from the query's)."""
    tag = name.rsplit("/", 1)[-1]
    parts = PARTS.get(tag)
    if parts is None:
        return {name: float(torch.linalg.vector_norm(t.float()))}
    return {f"{name}.{p}": float(torch.linalg.vector_norm(c.float()))
            for p, c in zip(parts, t.chunk(len(parts), dim=0))}


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k, v in tensors.items():
        out.update(part_norms(k, v))
    return out


# ------------------------------------------------------------- packing
def pack(docs: Sequence[np.ndarray], rows: int, seq: int, batches: int
         ) -> List[Dict[str, np.ndarray]]:
    """The first ``batches`` batches of ``rows`` x ``seq`` packed rows of
    the document stream: tokens, targets, segment ids, positions."""
    need = batches * rows * seq + 1
    tok, uid, pos, have = [], [], [], 0
    for i, d in enumerate(docs):
        d = np.asarray(d, np.int64)
        tok.append(d)
        uid.append(np.full(d.size, i + 1, np.int64))
        pos.append(np.arange(d.size, dtype=np.int64))
        have += d.size
        if have >= need:
            break
    if have < need:
        raise ValueError(f"documents hold {have} tokens, {need} needed")
    tok, uid, pos = (np.concatenate(a)[:need] for a in (tok, uid, pos))
    out = []
    for b in range(batches):
        lo = b * rows * seq
        sl = slice(lo, lo + rows * seq)
        t, u = tok[sl].reshape(rows, seq), uid[sl].reshape(rows, seq)
        nxt_t = tok[lo + 1:lo + rows * seq + 1].reshape(rows, seq)
        nxt_u = uid[lo + 1:lo + rows * seq + 1].reshape(rows, seq)
        tgt = np.where(nxt_u == u, nxt_t, -1)
        seg = np.zeros_like(u)
        for r in range(rows):
            _, first, inv = np.unique(u[r], return_index=True,
                                      return_inverse=True)
            order = np.argsort(np.argsort(first))
            seg[r] = order[inv] + 1
        out.append({"tok": t, "tgt": tgt, "seg": seg,
                    "pos": np.minimum(pos[sl].reshape(rows, seq), seq - 1)})
    return out


# ------------------------------------------------------------- forward
def _layernorm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def row_losses(p: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
               cfg: dict, quant: Optional[Callable] = None) -> torch.Tensor:
    """(rows,) loss of each row of ``batch`` (long tensors (rows, s))."""
    g = dims(cfg)
    q = quant or (lambda t: t)
    L, H, eps = g["L"], g["H"], g["eps"]
    tok, tgt, seg, pos = (batch[k] for k in ("tok", "tgt", "seg", "pos"))
    n, s = tok.shape
    d = g["d"]
    hd = d // H
    x = p["embed/wmat"][tok] + p["embed/wpos"][pos.clamp(max=g["S"] - 1)]
    ar = torch.arange(s, device=tok.device)
    keep = ((seg[:, :, None] == seg[:, None, :])
            & (ar[None, :, None] >= ar[None, None, :])
            & (seg[:, :, None] != 0)) | torch.eye(s, dtype=torch.bool,
                                                  device=tok.device)[None]
    keep = keep[:, None]
    for i in range(L):
        h = _layernorm(x, p[f"l{i}_ln1/wmat"], p[f"l{i}_ln1/bias"], eps)
        qkv = F.linear(q(h), q(p[f"l{i}_att/wqkv"]), p[f"l{i}_att/bqkv"])
        qkv = qkv.view(n, s, 3, H, hd).permute(2, 0, 3, 1, 4)
        sc = torch.matmul(q(qkv[0]), q(qkv[1]).transpose(-1, -2)) \
            / math.sqrt(hd)
        pr = torch.softmax(sc.masked_fill(~keep, float("-inf")), dim=-1)
        o = torch.matmul(q(pr), q(qkv[2])).transpose(1, 2).reshape(n, s, d)
        x = x + F.linear(q(o), q(p[f"l{i}_att/wout"]), p[f"l{i}_att/bout"])
        h = _layernorm(x, p[f"l{i}_ln2/wmat"], p[f"l{i}_ln2/bias"], eps)
        h = F.gelu(F.linear(q(h), q(p[f"l{i}_ffn1/wmat"]),
                            p[f"l{i}_ffn1/bias"]), approximate="tanh")
        x = x + F.linear(q(h), q(p[f"l{i}_ffn2/wmat"]), p[f"l{i}_ffn2/bias"])
    x = _layernorm(x, p["final_ln/wmat"], p["final_ln/bias"], eps)
    logp = torch.log_softmax(F.linear(q(x), q(p["head/wmat"])), dim=-1)
    valid = (tgt >= 0).to(logp.dtype)
    lp = logp.gather(2, tgt.clamp(min=0)[:, :, None])[:, :, 0]
    return -(lp * valid).sum(1) / valid.sum(1).clamp(min=1.0)


# ------------------------------------------------------------ training
def train(weights: Dict[str, torch.Tensor], batches: Sequence[dict],
          cfg: dict, opt: dict, quant: Optional[Callable] = None,
          rows: Optional[Sequence[int]] = None, block: int = 1) -> dict:
    """Steps of the configuration's Adam from ``weights`` over
    ``batches`` (numpy rows as :func:`pack` gives them), a block of
    ``block`` rows at a time: each step's loss, each leaf's gradient
    norm at the first step, and each leaf's change after the last."""
    dev = next(iter(weights.values())).device
    p = {k: v.detach().float().clone().requires_grad_(True)
         for k, v in weights.items()}
    m1 = {k: torch.zeros_like(v) for k, v in p.items()}
    m2 = {k: torch.zeros_like(v) for k, v in p.items()}
    d1, d2, eta, eps = opt["d1"], opt["d2"], opt["eta"], opt["eps"]
    losses, grad_norms = [], None
    for t, b in enumerate(batches):
        use = list(range(b["tok"].shape[0])) if rows is None else list(rows)
        total = 0.0
        for lo in range(0, len(use), block):
            idx = use[lo:lo + block]
            blk = {k: torch.as_tensor(b[k][idx], device=dev)
                   for k in ("tok", "tgt", "seg", "pos")}
            loss = row_losses(p, blk, cfg, quant).sum() / len(use)
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            if t == 0:
                grad_norms = norms({k: v.grad for k, v in p.items()})
            lr_t = eta * math.sqrt(1 - (1 - d2) ** (t + 1)) \
                / (1 - (1 - d1) ** (t + 1))
            for k, v in p.items():
                gk = v.grad
                m1[k].add_(gk - m1[k], alpha=d1)
                m2[k].add_(gk * gk - m2[k], alpha=d2)
                v.sub_(lr_t * m1[k] / (torch.sqrt(m2[k]) + eps))
                v.grad = None
    with torch.no_grad():
        change = norms({k: v - weights[k].float() for k, v in p.items()})
    return {"losses": losses, "grad_norms": grad_norms, "change": change}
