"""Mixture-of-experts layer with expert-parallel weights (the JAX
package's ``layers/moe.py``).

Switch-style top-1 routing with a fixed expert capacity::

    layer[+1] = moe
      num_expert = 8
      nhidden = 2048            # expert FFN width
      capacity_factor = 1.25    # per-expert slots = cf * tokens / E
      moe_alpha = 0.01          # load-balance aux loss weight

Forward (tokens t = batch * seq, width d, experts E, capacity c): the
float32 gate's probabilities (t, E) give each token its expert and its
slot (its rank among the tokens routed to that expert, in token order);
tokens past slot ``c`` are dropped.  ``y = x + gate_p * FFN_e(x)`` and a
dropped token keeps ``y = x``: the residual applies to every token.  Two
dispatch paths compute the same function (``moe_dispatch``): ``dense``,
the one-hot (t, E, c) einsum pair, and ``sorted``, a stable argsort by
expert and two gathers, with no (t, E, c) tensor; ``auto`` takes dense
where an axis hosts the experts, sorted elsewhere.  The Switch aux loss
``moe_alpha * E * sum_e f_e * P_e`` (tail-batch replica rows excluded)
joins the step's losses.

On a mesh (the port runs a rank a device): the capacity counts the
*global* tokens and a token's slot is its rank in *global* token order
(row-major over the global batch and sequence), so a rank adds the
counts of the tokens before its block (an all-gather of the per-row
expert counts over ``data`` and, when positions are split, ``seq``)
before its local count, and the tokens of later ranks are the ones
dropped at capacity; the aux loss's fractions and mean probabilities are
global means, and each rank adds its tokens' share.  The axis that hosts
the experts (:func:`expert_host_axis`: ``expert``, else ``model``) holds
each per-expert tensor as its block of experts; every rank of that axis
holds the same tokens (the batch shards over ``data`` only), runs its
local experts on them and the partial outputs are summed over the axis
(:class:`~..parallel.data.SumPartials`).  The tokens and the gate
probabilities enter that region through
:class:`~..parallel.data.SumGrads`, so their gradients, and through
them the replicated parameters', are whole on every rank rather than
each rank's share.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..analysis.schema import K
from ..ops import nn as N
from ..parallel import data as dplib, mesh as meshlib
from .base import ForwardContext, Layer, Shape4

def expert_host_axis(mesh) -> Optional[str]:
    """The mesh axis hosting the per-expert dimension: ``expert`` when it
    is wider than 1, else ``model`` when it is, else None (the JAX
    package's rule, which both the rest placement and the forward
    read)."""
    if mesh is not None:
        for ax in ("expert", "model"):
            if mesh.axis_size(ax) > 1:
                return ax
    return None


def expert_shard_rows(tag: str, shape, size: int) -> bool:
    """True when leaf ``tag`` of a moe layer is held as its block of
    experts over an axis of ``size`` ranks (the JAX package's
    ``MoELayer.shard_spec``): every per-expert tensor whose leading dim
    divides; the gate stays replicated."""
    return tag != "gate" and len(shape) >= 1 and shape[0] % size == 0


def _token_split(ctx: ForwardContext) -> Tuple[int, int]:
    """(data ranks, seq ranks) the forward's tokens are split over: rows
    over ``data`` on a mesh with a group, positions over ``seq`` when the
    trainer split them (``ctx.seq_split``)."""
    mesh = ctx.mesh
    if mesh is None or mesh.virtual:
        return 1, 1
    nq = mesh.axis_size("seq") if ctx.seq_split else 1
    return mesh.axis_size("data"), nq


class MoELayer(Layer):
    type_names = ("moe",)
    extra_config_keys = (
        K("num_expert", "int", lo=2),
        K("capacity_factor", "float", lo=0.0),
        K("moe_alpha", "float"),
        K("moe_dispatch", "enum", choices=("auto", "dense", "sorted")),
        K("router_jitter", "float", lo=0.0),
    )

    def __init__(self):
        super().__init__()
        self.num_expert = 0
        self.capacity_factor = 1.25
        self.moe_alpha = 0.01
        self.moe_dispatch = "auto"
        self.router_jitter = 0.0

    def set_param(self, name, val):
        if name == "num_expert":
            self.num_expert = int(val)
        elif name == "capacity_factor":
            self.capacity_factor = float(val)
        elif name == "moe_alpha":
            self.moe_alpha = float(val)
        elif name == "moe_dispatch":
            assert val in ("auto", "dense", "sorted"), \
                f"moe_dispatch must be auto|dense|sorted, got {val!r}"
            self.moe_dispatch = val
        elif name == "router_jitter":
            self.router_jitter = float(val)
        else:
            super().set_param(name, val)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, "moe: 1-1 connection only"
        assert self.num_expert > 1, "moe: set num_expert"
        assert self.param.num_hidden > 0, "moe: set nhidden (FFN width)"
        return [in_shapes[0]]

    def _capacity(self, tokens: int) -> int:
        return max(1, int(self.capacity_factor * tokens / self.num_expert))

    def init_params(self, gen, in_shapes, dtype=torch.float32):
        d = in_shapes[0][3]
        e, h = self.num_expert, self.param.num_hidden
        p = self.param
        dev = gen.device
        return {
            "gate": p.rand_init_weight(gen, (d, e), d, e, dtype),
            "wmat": p.rand_init_weight(gen, (e, d, h), d, h, dtype),
            "wmat2": p.rand_init_weight(gen, (e, h, d), h, d, dtype),
            "bias": torch.full((e, h), p.init_bias, dtype=dtype, device=dev),
            "bias2": torch.full((e, d), p.init_bias, dtype=dtype,
                                device=dev),
        }

    # -- dispatch / combine ----------------------------------------------
    @staticmethod
    def _ffn(params, xe):
        """The batched per-expert FFN on (E_local, c, d) slots."""
        w1 = params["wmat"].to(xe.dtype)
        w2 = params["wmat2"].to(xe.dtype)
        b1 = params["bias"].to(xe.dtype)
        b2 = params["bias2"].to(xe.dtype)
        h = F.gelu(torch.matmul(xe, w1) + b1[:, None, :], approximate="tanh")
        return torch.matmul(h, w2) + b2[:, None, :]

    def _dense_path(self, params, x, expert, gate_p, pos, c, e0, el):
        """The one-hot (t, E_local, c) dispatch and combine."""
        keep = pos < c
        onehot = F.one_hot(expert, self.num_expert)[:, e0:e0 + el]
        disp = onehot.float() * keep[:, None].float()
        slot = (pos[:, None] == torch.arange(c, device=x.device)).float()
        dmat = (disp[:, :, None] * slot[:, None, :]).to(x.dtype)
        xe = torch.einsum("tec,td->ecd", dmat, x)
        ye = self._ffn(params, xe)
        comb = dmat * gate_p.to(x.dtype)[:, None, None]
        return torch.einsum("ecd,tec->td", ye, comb)

    def _sorted_path(self, params, x, expert, gate_p, base, c, e0, el):
        """Sort-based dispatch: a stable argsort by expert gives a token's
        rank among this rank's tokens of its expert (plus ``base``, the
        global tokens of that expert before it); data moves by two
        gathers.  No (t, E, c) tensor."""
        t, d = x.shape
        ec = el * c
        dev = x.device
        order = torch.argsort(expert, stable=True)
        sorted_e = expert[order]
        seg_start = torch.searchsorted(
            sorted_e, torch.arange(self.num_expert, device=dev))
        pos_sorted = torch.arange(t, device=dev) - seg_start[sorted_e] \
            + base[order, sorted_e]
        local = sorted_e - e0
        ok = (pos_sorted < c) & (local >= 0) & (local < el)
        dest_ok = torch.where(ok, local * c + pos_sorted,
                              torch.full_like(pos_sorted, ec))
        # one spare slot takes every dropped token's write
        token_for_slot = torch.zeros(ec + 1, dtype=torch.long, device=dev)
        token_for_slot[dest_ok] = order
        slot_filled = torch.zeros(ec + 1, dtype=torch.bool, device=dev)
        slot_filled[dest_ok] = True
        token_for_slot, slot_filled = token_for_slot[:ec], slot_filled[:ec]
        xe = torch.where(slot_filled[:, None], x[token_for_slot],
                         torch.zeros((), dtype=x.dtype, device=dev)
                         ).reshape(el, c, d)
        ye = self._ffn(params, xe)
        slot_of_token = torch.full((t,), ec, dtype=torch.long, device=dev)
        slot_of_token[order] = dest_ok
        valid = slot_of_token < ec
        gathered = ye.reshape(ec, d)[slot_of_token.clamp(max=ec - 1)]
        return torch.where(valid[:, None],
                           gathered * gate_p.to(x.dtype)[:, None],
                           torch.zeros((), dtype=x.dtype, device=dev))

    def _token_base(self, expert_rows: torch.Tensor, ctx: ForwardContext
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(before, local_before)``, each (b_local, E) int: for each of
        this rank's rows, the global tokens routed to each expert that
        precede the row's block in global token order, and this rank's
        own such tokens in its rows before it.  A token's global slot is
        ``before`` plus its rank within the row's block, or ``before -
        local_before`` plus its rank among the rank's tokens."""
        e = self.num_expert
        counts = F.one_hot(expert_rows, e).sum(dim=1)  # (b_local, E)
        local_before = torch.cumsum(counts, dim=0) - counts
        nd, nq = _token_split(ctx)
        if nd * nq == 1:
            return local_before, local_before
        mesh = ctx.mesh
        b = counts.shape[0]
        every = counts[None]
        if nq > 1:
            every = meshlib.all_gather(every.contiguous(), mesh, "seq")
        if nd > 1:
            every = meshlib.all_gather(every.contiguous(), mesh, "data")
        # (data, seq, row, E) -> global order: (data, row, seq) row-major
        table = every.reshape(nd, nq, b, e).permute(0, 2, 1, 3) \
            .reshape(nd * b * nq, e)
        before = torch.cumsum(table, dim=0) - table
        d = mesh.axis_index("data") if nd > 1 else 0
        q = mesh.axis_index("seq") if nq > 1 else 0
        rows = (d * b + torch.arange(b, device=counts.device)) * nq + q
        return before[rows], local_before

    def _jitter(self, ctx: ForwardContext, shape) -> torch.Tensor:
        """Multiplicative router noise U[1 - eps, 1 + eps) for the (b, s,
        d) tokens: the global batch's draw, this rank's rows and
        positions kept (every rank's generator moves in step)."""
        eps = self.router_jitter
        nd, nq = _token_split(ctx)
        b, s, d = shape
        u = N.uniform(ctx.rng, (b * nd, s * nq, d), torch.float32)
        if nd * nq > 1:
            rd = ctx.mesh.axis_index("data") if nd > 1 else 0
            rq = ctx.mesh.axis_index("seq") if nq > 1 else 0
            u = u[rd * b:(rd + 1) * b, rq * s:(rq + 1) * s]
        return (1 - eps) + (2 * eps) * u

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        x4 = inputs[0]                       # (b, 1, s, d)
        b, _, s, d = x4.shape
        e = self.num_expert
        nd, nq = _token_split(ctx)
        c = self._capacity(b * nd * s * nq)
        x = x4.reshape(b * s, d)

        # top-1 routing in float32
        xg = x.float()
        if ctx.train and self.router_jitter > 0:
            xg = xg * self._jitter(ctx, (b, s, d)).reshape(b * s, d)
        logits = xg @ params["gate"].float()
        probs = torch.softmax(logits, dim=-1)            # (t, E)
        expert = torch.argmax(probs, dim=-1)             # (t,)
        gate_p = probs.gather(1, expert[:, None])[:, 0]
        before, local_before = self._token_base(expert.reshape(b, s), ctx)
        mesh = ctx.mesh
        eaxis = expert_host_axis(mesh)
        el = params["wmat"].shape[0]
        e0 = mesh.axis_index(eaxis) * el if el < e else 0
        partial = el < e
        dispatch = self.moe_dispatch
        if dispatch == "auto":
            dispatch = "dense" if eaxis is not None else "sorted"
        xin, gin = x, gate_p
        if partial:
            xin = dplib.SumGrads.apply(x, mesh, eaxis)
            gin = dplib.SumGrads.apply(gate_p, mesh, eaxis)
        if dispatch == "dense":
            onehot = F.one_hot(expert, e)
            within = (torch.cumsum(onehot.reshape(b, s, e), dim=1) - 1) \
                + before[:, None, :]
            pos = (within.reshape(b * s, e) * onehot).sum(dim=1)
            y = self._dense_path(params, xin, expert, gin, pos, c, e0, el)
        else:
            base = (before - local_before).repeat_interleave(s, dim=0)
            y = self._sorted_path(params, xin, expert, gin, base, c, e0, el)
        if partial:
            y = dplib.SumPartials.apply(y, mesh, eaxis)
        # every token keeps its residual: continuous at the capacity edge
        y = x + y

        if ctx.train and self.moe_alpha > 0:
            self._aux_loss(ctx, expert, probs, b, s, nd)
        return [y.reshape(b, 1, s, d)]

    def _aux_loss(self, ctx, expert, probs, b, s, nd) -> None:
        """The Switch load-balance loss over the global tokens (tail-
        batch replica rows excluded), this rank's share of it:
        ``alpha * E * sum_e frac_e * (local prob sum_e / n)`` with the
        global fractions and count; the shares sum to the global loss
        over ``data`` x ``seq`` (its weight ``loss_scale * b`` over the
        global batch: 1 / update_period)."""
        e = self.num_expert
        lmask = ctx.labels.mask if ctx.labels is not None else None
        onehot = F.one_hot(expert, e).float()
        if lmask is not None:
            tm = lmask.float().repeat_interleave(s)
            nf = (onehot * tm[:, None]).sum(dim=0)
            np_ = (probs * tm[:, None]).sum(dim=0)
            cnt = tm.sum().reshape(1)
        else:
            nf = onehot.sum(dim=0)
            np_ = probs.sum(dim=0)
            cnt = torch.full((1,), float(probs.shape[0]),
                             device=probs.device)
        stats = torch.cat([nf, cnt])
        if ctx.mesh is not None:
            for ax in ("data", "seq") if ctx.seq_split else ("data",):
                stats = meshlib.all_reduce(stats.clone(), ctx.mesh, ax)
        denom = stats[e:].clamp(min=1.0) if lmask is not None \
            else stats[e:]
        frac = stats[:e] / denom
        aux = self.moe_alpha * e * torch.sum(frac * (np_ / denom))
        ctx.losses.append(aux.float() * ctx.loss_scale * (b * nd))
