"""Trainer core: configuration, model init, snapshot load / save, the
eval forward and the training step (the JAX package's ``NetTrainer``).

A training step (:meth:`NetTrainer.update`) runs the forward under
autograd with the batch's label fields, takes ``torch.autograd.grad`` of
the summed loss terms (each already scaled by 1 / (batch_size *
update_period)) and hands each (layer, tag) gradient to the updater.
The three parts run inside ``train_forward`` / ``train_backward`` /
``train_update`` profiler ranges, which ``chip_smoke.py --profile``
reads.
With ``update_period = K > 1`` the gradients of K batches are summed
before one update, as in the JAX package.  Optimizer state is made at
the first update (a serving trainer never holds it).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import engine
from ..layers.base import ForwardContext, LabelInfo
from ..monitor import log as mlog
from ..monitor.metrics import Metrics
from ..updater.updaters import UpdaterHyper, create_updater
from ..utils import serializer
from .net import Network, Params
from .netconfig import NetConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}

#: trainer keys of the JAX package whose features are not ported: any
#: value but the default is refused by name (ROADMAP.md)
UNPORTED_KEYS = {"monitor": "0", "remat": "0", "batch_split": "1",
                 "shard_opt_state": "0", "update_on_server": "0",
                 "input_s2d": "0", "fullc_gather": "0"}


def refuse_unported(name: str, val: str, default: str) -> None:
    if val != default:
        raise ValueError(f"{name} = {val}: not ported to cxxnet_tpu_torch "
                         f"yet (only {default!r}; ROADMAP.md)")


def resolve_device(dev: str) -> torch.device:
    """``dev`` -> torch device.  ``cpu`` runs on the CPU; ``gpu``,
    ``cuda`` and the JAX package's accelerator names (``tpu``, with
    optional ``:i`` or ``:i-j``) run on the card, and raise when there is
    none — an accelerator request never lands on the CPU."""
    platform, _, ids = dev.strip().lower().partition(":")
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("gpu", "cuda", "tpu"):
        raise ValueError(f"dev = {dev!r}: expected cpu, gpu[:i], cuda[:i] "
                         "or tpu[:i]")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"dev = {dev}: no CUDA device is available; set dev = cpu to "
            "run on the CPU")
    index = int(re.split(r"[-,]", ids)[0]) if ids else 0
    return torch.device("cuda", index)


def _torch_leaf(a, dtype_name: Optional[str]) -> torch.Tensor:
    arr = np.asarray(a)
    name = dtype_name or arr.dtype.name
    if name not in DTYPES:
        raise ValueError(f"params_from_jax: unsupported dtype {name!r}")
    return torch.from_numpy(np.array(arr, np.float32)).to(DTYPES[name])


def params_from_jax(params_np: Dict, buffers_np: Dict,
                    dtypes: Optional[Dict[str, str]] = None
                    ) -> Tuple[Params, Params]:
    """The JAX package's nested ``{param_key: {tag: array}}`` params and
    buffers (numpy, bfloat16 allowed) -> the port's CPU tensors, same
    keys (``wmat``, ``bias``, ``wqkv``, ``bqkv``, ``wout``, ``bout``,
    ``wpos``).  ``dtypes`` is a ``.model`` header's map from flattened
    key (``params/<key>/<tag>``) to the dtype a float32-stored leaf had."""
    dtypes = dtypes or {}

    def convert(tree: Dict, group: str) -> Params:
        return {pkey: {tag: _torch_leaf(a, dtypes.get(f"{group}/{pkey}/{tag}"))
                       for tag, a in g.items()}
                for pkey, g in tree.items()}

    return convert(params_np, "params"), convert(buffers_np, "buffers")


def opt_state_from_jax(opt_np: Dict) -> Dict:
    """The JAX package's optimizer state ``{param_key: {tag: {name:
    array}}}`` (``m`` for sgd / nag, ``m1`` / ``m2`` for adam, ``w32``
    masters; all float32) -> the port's CPU float32 tensors."""
    return {pkey: {tag: {k: torch.from_numpy(np.array(a, np.float32))
                         for k, a in st.items()}
                   for tag, st in g.items()}
            for pkey, g in opt_np.items()}


class NetTrainer:
    """Config-driven trainer: ``set_param`` / ``init_model`` /
    ``load_model`` / ``save_model`` / ``update`` / ``forward_eval``."""

    def __init__(self) -> None:
        self.cfg: List[Tuple[str, str]] = []
        self.batch_size = 0
        self.update_period = 1
        self.seed = 0
        self.dev = "gpu"
        self.dtype = torch.float32
        self.silent = 0
        self.round = 0
        self.epoch_counter = 0
        self.sample_counter = 0
        self.opts = engine.EngineOptions()
        self.metrics = Metrics()
        self.net: Optional[Network] = None
        self.netcfg: Optional[NetConfig] = None
        self.device: Optional[torch.device] = None
        self.params: Params = {}
        self.buffers: Params = {}
        self.hypers: Dict[str, Dict[str, UpdaterHyper]] = {}
        self.opt_state: Optional[Dict] = None
        self._opt_host: Optional[Dict] = None  # loaded, installed lazily
        self._grad_acc: Optional[Dict] = None
        self.last_loss: Optional[torch.Tensor] = None

    def set_param(self, name: str, val: str) -> None:
        if name == "batch_size":
            self.batch_size = int(val)
        elif name == "update_period":
            self.update_period = int(val)
            if self.update_period < 1:
                raise ValueError(f"update_period = {val}: expected >= 1")
        elif name == "seed":
            self.seed = int(val)
        elif name == "dev":
            self.dev = val
        elif name == "dtype":
            if val not in DTYPES:
                raise ValueError(f"dtype = {val}: expected one of "
                                 f"{sorted(DTYPES)}")
            self.dtype = DTYPES[val]
        elif name == "mesh":
            sizes = [int(p.split(":")[1]) for p in val.split(",") if ":" in p]
            if int(np.prod(sizes or [1])) > 1:
                raise ValueError(f"mesh = {val}: multi-GPU meshes are not "
                                 "ported to cxxnet_tpu_torch yet (ROADMAP.md)")
        elif name in UNPORTED_KEYS:
            refuse_unported(name, val, UNPORTED_KEYS[name])
        elif name == "metric" or name.startswith("metric["):
            raise ValueError(f"{name} = {val}: evaluation metrics are not "
                             "ported to cxxnet_tpu_torch yet (ROADMAP.md)")
        elif engine.is_engine_option(name):
            self.opts.set(name, val)
        elif name == "silent":
            self.silent = int(val)
            mlog.set_silent(self.silent)
        elif name == "metrics_sink":
            self.metrics.configure_sink(val)
        self.cfg.append((name, val))

    # ---------------------------------------------------------------- init
    def _build_net(self, netcfg: NetConfig) -> None:
        assert self.batch_size > 0, "batch_size must be set"
        self.netcfg = netcfg
        self.device = resolve_device(self.dev)
        self.net = Network(netcfg, self.batch_size, self.dtype)

    def init_model(self) -> None:
        """Fresh weights from ``seed``, drawn on the trainer's device."""
        mlog.set_silent(self.silent)
        netcfg = NetConfig()
        netcfg.configure(self.cfg)
        self._build_net(netcfg)
        self.params = self.net.init_params(self.seed * 100 + 11, self.device)
        self.buffers = {}
        self._post_build()
        mlog.info(self.net.describe())

    def _post_build(self) -> None:
        """The updater, one hyper group per (layer, tag) — global keys,
        then the layer's own section (reference
        NeuralNet::InitUpdaters) — the loss scale and the counters."""
        self.updater = create_updater(self.netcfg.updater_type)
        key_to_layer = {c.param_key: i for i, c in
                        enumerate(self.net.connections) if c.owns_params}
        self.hypers = {}
        for pkey, group in self.params.items():
            li = key_to_layer.get(pkey)
            self.hypers[pkey] = {}
            for tag in group:
                h = UpdaterHyper(tag=tag)
                for k, v in self.netcfg.defcfg:
                    h.set_param(k, v)
                if li is not None:
                    for k, v in self.netcfg.layercfg[li]:
                        h.set_param(k, v)
                self.hypers[pkey][tag] = h
        self.loss_scale = 1.0 / (self.batch_size * self.update_period)
        self._label_fields = self.netcfg.label_fields()
        self.opt_state = None
        self._opt_host = None
        self._grad_acc = None
        self.sample_counter = 0
        self.epoch_counter = 0

    def load_model(self, path: str) -> None:
        """Load a ``.model`` written by either package.  The session's
        config is re-applied on top of the snapshot's, as in the JAX
        package (later pairs win); optimizer state in the file is
        installed at the first update."""
        mlog.set_silent(self.silent)
        self.opt_state = None
        header, params, buffers, opt = serializer.load_model(path)
        netcfg = NetConfig.from_dict(header["net"])
        netcfg.defcfg = list(netcfg.defcfg) + [
            (k, v) for (k, v) in self.cfg if not k.startswith("layer[")]
        for k, v in self.cfg:
            if k == "updater":
                netcfg.updater_type = v
        self._build_net(netcfg)
        self.set_state(*params_from_jax(params, buffers,
                                        header.get("dtypes")))
        self._post_build()
        if opt is not None:
            self._opt_host = opt_state_from_jax(opt)
        self.epoch_counter = header["epoch"]
        self.sample_counter = self.epoch_counter * self.update_period
        self.round = header.get("extra", {}).get("round", 0)

    def set_state(self, params: Params, buffers: Params) -> None:
        """Install parameters (e.g. from :func:`params_from_jax`) on the
        trainer's device, keeping their dtypes."""
        to = lambda tree: {k: {t: v.to(self.device) for t, v in g.items()}
                           for k, g in tree.items()}
        self.params = to(params)
        self.buffers = to(buffers)
        if self.opt_state is not None:
            self._refresh_masters()

    def set_opt_state(self, opt: Dict) -> None:
        """Install optimizer state (e.g. from :func:`opt_state_from_jax`)
        on the trainer's device."""
        self.opt_state = {k: {t: {n: a.to(self.device, torch.float32)
                                  for n, a in st.items()}
                              for t, st in g.items()}
                          for k, g in opt.items()}
        self._opt_host = None

    def _refresh_masters(self) -> None:
        """Re-derive the float32 masters from the params after a direct
        parameter write, so the next update does not revert it."""
        for pkey, group in self.params.items():
            for tag, p in group.items():
                st = self.opt_state[pkey][tag]
                if "w32" in st:
                    st["w32"] = p.detach().float().clone()

    def _ensure_opt_state(self) -> None:
        if self.opt_state is not None:
            return
        if self._opt_host is not None:
            self.set_opt_state(self._opt_host)
            return
        self.opt_state = {pkey: {tag: self.updater.make_state(p)
                                 for tag, p in g.items()}
                          for pkey, g in self.params.items()}

    def save_model(self, path: str, with_opt_state: bool = False) -> None:
        opt = self.opt_state if with_opt_state else None
        serializer.save_model(
            path, net_structure=self.netcfg.to_dict(),
            epoch=self.epoch_counter, params=self.params,
            buffers=self.buffers, opt_state=opt,
            extra_meta={"round": self.round})

    # ------------------------------------------------------------ training
    def start_round(self, r: int) -> None:
        self.round = r

    def _batch_tensors(self, batch) -> Tuple[Dict[int, torch.Tensor],
                                             LabelInfo]:
        dev = self.device
        inputs = {0: torch.as_tensor(np.asarray(batch.data, np.float32),
                                     device=dev)}
        for i, e in enumerate(getattr(batch, "extra_data", None) or ()):
            inputs[1 + i] = torch.as_tensor(np.asarray(e, np.float32),
                                            device=dev)
        label = torch.as_tensor(np.asarray(batch.label, np.float32),
                                device=dev)
        fields = {name: label[:, a:b] for name, a, b in self._label_fields}
        mask = None
        n_padd = int(getattr(batch, "tail_mask_padd", 0))
        if n_padd:
            # tail-batch replica padding trains nothing (DataBatch)
            mask = torch.ones((label.shape[0],), dtype=torch.float32,
                              device=dev)
            mask[label.shape[0] - n_padd:] = 0.0
        return inputs, LabelInfo(fields=fields, mask=mask)

    def loss_and_grads(self, batch) -> Tuple[torch.Tensor, Dict]:
        """The summed, scaled loss of one batch and its gradient for
        every parameter (same nesting as ``params``)."""
        inputs, labels = self._batch_tensors(batch)
        ctx = ForwardContext(train=True, opts=self.opts, labels=labels,
                             loss_scale=self.loss_scale)
        leaves = [(k, t, p) for k, g in self.params.items()
                  for t, p in g.items()]
        for _, _, p in leaves:
            p.requires_grad_(True)
        try:
            with record_function("train_forward"):
                self.net.forward(self.params, inputs, ctx)
                if not ctx.losses:
                    raise RuntimeError("network has no loss layer; cannot "
                                       "train")
                total = ctx.losses[0]
                for term in ctx.losses[1:]:
                    total = total + term
            with record_function("train_backward"):
                grads = torch.autograd.grad(total, [p for _, _, p in leaves])
        finally:
            for _, _, p in leaves:
                p.requires_grad_(False)
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for (k, t, _), g in zip(leaves, grads):
            out.setdefault(k, {})[t] = g
        return total.detach(), out

    def update(self, batch) -> None:
        """One training step on a host :class:`~..io.data.DataBatch`."""
        self._ensure_opt_state()
        self.sample_counter += 1
        do_update = self.sample_counter % self.update_period == 0
        epoch = self.epoch_counter
        if do_update:
            self.epoch_counter += 1
        loss, grads = self.loss_and_grads(batch)
        self.last_loss = loss
        if self.update_period > 1:
            if self._grad_acc is None:
                self._grad_acc = grads
            else:
                for k, g in grads.items():
                    for t, v in g.items():
                        self._grad_acc[k][t].add_(v)
            if not do_update:
                return
            grads, self._grad_acc = self._grad_acc, None
        self.apply_update(grads, epoch)

    def apply_update(self, grads: Dict, epoch: int) -> None:
        """The updater on every (layer, tag), in place."""
        with record_function("train_update"):
            for pkey, group in self.params.items():
                for tag, p in group.items():
                    self.updater.apply(p, grads[pkey][tag],
                                       self.opt_state[pkey][tag],
                                       self.hypers[pkey][tag], epoch)

    def sync(self) -> None:
        """Wait for the device (a no-op on the CPU)."""
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ forward
    def forward_eval(self, data: np.ndarray,
                     node_ids: Sequence[int]) -> List[np.ndarray]:
        """Eval forward of a ``(n, c, y, x)`` batch; float32 numpy values
        of the requested nodes."""
        x = torch.as_tensor(np.asarray(data, np.float32), device=self.device)
        with torch.inference_mode():
            nodes = self.net.forward(self.params, {0: x}, self.context())
        return [nodes[n].float().cpu().numpy() for n in node_ids]

    def context(self, decode=None) -> ForwardContext:
        return ForwardContext(train=False, opts=self.opts, decode=decode)
