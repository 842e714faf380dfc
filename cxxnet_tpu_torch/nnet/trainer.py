"""Trainer core for serving: configuration, model init, snapshot load /
save and the eval forward (the JAX package's ``NetTrainer`` surface that
``task = serve`` uses).  The training step comes with the training
slice.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import engine
from ..layers.base import ForwardContext
from ..monitor import log as mlog
from ..monitor.metrics import Metrics
from ..utils import serializer
from .net import Network, Params
from .netconfig import NetConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


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


class NetTrainer:
    """Config-driven model holder: ``set_param`` / ``init_model`` /
    ``load_model`` / ``save_model`` / ``forward_eval``."""

    def __init__(self) -> None:
        self.cfg: List[Tuple[str, str]] = []
        self.batch_size = 0
        self.seed = 0
        self.dev = "gpu"
        self.dtype = torch.float32
        self.silent = 0
        self.round = 0
        self.epoch_counter = 0
        self.opts = engine.EngineOptions()
        self.metrics = Metrics()
        self.net: Optional[Network] = None
        self.netcfg: Optional[NetConfig] = None
        self.device: Optional[torch.device] = None
        self.params: Params = {}
        self.buffers: Params = {}

    def set_param(self, name: str, val: str) -> None:
        if name == "batch_size":
            self.batch_size = int(val)
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
                                 "ported yet (ROADMAP.md)")
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
        mlog.info(self.net.describe())

    def load_model(self, path: str) -> None:
        """Load a ``.model`` written by either package.  The session's
        config is re-applied on top of the snapshot's, as in the JAX
        package (later pairs win)."""
        mlog.set_silent(self.silent)
        header, params, buffers = serializer.load_model(path)
        netcfg = NetConfig.from_dict(header["net"])
        netcfg.defcfg = list(netcfg.defcfg) + [
            (k, v) for (k, v) in self.cfg if not k.startswith("layer[")]
        for k, v in self.cfg:
            if k == "updater":
                netcfg.updater_type = v
        self._build_net(netcfg)
        self.set_state(*params_from_jax(params, buffers,
                                        header.get("dtypes")))
        self.epoch_counter = header["epoch"]
        self.round = header.get("extra", {}).get("round", 0)

    def set_state(self, params: Params, buffers: Params) -> None:
        """Install parameters (e.g. from :func:`params_from_jax`) on the
        trainer's device, keeping their dtypes."""
        to = lambda tree: {k: {t: v.to(self.device) for t, v in g.items()}
                           for k, g in tree.items()}
        self.params = to(params)
        self.buffers = to(buffers)

    def save_model(self, path: str) -> None:
        serializer.save_model(
            path, net_structure=self.netcfg.to_dict(),
            epoch=self.epoch_counter, params=self.params,
            buffers=self.buffers, extra_meta={"round": self.round})

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
