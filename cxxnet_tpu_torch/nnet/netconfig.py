"""Network structure configuration: the ``netconfig=start/end`` +
``layer[from->to] = type:name`` declaration language.

Reference: ``src/nnet/nnet_config.h`` (Configure :207-289, GetLayerInfo
:303-360).  Parity covers:

* node name/index maps seeded with node 0 = "in" (and "0");
* ``layer[+1]`` auto-node, ``layer[+0]`` self-loop, ``layer[+1:tag]`` named
  output node;
* ``layer[a,b->c]`` comma-separated multi-node connections;
* ``share[tag]`` layers referencing a primary layer by name;
* per-layer config capture (keys after a ``layer[..]`` line belong to that
  layer until the next ``layer[..]``/``netconfig=end``);
* ``label_vec[a,b)`` multi-label field ranges and ``extra_data_num`` /
  ``extra_data_shape[i]`` side inputs;
* ``input_shape = c,y,x``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

from ..utils.config import ConfigError, ConfigPairs


def global_pairs(defcfg: ConfigPairs) -> ConfigPairs:
    """The pairs of ``defcfg`` that every layer (and updater group)
    takes: those outside ``netconfig = start ... end`` blocks.  A loaded
    snapshot's net appends the session's config to its ``defcfg`` as the
    JAX package does (and saves it so), netconfig blocks included; a key
    of a layer's own section there must not reach every layer, or a
    conv's ``pad`` would reach the max pool after it and change its
    output shape (MNIST_CONV.conf's pool: 8 x 8 for 7 x 7)."""
    out, inside = [], False
    for k, v in defcfg:
        if k == "netconfig":
            inside = v == "start"
            continue
        if not inside:
            out.append((k, v))
    return out


@dataclasses.dataclass
class LayerInfo:
    type_name: str
    name: str = ""
    nindex_in: List[int] = dataclasses.field(default_factory=list)
    nindex_out: List[int] = dataclasses.field(default_factory=list)
    # for share[tag] layers: index of the primary layer whose params we share
    primary_layer_index: int = -1

    @property
    def is_shared(self) -> bool:
        return self.primary_layer_index >= 0


_LAYER_PLUS = re.compile(r"^layer\[\+(\d+)(?::([^\]]+))?\]$")
_LAYER_ARROW = re.compile(r"^layer\[([^\]>]+)->([^\]]+)\]$")
_LABEL_VEC = re.compile(r"^label_vec\[(\d+),(\d+)\)$")
_EXTRA_SHAPE = re.compile(r"^extra_data_shape\[(\d+)\]$")
_SHARE = re.compile(r"^share\[([^\]]+)\]$")


class NetConfig:
    """Parsed network structure + captured per-layer / global config."""

    def __init__(self) -> None:
        self.node_names: List[str] = ["in"]
        self.node_name_map: Dict[str, int] = {"in": 0, "0": 0}
        self.layers: List[LayerInfo] = []
        self.layer_name_map: Dict[str, int] = {}
        self.layercfg: List[ConfigPairs] = []
        self.defcfg: ConfigPairs = []
        self.input_shape: Optional[Tuple[int, int, int]] = None  # (c, y, x)
        self.updater_type: str = "sgd"
        self.sync_type: str = ""
        # label ranges: field name -> (start, end) columns in the label vector
        self.label_range: List[Tuple[int, int]] = []
        self.label_name_map: Dict[str, int] = {}
        self.extra_data_num: int = 0
        self.extra_shape: List[int] = []

    # -- label field helpers ---------------------------------------------
    def label_fields(self) -> List[Tuple[str, int, int]]:
        """(name, start, end) per label field; default single field "label"."""
        if not self.label_range:
            return [("label", 0, 1)]
        out = []
        for name, idx in sorted(self.label_name_map.items(), key=lambda kv: kv[1]):
            a, b = self.label_range[idx]
            out.append((name, a, b))
        return out

    def label_width(self) -> int:
        return max(e for _, _, e in self.label_fields())

    # -- parsing ----------------------------------------------------------
    def _get_node_index(self, name: str, alloc_unknown: bool) -> int:
        name = name.strip()
        if name in self.node_name_map:
            return self.node_name_map[name]
        if not alloc_unknown:
            raise ConfigError(
                f"undefined node name {name!r}: a layer's input node must be the "
                "output of an earlier layer")
        idx = len(self.node_names)
        self.node_names.append(name)
        self.node_name_map[name] = idx
        return idx

    def _parse_layer_line(self, key: str, val: str, top_node: int,
                          layer_index: int) -> LayerInfo:
        info = LayerInfo(type_name="")
        m = _LAYER_PLUS.match(key)
        if m:
            inc, tag = int(m.group(1)), m.group(2)
            if top_node < 0:
                raise ConfigError(
                    "layer[+1] used after a layer with multiple outputs; "
                    "use layer[in->out] instead")
            info.nindex_in.append(top_node)
            if tag is not None:
                info.nindex_out.append(self._get_node_index(tag, True))
            elif inc == 0:
                info.nindex_out.append(top_node)  # self-loop
            else:
                info.nindex_out.append(
                    self._get_node_index(f"!node-after-{top_node}", True))
        else:
            m = _LAYER_ARROW.match(key)
            if m is None:
                raise ConfigError(f"invalid layer declaration {key!r}")
            for tok in m.group(1).split(","):
                info.nindex_in.append(self._get_node_index(tok, False))
            for tok in m.group(2).split(","):
                info.nindex_out.append(self._get_node_index(tok, True))
        # value: "type" or "type:name"
        if ":" in val and not val.startswith("share"):
            tname, lname = val.split(":", 1)
        else:
            sm = _SHARE.match(val.split(":", 1)[0])
            if sm or val.startswith("share"):
                # share[tag] or share[tag]:name
                if ":" in val:
                    head, lname = val.split(":", 1)
                else:
                    head, lname = val, ""
                sm = _SHARE.match(head)
                if sm is None:
                    raise ConfigError(
                        "shared layer must specify the tag of the layer to "
                        "share with: share[tag]")
                tag = sm.group(1)
                if tag not in self.layer_name_map:
                    raise ConfigError(
                        f"shared layer tag {tag!r} is not defined before")
                info.primary_layer_index = self.layer_name_map[tag]
                info.type_name = "share"
                if lname:
                    self.layer_name_map[lname] = layer_index
                    info.name = lname
                return info
            tname, lname = val, ""
        info.type_name = tname
        if lname:
            if lname in self.layer_name_map and self.layer_name_map[lname] != layer_index:
                raise ConfigError(f"duplicate layer name {lname!r}")
            self.layer_name_map[lname] = layer_index
            info.name = lname
        return info

    def configure(self, cfg: ConfigPairs) -> None:
        netcfg_mode = 0
        cfg_top_node = 0
        cfg_layer_index = 0
        for name, val in cfg:
            if name == "extra_data_num":
                self.extra_data_num = int(val)
                for i in range(self.extra_data_num):
                    nm = f"in_{i + 1}"
                    if nm not in self.node_name_map:
                        self._get_node_index(nm, True)
                continue
            m = _EXTRA_SHAPE.match(name)
            if m:
                dims = [int(t) for t in val.split(",")]
                if len(dims) != 3:
                    raise ConfigError("extra data shape config incorrect")
                self.extra_shape.extend(dims)
                continue
            if name == "input_shape":
                dims = [int(t) for t in val.split(",")]
                if len(dims) != 3:
                    raise ConfigError(
                        "input_shape must be three comma-separated ints c,y,x")
                self.input_shape = tuple(dims)
            if netcfg_mode != 2:
                if name == "updater":
                    self.updater_type = val
                if name == "sync":
                    self.sync_type = val
                lm = _LABEL_VEC.match(name)
                if lm:
                    a, b = int(lm.group(1)), int(lm.group(2))
                    self.label_range.append((a, b))
                    self.label_name_map[val] = len(self.label_range) - 1
            if name == "netconfig" and val == "start":
                netcfg_mode = 1
                continue
            if name == "netconfig" and val == "end":
                netcfg_mode = 0
                continue
            if name.startswith("layer["):
                info = self._parse_layer_line(name, val, cfg_top_node,
                                              cfg_layer_index)
                netcfg_mode = 2
                assert len(self.layers) == cfg_layer_index, "NetConfig inconsistent"
                self.layers.append(info)
                self.layercfg.append([])
                if len(info.nindex_out) == 1:
                    cfg_top_node = info.nindex_out[0]
                else:
                    cfg_top_node = -1
                cfg_layer_index += 1
                continue
            if netcfg_mode == 2:
                if self.layers[cfg_layer_index - 1].is_shared:
                    raise ConfigError(
                        "do not set parameters on a shared layer; set them on "
                        "the primary layer")
                self.layercfg[cfg_layer_index - 1].append((name, val))
            else:
                self.defcfg.append((name, val))
        self.num_nodes = 0
        for info in self.layers:
            for j in info.nindex_in + info.nindex_out:
                self.num_nodes = max(self.num_nodes, j + 1)
        if self.num_nodes != len(self.node_names):
            raise ConfigError("num_nodes inconsistent with node_names")

    # -- (de)serialization for checkpoints -------------------------------
    def to_dict(self) -> dict:
        return {
            "node_names": self.node_names,
            "layers": [dataclasses.asdict(l) for l in self.layers],
            "layer_name_map": self.layer_name_map,
            "layercfg": self.layercfg,
            "defcfg": self.defcfg,
            "input_shape": self.input_shape,
            "updater_type": self.updater_type,
            "label_range": self.label_range,
            "label_name_map": self.label_name_map,
            "extra_data_num": self.extra_data_num,
            "extra_shape": self.extra_shape,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "NetConfig":
        nc = cls()
        nc.node_names = list(d["node_names"])
        nc.node_name_map = {n: i for i, n in enumerate(nc.node_names)}
        nc.node_name_map["0"] = 0
        nc.layers = [LayerInfo(**l) for l in d["layers"]]
        nc.layer_name_map = dict(d["layer_name_map"])
        nc.layercfg = [[tuple(p) for p in lc] for lc in d["layercfg"]]
        nc.defcfg = [tuple(p) for p in d["defcfg"]]
        nc.input_shape = tuple(d["input_shape"]) if d["input_shape"] else None
        nc.updater_type = d["updater_type"]
        nc.label_range = [tuple(r) for r in d["label_range"]]
        nc.label_name_map = dict(d["label_name_map"])
        nc.extra_data_num = d["extra_data_num"]
        nc.extra_shape = list(d["extra_shape"])
        nc.num_nodes = len(nc.node_names)
        return nc
