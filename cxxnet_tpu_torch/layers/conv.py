"""Convolution, pooling, LRN and insanity pooling layers (the JAX
package's ``layers/conv.py``; reference ``convolution_layer-inl.hpp``,
``pooling_layer``, ``lrn_layer``, ``insanity_pooling_layer``)."""

from __future__ import annotations

from typing import List

import torch

from ..analysis.schema import K
from ..ops import nn as N
from .base import Layer, Shape4


class ConvolutionLayer(Layer):
    """Grouped 2-D convolution: weight ``wmat`` (out_c, in_c / ngroup,
    kh, kw), bias ``bias`` (out_c,)."""

    type_names = ("conv",)
    extra_config_keys = (
        K("space_to_depth", "int", lo=0, hi=1,
          help="lower a strided conv through space-to-depth"),
        K("temp_col_max", "int",
          help="accepted and ignored: the conv library tiles its "
               "scratch itself"),
    )

    def __init__(self):
        super().__init__()
        # space_to_depth = 1: a strided ungrouped conv runs as the
        # stride-1 conv of its space-to-depth input (ops.nn.conv2d_s2d)
        self.space_to_depth = 0
        # set by the trainer under input_s2d = 1: the input arrives in
        # space-to-depth form, and the conv is the stride-1 conv of it
        self.s2d_input = 0
        # set by the trainer's relu/bias -> pool reorder: the bias add
        # moves to the downstream max pool (max(z + b) == max(z) + b)
        self.defer_bias = 0

    def set_param(self, name: str, val: str) -> None:
        if name == "space_to_depth":
            self.space_to_depth = int(val)
        super().set_param(name, val)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, "conv: 1-1 connection only"
        p = self.param
        assert p.kernel_height > 0 and p.kernel_width > 0, \
            "conv: must set kernel_size correctly"
        assert p.num_channel > 0, "conv: must set nchannel correctly"
        n, c, h, w = in_shapes[0]
        assert c % p.num_group == 0 and p.num_channel % p.num_group == 0, \
            "conv: channels must divide ngroup"
        oh = N.conv_out_size(h, p.kernel_height, p.stride, p.pad_y)
        ow = N.conv_out_size(w, p.kernel_width, p.stride, p.pad_x)
        assert oh > 0 and ow > 0, "conv: kernel/stride exceed input size"
        return [(n, p.num_channel, oh, ow)]

    def init_params(self, gen, in_shapes, dtype=torch.float32):
        p = self.param
        c = in_shapes[0][1]
        in_per_group = c // p.num_group
        area = p.kernel_height * p.kernel_width
        wmat = p.rand_init_weight(
            gen, (p.num_channel, in_per_group, p.kernel_height,
                  p.kernel_width),
            in_per_group * area, p.num_channel // p.num_group * area, dtype)
        params = {"wmat": wmat}
        if not p.no_bias:
            params["bias"] = torch.full((p.num_channel,), p.init_bias,
                                        dtype=dtype, device=gen.device)
        return params

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        p = self.param
        x = inputs[0]
        bias = params.get("bias") if not self.defer_bias else None
        if self.s2d_input:
            out = N.conv2d_pres2d(x, params["wmat"], stride=p.stride)
        elif (bias is not None and not self.space_to_depth
              and N.use_fast_wgrad(x.shape[1], p.stride, p.num_group,
                                   ctx.opts)):
            return [N.conv_bias_fast(x, params["wmat"], bias, p.stride,
                                     p.pad_y, p.pad_x, ctx.opts.fast_wgrad,
                                     ctx.opts.conv1_fwd == "s2d")]
        elif self.space_to_depth and p.stride > 1 and p.num_group == 1:
            out = N.conv2d_s2d(x, params["wmat"], stride=p.stride,
                               pad_y=p.pad_y, pad_x=p.pad_x)
        else:
            out = N.conv2d(x, params["wmat"], stride=p.stride,
                           pad_y=p.pad_y, pad_x=p.pad_x,
                           num_group=p.num_group)
        if bias is not None:
            out = out + bias.to(out.dtype).reshape(1, -1, 1, 1)
        return [out]


class _PoolingBase(Layer):
    """Pooling; ``pad`` / ``pad_y`` / ``pad_x`` are a superset of the
    reference (whose pooling has no padding)."""

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, "pooling: 1-1 connection only"
        p = self.param
        assert p.kernel_height > 0 and p.kernel_width > 0, \
            "pooling: must set kernel_size correctly"
        n, c, h, w = in_shapes[0]
        assert p.kernel_height <= h + 2 * p.pad_y \
            and p.kernel_width <= w + 2 * p.pad_x, \
            "pooling: kernel size exceeds input"
        assert p.pad_y < p.kernel_height and p.pad_x < p.kernel_width, \
            "pooling: pad must be smaller than kernel"
        return [(n, c,
                 N.pool_out_size_padded(h, p.kernel_height, p.stride,
                                        p.pad_y),
                 N.pool_out_size_padded(w, p.kernel_width, p.stride,
                                        p.pad_x))]

    def _geom(self):
        p = self.param
        return (p.kernel_height, p.kernel_width, p.stride, p.pad_y, p.pad_x)


class MaxPoolingLayer(_PoolingBase):
    type_names = ("max_pooling",)

    def __init__(self):
        super().__init__()
        # set by the trainer's relu -> pool reorder: the upstream relu is
        # applied to the pooled output (max(relu(x)) == relu(max(x)))
        self.relu_after = False
        # param key of an upstream conv whose bias add moved through this
        # pool; the net passes that bias as "deferred_bias"
        self.deferred_bias_key = None

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        if self.relu_after and "deferred_bias" not in params:
            # the fusable form: no bias between the pool and the relu
            return [N.max_pool2d_relu(x, *self._geom(), opts=ctx.opts)]
        out = N.max_pool2d(x, *self._geom(), opts=ctx.opts)
        if "deferred_bias" in params:
            out = out + params["deferred_bias"].to(out.dtype).reshape(
                1, -1, 1, 1)
        if self.relu_after:
            out = N.relu(out, ctx.opts)
        return [out]


class ReluMaxPoolingLayer(_PoolingBase):
    """relu fused into max pooling (layer_impl-inl.hpp:55-56): under
    ``pool_relu_reorder = 1`` (default) computed as relu(pool(x)), else
    in the reference's order pool(relu(x))."""

    type_names = ("relu_max_pooling",)

    def forward(self, params, inputs, ctx):
        if ctx.opts.pool_relu_reorder != "1":
            return [N.max_pool2d(N.relu(inputs[0], ctx.opts), *self._geom(),
                                 opts=ctx.opts)]
        return [N.max_pool2d_relu(inputs[0], *self._geom(), opts=ctx.opts)]


class SumPoolingLayer(_PoolingBase):
    type_names = ("sum_pooling",)

    def forward(self, params, inputs, ctx):
        return [N.sum_pool2d(inputs[0], *self._geom())]


class AvgPoolingLayer(_PoolingBase):
    type_names = ("avg_pooling",)

    def forward(self, params, inputs, ctx):
        return [N.avg_pool2d(inputs[0], *self._geom())]


class InsanityPoolingLayer(_PoolingBase):
    """Stochastic-neighbourhood max pooling
    (insanity_pooling_layer-inl.hpp): in a training forward each input
    position reads itself or, with probability 1 - ``keep``, one of its
    4 neighbours (``ops.nn.jitter5``), the max pool runs over the
    jittered image, and the all-ties gradient goes to the window
    position (``ops.nn.insanity_max_pool``); eval is the plain max pool.
    No padding, as in the reference."""

    type_names = ("insanity_max_pooling",)
    extra_config_keys = (
        K("keep", "float", lo=0.0, hi=1.0, help="jitter keep probability"),
    )

    def __init__(self):
        super().__init__()
        self.p_keep = 1.0

    def set_param(self, name: str, val: str) -> None:
        if name == "keep":
            self.p_keep = float(val)
        super().set_param(name, val)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert self.param.pad_y == 0 and self.param.pad_x == 0, \
            "insanity_max_pooling does not support padding"
        return super().infer_shapes(in_shapes)

    def forward(self, params, inputs, ctx):
        p = self.param
        x = inputs[0]
        if not ctx.train:
            return [N.max_pool2d(x, p.kernel_height, p.kernel_width,
                                 p.stride, opts=ctx.opts)]
        mask = N.batch_draw(N.uniform, ctx, x.shape, torch.float32)
        return [N.insanity_max_pool(x, mask, p.kernel_height,
                                    p.kernel_width, p.stride, self.p_keep)]


class LRNLayer(Layer):
    """Cross-channel local response normalisation
    (lrn_layer-inl.hpp:11-89)."""

    type_names = ("lrn",)
    extra_config_keys = (
        K("local_size", "int", lo=1), K("alpha", "float"),
        K("beta", "float"), K("knorm", "float"),
    )

    def __init__(self):
        super().__init__()
        self.knorm = 1.0
        self.nsize = 3
        self.alpha = 0.001
        self.beta = 0.75

    def set_param(self, name, val):
        if name == "local_size":
            self.nsize = int(val)
        elif name == "alpha":
            self.alpha = float(val)
        elif name == "beta":
            self.beta = float(val)
        elif name == "knorm":
            self.knorm = float(val)
        else:
            super().set_param(name, val)

    def infer_shapes(self, in_shapes: List[Shape4]) -> List[Shape4]:
        assert len(in_shapes) == 1, "lrn: 1-1 connection only"
        return [in_shapes[0]]

    def forward(self, params, inputs, ctx):
        self.check_n_inputs(inputs, 1)
        return [N.lrn(inputs[0], self.nsize, self.alpha, self.beta,
                      self.knorm, opts=ctx.opts)]
