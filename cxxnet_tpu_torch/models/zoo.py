"""Model zoo: netconfig text generators (the JAX package's
``models/zoo.py``, text for text): the MLP, LeNet, AlexNet, GoogLeNet,
ResNet and VGG convnets and the transformer LM.

Each function returns the text of a ``netconfig=start/end`` block plus
the ``input_shape`` (and, for sequence models, ``label_vec``) lines;
the training keys are the caller's.
"""

from __future__ import annotations

from typing import List, Sequence


def mlp(num_class: int = 10, input_dim: int = 784,
        hidden: Sequence[int] = (100,)) -> str:
    """Fully-connected softmax classifier (the MNIST.conf MLP shape).

    Hidden layers are named ``fc1..fcN``, the classifier head ``fcN+1``.
    """
    lines = ["netconfig=start"]
    for i, nh in enumerate(hidden):
        lines += [f"layer[+1] = fullc:fc{i + 1}", f"  nhidden = {nh}",
                  "layer[+0] = relu"]
    lines += [f"layer[+1] = fullc:fc{len(hidden) + 1}",
              f"  nhidden = {num_class}",
              "layer[+0] = softmax",
              "netconfig=end",
              f"input_shape = 1,1,{input_dim}"]
    return "\n".join(lines) + "\n"



def lenet(num_class: int = 10) -> str:
    """LeNet-style MNIST convnet (the MNIST_CONV.conf shape): two
    conv+pool stages and a 500-wide hidden layer."""
    return f"""
netconfig=start
layer[0->1] = conv:conv1
  kernel_size = 5
  nchannel = 20
layer[1->2] = max_pooling
  kernel_size = 2
  stride = 2
layer[2->3] = relu
layer[3->4] = conv:conv2
  kernel_size = 5
  nchannel = 50
layer[4->5] = max_pooling
  kernel_size = 2
  stride = 2
layer[5->6] = relu
layer[6->7] = flatten
layer[7->8] = fullc:fc1
  nhidden = 500
layer[8->9] = relu
layer[9->10] = fullc:fc2
  nhidden = {num_class}
layer[10->10] = softmax
netconfig=end
input_shape = 1,28,28
"""


def alexnet(num_class: int = 1000) -> str:
    """AlexNet (the ImageNet.conf:26-95 architecture): 5 conv stages with
    grouped conv2/4/5, LRN after conv1/2, three 4096/4096/num_class fullc
    layers with dropout."""
    return f"""
netconfig=start
layer[0->1] = conv:conv1
  kernel_size = 11
  stride = 4
  nchannel = 96
layer[1->2] = relu
layer[2->3] = max_pooling
  kernel_size = 3
  stride = 2
layer[3->4] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[4->5] = conv:conv2
  ngroup = 2
  kernel_size = 5
  pad = 2
  nchannel = 256
layer[5->6] = relu
layer[6->7] = max_pooling
  kernel_size = 3
  stride = 2
layer[7->8] = lrn
  local_size = 5
  alpha = 0.001
  beta = 0.75
  knorm = 1
layer[8->9] = conv:conv3
  kernel_size = 3
  pad = 1
  nchannel = 384
layer[9->10] = relu
layer[10->11] = conv:conv4
  ngroup = 2
  kernel_size = 3
  pad = 1
  nchannel = 384
layer[11->12] = relu
layer[12->13] = conv:conv5
  ngroup = 2
  kernel_size = 3
  pad = 1
  nchannel = 256
layer[13->14] = relu
layer[14->15] = max_pooling
  kernel_size = 3
  stride = 2
layer[15->16] = flatten
layer[16->17] = fullc:fc6
  nhidden = 4096
layer[17->18] = relu
layer[18->18] = dropout
  threshold = 0.5
layer[18->19] = fullc:fc7
  nhidden = 4096
layer[19->20] = relu
layer[20->20] = dropout
  threshold = 0.5
layer[20->21] = fullc:fc8
  nhidden = {num_class}
layer[21->21] = softmax
netconfig=end
input_shape = 3,227,227
"""


def _conv_relu(lines: List[str], bottom: str, top: str, name: str,
               nchannel: int, ksize: int, pad: int = 0,
               stride: int = 1, init: str = "xavier") -> str:
    lines += [f"layer[{bottom}->{top}] = conv:{name}",
              f"  kernel_size = {ksize}",
              f"  nchannel = {nchannel}",
              f"  random_type = {init}"]
    if stride != 1:
        lines.append(f"  stride = {stride}")
    if pad:
        lines.append(f"  pad = {pad}")
    lines.append("layer[+0] = relu")
    return top


def _inception(lines: List[str], name: str, bottom: str,
               n1x1: int, n3x3red: int, n3x3: int,
               n5x5red: int, n5x5: int, proj: int,
               init: str = "xavier") -> str:
    """Append a GoogLeNet inception module; returns the top node name.

    4-way split -> {1x1, 1x1->3x3, 1x1->5x5, pool->1x1} -> ch_concat (the
    concat layer's 4-input cap, concat_layer-inl.hpp, is exactly the branch
    count).  The pool branch relies on padded pooling — a superset of the
    reference's pooling, needed to keep the branch same-size.
    """
    sp = [f"{name}_sp{i}" for i in range(4)]
    lines.append(f"layer[{bottom}->{','.join(sp)}] = split")
    b0 = _conv_relu(lines, sp[0], f"{name}_b0", f"{name}_1x1", n1x1, 1,
                    init=init)
    _conv_relu(lines, sp[1], f"{name}_r3", f"{name}_3x3r", n3x3red, 1,
               init=init)
    b1 = _conv_relu(lines, f"{name}_r3", f"{name}_b1", f"{name}_3x3",
                    n3x3, 3, pad=1, init=init)
    _conv_relu(lines, sp[2], f"{name}_r5", f"{name}_5x5r", n5x5red, 1,
               init=init)
    b2 = _conv_relu(lines, f"{name}_r5", f"{name}_b2", f"{name}_5x5",
                    n5x5, 5, pad=2, init=init)
    lines += [f"layer[{sp[3]}->{name}_p] = max_pooling",
              "  kernel_size = 3", "  stride = 1", "  pad = 1"]
    b3 = _conv_relu(lines, f"{name}_p", f"{name}_b3", f"{name}_proj",
                    proj, 1, init=init)
    lines.append(f"layer[{b0},{b1},{b2},{b3}->{name}] = ch_concat")
    return name


def _aux_head(lines: List[str], name: str, bottom: str,
              num_class: int, init: str = "xavier") -> str:
    """GoogLeNet v1 auxiliary classifier: avgpool5/s3 -> 1x1 conv 128 ->
    fc1024 -> dropout 0.7 -> fc -> softmax at grad_scale 0.3.  Returns the
    trunk-continuation node.  The aux gradient injection is what lets the
    22-layer trunk train under plain SGD (measured: without the heads a
    512-sample memorization stalls at loss ~5.9; with them it collapses)."""
    main, aux = f"{name}_main", f"{name}_in"
    lines += [f"layer[{bottom}->{main},{aux}] = split",
              f"layer[{aux}->{name}_ap] = avg_pooling",
              "  kernel_size = 5", "  stride = 3"]
    _conv_relu(lines, f"{name}_ap", f"{name}_cv", f"{name}_conv", 128, 1,
               init=init)
    lines += [f"layer[{name}_cv->{name}_fl] = flatten",
              f"layer[{name}_fl->{name}_fc1] = fullc:{name}_fc1",
              "  nhidden = 1024",
              f"layer[+1:{name}_r] = relu",
              f"layer[{name}_r->{name}_r] = dropout",
              "  threshold = 0.7",
              f"layer[{name}_r->{name}_fc2] = fullc:{name}_fc2",
              f"  nhidden = {num_class}",
              f"layer[{name}_fc2->{name}_fc2] = softmax",
              "  grad_scale = 0.3"]
    return main


def googlenet(num_class: int = 1000, aux_heads: bool = True,
              init: str = "xavier") -> str:
    """GoogLeNet v1: 9 inception modules + the two auxiliary classifiers
    (after i4a and i4d, grad_scale 0.3 — the v1 recipe).

    No reference config exists (SURVEY.md §6: config-to-write, not
    config-to-port); channel plan is the canonical v1 table.
    """
    lines = ["netconfig=start"]
    _conv_relu(lines, "0", "c1", "conv1", 64, 7, pad=3, stride=2, init=init)
    lines += ["layer[c1->p1] = max_pooling",
              "  kernel_size = 3", "  stride = 2",
              "layer[p1->n1] = lrn",
              "  local_size = 5", "  alpha = 0.0001", "  beta = 0.75",
              "  knorm = 1"]
    _conv_relu(lines, "n1", "c2r", "conv2r", 64, 1, init=init)
    _conv_relu(lines, "c2r", "c2", "conv2", 192, 3, pad=1, init=init)
    lines += ["layer[c2->n2] = lrn",
              "  local_size = 5", "  alpha = 0.0001", "  beta = 0.75",
              "  knorm = 1",
              "layer[n2->p2] = max_pooling",
              "  kernel_size = 3", "  stride = 2"]
    top = _inception(lines, "i3a", "p2", 64, 96, 128, 16, 32, 32, init=init)
    top = _inception(lines, "i3b", top, 128, 128, 192, 32, 96, 64, init=init)
    lines += [f"layer[{top}->p3] = max_pooling",
              "  kernel_size = 3", "  stride = 2"]
    top = _inception(lines, "i4a", "p3", 192, 96, 208, 16, 48, 64, init=init)
    if aux_heads:
        top = _aux_head(lines, "aux1", top, num_class, init=init)
    top = _inception(lines, "i4b", top, 160, 112, 224, 24, 64, 64, init=init)
    top = _inception(lines, "i4c", top, 128, 128, 256, 24, 64, 64, init=init)
    top = _inception(lines, "i4d", top, 112, 144, 288, 32, 64, 64, init=init)
    if aux_heads:
        top = _aux_head(lines, "aux2", top, num_class, init=init)
    top = _inception(lines, "i4e", top, 256, 160, 320, 32, 128, 128, init=init)
    lines += [f"layer[{top}->p4] = max_pooling",
              "  kernel_size = 3", "  stride = 2"]
    top = _inception(lines, "i5a", "p4", 256, 160, 320, 32, 128, 128, init=init)
    top = _inception(lines, "i5b", top, 384, 192, 384, 48, 128, 128, init=init)
    lines += [f"layer[{top}->gp] = avg_pooling",
              "  kernel_size = 7", "  stride = 1",
              "layer[gp->gp] = dropout",
              "  threshold = 0.4",
              "layer[gp->fl] = flatten",
              "layer[fl->fc] = fullc:fc",
              f"  nhidden = {num_class}",
              "layer[fc->fc] = softmax",
              "netconfig=end",
              "input_shape = 3,224,224",
              # global default so the fullc heads (aux fc1/fc2, final fc)
              # follow the chosen init too; per-layer conv settings above
              # are explicit
              f"random_type = {init}"]
    return "\n".join(lines) + "\n"


def transformer(vocab: int, seq: int, dim: int, nlayer: int,
                nhead: int, causal: int = 1, ffn_mult: int = 4,
                packed: bool = False, moe_experts: int = 0,
                moe_capacity: float = 2.0) -> str:
    """Pre-norm decoder-only transformer LM.

    Input node is (b,1,1,seq) token ids, labels are per-position targets via
    ``label_vec[0,seq)``.  No reference counterpart (SURVEY.md §5.7) — this
    is the long-context model family; attention runs as ring attention when
    the trainer mesh has a ``seq`` axis.

    ``packed = True`` targets the document-packed LM data path
    (``io/text.py``): labels carry three fields
    (``label_vec[0,s)=label``, ``[s,2s)=segment``, ``[2s,3s)=position``),
    attention masks cross-document scores (``segment_key``), positional
    embeddings reset per document (``pos_key``), and the loss masks
    boundary/padding targets (``packed = 1``).

    ``moe_experts = E > 0`` replaces each block's dense FFN with a
    sparse ``moe`` layer (top-1 switch routing, ``layers/moe.py``) — the
    ``data x expert`` flagship family.
    """
    lines = ["netconfig=start",
             "layer[0->x0] = embedding:embed",
             f"  vocab_size = {vocab}",
             f"  nhidden = {dim}",
             "  pos_embed = 1",
             "  init_sigma = 0.02"]
    if packed:
        lines.append("  pos_key = position")
    top = "x0"
    for i in range(nlayer):
        a, m, nxt = f"b{i}a", f"b{i}m", f"x{i + 1}"
        lines += [
            f"layer[{top}->{a}_r,{a}_in] = split",
            f"layer[{a}_in->{a}_n] = layernorm:l{i}_ln1",
            f"layer[{a}_n->{a}_o] = attention:l{i}_att",
            f"  nhead = {nhead}",
            f"  causal = {causal}",
        ]
        if packed:
            lines.append("  segment_key = segment")
        lines += [
            f"layer[{a}_r,{a}_o->{m}] = eltsum",
        ]
        if moe_experts > 0:
            # the moe layer carries its own residual (y = x + gate*E(x)),
            # so no split/eltsum pair is needed around it — the
            # THREE_AXIS_NET idiom (__graft_entry__.py)
            lines += [
                f"layer[{m}->{m}_n] = layernorm:l{i}_ln2",
                f"layer[{m}_n->{nxt}] = moe:l{i}_moe",
                f"  num_expert = {moe_experts}",
                f"  nhidden = {ffn_mult * dim}",
                f"  capacity_factor = {moe_capacity}",
            ]
        else:
            lines += [
                f"layer[{m}->{m}_r,{m}_in] = split",
                f"layer[{m}_in->{m}_n] = layernorm:l{i}_ln2",
                f"layer[{m}_n->{m}_h] = seq_fullc:l{i}_ffn1",
                f"  nhidden = {ffn_mult * dim}",
                "layer[+0] = gelu",
                f"layer[{m}_h->{m}_o] = seq_fullc:l{i}_ffn2",
                f"  nhidden = {dim}",
                f"layer[{m}_r,{m}_o->{nxt}] = eltsum",
            ]
        top = nxt
    lines += [f"layer[{top}->fin] = layernorm:final_ln",
              "layer[fin->logits] = seq_fullc:head",
              f"  nhidden = {vocab}",
              "  no_bias = 1",
              "layer[+0] = softmax_seq"]
    if packed:
        lines.append("  packed = 1")
    lines += ["netconfig=end",
              f"input_shape = 1,1,{seq}",
              f"label_vec[0,{seq}) = label"]
    if packed:
        lines += [f"label_vec[{seq},{2 * seq}) = segment",
                  f"label_vec[{2 * seq},{3 * seq}) = position"]
    return "\n".join(lines) + "\n"


def _res_block(lines: List[str], name: str, bottom: str, w: int,
               stride: int, project: bool) -> str:
    """Basic residual block: two 3x3 conv+bn with an identity (or 1x1
    projected) shortcut summed by eltsum.  Fan-out goes through an explicit
    split layer, same idiom as the transformer blocks above."""
    lines += [f"layer[{bottom}->{name}_sc,{name}_in] = split",
              f"layer[{name}_in->{name}_c1] = conv:{name}_conv1",
              "  kernel_size = 3", "  pad = 1",
              f"  stride = {stride}", f"  nchannel = {w}", "  no_bias = 1",
              f"layer[{name}_c1->{name}_c1] = batch_norm:{name}_bn1",
              f"layer[{name}_c1->{name}_c1] = relu",
              f"layer[{name}_c1->{name}_c2] = conv:{name}_conv2",
              "  kernel_size = 3", "  pad = 1",
              f"  nchannel = {w}", "  no_bias = 1",
              f"layer[{name}_c2->{name}_c2] = batch_norm:{name}_bn2"]
    sc = f"{name}_sc"
    if project:
        lines += [f"layer[{sc}->{name}_p] = conv:{name}_proj",
                  "  kernel_size = 1",
                  f"  stride = {stride}", f"  nchannel = {w}", "  no_bias = 1",
                  f"layer[{name}_p->{name}_p] = batch_norm:{name}_bnp"]
        sc = f"{name}_p"
    lines += [f"layer[{sc},{name}_c2->{name}] = eltsum",
              f"layer[{name}->{name}] = relu"]
    return name


def resnet(num_class: int = 10, depth: int = 20,
           widths=(16, 32, 64), input_side: int = 32) -> str:
    """CIFAR-style ResNet (depth = 6n+2): three stages of basic blocks with
    widths 16/32/64, global average pooling, softmax head.

    No reference counterpart (the reference predates residual nets); the
    layer zoo's split/eltsum/batch_norm make it expressible, so this
    builder exists to exercise that family end-to-end.
    """
    assert (depth - 2) % 6 == 0, "resnet: depth must be 6n+2"
    n = (depth - 2) // 6
    lines = ["netconfig=start",
             "layer[0->stem] = conv:stem",
             "  kernel_size = 3", "  pad = 1",
             f"  nchannel = {widths[0]}", "  no_bias = 1",
             "layer[stem->stem] = batch_norm:stem_bn",
             "layer[stem->stem] = relu"]
    top = "stem"
    side = input_side
    for si, w in enumerate(widths):
        for bi in range(n):
            stride = 2 if (si > 0 and bi == 0) else 1
            # k=3/pad=1 conv: out side is ceil(side/stride), not floor
            side = (side + 2 - 3) // stride + 1
            top = _res_block(lines, f"s{si}b{bi}", top, w,
                             stride, project=stride != 1)
    lines += [f"layer[{top}->gp] = avg_pooling",
              f"  kernel_size = {side}", f"  stride = {side}",
              "layer[gp->fl] = flatten",
              "layer[fl->fc] = fullc:fc",
              f"  nhidden = {num_class}",
              "layer[fc->fc] = softmax",
              "netconfig=end",
              f"input_shape = 3,{input_side},{input_side}"]
    return "\n".join(lines) + "\n"


def vgg(num_class: int = 1000, depth: int = 16) -> str:
    """VGG-11/13/16/19: stacked 3x3 convs with 2x2 max pooling, three fullc
    layers with dropout.  Expressible entirely with the reference's layer
    zoo (conv/relu/max_pooling/fullc/dropout/softmax); no reference config
    exists, so this builder is authored like googlenet above."""
    plans = {11: (1, 1, 2, 2, 2), 13: (2, 2, 2, 2, 2),
             16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}
    assert depth in plans, f"vgg: depth must be one of {sorted(plans)}"
    widths = (64, 128, 256, 512, 512)
    lines = ["netconfig=start"]
    for si, (reps, w) in enumerate(zip(plans[depth], widths)):
        for ri in range(reps):
            lines += [f"layer[+1] = conv:s{si}c{ri}",
                      "  kernel_size = 3", "  pad = 1", f"  nchannel = {w}"]
            lines += ["layer[+0] = relu"]
        lines += ["layer[+1] = max_pooling", "  kernel_size = 2",
                  "  stride = 2"]
    lines += ["layer[+1] = flatten"]
    for i, nh in enumerate((4096, 4096)):
        lines += [f"layer[+1] = fullc:fc{i + 6}", f"  nhidden = {nh}",
                  "layer[+0] = relu", "layer[+0] = dropout",
                  "  threshold = 0.5"]
    lines += [f"layer[+1] = fullc:fc8", f"  nhidden = {num_class}",
              "layer[+0] = softmax",
              "netconfig=end",
              "input_shape = 3,224,224",
              "random_type = xavier"]
    return "\n".join(lines) + "\n"
