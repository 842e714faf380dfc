"""Model zoo: netconfig text generators (the JAX package's
``models/zoo.py``), for the models the port runs so far: the LeNet and
AlexNet convnets and the transformer LM."""

from __future__ import annotations


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
