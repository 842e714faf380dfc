"""The port's sequence parallelism against the JAX package, on the CPU.

* Ring attention, op level: the port's ``ring.ring_attention`` on 2 and
  4 gloo ranks of a ``seq`` axis (``seq:4`` and ``data:2,seq:2`` in one
  spawned group, ``parallel.mesh.spawn``) against the JAX package's
  ``ring.sharded_attention`` on its ``cpu:0-3`` host mesh and its
  ``dense_attention`` on the whole arrays: causal and not, with and
  without segment ids, and with the key chunking forced (the
  ``test_sequence.py`` chunked-ring case).  Bounds: the forward within
  1e-6 of the reference's largest value, dq / dk / dv within 1e-5
  normwise (tighter than the 5e-3 gradient envelope).
* The embedding on a seq shard adds its block's rows of ``wpos`` (or
  the ``pos_key`` field's rows, cut with the block): the JAX package's
  embedding on the whole sequence, cut to the block, bitwise.
* A sequence the ``seq`` axis does not divide falls back to dense
  attention with the JAX package's warning.
* ``example/LM/longctx.conf`` at ``mesh = data:2,seq:2`` (and ``seq:4``)
  through the
  port's CLI (four gloo ranks) against the JAX package's CLI on its
  ``cpu:0-3`` mesh, from one JAX-written initial snapshot over the same
  ``tools/make_synth_text.py`` corpus (3 batches): per-step losses
  within 1e-6 relative, the snapshot's parameters within 1e-5, the
  replicas bitwise equal (``test_on_server = 1``).
"""

import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import torch_threads  # noqa: E402,F401 — torch threads under xdist

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cxxnet_tpu.parallel import ring as jring  # noqa: E402

#: the forward's bound (of the reference's largest value) and the
#: gradients' (normwise)
FWD_TOL = 1e-6
GRAD_TOL = 1e-5
#: the whole-conf bounds of tests/test_torch_dp.py
LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-5

B, H, S, D = 2, 2, 32, 8
#: (id, causal, with segment ids, forced key chunking)
OP_CASES = [("plain", False, False, False), ("causal", True, False, False),
            ("seg", False, True, False), ("causal_seg", True, True, False),
            ("chunked", False, False, True),
            ("chunked_causal", True, False, True),
            ("chunked_causal_seg", True, True, True)]


def _op_inputs():
    rnd = np.random.RandomState(0)
    q, k, v, g = (rnd.randn(B, H, S, D).astype(np.float32)
                  for _ in range(4))
    seg = np.sort(rnd.randint(0, 3, (B, S)), axis=1).astype(np.int32)
    return q, k, v, g, seg


def _forced_chunks(mod):
    """``test_sequence.py``'s forced chunking of a ring module: 4 chunks
    a block, the threshold at 8 positions."""
    mod._chunk_for = lambda n: max(n // 4, 1) if n % 4 == 0 else n
    mod.CHUNKED_ATTN_THRESHOLD = 8


def _op_rank(rank: int, out_dir: str) -> None:
    """A rank of the op-level group of 4: every case's forward and q / k
    / v gradients of ``sum(out * g)`` on its block, over ``seq:4`` and
    over the ``seq`` axis of ``data:2,seq:2`` (two rings of 2), saved."""
    torch.set_num_threads(1)
    from cxxnet_tpu_torch.parallel import mesh as meshlib, ring
    q, k, v, g, seg = (torch.from_numpy(a) for a in _op_inputs())
    keep = (ring._chunk_for, ring.CHUNKED_ATTN_THRESHOLD)
    for n, axes in ((4, {"seq": 4}), (2, {"data": 2, "seq": 2})):
        m = meshlib.build_mesh(meshlib.MeshSpec(axes), torch.device("cpu"))
        i = m.axis_index("seq")
        blk = slice(i * S // n, (i + 1) * S // n)
        res = {}
        for cid, causal, with_seg, chunked in OP_CASES:
            if chunked:
                _forced_chunks(ring)
            qs, ks, vs = (t[:, :, blk].clone().requires_grad_()
                          for t in (q, k, v))
            out = ring.ring_attention(qs, ks, vs, m, "seq", causal=causal,
                                      seg=seg[:, blk] if with_seg else None)
            (out * g[:, :, blk]).sum().backward()
            res[cid] = [out.detach(), qs.grad, ks.grad, vs.grad]
            ring._chunk_for, ring.CHUNKED_ATTN_THRESHOLD = keep
        if m.axis_index("data") == 0:
            torch.save(res, os.path.join(out_dir, f"ring{n}_{i}.pt"))


def _jax_op(mesh, cid, causal, with_seg, chunked):
    """The JAX package's sharded ring (``mesh``; None: its dense
    attention) forward and q / k / v gradients of ``sum(out * g)``."""
    q, k, v, g, seg = (jnp.asarray(a) for a in _op_inputs())
    keep = (jring._chunk_for, jring.CHUNKED_ATTN_THRESHOLD)
    if chunked and mesh is not None:
        _forced_chunks(jring)
    try:
        def f(q_, k_, v_):
            s = seg if with_seg else None
            if mesh is None:
                out = jring.dense_attention(q_, k_, v_, causal=causal, seg=s)
            else:
                out = jring.sharded_attention(q_, k_, v_, mesh,
                                              causal=causal, seg=s)
            return jnp.sum(out * g), out
        (_, out), grads = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
        return [np.asarray(a) for a in (out,) + tuple(grads)]
    finally:
        jring._chunk_for, jring.CHUNKED_ATTN_THRESHOLD = keep


@pytest.fixture(scope="module")
def op_runs(tmp_path_factory):
    from cxxnet_tpu_torch.parallel import mesh as meshlib
    out = tmp_path_factory.mktemp("ring")
    res = {}
    meshlib.spawn(_op_rank, 4, (str(out),), timeout_sec=120)
    for n in (2, 4):
        ranks = [torch.load(os.path.join(out, f"ring{n}_{r}.pt"))
                 for r in range(n)]
        res[n] = {cid: [torch.cat([rk[cid][i] for rk in ranks], 2).numpy()
                        for i in range(4)] for cid, *_ in OP_CASES}
    return res


def _normwise(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


_DENSE = {}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_ring_matches_jax_sharded_attention(op_runs, n, case):
    """The port's ring on n seq ranks against the JAX package's
    ``sharded_attention`` on n host devices (and its dense attention):
    forward within FWD_TOL of the largest value, gradients within
    GRAD_TOL normwise."""
    from jax.sharding import Mesh
    cid = case[0]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(n), ("seq",))
    got = op_runs[n][cid]
    if case[1:3] not in _DENSE:
        _DENSE[case[1:3]] = _jax_op(None, *case)
    for ref in (_jax_op(mesh, *case), _DENSE[case[1:3]]):
        scale = float(np.abs(ref[0]).max())
        assert float(np.abs(got[0] - ref[0]).max()) <= FWD_TOL * scale, cid
        for name, a, b in zip(("dq", "dk", "dv"), got[1:], ref[1:]):
            assert _normwise(a, b) <= GRAD_TOL, (cid, name,
                                                 _normwise(a, b))


# ------------------------------------------------------------ layers

def _seq_ctx(rank: int, n: int, labels=None):
    """A training context of rank ``rank`` of a ``seq:n`` mesh whose
    positions are split (no process group: the layers below call no
    collective)."""
    from cxxnet_tpu_torch.engine import EngineOptions
    from cxxnet_tpu_torch.layers.base import ForwardContext
    from cxxnet_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh({"seq": n}, rank, torch.device("cpu"), "gloo")
    return ForwardContext(train=True, opts=EngineOptions(), labels=labels,
                          mesh=mesh, seq_split=True)


@pytest.mark.parametrize("pos_key", ["", "position"])
def test_embedding_positions_on_a_seq_shard(pos_key):
    """Each of 4 seq ranks' embedding output equals its block of the JAX
    package's embedding over the whole sequence, bitwise, with
    sequential positions (the block's rows of ``wpos``) and with a
    ``pos_key`` field (the field's block)."""
    from cxxnet_tpu.layers.base import ForwardContext as JCtx, LabelInfo as JL
    from cxxnet_tpu.layers.registry import create_layer as jcreate
    from cxxnet_tpu_torch.layers.base import LabelInfo
    from cxxnet_tpu_torch.layers.registry import create_layer
    rnd = np.random.RandomState(3)
    b, s, vocab, d, n = 2, 16, 11, 8, 4
    ids = rnd.randint(0, vocab, (b, 1, 1, s)).astype(np.float32)
    pos = np.concatenate([np.arange(5), np.arange(s - 5)])[None] \
        .repeat(b, 0).astype(np.float32)
    cfg = {"vocab_size": vocab, "nhidden": d, "pos_embed": 1,
           "pos_key": pos_key}
    jl, tl = jcreate("embedding"), create_layer("embedding")
    for k, v in cfg.items():
        jl.set_param(k, str(v))
        tl.set_param(k, str(v))
    jl.infer_shapes([ids.shape])
    params = jl.init_params(jax.random.PRNGKey(0), [ids.shape])
    jctx = JCtx(train=True, labels=JL(fields={"position": jnp.asarray(pos)})
                if pos_key else None)
    (want,), _ = jl.forward(params, {}, [jnp.asarray(ids)], jctx)
    tparams = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    for r in range(n):
        blk = slice(r * s // n, (r + 1) * s // n)
        labels = LabelInfo(fields={"position": torch.from_numpy(
            pos[:, blk])}) if pos_key else None
        (got,) = tl.forward(tparams, [torch.from_numpy(ids[..., blk])],
                            _seq_ctx(r, n, labels))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want)[:, :, blk])


def test_undivided_sequence_falls_back_with_the_jax_words():
    """A sequence the seq axis does not divide stays whole on every rank
    (the trainer splits no positions) and attention takes dense
    attention, with the JAX package's warning."""
    from cxxnet_tpu_torch.layers.registry import create_layer
    from cxxnet_tpu_torch.parallel import ring
    layer = create_layer("attention")
    layer.set_param("nhead", "2")
    layer.set_param("causal", "1")
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 1, 6, 8)
                         .astype(np.float32))
    layer.infer_shapes([tuple(x.shape)])
    params = layer.init_params(torch.Generator().manual_seed(0),
                               [tuple(x.shape)])
    ctx = _seq_ctx(0, 4)
    ctx.seq_split = False
    ctx.opts.set("flash_attn", "0")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (y,) = layer.forward(params, [x], ctx)
    words = ("attention: seq length 6 is not divisible by the seq mesh "
             "axis (4); falling back to dense attention, which gathers "
             "the full sequence on one device")
    assert [str(w.message) for w in caught] == [words]
    ctx.mesh = None
    (y1,) = layer.forward(params, [x], ctx)
    assert torch.equal(y, y1)
    assert ring.NEG_INF == jring.NEG_INF


# ----------------------------------------------------- whole confs, CLI

def write_lm_corpus(out_dir, batch: int, seqlen: int, steps: int = 3,
                    seed: int = 5) -> str:
    """``make_synth_text.gen_docs`` (vocab 512, the confs') documents
    totalling exactly enough tokens for ``steps`` packed batches of
    ``batch`` x ``seqlen`` (and the lookahead token), as the confs' 4
    token shards; returns the ``path_tok`` pattern."""
    from make_synth_text import gen_docs
    from cxxnet_tpu_torch.io.text import write_token_shard
    want = steps * batch * seqlen + 1
    docs, total = [], 0
    for d in gen_docs(400, 512, 96, seed=seed):
        d = d[:want - total]
        if d.size < 4:
            break
        docs.append(d)
        total += d.size
    assert total == want, total
    pattern = os.path.join(str(out_dir), "train_%d.tok")
    for i in range(4):
        write_token_shard(pattern % i, docs[i::4], itemsize=2)
    return pattern


def conf_net(conf: str):
    """A conf's netconfig block and its net-wide keys (input shape,
    label fields, batch, updater), as config pairs."""
    from cxxnet_tpu_torch.utils.config import parse_config_file
    out, inside = [], False
    for k, v in parse_config_file(conf):
        if k == "netconfig" and v == "start":
            inside = True
        if inside or k in ("input_shape", "batch_size", "updater", "eta") \
                or k.startswith("label_vec"):
            out.append((k, v))
        if k == "netconfig" and v == "end":
            inside = False
    return out


def write_init_model(conf: str, path: str):
    """A JAX trainer of ``conf``'s net on one device, its initial
    snapshot written to ``path``; returns its params and buffers as
    numpy trees."""
    from cxxnet_tpu.nnet.trainer import NetTrainer as JTrainer
    jt = JTrainer()
    for k, v in conf_net(conf) + [("dev", "cpu"), ("silent", "1")]:
        jt.set_param(k, v)
    jt.init_model()
    jt.save_model(path)
    return (jax.tree.map(np.asarray, jt.params),
            jax.tree.map(np.asarray, jt.buffers))


def cli_runs(conf: str, tmp, mesh: str, corpus: str, init: str,
             label: str):
    """``conf`` through the JAX package's CLI (its cpu:0-3 mesh) and the
    port's (four gloo ranks), each from ``init`` over ``corpus`` for one
    round with a step record a step and ``test_on_server = 1``; returns
    ``{package: (per-step losses, the round's snapshot's params)}``."""
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu_torch.main import LearnTask as TTask
    from cxxnet_tpu_torch.utils import serializer
    out = {}
    for name, task in (("jax", JTask), ("port", TTask)):
        d = os.path.join(str(tmp), f"{label}_{name}")
        sink = d + ".jsonl"
        argv = [conf, f"path_tok={corpus}", f"model_in={init}",
                f"model_dir={d}", f"mesh={mesh}", "dev=cpu:0-3",
                "max_round=1", "save_model=1", "print_step=1",
                "test_on_server=1", "silent=1", f"metrics_sink=jsonl:{sink}"]
        assert task().run(argv) == 0, name
        recs = [json.loads(x) for x in open(sink)]
        losses = [r["loss"] for r in recs if r["kind"] == "step"]
        last = sorted(f for f in os.listdir(d) if f.endswith(".model"))[-1]
        _, params, _, _ = serializer.load_model(os.path.join(d, last))
        out[name] = (losses, params)
    return out


def assert_cli_parity(runs, steps: int = 3):
    (jl, jp), (tl, tp) = runs["jax"], runs["port"]
    assert len(jl) == len(tl) == steps, (jl, tl)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=0)
    assert sorted(tp) == sorted(jp)
    for key, group in jp.items():
        assert sorted(tp[key]) == sorted(group), key
        for tag, v in group.items():
            np.testing.assert_allclose(tp[key][tag], v, rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"{key}/{tag}")


@pytest.mark.parametrize("mesh", ["data:2,seq:2", "seq:4"])
def test_longctx_data_seq_mesh_matches_jax_cli(tmp_path, mesh):
    """example/LM/longctx.conf as shipped (d 64, 4 heads, s 256, batch 8,
    adam) at its data:2,seq:2 and at seq:4 (no data axis: every rank
    holds the whole batch's rows, a quarter of their positions): the
    port's CLI on four gloo ranks against the JAX package's on cpu:0-3,
    3 steps from one initial snapshot."""
    conf = os.path.join(REPO, "example", "LM", "longctx.conf")
    corpus = write_lm_corpus(tmp_path, 8, 256)
    init = str(tmp_path / "init.model")
    write_init_model(conf, init)
    assert_cli_parity(cli_runs(conf, tmp_path, mesh, corpus, init,
                               "longctx"))
