"""The port's serving slice against the JAX package, on the CPU.

A tiny transformer LM is built by the JAX package (the
tests/test_decode.py fixture), its parameters carried into the port with
``params_from_jax``, and both packages' full forward, prefill, step
logits and greedy generations are compared at f32.  Also: the gelu trap,
``.model`` interop, the config / netconfig / iterator ports, the CLI
end to end against the JAX CLI, and the port's isolation from JAX.
"""

import ast
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch_threads  # noqa: E402,F401 — torch threads under xdist

from cxxnet_tpu.models import transformer  # noqa: E402
from cxxnet_tpu.serve.batcher import StepScheduler as JScheduler  # noqa: E402
from cxxnet_tpu.serve.decode import DecodeEngine as JEngine  # noqa: E402
from cxxnet_tpu_torch.nnet.trainer import (NetTrainer,  # noqa: E402
                                           params_from_jax, resolve_device)
from cxxnet_tpu_torch.serve.batcher import (  # noqa: E402
    StepScheduler as TScheduler)
from cxxnet_tpu_torch.serve.decode import DecodeEngine as TEngine  # noqa: E402
from cxxnet_tpu_torch.utils.config import parse_config_string  # noqa: E402

LOGIT_TOL = 1e-4
NET = transformer(vocab=64, seq=32, dim=32, nlayer=2, nhead=2)


def _port_trainer(net_conf, batch_size, extra=()):
    t = NetTrainer()
    for k, v in parse_config_string(net_conf):
        t.set_param(k, v)
    for k, v in (("batch_size", str(batch_size)), ("dev", "cpu"),
                 ("silent", "1")) + tuple(extra):
        t.set_param(k, v)
    t.init_model()
    return t


@pytest.fixture(scope="module")
def pair():
    """(JAX trainer, port trainer) holding the same weights."""
    from __graft_entry__ import _make_trainer
    jt = _make_trainer(NET, 2, "cpu", extra=[
        ("updater", "sgd"), ("eta", "0.01"), ("eval_train", "0"),
        ("silent", "1")])
    tt = _port_trainer(NET, 2)
    params, buffers = params_from_jax(jax.tree.map(np.asarray, jt.params),
                                      jax.tree.map(np.asarray, jt.buffers))
    assert set(params) == set(tt.params)
    for key, group in params.items():
        assert set(group) == set(tt.params[key]), key
        for tag, v in group.items():
            assert v.shape == tt.params[key][tag].shape, (key, tag)
    tt.set_state(params, buffers)
    return jt, tt


@pytest.fixture(scope="module")
def engines(pair):
    jt, tt = pair
    je = JEngine(jt, slots=2, max_seqlen=32)
    je.warmup()
    return je, TEngine(tt, slots=2, max_seqlen=32)


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, 64, n).astype(np.int32)


@pytest.mark.parametrize("length", [1, 9, 32])
def test_full_forward_logits_match_jax(engines, length):
    je, te = engines
    p = _prompt(length, seed=length)
    np.testing.assert_allclose(te.full_logits(p), je.full_logits(p),
                               atol=LOGIT_TOL)


def test_eval_forward_matches_jax(pair):
    """The trainers' eval forward: softmax_seq output of a batch."""
    jt, tt = pair
    data = np.random.RandomState(3).randint(0, 64, (2, 1, 1, 32)) \
        .astype(np.float32)
    nid = tt.net.final_node
    want = jt.forward_eval(jt.params, jt.buffers, jnp.asarray(data),
                           (nid,))[nid]                  # (b, 1*32*64)
    [got] = tt.forward_eval(torch.from_numpy(data), [nid])
    assert got.shape == (2, 1, 32, 64)
    np.testing.assert_allclose(got.reshape(2, -1), np.asarray(want),
                               atol=1e-6)


@pytest.mark.parametrize("length", [1, 5, 17, 32])
def test_prefill_logits_match_jax(engines, length):
    je, te = engines
    p = _prompt(length, seed=100 + length)
    got, want = te.prefill(0, p), je.prefill(0, p)
    assert got.dtype == np.float32 and got.shape == (64,)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL)


def test_incremental_step_logits_match_jax(engines):
    """Prefill, then 8 greedy steps in slot 1: every step's logits row
    matches the JAX engine's, and the port's own full forward."""
    je, te = engines
    p = _prompt(6, seed=42)
    logits = je.prefill(1, p)
    np.testing.assert_allclose(te.prefill(1, p), logits, atol=LOGIT_TOL)
    seq = list(p) + [int(np.argmax(logits))]
    for _ in range(8):
        pos = len(seq) - 1
        toks = np.asarray([0, seq[-1]], np.int32)
        poss = np.asarray([0, pos], np.int32)
        want = je.step(toks, poss)[1]
        got = te.step(toks, poss)[1]
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL)
        np.testing.assert_allclose(got, te.full_logits(np.asarray(seq))[pos],
                                   atol=LOGIT_TOL)
        seq.append(int(np.argmax(want)))


@pytest.mark.parametrize("continuous", [True, False])
def test_scheduler_greedy_ids_match_jax(engines, continuous):
    """Concurrent greedy generation through both step schedulers over
    seeded mixed-length prompts: identical token ids."""
    je, te = engines
    prompts = [_prompt(3 + 4 * i, seed=200 + i) for i in range(6)]
    lens = [3 + (i % 4) for i in range(6)]

    def run(sched_cls, eng):
        s = sched_cls(eng, max_new_tokens=8, queue_depth=8,
                      continuous=continuous)
        s.start()
        out = [None] * len(prompts)

        def client(i):
            out[i] = s.submit(prompts[i], lens[i])

        ths = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
        try:
            for th in ths:
                th.start()
            for th in ths:
                th.join()
        finally:
            s.close()
        return out, s.stats()

    want, _ = run(JScheduler, je)
    got, stats = run(TScheduler, te)
    assert got == want
    assert stats["requests"] == 6 and stats["tokens"] == sum(lens)
    assert stats["batching"] == ("continuous" if continuous else "request")


def test_scheduler_runner_failure_reaches_clients():
    class Broken:
        slots, max_seqlen = 2, 16

        def prefill(self, slot, tokens):
            raise RuntimeError("device lost")

    s = TScheduler(Broken(), max_new_tokens=4)
    s.start()
    try:
        with pytest.raises(RuntimeError, match="device lost"):
            s.submit(np.arange(3))
        with pytest.raises(RuntimeError, match="device lost"):
            s.submit(np.arange(3))
    finally:
        s.close()


def test_sampling_matches_jax():
    from cxxnet_tpu.serve.decode import sample_token as jsample
    from cxxnet_tpu_torch.serve.decode import sample_token as tsample
    logits = np.random.RandomState(1).randn(50).astype(np.float32)
    for kind, kw in (("greedy", {}), ("temperature", {"temp": 0.7}),
                     ("topk", {"temp": 1.3, "topk": 5})):
        a = [jsample(logits, kind, rng=np.random.RandomState(i), **kw)
             for i in range(20)]
        b = [tsample(logits, kind, rng=np.random.RandomState(i), **kw)
             for i in range(20)]
        assert a == b, kind


# ------------------------------------------------------------------ layers

def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to the tanh form; the port must match it, and
    differ measurably from torch's default erf form."""
    from cxxnet_tpu_torch.engine import EngineOptions
    from cxxnet_tpu_torch.layers.activation import GeluLayer
    from cxxnet_tpu_torch.layers.base import ForwardContext
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    [got] = GeluLayer().forward({}, [torch.from_numpy(x)],
                                ForwardContext(False, EngineOptions()))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


def test_bf16_net_keeps_token_ids_exact():
    """In a bf16 net the id input stays float32: id 8191 looks up row
    8191 (a bf16 cast would round it to 8192)."""
    assert float(jnp.asarray(8191.0, jnp.bfloat16)) != 8191.0
    net = transformer(vocab=8192, seq=4, dim=16, nlayer=1, nhead=2)
    t = _port_trainer(net, 1, extra=(("dtype", "bfloat16"),))
    embed_key = [k for k in t.params if k.endswith("embed")][0]
    ids = torch.tensor([[[[8191.0, 4097.0, 300.0, 0.0]]]])
    nodes = t.net.forward(t.params, {0: ids}, t.context())
    x0 = nodes[t.net.node_id("x0")][0, 0]
    p = t.params[embed_key]
    want = p["wmat"][[8191, 4097, 300, 0]] + p["wpos"]
    assert torch.equal(x0, want)


# ----------------------------------------------------------- config + I/O

def test_config_netconfig_and_engine_options_match_jax():
    from cxxnet_tpu import engine as jengine
    from cxxnet_tpu.nnet.netconfig import NetConfig as JNC
    from cxxnet_tpu.utils.config import parse_config_string as jparse
    from cxxnet_tpu_torch import engine as tengine
    from cxxnet_tpu_torch.nnet.netconfig import NetConfig as TNC
    text = open(os.path.join(REPO, "example/LM/serve_lm.conf")).read()
    assert parse_config_string(text) == jparse(text)
    a, b = JNC(), TNC()
    a.configure(jparse(text))
    b.configure(parse_config_string(text))
    assert a.to_dict() == b.to_dict()
    assert {k: v[:2] for k, v in jengine._DEFS.items()} \
        == {k: v[:2] for k, v in tengine._DEFS.items()}
    opts = tengine.EngineOptions()
    for key, val in (("fused_update", "1"), ("pallas_lrn", "hwcn"),
                     ("fast_wgrad", "pallas")):
        opts.set(key, val)
        assert getattr(opts, key) == val
    with pytest.raises(ValueError):
        opts.set("flash_attn", "2")
    with pytest.raises(ValueError):
        opts.set("no_such_option", "1")


@pytest.mark.parametrize("key,val", [("relu_vjp", "xla"),
                                     ("dp_overlap", "1"),
                                     ("pool_layout", "chwn"),
                                     ("pool_bwd", "auto"),
                                     ("conv_sibling_fuse", "1"),
                                     ("concat_virtual", "1"),
                                     ("group_conv", "split"),
                                     ("conv1_fwd", "s2d"),
                                     ("dp_bucket_mb", "8"),
                                     ("dp_reduce_dtype", "bf16"),
                                     ("dp_reduce_at", "step")])
def test_unported_engine_options_are_refused(monkeypatch, key, val):
    """Every value the JAX package takes is taken: the dp_* options
    (refused until the data-parallel plane was ported) and the CNN
    stack's lowering values (refused until they were ported), from a
    conf, the trainer or the environment, and read back."""
    from cxxnet_tpu_torch import engine as tengine
    opts = tengine.EngineOptions()
    opts.set(key, tengine._DEFS[key][1])
    t = NetTrainer()
    assert tengine._valid(key, val)
    opts.set(key, val)
    t.set_param(key, val)
    assert getattr(opts, key) == getattr(t.opts, key) == val
    monkeypatch.setenv(tengine._DEFS[key][0], val)
    assert getattr(tengine.EngineOptions(), key) == val


def test_packed_iterator_batches_match_jax(tmp_path):
    from cxxnet_tpu.io.factory import (create_iterator as jcreate,
                                       init_iterator as jinit)
    from cxxnet_tpu.io.text import write_token_shard
    from cxxnet_tpu_torch.io.factory import (create_iterator as tcreate,
                                             init_iterator as tinit)
    rng = np.random.RandomState(2)
    write_token_shard(str(tmp_path / "d.tok"),
                      [rng.randint(0, 500, rng.randint(3, 40))
                       for _ in range(50)], itemsize=2)
    cfg = [("iter", "text"), ("path_tok", str(tmp_path / "d.tok")),
           ("iter", "packseq"), ("seqlen", "16"), ("iter", "end")]
    defcfg = [("batch_size", "3"), ("silent", "1")]
    a, b = jinit(jcreate(cfg), defcfg), tinit(tcreate(cfg), defcfg)
    a.before_first()
    b.before_first()
    n = 0
    while True:
        x, y = a.next(), b.next()
        if x is None:
            assert y is None
            break
        assert np.array_equal(x.data, y.data)
        assert np.array_equal(x.label, y.label)
        n += 1
    assert n > 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_model_loads_in_port_with_identical_arrays(tmp_path, dtype):
    from __graft_entry__ import _make_trainer
    net = transformer(vocab=40, seq=8, dim=16, nlayer=1, nhead=2)
    jt = _make_trainer(net, 2, "cpu", extra=[
        ("updater", "sgd"), ("silent", "1"), ("dtype", dtype)])
    path = str(tmp_path / "m.model")
    jt.save_model(path)
    t = NetTrainer()
    for k, v in (("batch_size", "2"), ("dev", "cpu"), ("silent", "1"),
                 ("dtype", dtype)):
        t.set_param(k, v)
    t.load_model(path)
    assert set(t.params) == set(jt.params)
    for key, group in jt.params.items():
        for tag, v in group.items():
            got = t.params[key][tag]
            assert got.dtype == getattr(torch, dtype)
            assert np.array_equal(got.float().numpy(),
                                  np.asarray(v, np.float32)), (key, tag)
    # and back: the port's save loads in the JAX package unchanged
    path2 = str(tmp_path / "m2.model")
    t.save_model(path2)
    from cxxnet_tpu.nnet.trainer import NetTrainer as JNetTrainer
    j2 = JNetTrainer()
    for k, v in (("batch_size", "2"), ("dev", "cpu"), ("silent", "1"),
                 ("updater", "sgd"), ("dtype", dtype)):
        j2.set_param(k, v)
    j2.load_model(path2)
    for key, group in jt.params.items():
        for tag, v in group.items():
            assert np.array_equal(np.asarray(j2.params[key][tag], np.float32),
                                  np.asarray(v, np.float32))


# ---------------------------------------------------------------------- CLI

def _serve_conf(tmp_path, model):
    """example/LM/serve_lm.conf without its draft / chunk / kv-dtype keys,
    pointed at this test's snapshot and shards."""
    text = open(os.path.join(REPO, "example/LM/serve_lm.conf")).read()
    drop = ("serve_draft_model", "spec_k", "decode_prefill_chunk",
            "decode_kv_dtype")
    lines = [ln for ln in text.splitlines()
             if not ln.strip().startswith(drop)]
    text = "\n".join(lines) + "\n"
    text = text.replace("model_in = models/lm.model", f"model_in = {model}")
    text = text.replace("path_tok = lm_data/eval_%d.tok",
                        f"path_tok = {tmp_path}/eval_%d.tok")
    text = text.replace("metrics_sink = jsonl:serve_gen_metrics.jsonl",
                        f"metrics_sink = jsonl:{tmp_path}/m.jsonl")
    return text


def test_cli_serve_gen_matches_jax_cli(tmp_path):
    """task=serve serve_gen=1 through both CLIs on one JAX snapshot and
    one token shard: the port's gen_out.txt equals the JAX package's."""
    from cxxnet_tpu.io.text import write_token_shard
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu.nnet.trainer import NetTrainer as JNetTrainer
    from cxxnet_tpu.utils.config import parse_config_string as jparse
    from cxxnet_tpu_torch.main import LearnTask as TTask
    model = str(tmp_path / "lm.model")
    conf_text = _serve_conf(tmp_path, model)
    jt = JNetTrainer()
    for k, v in jparse(conf_text):
        if k not in ("metrics_sink",):
            jt.set_param(k, v)
    jt.set_param("updater", "sgd")
    jt.init_model()
    jt.save_model(model)
    rng = np.random.RandomState(9)
    write_token_shard(str(tmp_path / "eval_0.tok"),
                      [rng.randint(0, 512, rng.randint(20, 90))
                       for _ in range(12)], itemsize=2)
    outs = {}
    for name, task in (("jax", JTask), ("port", TTask)):
        conf = tmp_path / f"{name}.conf"
        conf.write_text(conf_text.replace(
            "pred = gen_out.txt", f"pred = {tmp_path}/{name}_out.txt"))
        assert task().run([str(conf)]) == 0
        outs[name] = open(tmp_path / f"{name}_out.txt").read()
    assert outs["port"] == outs["jax"]
    rows = outs["port"].splitlines()
    assert len(rows) >= 4 and all(len(r.split()) == 16 for r in rows)


def _doc_rows_iterator(tmp_path, docs, seqlen):
    from cxxnet_tpu_torch.io.factory import create_iterator, init_iterator
    from cxxnet_tpu_torch.io.text import write_token_shard
    write_token_shard(str(tmp_path / "p.tok"), docs, itemsize=2)
    it = init_iterator(create_iterator(
        [("iter", "text"), ("path_tok", str(tmp_path / "p.tok")),
         ("iter", "packseq"), ("seqlen", str(seqlen)), ("pack_split", "0"),
         ("iter", "end")]), [("batch_size", "2"), ("silent", "1")])
    it.before_first()
    return it


def test_serve_prompts_per_document(tmp_path):
    """serve_gen_prompt_doc = 1: each document of a whole-document
    packseq row is one prompt of its own length (capped at
    serve_gen_prompt); the default takes each row's leading ids."""
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.serve import ServeConfig
    rng = np.random.RandomState(4)
    docs = [rng.randint(1, 500, n) for n in (5, 9, 20, 3, 16, 7, 15)]
    it = _doc_rows_iterator(tmp_path, docs, 24)
    cfg = ServeConfig.from_pairs([("serve_gen_prompt", "12"),
                                  ("serve_gen_prompt_doc", "1")])
    got = []
    while (batch := it.next()) is not None:
        got += LearnTask._prompts(batch, cfg)
    want = [d[:12] for d in docs]
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    it.before_first()
    plain = LearnTask._prompts(it.next(), ServeConfig(gen_prompt=6))
    assert [p.tolist() for p in plain] == [docs[0].tolist() + docs[1][:1]
                                           .tolist(), docs[2][:6].tolist()]
    with pytest.raises(ValueError, match="expected 0 or 1"):
        ServeConfig(gen_prompt_doc=2)


def test_cli_serves_one_request_per_document(tmp_path):
    from cxxnet_tpu_torch.io.text import write_token_shard
    from cxxnet_tpu_torch.main import LearnTask
    model = str(tmp_path / "lm.model")
    _port_trainer(NET, 1).save_model(model)
    rng = np.random.RandomState(6)
    lens = [4, 11, 2, 15, 6]
    write_token_shard(str(tmp_path / "p.tok"),
                      [rng.randint(0, 64, n) for n in lens], itemsize=2)
    conf = tmp_path / "s.conf"
    conf.write_text(
        f"dev = cpu\ntask = serve\nmodel_in = {model}\n"
        f"pred = {tmp_path}/out.txt\niter = text\n"
        f"  path_tok = {tmp_path}/p.tok\niter = packseq\n  seqlen = 32\n"
        f"  pack_split = 0\niter = end\n{NET}\nbatch_size = 1\n"
        "serve_gen = 1\ndecode_slots = 2\nserve_gen_tokens = 3\n"
        "serve_gen_prompt = 16\nserve_gen_prompt_doc = 1\n"
        "serve_clients = 2\nsilent = 1\n")
    task = LearnTask()
    assert task.run([str(conf)]) == 0
    rows = open(tmp_path / "out.txt").read().splitlines()
    assert len(rows) == len(lens) == task.last_serve["requests"]
    assert all(len(r.split()) == 3 for r in rows)


def test_cli_without_dev_cpu_raises_without_a_card(tmp_path):
    """An accelerator request never lands on the CPU: dev unset (gpu),
    dev = tpu, dev = cuda:0 and dev = tpu:0-3 (several ids: a mesh of
    cards) all raise when no card is present, before any rank is
    started."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from cxxnet_tpu_torch.main import LearnTask
    model = str(tmp_path / "lm.model")
    t = _port_trainer(NET, 2)
    t.save_model(model)
    conf = tmp_path / "s.conf"
    conf.write_text(f"task = serve\nmodel_in = {model}\nserve_gen = 1\n"
                    f"batch_size = 2\n")
    for extra in ([], ["dev=tpu"], ["dev=cuda:0"], ["dev=gpu"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LearnTask().run([str(conf)] + extra)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LearnTask().run([str(conf), "dev=tpu:0-3"])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("fpga")


@pytest.mark.parametrize("dev", ["cpu:0-3", "gpu:0-3", "tpu:0-3",
                                 "cuda:0,1", "gpu:1,3"])
def test_dev_with_several_ids_is_refused(dev, tmp_path):
    """Several device ids are a data mesh of one rank a device, as in
    the JAX package: a rank's device is its id's (the CPU for cpu ids;
    an accelerator id never lands on the CPU), and a trainer outside a
    process group refuses to build rather than run on one device.
    ``task = pred`` runs on them: on cpu ids the CLI spawns a rank an id
    and writes one device's rows; gpu ids without a card raise, naming
    ``dev = cpu``."""
    from cxxnet_tpu_torch.io.text import write_token_shard
    from cxxnet_tpu_torch.main import LearnTask
    if dev.startswith("cpu"):
        assert resolve_device(dev) == torch.device("cpu")
        assert resolve_device(dev, rank=3) == torch.device("cpu")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(dev)
    t = _port_trainer(NET, 4)
    t.set_param("dev", dev)
    with pytest.raises((RuntimeError, ValueError),
                       match="no process group|no CUDA device"):
        t.init_model()
    model = str(tmp_path / "lm.model")
    _port_trainer(NET, 4).save_model(model)
    rng = np.random.RandomState(8)
    write_token_shard(str(tmp_path / "p.tok"),
                      [rng.randint(0, 64, 40) for _ in range(4)], itemsize=2)
    conf = tmp_path / "p.conf"
    conf.write_text(
        f"task = pred\nmodel_in = {model}\ndev = {dev}\nbatch_size = 4\n"
        f"silent = 1\npred = {tmp_path}/out.txt\niter = text\n"
        f"  path_tok = {tmp_path}/p.tok\niter = packseq\n  seqlen = 32\n"
        "iter = end\n")
    if not dev.startswith("cpu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LearnTask().run([str(conf)])
        return
    assert LearnTask().run([str(conf)]) == 0
    got = open(tmp_path / "out.txt").read()
    assert LearnTask().run([str(conf), "dev=cpu"]) == 0
    assert got == open(tmp_path / "out.txt").read()
    assert len(got.splitlines()) == 4


def test_dev_with_one_id_is_kept():
    assert resolve_device("cpu:0") == torch.device("cpu")
    assert resolve_device("cpu:2-2") == torch.device("cpu")
    with pytest.raises(ValueError, match="dev suffix"):
        resolve_device("gpu:a")


# ---------------------------------------------------------------- isolation

def _port_files():
    root = os.path.join(REPO, "cxxnet_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(mod):
    return mod is not None and (mod.split(".")[0] in ("jax", "jaxlib",
                                                       "cxxnet_tpu"))


def test_port_sources_import_neither_jax_nor_cxxnet_tpu():
    bad = []
    for path in _port_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if _forbidden(node.module):
                    bad.append((path, node.module))
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import cxxnet_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(cxxnet_tpu_torch.__path__,\n"
        "                               'cxxnet_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'cxxnet_tpu')]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd="/")
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA device: non-zero exit, no result line (and alone in a
    directory it cannot import the port at all)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
