"""The port's checkpoint plane against the JAX package, on the CPU.

* The snapshot primitives of ``cxxnet_tpu_torch.ckpt``: a round trip,
  crc corruption found, a kill at each write stage keeping the previous
  snapshot, a rewrite dropping the manifest first, retention with the
  debris sweep, the async writer's commit record and its failure latch
  re-raising on the train thread, and payload arrays that are copies,
  not views of tensors the next step rewrites.
* Snapshots crossing between the packages both ways: a port ``.ckpt``
  validates and loads in the JAX ``NetTrainer``; a JAX ``.ckpt`` or
  ``.model`` (with its ``train_state``) loads in the port and two more
  steps match the JAX trainer's within 1e-5.  "Bitwise" across the two
  packages means this and no more: the manifests' keys and their values
  other than checksums are equal (``torch_rng_state``, the port's
  generator state, is the one key the JAX package lacks), the npz key
  sets and the ``dtypes`` maps are equal, and the arrays are equal where
  the parameters are the same.  The npz files themselves differ:
  ``np.savez`` stamps each zip member with the time it was written.
* ``continue = 1`` picks the same snapshot in both packages over one
  ``model_dir`` of good, partial, corrupt and non-finite snapshots.
* A port run killed mid-round and continued equals the uninterrupted
  run bitwise (params, optimizer state, rng and iterator state): the
  MNIST MLP with dropout and momentum, through ``.ckpt`` and ``.model``
  snapshots, and the packed text LM with adam and ``update_period = 2``,
  whose snapshots carry a pending gradient window (the ``acc`` shard).

The kill-resume helpers and the MNIST conf are those of
tests/test_ckpt.py (imported, not copied).
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_threads  # noqa: E402,F401 — torch threads under xdist

import cxxnet_tpu.ckpt as jckpt  # noqa: E402
import cxxnet_tpu_torch.ckpt as ckptlib  # noqa: E402
import cxxnet_tpu_torch.ckpt.writer as ckpt_writer  # noqa: E402
from cxxnet_tpu_torch.ckpt.writer import AsyncCheckpointWriter  # noqa: E402
from cxxnet_tpu_torch.main import LearnTask  # noqa: E402
from cxxnet_tpu_torch.nnet.trainer import read_snapshot  # noqa: E402
from cxxnet_tpu_torch.utils.config import (parse_config_file,  # noqa: E402
                                           parse_keyval_args)
from test_ckpt import (MLP_DROPOUT_NET, _KillAtBatch,  # noqa: E402
                       _lm_batches_in_rounds, _make_task as _jax_task,
                       _write_conf, _write_lm_conf, _write_lm_corpus,
                       _write_synth_mnist)

#: the MLP of MLP_DROPOUT_NET without its dropout layer: the two packages'
#: rng streams differ (threefry against Philox), so steps compared
#: across them draw no randomness
MLP_NET = MLP_DROPOUT_NET.replace(
    "layer[2->2] = dropout\n  threshold = 0.5\n", "")


# ------------------------------------------------------- snapshot format

def _shards(seed=0):
    rnd = np.random.RandomState(seed)
    return {"params": {"params/fc1/wmat": rnd.rand(4, 3).astype(np.float32),
                       "params/fc1/bias": rnd.rand(3).astype(np.float32)},
            "opt": {"opt/fc1/wmat/m": np.zeros((4, 3), np.float32)}}


def _meta(round_=1):
    return {"net": {}, "epoch": round_, "has_opt_state": True,
            "dtypes": {}, "extra": {"round": round_}}


class _Kill(BaseException):
    pass


def test_snapshot_roundtrip(tmp_path):
    path = str(tmp_path / "0001.ckpt")
    stats = ckptlib.write_snapshot(path, _shards(), _meta())
    assert stats["shards"] == 2 and stats["bytes"] > 0
    manifest = ckptlib.validate_snapshot(path)
    assert manifest is not None and manifest["epoch"] == 1
    _, arrays = ckptlib.load_snapshot(path)
    for shard, flat in _shards().items():
        for k, v in flat.items():
            np.testing.assert_array_equal(arrays[shard][k], v)
    assert not [n for n in os.listdir(path) if n.endswith(".tmp")]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_format_crosses_packages(tmp_path, writer):
    """A snapshot written by either package's ``write_snapshot``
    validates and loads under the other's, with the same manifest but
    for the checksums (the zip members carry their write time)."""
    other = {"port": jckpt, "jax": ckptlib}[writer]
    mine = {"port": ckptlib, "jax": jckpt}[writer]
    mine.write_snapshot(str(tmp_path / "a.ckpt"), _shards(), _meta())
    other.write_snapshot(str(tmp_path / "b.ckpt"), _shards(), _meta())
    ma = other.validate_snapshot(str(tmp_path / "a.ckpt"))
    mb = mine.validate_snapshot(str(tmp_path / "b.ckpt"))
    assert ma is not None and mb is not None
    for m in (ma, mb):
        for sm in m["shards"].values():
            sm.pop("crc32")
    assert ma == mb
    _, arrays = other.load_snapshot(str(tmp_path / "a.ckpt"))
    for shard, flat in _shards().items():
        for k, v in flat.items():
            np.testing.assert_array_equal(arrays[shard][k], v)


def test_snapshot_corruption_detected(tmp_path):
    path = str(tmp_path / "0001.ckpt")
    ckptlib.write_snapshot(path, _shards(), _meta())
    f = os.path.join(path, "params.npz")
    data = bytearray(open(f, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(f, "wb").write(bytes(data))
    assert ckptlib.validate_snapshot(path) is None
    with pytest.raises(ValueError):
        ckptlib.load_snapshot(path)
    path2 = str(tmp_path / "0002.ckpt")
    ckptlib.write_snapshot(path2, _shards(), _meta(2))
    mp = os.path.join(path2, ckptlib.MANIFEST)
    open(mp, "wb").write(open(mp, "rb").read()[:20])
    assert ckptlib.validate_snapshot(path2) is None


@pytest.mark.parametrize("stage", ["shard:params", "shard:opt", "manifest"])
def test_kill_at_each_stage_keeps_previous(tmp_path, stage):
    """A kill after any shard or before the manifest leaves the previous
    snapshot valid and the new one uncommitted (listed, never loaded)."""
    prev = str(tmp_path / "0001.ckpt")
    ckptlib.write_snapshot(prev, _shards(1), _meta(1))

    def die(at):
        if at == stage:
            raise _Kill()

    cur = str(tmp_path / "0002.ckpt")
    with pytest.raises(_Kill):
        ckptlib.write_snapshot(cur, _shards(2), _meta(2), fault_hook=die)
    assert ckptlib.validate_snapshot(prev) is not None
    assert ckptlib.validate_snapshot(cur) is None
    assert [c for c, _ in ckptlib.list_snapshots(str(tmp_path))] == [1, 2]


def test_rewrite_drops_manifest_first(tmp_path):
    path = str(tmp_path / "0003.ckpt")
    ckptlib.write_snapshot(path, _shards(1), _meta(3))

    def die_after_first_shard(at):
        if at.startswith("shard:"):
            raise _Kill()

    with pytest.raises(_Kill):
        ckptlib.write_snapshot(path, _shards(2), _meta(3),
                               fault_hook=die_after_first_shard)
    assert ckptlib.validate_snapshot(path) is None


def test_prune_retention_and_debris(tmp_path):
    for i in range(1, 5):
        ckptlib.write_snapshot(str(tmp_path / f"{i:04d}.ckpt"),
                               _shards(i), _meta(i))
    os.makedirs(tmp_path / "0000.ckpt")  # kill debris, older than 0004
    os.makedirs(tmp_path / "0009.ckpt")  # debris newer than any commit
    assert ckptlib.prune_snapshots(str(tmp_path), keep=2) == 3
    left = sorted(n for n in os.listdir(tmp_path) if n.endswith(".ckpt"))
    assert left == ["0003.ckpt", "0004.ckpt", "0009.ckpt"]
    open(tmp_path / "0001.model", "wb").write(b"x")
    assert ckptlib.prune_snapshots(str(tmp_path), keep=1) == 1
    assert os.path.exists(tmp_path / "0001.model")
    # .model sorts before .ckpt at one counter
    open(tmp_path / "0004.model", "wb").write(b"x")
    assert [os.path.basename(p) for _, p in
            ckptlib.list_snapshots(str(tmp_path))] == [
        "0001.model", "0004.model", "0004.ckpt", "0009.ckpt"]


def test_writer_commits_and_reports(tmp_path):
    done = []
    w = AsyncCheckpointWriter(on_done=done.append)
    w.submit(str(tmp_path / "0001.ckpt"), _shards(), _meta(),
             counter=1, keep=3)
    w.close()
    [st] = done
    assert st["counter"] == 1 and st["shards"] == 2 and st["bytes"] > 0
    assert st["write_sec"] >= 0 and st["pruned"] == 0
    assert ckptlib.validate_snapshot(str(tmp_path / "0001.ckpt"))


def test_writer_failure_latches_and_reraises(tmp_path, monkeypatch):
    """A writer exception re-raises on the calling (train) thread at
    drain, at every later submit and at close; nothing is committed."""
    class Boom(RuntimeError):
        pass

    def explode(stage):
        raise Boom("disk on fire")

    monkeypatch.setattr(ckpt_writer, "FAULT_HOOK", explode)
    w = AsyncCheckpointWriter()
    w.submit(str(tmp_path / "0001.ckpt"), _shards(), _meta(),
             counter=1, keep=3)
    with pytest.raises(Boom):
        w.drain()
    with pytest.raises(Boom):
        w.poll()
    with pytest.raises(Boom):
        w.submit(str(tmp_path / "0002.ckpt"), _shards(), _meta(),
                 counter=2, keep=3)
    with pytest.raises(Boom):
        w.close()
    assert ckptlib.validate_snapshot(str(tmp_path / "0001.ckpt")) is None


# ------------------------------------------------------------ helpers

def _mnist_conf(tmp_path, name, net=MLP_DROPOUT_NET, extra=""):
    """tests/test_ckpt.py's MNIST conf (dev = cpu, batch 16, momentum,
    6 rounds, ckpt_async = 1) with ``net`` in place of its net."""
    conf = _write_conf(tmp_path, str(tmp_path / name), extra=extra)
    if net != MLP_DROPOUT_NET:
        conf.write_text(conf.read_text().replace(MLP_DROPOUT_NET, net))
    return conf


def _port_task(conf, *args):
    task = LearnTask()
    for k, v in parse_config_file(str(conf)):
        task.set_param(k, v)
    for k, v in parse_keyval_args(list(args)):
        task.set_param(k, v)
    return task


def _close(task):
    for it in [task.itr_train] + task.itr_evals:
        if it is not None:
            it.close()
    if task.net is not None:
        task.net.metrics.close()


def _run(task):
    try:
        task.init()
        task.task_train()
    finally:
        _close(task)


def _flat_snapshot(path):
    """(header, {"group/key...": array}) of a .ckpt or .model, either
    package's."""
    header, params, buffers, opt, acc = read_snapshot(path)
    flat = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(f"{prefix}/{k}", v)
            else:
                flat[f"{prefix}/{k}"] = np.asarray(v)

    for name, tree in (("params", params), ("buffers", buffers),
                       ("opt", opt or {}), ("acc", acc or {})):
        walk(name, tree)
    return header, flat


def _assert_bitwise(path_a, path_b):
    ha, fa = _flat_snapshot(path_a)
    hb, fb = _flat_snapshot(path_b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert fa[k].tobytes() == fb[k].tobytes(), f"first difference: {k}"
    ea, eb = ha["extra"], hb["extra"]
    assert ea["train_state"] == eb["train_state"]
    assert ea["iter_state"] == eb["iter_state"]
    return ha, hb


def _mnist_batches(tmp_path, n):
    from cxxnet_tpu_torch.io.factory import create_iterator, init_iterator
    it = init_iterator(create_iterator(
        [("iter", "mnist"), ("path_img", str(tmp_path / "img.gz")),
         ("path_label", str(tmp_path / "lbl.gz")), ("iter", "end")]),
        [("batch_size", "16"), ("silent", "1")])
    it.before_first()
    return [it.next() for _ in range(n)]


_MLP_KEYS = [("input_shape", "1,1,144"), ("updater", "adam"),
             ("eta", "0.01"), ("silent", "1")]


def _jax_mlp(extra=()):
    from __graft_entry__ import _make_trainer
    return _make_trainer(MLP_NET, 16, "cpu", extra=_MLP_KEYS + list(extra))


def _port_loaded(path, extra=(), keys=_MLP_KEYS):
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    tt = NetTrainer()
    for k, v in [("batch_size", "16"), ("dev", "cpu")] + keys + list(extra):
        tt.set_param(k, v)
    tt.load_model(path)
    return tt


# ---------------------------------------------------- across packages

def test_port_ckpt_loads_in_jax(tmp_path):
    """Two rounds of the port's CLI (MNIST MLP with dropout, momentum,
    ckpt_async = 1): its 0002.ckpt validates under the JAX package's
    validate_snapshot, and the JAX NetTrainer loads it with the port's
    params, sample / epoch counters and round, bitwise."""
    from cxxnet_tpu.nnet.trainer import NetTrainer as JNetTrainer
    _write_synth_mnist(tmp_path)
    task = _port_task(_mnist_conf(tmp_path, "P"), "num_round=2")
    _run(task)
    path = str(tmp_path / "P" / "0002.ckpt")
    manifest = jckpt.validate_snapshot(path)
    assert manifest is not None
    jt = JNetTrainer()
    for k, v in (("batch_size", "16"), ("dev", "cpu"), ("silent", "1")):
        jt.set_param(k, v)
    jt.load_model(path, validated=True)
    tt = task.net
    assert (jt.sample_counter, jt.epoch_counter, jt.round) == (
        tt.sample_counter, tt.epoch_counter, tt.round) == (16, 16, 2)
    for key, group in tt.params.items():
        for tag, p in group.items():
            assert np.array_equal(np.asarray(jt.params[key][tag]), p.numpy())
    for key, group in tt.opt_state.items():
        for tag, st in group.items():
            for name, a in st.items():
                assert np.array_equal(
                    np.asarray(jt.opt_state[key][tag][name]), a.numpy())
    assert np.asarray(jt._rng_base).tolist() == \
        manifest["extra"]["train_state"]["rng_key"]


@pytest.mark.parametrize("form,period", [("ckpt", 1), ("ckpt", 2),
                                         ("model", 1)])
def test_jax_snapshot_continues_in_port(tmp_path, form, period):
    """The JAX trainer (MNIST MLP, adam, f32, no dropout) takes three
    steps and writes a .ckpt (checkpoint_payload + write_snapshot) or a
    .model with its train_state; the port loads it and both take two
    more steps on the same batches: params and adam moments within 1e-5,
    counters equal.  At update_period = 2 the third step leaves half a
    window, which the .ckpt carries as its acc shard."""
    _write_synth_mnist(tmp_path)
    batches = _mnist_batches(tmp_path, 5)
    extra = [("update_period", str(period))]
    jt = _jax_mlp(extra)
    for b in batches[:3]:
        jt.update(b)
    path = str(tmp_path / f"0003.{form}")
    if form == "ckpt":
        shards, meta = jt.checkpoint_payload(with_opt=True)
        assert ("acc" in shards) == (period == 2)
        jckpt.write_snapshot(path, shards, meta)
    else:
        jt.save_model(path, with_opt_state=True)
    tt = _port_loaded(path, extra)
    assert (tt.sample_counter, tt.epoch_counter, tt.round) == (
        jt.sample_counter, jt.epoch_counter, jt.round)
    assert (tt._grad_acc is not None) == (period == 2)
    for b in batches[3:]:
        jt.update(b)
        tt.update(b)
    assert tt.epoch_counter == jt.epoch_counter
    for key, group in jt.params.items():
        for tag, v in group.items():
            np.testing.assert_allclose(tt.params[key][tag].numpy(),
                                       np.asarray(v), atol=1e-5,
                                       err_msg=f"{key}/{tag}")
            for name in ("m1", "m2"):
                np.testing.assert_allclose(
                    tt.opt_state[key][tag][name].numpy(),
                    np.asarray(jt.opt_state[key][tag][name]), atol=1e-5)


def _manifest_pair(tmp_path):
    """Both CLIs train one round of the MNIST MLP (no dropout, adam)
    from one JAX-written 0000.model with ckpt_async = 1, one after the
    other into one model_dir (the manifest's net holds the config);
    returns the two 0001.ckpt paths (JAX's, the port's)."""
    from cxxnet_tpu.main import LearnTask as JTask
    _write_synth_mnist(tmp_path)
    init = str(tmp_path / "0000.model")
    _jax_mlp().save_model(init)
    out = []
    conf = _mnist_conf(tmp_path, "M", MLP_NET,
                       extra="updater = adam\neta = 0.01")
    for name, cls in (("J", JTask), ("T", LearnTask)):
        args = [f"model_in={init}", "num_round=1"]
        task = _jax_task(conf, *args) if cls is JTask \
            else _port_task(conf, *args)
        try:
            task.init()
            task.task_train()
        finally:
            _close(task)
        os.rename(tmp_path / "M", tmp_path / name)
        out.append(str(tmp_path / name / "0001.ckpt"))
    return out


def _strip(tree, drop):
    if isinstance(tree, dict):
        return {k: _strip(v, drop) for k, v in tree.items() if k not in drop}
    return tree


def test_manifest_and_npz_keys_match_jax(tmp_path):
    """The same round in both CLIs: the manifests are equal but for the
    shard checksums and the port's torch_rng_state (its generator; the
    one stated difference), rng_key is JAX's PRNGKey(seed), the npz key
    sets and dtypes maps of every shard are equal, and the arrays agree
    within the training envelope (1e-5)."""
    jpath, tpath = _manifest_pair(tmp_path)
    mj, sj = jckpt.load_snapshot(jpath)
    mt, st = ckptlib.load_snapshot(tpath)
    tstate = mt["extra"]["train_state"]
    assert set(tstate) - set(mj["extra"]["train_state"]) == \
        {"torch_rng_state"}
    assert tstate["rng_key"] == np.asarray(jax.random.PRNGKey(0)).tolist()
    assert tstate["rng_dtype"] == str(np.asarray(jax.random.PRNGKey(0)).dtype)
    drop = {"crc32", "torch_rng_state"}
    assert _strip(mt, drop) == _strip(mj, drop)
    assert st.keys() == sj.keys()
    for name in sj:
        assert st[name].keys() == sj[name].keys(), name
        for k, v in sj[name].items():
            assert st[name][k].dtype == v.dtype
            np.testing.assert_allclose(st[name][k], v, atol=1e-5, err_msg=k)


def test_mnist_iterator_state_matches_jax(tmp_path):
    """The port's MNIST iterator keeps the reference's state, the cursor,
    at every point of an epoch, and resumes from it."""
    from cxxnet_tpu.io.factory import create_iterator as jcreate
    from cxxnet_tpu.io.factory import init_iterator as jinit
    from cxxnet_tpu_torch.io.factory import create_iterator, init_iterator
    _write_synth_mnist(tmp_path, n=100)
    cfg = [("iter", "mnist"), ("path_img", str(tmp_path / "img.gz")),
           ("path_label", str(tmp_path / "lbl.gz")), ("shuffle", "1"),
           ("iter", "end")]
    defcfg = [("batch_size", "16"), ("silent", "1")]
    jt = jinit(jcreate(cfg), defcfg)
    tt = init_iterator(create_iterator(cfg), defcfg)
    jt.before_first()
    tt.before_first()
    states, batches = [], []
    while True:
        assert tt.state() == jt.state()
        states.append(tt.state())
        jb, tb = jt.next(), tt.next()
        assert (jb is None) == (tb is None)
        if tb is None:
            break
        batches.append(tb)
    assert states[0] == {"loc": 0} and states[-1] == {"loc": 100}
    tt.set_state(states[3])
    np.testing.assert_array_equal(tt.next().data, batches[3].data)


def _corrupt_model_dir(tmp_path, with_model):
    """One model_dir: 0001.ckpt good, 0002 good (a .model when
    ``with_model``, else removed), 0003.ckpt with NaN params (checksums
    valid), 0004.ckpt with a flipped byte, 0005.ckpt without a manifest."""
    _write_synth_mnist(tmp_path)
    conf = _mnist_conf(tmp_path, "C", extra="ckpt_keep = 10")
    _run(_port_task(conf, "num_round=2"))
    d = tmp_path / "C"
    ckpt2 = str(d / "0002.ckpt")
    if with_model:
        _port_loaded(ckpt2, keys=[("silent", "1")]).save_model(
            str(d / "0002.model"), with_opt_state=True)
    manifest, shards = ckptlib.load_snapshot(ckpt2)
    meta = {k: manifest[k] for k in
            ("net", "epoch", "has_opt_state", "dtypes", "extra")}
    ckptlib.write_snapshot(str(d / "0004.ckpt"), shards, meta)
    ckptlib.write_snapshot(str(d / "0005.ckpt"), shards, meta)
    os.remove(d / "0005.ckpt" / ckptlib.MANIFEST)
    f = d / "0004.ckpt" / "params.npz"
    data = bytearray(f.read_bytes())
    data[len(data) // 2] ^= 0xFF
    f.write_bytes(bytes(data))
    nan = {k: np.full_like(v, np.nan) for k, v in shards["params"].items()}
    ckptlib.write_snapshot(str(d / "0003.ckpt"), dict(shards, params=nan),
                           meta)
    import shutil
    shutil.rmtree(ckpt2)
    return conf


@pytest.mark.parametrize("with_model", [True, False],
                         ids=["model", "no-model"])
def test_continue_picks_the_same_snapshot_as_jax(tmp_path, with_model):
    """continue = 1 in both packages over one model_dir walks past the
    partial, the corrupt and the non-finite snapshot to the same one:
    0002.model (start_counter 3) or, without it, 0001.ckpt (2), with the
    same params."""
    conf = _corrupt_model_dir(tmp_path, with_model)
    jt = _jax_task(conf, "continue=1")
    tt = _port_task(conf, "continue=1")
    try:
        jt.init()
        tt.init()
        want = 3 if with_model else 2
        assert jt.start_counter == tt.start_counter == want
        assert jt.net.epoch_counter == tt.net.epoch_counter
        for key, group in tt.net.params.items():
            for tag, p in group.items():
                assert np.array_equal(np.asarray(jt.net.params[key][tag]),
                                      p.numpy())
    finally:
        _close(jt)
        _close(tt)


# ------------------------------------------------ kill and continue

def _kill_run(task, at):
    """init, then train until the iterator raises at batch ``at`` (the
    stand-in for a kill: the writer's committed snapshots survive)."""
    task.init()
    task.itr_train = _KillAtBatch(task.itr_train, at=at)
    try:
        with pytest.raises(_KillAtBatch.Killed):
            task.task_train()
    finally:
        _close(task)


@pytest.mark.parametrize("ckpt_async", ["1", "0"])
def test_mnist_kill_continue_is_bitwise(tmp_path, ckpt_async):
    """Six rounds of the MNIST MLP with dropout and momentum (run A);
    the same run killed mid-round 5 and continued with continue = 1 in
    a fresh task (run B): the 0006 snapshots (.ckpt under ckpt_async =
    1, else .model) are equal bitwise, params, momentum, the torch rng
    state and the iterator state included.  Retention keeps the newest
    three .ckpt; the ckpt records carry the reference's fields."""
    ext = "ckpt" if ckpt_async == "1" else "model"
    _write_synth_mnist(tmp_path)
    extra = f"metrics_sink = jsonl:{{}}\nckpt_async = {ckpt_async}"
    conf_a = _mnist_conf(tmp_path, "A",
                         extra=extra.format(tmp_path / "A.jsonl"))
    _run(_port_task(conf_a))
    conf_b = _mnist_conf(tmp_path, "B",
                         extra=extra.format(tmp_path / "B.jsonl"))
    _kill_run(_port_task(conf_b), at=4 * 8 + 3)
    snap4 = str(tmp_path / "B" / f"0004.{ext}")
    assert ckpt_async == "0" or ckptlib.validate_snapshot(snap4)
    resumed = _port_task(conf_b, "continue=1")
    _run(resumed)
    assert resumed.last_train["steps"] == 2 * 8
    ha, _ = _assert_bitwise(str(tmp_path / "A" / f"0006.{ext}"),
                            str(tmp_path / "B" / f"0006.{ext}"))
    assert ha["extra"]["train_state"]["sample_counter"] == 48
    assert ha["extra"]["iter_state"] == {"loc": 128}
    if ckpt_async == "1":
        for d in ("A", "B"):
            kept = sorted(n for n in os.listdir(tmp_path / d)
                          if n.endswith(".ckpt"))
            assert kept == ["0004.ckpt", "0005.ckpt", "0006.ckpt"]
    recs = [json.loads(line) for line in open(tmp_path / "A.jsonl")]
    ckpts = [r for r in recs if r["kind"] == "ckpt"]
    assert [r["round"] for r in ckpts] == list(range(7))
    fields = {"round", "path", "async_write", "shards", "bytes", "write_sec",
              "blocked_sec", "pruned", "keep"}
    assert all(fields <= set(r) and r["async_write"] == int(ckpt_async)
               for r in ckpts)


def test_lm_kill_continue_with_pending_window_is_bitwise(tmp_path):
    """The packed text LM (adam) at update_period = 2, over a corpus whose
    rounds hold an odd number of batches: the round-4 snapshot carries
    the acc shard (half a window), the run is killed mid-round 5 and
    continued, and the 0006.ckpt equals the uninterrupted run's bitwise,
    the packer's ragged carry in iter_state included."""
    _write_lm_corpus(tmp_path, n_docs=40)
    counts = [_lm_batches_in_rounds(tmp_path, r) for r in (4, 6)]
    assert counts[0] % 2 == 1, "round 4 must end mid-window"
    extra = "update_period = 2"
    _run(_port_task(_write_lm_conf(tmp_path, str(tmp_path / "LA"), extra)))
    conf_b = _write_lm_conf(tmp_path, str(tmp_path / "LB"), extra)
    _kill_run(_port_task(conf_b), at=counts[0] + 3)
    _, shards = ckptlib.load_snapshot(str(tmp_path / "LB" / "0004.ckpt"))
    assert "acc" in shards
    _run(_port_task(conf_b, "continue=1"))
    ha, _ = _assert_bitwise(str(tmp_path / "LA" / "0006.ckpt"),
                            str(tmp_path / "LB" / "0006.ckpt"))
    assert ha["extra"]["train_state"]["sample_counter"] == counts[1]
    assert len(ha["extra"]["iter_state"]["tok"]) > 0


# ----------------------------------------------------- the trainer side

def test_payload_arrays_are_copies(tmp_path):
    """checkpoint_payload's arrays do not move when the next step
    rewrites the params and momentum in place (on the CPU a float32
    tensor's numpy() is a view)."""
    _write_synth_mnist(tmp_path)
    batches = _mnist_batches(tmp_path, 2)
    tt = _port_loaded_fresh()
    tt.update(batches[0])
    shards, meta = tt.checkpoint_payload(with_opt=True)
    before = {s: {k: v.copy() for k, v in a.items()}
              for s, a in shards.items()}
    tt.update(batches[1])
    for s, a in shards.items():
        for k, v in a.items():
            assert np.array_equal(v, before[s][k]), k
    assert meta["has_opt_state"] and set(shards) == {"params", "opt"}


def _port_loaded_fresh():
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.utils.config import parse_config_string
    tt = NetTrainer()
    for k, v in parse_config_string(MLP_NET):
        tt.set_param(k, v)
    for k, v in [("batch_size", "16"), ("dev", "cpu"), ("momentum", "0.9"),
                 ("updater", "sgd"), ("eta", "0.05"), ("input_shape",
                                                       "1,1,144"),
                 ("silent", "1")]:
        tt.set_param(k, v)
    tt.init_model()
    return tt


def test_model_in_ckpt_and_finetune_from_ckpt(tmp_path):
    """model_in = NNNN.ckpt trains on from round NNNN + 1; task =
    finetune copies every layer of a .ckpt."""
    _write_synth_mnist(tmp_path)
    conf = _mnist_conf(tmp_path, "M")
    _run(_port_task(conf, "num_round=1"))
    path = str(tmp_path / "M" / "0001.ckpt")
    task = _port_task(conf, f"model_in={path}", "num_round=2")
    try:
        task.init()
        assert task.start_counter == 2 and task.net.sample_counter == 8
    finally:
        _close(task)
    tt = _port_loaded_fresh()
    tt.copy_model_from(path)
    assert tt.copied_layers == ["fc1", "fc2"]
    _, flat = _flat_snapshot(path)
    by_name = {k.split("-", 1)[1]: v for k, v in flat.items()}
    for key, group in tt.params.items():
        for tag, p in group.items():
            name = key.split("-", 1)[1]
            assert np.array_equal(p.numpy(), by_name[f"{name}/{tag}"])
