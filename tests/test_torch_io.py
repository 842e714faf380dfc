"""The port's host input pipeline against the JAX package, on the CPU.

* Every ``iter =`` name and every stage (batch adapter, augment with crop,
  mirror, mean image, ``mean_value``, contrast, illumination and the cv2
  affine stage, ``imgbin`` / ``imgbinx`` over a JPEG pack made here with
  ``cv2.imencode`` (shuffled, ``%d`` shards, ``dist_num_worker``,
  ``decode_thread_num``), ``img``, threadbuffer, membuffer, attachtxt,
  text / packseq, ``imbin_native`` over raw u8, float32 and JPEG packs):
  the same chain built by both packages gives the same batches, bitwise,
  epoch after epoch; and a chain's ``state()`` / ``set_state()`` round
  trip resumes the next epoch as the uninterrupted chain reads it.
* Page files: each package writes byte-equal files and reads the
  other's.
* ``imbin_native``: a session fixture builds the port's library once (a
  file lock in ``cxxnet_tpu_torch/io/native.py``), and the JAX binding
  is pointed at that library in-process, so no test here runs ``make -C
  native``.
* ``S2DEmitIterator`` and ``LearnTask._wrap_s2d``, ``_normalize_input``
  (u8 batches normalised on the device) against the JAX package's.
* Staging: ``prefetch_device = 0`` against 2 gives bitwise losses and
  snapshots for a small MNIST_CONV run, through each package's CLI; a
  staged batch trains, predicts and evaluates as its host batch does; a
  producer's exception reaches the consumer and a raise mid-round leaves
  no thread behind; ``test_io = 1`` reads the same batches in both
  CLIs.
"""

import json
import os
import re
import sys
import threading

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_threads  # noqa: E402,F401 — torch threads under xdist

import cxxnet_tpu.io.native as jnative  # noqa: E402
from cxxnet_tpu.io import factory as jfactory  # noqa: E402
from cxxnet_tpu.io import imbin as jimbin  # noqa: E402
from cxxnet_tpu_torch.io import factory as tfactory  # noqa: E402
from cxxnet_tpu_torch.io import imbin as timbin  # noqa: E402
from cxxnet_tpu_torch.io import native as tnative  # noqa: E402
from cxxnet_tpu_torch.io.data import DataBatch, IIterator  # noqa: E402
from cxxnet_tpu_torch.io.device_prefetch import (  # noqa: E402
    DevicePrefetcher, StagedBatch)
from cxxnet_tpu_torch.io.text import write_token_shard  # noqa: E402

from test_ckpt import _write_synth_mnist  # noqa: E402

N_IMG, SIDE = 13, 12

# ------------------------------------------------------------------ data


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Seeded image sets: 13 JPEGs of 12x12 (files, one pack, three
    shards), raw u8 and float32 packs of 3x10x10, side features, a small
    MNIST and a token shard."""
    import cv2
    root = tmp_path_factory.mktemp("io")
    rnd = np.random.RandomState(3)
    imgs = (rnd.rand(N_IMG, SIDE, SIDE, 3) * 255).astype(np.uint8)
    labels = rnd.randint(0, 5, (N_IMG, 2))
    lines = []
    for i in range(N_IMG):
        ok, enc = cv2.imencode(".jpg", imgs[i], [cv2.IMWRITE_JPEG_QUALITY, 90])
        assert ok
        (root / f"im{i}.jpg").write_bytes(enc.tobytes())
        lines.append(f"{100 + i}\t{labels[i, 0]}\t{labels[i, 1]}\tim{i}.jpg\n")
    (root / "jpg.lst").write_text("".join(lines))
    timbin.pack_imbin(str(root / "jpg.lst"), str(root), str(root / "jpg.bin"),
                      page_size=4096)
    for s, (a, b) in enumerate([(0, 5), (5, 9), (9, N_IMG)]):
        (root / f"shard_{s}.lst").write_text("".join(lines[a:b]))
        timbin.pack_imbin(str(root / f"shard_{s}.lst"), str(root),
                          str(root / f"shard_{s}.bin"), page_size=2048)
    raw = rnd.randint(0, 256, (N_IMG, 3, 10, 10)).astype(np.uint8)
    for kind, recs in (("u8", raw), ("f32", raw.astype(np.float32) * 0.5
                                     + 0.25)):
        w = timbin.BinaryPageWriter(str(root / f"{kind}.bin"), page_size=4096)
        for r in recs:
            w.push(np.ascontiguousarray(r).tobytes())
        w.close()
    _write_synth_mnist(root, n=37)
    (root / "attach.txt").write_text("".join(
        f"{100 + i} " + " ".join(f"{v:.3f}" for v in rnd.rand(4)) + "\n"
        for i in range(37)))
    docs = [rnd.randint(1, 50, rnd.randint(3, 20)) for _ in range(17)]
    write_token_shard(str(root / "docs.tok"), docs)
    return root


def _jpg(d, **kw):
    return [("image_list", f"{d}/jpg.lst"), ("image_bin", f"{d}/jpg.bin"),
            ("input_shape", "3,10,10"), ("silent", "1")] + list(kw.items())


def _native(d, kind, **kw):
    cfg = [("image_bin", f"{d}/{kind}.bin"), ("image_list", f"{d}/jpg.lst"),
           ("silent", "1"), ("decode_thread_num", "0"),
           ("input_shape", "3,12,12" if kind == "jpg" else "3,10,10")]
    return cfg + list(kw.items())


def _mnist(d, **kw):
    return [("path_img", f"{d}/img.gz"), ("path_label", f"{d}/lbl.gz"),
            ("silent", "1")] + list(kw.items())


#: chain name -> (iterator section of (key, value) pairs, global pairs).
#: ``{tag}`` in a value becomes the package's name (files each writes).
CHAINS = {
    "mnist": (lambda d: [("iter", "mnist")] + _mnist(d, shuffle="1"),
              [("batch_size", "5")]),
    "mnist_round_batch": (lambda d: [("iter", "mnist")] + _mnist(
        d, round_batch="1", input_flat="0"), [("batch_size", "5")]),
    "img": (lambda d: [("iter", "img"), ("image_list", f"{d}/jpg.lst"),
                       ("image_root", str(d)), ("input_shape", "3,10,10"),
                       ("shuffle", "1"), ("rand_crop", "1"),
                       ("rand_mirror", "1"), ("silent", "1")],
            [("batch_size", "4")]),
    "imgbin": (lambda d: [("iter", "imgbin")] + _jpg(d),
               [("batch_size", "4")]),
    "imgbin_shuffle_crop_mirror": (lambda d: [("iter", "imgbin")] + _jpg(
        d, shuffle="1", rand_crop="1", rand_mirror="1", seed_data="3"),
        [("batch_size", "4")]),
    "imgbin_label_width": (lambda d: [("iter", "imgbin")] + _jpg(
        d, label_width="2", mirror="1", crop_y_start="1", crop_x_start="2"),
        [("batch_size", "4")]),
    "imgbin_shards": (lambda d: [
        ("iter", "imgbin"), ("image_list", f"{d}/shard_%d.lst"),
        ("image_bin", f"{d}/shard_%d.bin"), ("imgbin_count", "3"),
        ("input_shape", "3,10,10"), ("shuffle", "1"), ("silent", "1")],
        [("batch_size", "3")]),
    "imgbin_dist_worker": (lambda d: [
        ("iter", "imgbin"), ("image_list", f"{d}/shard_%d.lst"),
        ("image_bin", f"{d}/shard_%d.bin"), ("imgbin_count", "3"),
        ("dist_num_worker", "2"), ("dist_worker_rank", "1"),
        ("input_shape", "3,10,10"), ("silent", "1")],
        [("batch_size", "3")]),
    "imgbin_decode_threads": (lambda d: [("iter", "imgbin")] + _jpg(
        d, decode_thread_num="2", shuffle="1"), [("batch_size", "4")]),
    "imgbinx": (lambda d: [("iter", "imgbinx")] + _jpg(d, rand_crop="1"),
                [("batch_size", "4")]),
    "imgbin_mean_file": (lambda d: [("iter", "imgbin")] + _jpg(
        d, image_mean=f"{d}/mean_{{tag}}.npz", rand_crop="1",
        scale="0.01"), [("batch_size", "4")]),
    "imgbin_mean_value": (lambda d: [("iter", "imgbin")] + _jpg(
        d, mean_value="100,110,120", scale="0.02"), [("batch_size", "4")]),
    "imgbin_contrast_illumination": (lambda d: [("iter", "imgbin")] + _jpg(
        d, max_random_contrast="0.3", max_random_illumination="20",
        rand_mirror="1"), [("batch_size", "4")]),
    "imgbin_affine": (lambda d: [("iter", "imgbin")] + _jpg(
        d, max_rotate_angle="30", max_shear_ratio="0.2",
        max_aspect_ratio="0.3", min_crop_size="8", max_crop_size="11",
        fill_value="5"), [("batch_size", "4")]),
    "imgbin_rotate_list": (lambda d: [("iter", "imgbin")] + _jpg(
        d, rotate_list="0,90,180"), [("batch_size", "4")]),
    "imgbin_round_batch": (lambda d: [("iter", "imgbin")] + _jpg(
        d, round_batch="1"), [("batch_size", "5")]),
    "imgbin_test_skipread": (lambda d: [("iter", "imgbin")] + _jpg(
        d, test_skipread="1"), [("batch_size", "4")]),
    "imgbin_threadbuffer": (lambda d: [("iter", "imgbin")] + _jpg(
        d, shuffle="1", rand_crop="1") + [("iter", "threadbuffer"),
                                          ("buffer_size", "2")],
        [("batch_size", "4")]),
    "imgbin_membuffer": (lambda d: [("iter", "imgbin")] + _jpg(
        d, shuffle="1", rand_mirror="1") + [("iter", "membuffer"),
                                            ("max_nbatch", "2")],
        [("batch_size", "4")]),
    "imgbin_attachtxt": (lambda d: [("iter", "imgbin")] + _jpg(d) + [
        ("iter", "attachtxt"), ("path_attach_txt", f"{d}/attach.txt"),
        ("extra_data_shape[0]", "2,1,1"), ("extra_data_shape[1]", "1,1,2")],
        [("batch_size", "4")]),
    "mnist_attachtxt_threadbuffer": (lambda d: [("iter", "mnist")] + _mnist(
        d, index_offset="100") + [("iter", "attachtxt"),
                                  ("path_txt", f"{d}/attach.txt"),
                                  ("iter", "threadbuffer")],
        [("batch_size", "4")]),
    "text": (lambda d: [("iter", "text"), ("path_tok", f"{d}/docs.tok"),
                        ("shuffle", "1"), ("silent", "1")], []),
    "text_packseq_threadbuffer": (lambda d: [
        ("iter", "text"), ("path_tok", f"{d}/docs.tok"), ("shuffle", "1"),
        ("silent", "1"), ("iter", "packseq"), ("seqlen", "16"),
        ("iter", "threadbuffer")], [("batch_size", "3")]),
    "native_u8": (lambda d: [("iter", "imbin_native")] + _native(
        d, "u8", output_u8="1"), [("batch_size", "4")]),
    "native_u8_shuffle_threadbuffer": (lambda d: [
        ("iter", "imbin_native")] + _native(
        d, "u8", output_u8="1", shuffle="1", decode_thread_num="2") + [
        ("iter", "threadbuffer")], [("batch_size", "4")]),
    "native_f32_mean_scale": (lambda d: [("iter", "imbin_native")] + _native(
        d, "f32", mean_value="10,20,30", scale="0.5", round_batch="1"),
        [("batch_size", "4")]),
    "native_jpeg": (lambda d: [("iter", "imbin_native")] + _native(
        d, "jpg", label_width="2"), [("batch_size", "5")]),
    "native_jpeg_u8": (lambda d: [("iter", "imbin_native")] + _native(
        d, "jpg", output_u8="1", shuffle="1"), [("batch_size", "5")]),
}
STATEFUL = [n for n in CHAINS if not n.startswith("native")]


@pytest.fixture(scope="session")
def native_lib():
    """The port's build of native/imbin_iter.cc, once a session."""
    return str(tnative.build_library())


@pytest.fixture
def use_native(request, monkeypatch):
    """For a native chain: the JAX binding pointed at the port's
    library (no ``make -C native``)."""
    if "native" in request.node.name:
        lib = request.getfixturevalue("native_lib")
        monkeypatch.setattr(jnative, "_LIB_PATH", lib)
        monkeypatch.setattr(jnative, "_lib", None)


def _build(pkg, name, d):
    """The chain ``name`` of package ``pkg``, initialised.  The JAX
    package's threadbuffer is left out of its chain, and the rewind its
    ``init()`` makes is made by hand: its primed producer pulls a
    timing-dependent number of items that the first ``before_first()``
    throws away (ROADMAP.md §C), where the port's pulls none, so the
    reference is the JAX chain beneath its threadbuffer, rewound once
    more."""
    section, defcfg = CHAINS[name]
    cfg = [(k, v.replace("{tag}", pkg)) for k, v in section(d)] + [
        ("iter", "end")]
    buffered = ("iter", "threadbuffer") in cfg
    if pkg == "jax" and buffered:
        cfg = [(k, v) for k, v in cfg if (k, v) != ("iter", "threadbuffer")
               and k != "buffer_size"]
    fac = jfactory if pkg == "jax" else tfactory
    it = fac.init_iterator(fac.create_iterator(cfg), defcfg)
    if pkg == "jax" and buffered:
        it.before_first()
    return it


def _jax_state(name, it):
    """The JAX chain's state as the port's chain nests it (a
    threadbuffer, outermost in these chains, adds a level)."""
    st = it.state()
    section, _ = CHAINS[name]
    return {"base": st} if ("iter", "threadbuffer") in section("") else st


def _rec(v):
    """One batch or instance as plain host values (copied: a membuffer
    returns the same objects every epoch)."""
    out = {"data": np.array(v.data), "label": np.array(v.label),
           "index": np.array(v.index)}
    for k in ("num_batch_padd", "tail_mask_padd"):
        if hasattr(v, k):
            out[k] = int(getattr(v, k))
    extra = getattr(v, "extra_data", None)
    if extra:
        out["extra"] = [np.array(e) for e in extra]
    return out


def _epoch(it, limit=None):
    """One epoch's items (at most ``limit``: a ``test_skipread`` epoch
    repeats its first batch without end)."""
    it.before_first()
    out = []
    while limit is None or len(out) < limit:
        v = it.next()
        if v is None:
            break
        out.append(_rec(v))
    return out


def _assert_same(a, b, what=""):
    assert len(a) == len(b), f"{what}: {len(a)} against {len(b)} items"
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.keys() == y.keys(), f"{what} item {i}"
        for k in x:
            if k == "extra":
                pairs = list(zip(x[k], y[k]))
                assert len(x[k]) == len(y[k])
            else:
                pairs = [(x[k], y[k])]
            for p, q in pairs:
                if isinstance(p, np.ndarray):
                    assert p.dtype == q.dtype and p.shape == q.shape \
                        and p.tobytes() == q.tobytes(), \
                        f"{what} item {i} field {k} differs"
                else:
                    assert p == q, f"{what} item {i} field {k}: {p} != {q}"


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_batches_bitwise(name, data, use_native):
    """Three epochs of a chain built by each package: equal batch for
    batch, bitwise (data dtype, values, labels, indices, padding, side
    inputs)."""
    its = {pkg: _build(pkg, name, data) for pkg in ("jax", "port")}
    try:
        limit = 6 if "skipread" in name else None
        for e in range(3):
            got = {pkg: _epoch(it, limit) for pkg, it in its.items()}
            assert got["port"], f"{name}: epoch {e} is empty"
            _assert_same(got["jax"], got["port"], f"{name} epoch {e}")
    finally:
        for it in its.values():
            it.close()
    if name == "imgbin_mean_file":
        m = {pkg: np.load(data / f"mean_{pkg}.npz")["mean"]
             for pkg in its}
        assert m["port"].tobytes() == m["jax"].tobytes()


@pytest.mark.parametrize("name", STATEFUL)
def test_chain_state_round_trip(name, data):
    """After one epoch, the chain's ``state()`` (through JSON) restores a
    fresh chain to read the second epoch exactly as the uninterrupted
    chain reads it; the state equals the JAX package's."""
    a, b = _build("port", name, data), _build("port", name, data)
    j = _build("jax", name, data)
    c = None
    limit = 6 if "skipread" in name else None
    try:
        _epoch(a, limit), _epoch(b, limit), _epoch(j, limit)
        st = json.loads(json.dumps(b.state()))
        assert st == json.loads(json.dumps(_jax_state(name, j)))
        c = _build("port", name, data)
        c.set_state(st)
        _assert_same(_epoch(a, limit), _epoch(c, limit),
                     f"{name} resumed epoch")
    finally:
        for it in (a, b, j, c):
            if it is not None:
                it.close()


def test_native_state_raises(data, native_lib):
    it = _build("port", "native_u8", data)
    try:
        with pytest.raises(NotImplementedError, match="resume restarts"):
            it.state()
    finally:
        it.close()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A compiler error raises with the compiler's message: no fallback
    to the Python chain."""
    bad = tmp_path / "native"
    bad.mkdir()
    for name in tnative.SOURCES:
        (bad / name).write_text("#error deliberately broken\n")
    monkeypatch.setattr(tnative, "NATIVE_DIR", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(tnative.NativeCompileError,
                       match="deliberately broken"):
        tnative.build_library()


# ----------------------------------------------------------- page files

def test_page_files_byte_equal_and_cross_read(data, tmp_path):
    """The same records written by each package's BinaryPageWriter (and
    packed by each pack_imbin) are byte-equal files; each package's
    read_pages reads the other's pages."""
    rnd = np.random.RandomState(9)
    recs = [rnd.bytes(rnd.randint(1, 700)) for _ in range(40)]
    for pkg, mod in (("jax", jimbin), ("port", timbin)):
        w = mod.BinaryPageWriter(str(tmp_path / f"{pkg}.bin"),
                                 page_size=2048)
        for r in recs:
            w.push(r)
        w.close()
        mod.pack_imbin(str(data / "jpg.lst"), str(data),
                       str(tmp_path / f"{pkg}_jpg.bin"), page_size=4096)
    for stem in ("", "_jpg"):
        assert (tmp_path / f"jax{stem}.bin").read_bytes() == \
            (tmp_path / f"port{stem}.bin").read_bytes()
    for reader, writer in ((jimbin, "port"), (timbin, "jax")):
        pages = list(reader.read_pages(str(tmp_path / f"{writer}.bin")))
        assert len(pages) > 1
        assert [r for p in pages for r in p] == recs


def test_factory_names_match_jax():
    assert tfactory.iter_type_names() == jfactory.iter_type_names()
    for name in tfactory.iter_type_names()[:-1]:
        got = [c.__name__ for c in tfactory.iter_stage_classes(name)]
        want = [c.__name__ for c in jfactory.iter_stage_classes(name)]
        assert got == want, name
    with pytest.raises(ValueError, match="unknown iterator type"):
        tfactory.create_iterator([("iter", "nope")])


# ------------------------------------------------------------- s2d, u8

class ListIter(IIterator):
    def __init__(self, batches):
        self.batches = batches

    def before_first(self):
        self.i = 0

    def next(self):
        if self.i >= len(self.batches):
            return None
        self.i += 1
        return self.batches[self.i - 1]


@pytest.mark.parametrize("dtype,pad", [(np.float32, 0), (np.float32, 2),
                                       (np.uint8, 0), (np.uint8, 2)])
def test_s2d_emit_iterator_matches_jax(dtype, pad):
    """``s2d_np`` / ``S2DEmitIterator`` emit the JAX package's arrays; a
    u8 batch through a padded conv passes unchanged in both."""
    from cxxnet_tpu.io import iter_proc as jproc
    from cxxnet_tpu.io.data import DataBatch as JBatch
    from cxxnet_tpu_torch.io.iter_proc import S2DEmitIterator
    from cxxnet_tpu_torch.ops.nn import conv_out_size
    rnd = np.random.RandomState(4)
    s, k, h = 2, 5, 21
    o = conv_out_size(h, k, s, pad)
    args = (s, k, k, o, o, pad, pad)
    x = (rnd.randint(0, 256, (3, 3, h, h)) if dtype == np.uint8
         else rnd.randn(3, 3, h, h)).astype(dtype)
    lab = np.zeros((3, 1), np.float32)
    idx = np.arange(3, dtype=np.uint32)
    it = S2DEmitIterator(ListIter([DataBatch(x, lab, idx)]), args)
    jit = jproc.S2DEmitIterator(ListIter([JBatch(x, lab, idx)]), args)
    got, want = _epoch(it), _epoch(jit)
    _assert_same(want, got, "s2d")
    if dtype == np.uint8 and pad:
        assert got[0]["data"].tobytes() == x.tobytes()


def test_wrap_s2d_splices_beneath_deepest_buffer():
    from cxxnet_tpu_torch.io.iter_proc import (DenseBufferIterator,
                                               S2DEmitIterator,
                                               ThreadBufferIterator)
    from cxxnet_tpu_torch.main import LearnTask

    class Net:
        _s2d_args = (2, 5, 5, 9, 9, 0, 0)

    task = LearnTask()
    task.net = Net()
    base = ListIter([])
    top = DenseBufferIterator(ThreadBufferIterator(base))
    assert task._wrap_s2d(top) is top
    assert isinstance(top.base, ThreadBufferIterator)
    assert isinstance(top.base.base, S2DEmitIterator)
    assert top.base.base.base is base
    plain = ListIter([])
    wrapped = task._wrap_s2d(plain)
    assert isinstance(wrapped, S2DEmitIterator) and wrapped.base is plain
    task.net = None
    assert task._wrap_s2d(plain) is plain


NORM_NET = """netconfig=start
layer[0->1] = conv
  kernel_size = 5
  stride = 2
  nchannel = 4
layer[1->2] = flatten
layer[2->3] = fullc
  nhidden = 3
layer[3->3] = softmax
netconfig=end
input_shape = 3,21,21
batch_size = 4
dev = cpu
silent = 1
"""


def _trainers(extra):
    from cxxnet_tpu.nnet.trainer import NetTrainer as JTrainer
    from cxxnet_tpu.utils.config import parse_config_string
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    out = []
    for cls in (JTrainer, NetTrainer):
        t = cls()
        for k, v in parse_config_string(NORM_NET + extra):
            t.set_param(k, v)
        t.init_model()
        out.append(t)
    return out


@pytest.mark.parametrize("extra,s2d_host", [
    ("mean_value = 10,20,30\nscale = 0.01\n", False),
    ("scale = 0.5\n", False),
    ("mean_value = 123.68,116.78,103.94\n", False),
    ("mean_value = 10,20,30\nscale = 0.01\ninput_s2d = 1\n", False),
    ("mean_value = 10,20,30\nscale = 0.01\ninput_s2d = 1\n", True)])
def test_normalize_input_matches_jax(extra, s2d_host):
    """``_normalize_input`` of a u8 batch equals the JAX package's
    bitwise (under ``input_s2d = 1`` also the staged space-to-depth
    form, from a plain batch and from one the host delivered in s2d
    form, the mean repeated over the (c, sy, sx) channels); float
    batches pass unchanged."""
    import jax.numpy as jnp
    from cxxnet_tpu.io.iter_proc import s2d_np
    jt, tt = _trainers(extra)
    x = np.random.RandomState(5).randint(0, 256, (4, 3, 21, 21)) \
        .astype(np.uint8)
    if s2d_host:
        x = s2d_np(x, *tt._s2d_args)
    want = np.asarray(jt._normalize_input(jnp.asarray(x)))
    got = tt._normalize_input(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    if tt._s2d_args is not None:
        want = np.asarray(jt._s2d_transform(jnp.asarray(x)))
        got = tt.stage_batch(DataBatch(
            x, np.zeros((4, 1), np.float32),
            np.arange(4, dtype=np.uint32))).data.numpy()
        assert got.tobytes() == want.tobytes()
    f = torch.rand(2, 3)
    assert tt._normalize_input(f) is f


def test_u8_step_equals_host_normalised_step():
    """A u8 batch normalised on the device trains exactly as the same
    batch normalised on the host (the iterators' SetData rule)."""
    _, a = _trainers("mean_value = 10,20,30\nscale = 0.01\n")
    _, b = _trainers("mean_value = 10,20,30\nscale = 0.01\n")
    rnd = np.random.RandomState(0)
    raw = rnd.randint(0, 256, (4, 3, 21, 21)).astype(np.uint8)
    label = rnd.randint(0, 3, (4, 1)).astype(np.float32)
    host = (raw.astype(np.float32)
            - np.array([10, 20, 30], np.float32).reshape(1, 3, 1, 1)) \
        * np.float32(0.01)
    idx = np.arange(4, dtype=np.uint32)
    a.update(DataBatch(raw, label, idx))
    b.update(DataBatch(host, label, idx))
    for k, g in a.params.items():
        for tag, v in g.items():
            assert torch.equal(v, b.params[k][tag]), f"{k}/{tag}"


# -------------------------------------------------------------- staging

def test_staged_batch_trains_predicts_evaluates_as_host_batch():
    """``stage_batch`` then ``update`` / ``predict`` / ``predict_raw`` /
    ``extract_feature`` / ``evaluate`` equals the same calls on the host
    batch (the tail mask and padding included)."""
    _, a = _trainers("metric = error\n")
    _, b = _trainers("metric = error\n")
    rnd = np.random.RandomState(1)
    batches = [DataBatch(rnd.rand(4, 3, 21, 21).astype(np.float32),
                         rnd.randint(0, 3, (4, 1)).astype(np.float32),
                         np.arange(4, dtype=np.uint32),
                         num_batch_padd=p, tail_mask_padd=p)
               for p in (0, 1)]
    for x in batches:
        sb = b.stage_batch(x)
        assert isinstance(sb, StagedBatch) and sb.ready is None
        assert (sb.mask is None) == (x.tail_mask_padd == 0)
        a.update(x)
        b.update(sb)
        assert torch.equal(a.last_loss, b.last_loss)
    for x in batches:
        sb = b.stage_batch(x)
        assert np.array_equal(a.predict(x), b.predict(sb))
        assert np.array_equal(a.predict_raw(x), b.predict_raw(sb))
        assert np.array_equal(a.extract_feature(x, "1"),
                              b.extract_feature(sb, "1"))
    pf = DevicePrefetcher(ListIter(batches), b, depth=2, for_eval=True)
    try:
        assert a.evaluate(ListIter(batches), "v") == b.evaluate(pf, "v")
    finally:
        pf.close()


def _cnn_conf(tmp_path, extra=""):
    """MNIST_CONV.conf over tools/make_synth_mnist.py data, dropout off
    (the run is compared with itself), a round of 3 steps."""
    import subprocess
    data = tmp_path / "data"
    if not data.exists():
        subprocess.run([sys.executable,
                        os.path.join(REPO, "tools/make_synth_mnist.py"),
                        "--out", str(data), "--train", "300", "--test",
                        "100"], check=True, capture_output=True)
    text = open(os.path.join(REPO, "example/MNIST/MNIST_CONV.conf")).read()
    text = text.replace("./data/", f"{data}/")
    text = re.sub(r"(?m)^(dev|save_model|model_dir|max_round|num_round)"
                  r"\s*=.*$", "", text)
    conf = tmp_path / "mnist_conv.conf"
    conf.write_text(text + f"\ndev = cpu\nnum_round = 2\nsilent = 1\n"
                    f"print_step = 1\n{extra}")
    return conf


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_prefetch_on_off_bitwise_cli(pkg, tmp_path):
    """MNIST_CONV through the package's CLI at ``prefetch_device = 0``
    and ``2`` (eval prefetchers too): the same losses bitwise, the same
    round lines, and byte-equal parameter arrays in the snapshots."""
    if pkg == "jax":
        from cxxnet_tpu.main import LearnTask
    else:
        from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.nnet.trainer import read_snapshot
    conf = _cnn_conf(tmp_path)
    runs = {}
    for pf in (0, 2):
        sink = tmp_path / f"{pkg}_{pf}.jsonl"
        mdir = tmp_path / f"{pkg}_{pf}"
        task = LearnTask()
        assert task.run([str(conf), f"prefetch_device={pf}",
                         f"model_dir={mdir}", "save_model=2",
                         f"metrics_sink=jsonl:{sink}"]) == 0
        recs = [json.loads(line) for line in open(sink)]
        losses = [r["loss"] for r in recs if r["kind"] == "step"]
        rounds = [{k: v for k, v in r.items() if "error" in k}
                  for r in recs if r["kind"] == "round"]
        _, params, _, _, _ = read_snapshot(str(mdir / "0002.model"))
        runs[pf] = losses, rounds, params
    (l0, r0, p0), (l2, r2, p2) = runs[0], runs[2]
    assert len(l0) == 6 and l0 == l2
    assert len(r0) == 2 and r0 == r2
    for k, g in p0.items():
        for tag, v in g.items():
            assert np.asarray(v).tobytes() == np.asarray(p2[k][tag]).tobytes()


def test_test_io_batch_counts_match_jax_cli(tmp_path):
    """``test_io = 1`` through both CLIs over an imgbin + threadbuffer
    chain: the same examples a round, no update (no step record in
    either), and the port's round line of examples/sec."""
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu_torch.main import LearnTask as TTask
    conf = _cnn_conf(tmp_path, "test_io = 1\nbatch_size = 32\n")
    counts = {}
    for name, task in (("jax", JTask), ("port", TTask)):
        sink = tmp_path / f"io_{name}.jsonl"
        t = task()
        assert t.run([str(conf), "save_model=0",
                      f"metrics_sink=jsonl:{sink}"]) == 0
        recs = [json.loads(line) for line in open(sink)]
        assert not [r for r in recs if r["kind"] == "step"]
        counts[name] = [r["examples"] for r in recs if r["kind"] == "round"]
    assert counts["port"] == counts["jax"] == [300, 300]
    assert t.last_train["steps"] == 0
    assert all(r["examples_per_sec"] > 0 for r in t.last_train["rounds"])


class _Failing(IIterator):
    """Two good batches, then a raise."""

    def before_first(self):
        self.i = 0

    def next(self):
        self.i += 1
        if self.i > 2:
            raise RuntimeError("host decode failed")
        return DataBatch(np.zeros((2, 1, 1, 3), np.float32),
                         np.zeros((2, 1), np.float32),
                         np.arange(2, dtype=np.uint32))


class _Stager:
    device = torch.device("cpu")

    def stage_batch(self, b):
        return b


@pytest.mark.parametrize("stage", ["threadbuffer", "prefetch_async",
                                   "prefetch_sync"])
def test_producer_exception_reaches_consumer(stage):
    """A raise on the producer surfaces in the consumer's ``next()``, and
    again on the next call (the epoch is dead, never a hang); no thread
    is left after ``close()``."""
    from cxxnet_tpu_torch.io.iter_proc import ThreadBufferIterator
    baseline = threading.active_count()
    if stage == "threadbuffer":
        it = ThreadBufferIterator(_Failing())
        it.init()
    else:
        it = DevicePrefetcher(_Failing(), _Stager(),
                              depth=2 if stage == "prefetch_async" else 0)
    it.before_first()
    assert it.next() is not None and it.next() is not None
    with pytest.raises(RuntimeError, match="host decode failed"):
        it.next()
    with pytest.raises(RuntimeError, match="host decode failed"):
        it.next()
    it.close()
    assert threading.active_count() == baseline


def test_midround_raise_leaves_no_threads(tmp_path, monkeypatch):
    """A raise in round 2's update (after round 1 made the eval
    prefetchers) over a threadbuffer chain at ``prefetch_device = 2``
    propagates out of the CLI, and every producer thread is joined."""
    from cxxnet_tpu_torch.main import LearnTask
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    conf = _cnn_conf(tmp_path)
    text = conf.read_text().replace("iter = end", "iter = threadbuffer\n"
                                    "iter = end", 1)
    conf.write_text(text)
    baseline = threading.active_count()
    calls = {"n": 0}
    orig = NetTrainer.update

    def boom(self, batch):
        calls["n"] += 1
        if calls["n"] > 4:
            raise RuntimeError("mid-round failure")
        return orig(self, batch)

    monkeypatch.setattr(NetTrainer, "update", boom)
    task = LearnTask()
    with pytest.raises(RuntimeError, match="mid-round failure"):
        task.run([str(conf), "prefetch_device=2", "save_model=0"])
    assert task._eval_prefetchers is None
    assert threading.active_count() == baseline


def test_prefetcher_threads_across_epochs():
    """One producer at most while epochs cycle; none after close()."""
    batches = [DataBatch(np.full((2, 1, 1, 3), i, np.float32),
                         np.zeros((2, 1), np.float32),
                         np.arange(2, dtype=np.uint32)) for i in range(5)]
    baseline = threading.active_count()
    pf = DevicePrefetcher(ListIter(batches), _Stager(), depth=2)
    for _ in range(4):
        got = [b[0].data[0, 0, 0, 0] for b in pf]
        assert got == [0, 1, 2, 3, 4]
        assert threading.active_count() <= baseline + 1
    pf.close()
    assert threading.active_count() == baseline


def test_threadbuffer_first_epoch_independent_of_timing(data):
    """The port's threadbuffer pulls nothing before the first epoch: its
    batches over an augmenting, shuffled chain are the same whether the
    first ``before_first()`` comes at once or after its producer could
    have filled the queue."""
    import time
    epochs = []
    for wait in (0.0, 0.3):
        it = _build("port", "imgbin_threadbuffer", data)
        try:
            time.sleep(wait)
            epochs.append(_epoch(it))
        finally:
            it.close()
    _assert_same(epochs[0], epochs[1], "threadbuffer after a wait")


def test_input_s2d_cli_emits_host_s2d_batches(data, tmp_path):
    """``input_s2d = 1`` through the port's CLI over an imgbin +
    threadbuffer chain: the host emits space-to-depth batches beneath
    the threadbuffer (``_wrap_s2d``), and training matches ``input_s2d
    = 0`` on the same batches (the two convs differ only in summation
    order)."""
    from cxxnet_tpu_torch.io.iter_proc import (S2DEmitIterator,
                                               ThreadBufferIterator)
    from cxxnet_tpu_torch.main import LearnTask
    section = "\n".join(f"  {k} = {v}" for k, v in _jpg(
        data, shuffle="1", mean_value="100,110,120", scale="0.02"))
    conf = tmp_path / "s2d.conf"
    conf.write_text(f"""data = train
iter = imgbin
{section}
iter = threadbuffer
iter = end
netconfig=start
layer[0->1] = conv
  kernel_size = 3
  stride = 2
  nchannel = 4
layer[1->2] = flatten
layer[2->3] = fullc
  nhidden = 5
layer[3->3] = softmax
netconfig=end
batch_size = 4
dev = cpu
eta = 0.1
num_round = 2
save_model = 0
silent = 1
""")
    losses = {}
    for s2d in (0, 1):
        task = LearnTask()
        assert task.run([str(conf), f"input_s2d={s2d}"]) == 0
        losses[s2d] = task.last_train["losses"]
        if s2d:
            tb = task.itr_train
            assert isinstance(tb, ThreadBufferIterator)
            assert isinstance(tb.base, S2DEmitIterator)
    assert len(losses[0]) == 8
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
