"""The port's speculative decoding, chunked prefill and KV-cache dtype
against the JAX package, on the CPU.

A tiny transformer LM is built by the JAX package (the
tests/test_decode.py fixture) and carried into the port with
``params_from_jax``.  Block-mode logits (the verify and chunk dispatch)
are held to the JAX package's within the serve tolerance, and to the
port's own sequential steps within 1e-5 relative: neither package's
block rows are bitwise its steps' rows, because the GEMMs reduce in an
order picked by the row count.  Greedy speculative ids must equal plain
greedy ids and the JAX scheduler's, list for list.  Also: the sampling
helpers bitwise, the scheduler's speculation and chunk bookkeeping over
fake runners against the JAX scheduler's, both KV-cache dtypes under
both net dtypes, and the CLI against the JAX CLI.
"""

import json
import os
import sys
import threading
import time

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch_threads  # noqa: E402,F401 — torch threads under xdist

from cxxnet_tpu.models import transformer  # noqa: E402
from cxxnet_tpu.serve.batcher import StepScheduler as JScheduler  # noqa: E402
from cxxnet_tpu.serve.decode import DecodeEngine as JEngine  # noqa: E402
from cxxnet_tpu_torch.nnet.trainer import (NetTrainer,  # noqa: E402
                                           params_from_jax)
from cxxnet_tpu_torch.serve.batcher import (  # noqa: E402
    StepScheduler as TScheduler)
from cxxnet_tpu_torch.serve.decode import DecodeEngine as TEngine  # noqa: E402
from cxxnet_tpu_torch.utils.config import parse_config_string  # noqa: E402

LOGIT_TOL = 1e-4
#: block rows against the port's own sequential steps: max |diff| /
#: max |step row|
BLOCK_STEP_TOL = 1e-5
SERVE_TOL_BF16 = 2e-2
NET = transformer(vocab=64, seq=32, dim=32, nlayer=2, nhead=2)
DRAFT_NET = transformer(vocab=64, seq=32, dim=16, nlayer=1, nhead=2)
WIDTHS = (1, 2, 3, 4, 8, 16)
JAX_EXTRA = [("updater", "sgd"), ("eta", "0.01"), ("eval_train", "0"),
             ("silent", "1")]


def _carry(net, extra=()):
    """(JAX trainer, port trainer) holding the same weights."""
    from __graft_entry__ import _make_trainer
    jt = _make_trainer(net, 2, "cpu", extra=JAX_EXTRA + list(extra))
    tt = NetTrainer()
    for k, v in parse_config_string(net):
        tt.set_param(k, v)
    for k, v in (("batch_size", "2"), ("dev", "cpu"),
                 ("silent", "1")) + tuple(extra):
        tt.set_param(k, v)
    tt.init_model()
    tt.set_state(*params_from_jax(jax.tree.map(np.asarray, jt.params),
                                  jax.tree.map(np.asarray, jt.buffers)))
    return jt, tt


@pytest.fixture(scope="module")
def pair():
    return _carry(NET)


@pytest.fixture(scope="module")
def engines(pair):
    """(JAX, port) flagship engines with the verify and chunk widths."""
    jt, tt = pair
    je = JEngine(jt, slots=2, max_seqlen=32, block_widths=WIDTHS)
    je.warmup()
    te = TEngine(tt, slots=2, max_seqlen=32, block_widths=WIDTHS)
    te.warmup()
    return je, te


@pytest.fixture(scope="module")
def self_drafts(pair):
    """The flagship as its own draft (every proposal agrees)."""
    jt, tt = pair
    jd = JEngine(jt, slots=2, max_seqlen=32)
    jd.warmup()
    td = TEngine(tt, slots=2, max_seqlen=32)
    td.warmup()
    return jd, td


@pytest.fixture(scope="module")
def small_drafts():
    """A smaller, different draft net in both packages."""
    jt, tt = _carry(DRAFT_NET)
    jd = JEngine(jt, slots=2, max_seqlen=32)
    jd.warmup()
    td = TEngine(tt, slots=2, max_seqlen=32)
    td.warmup()
    return jd, td


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, 64, n).astype(np.int32)


def _rel(got, ref):
    return float(np.max(np.abs(got - ref))) / (float(np.max(np.abs(ref)))
                                               + 1e-6)


class ShiftedDraft:
    """Adversarial draft: the wrapped engine's logits rolled one vocab
    slot, so no greedy proposal matches the verified argmax."""

    def __init__(self, eng):
        self.eng = eng
        self.slots = eng.slots
        self.max_seqlen = eng.max_seqlen
        self.vocab = eng.vocab

    def prefill(self, slot, tokens):
        return np.roll(self.eng.prefill(slot, tokens), 1, axis=-1)

    def step(self, tokens, positions):
        return np.roll(self.eng.step(tokens, positions), 1, axis=-1)


# ------------------------------------------------------------ block mode

@pytest.mark.parametrize("width,plen", [(1, 9), (2, 9), (3, 9), (4, 9),
                                        (4, 30)])
def test_block_logits_match_jax(engines, width, plen):
    """One block of ``width`` columns after a prompt in slot 0 (slot 1
    rides at 0): every row within LOGIT_TOL of the JAX block's.  At
    plen 30 the width-4 block runs past the 32-column cache: the JAX
    package drops the last two columns, the port leaves them out of the
    write; then one step at 31 reads the cache both left."""
    je, te = engines
    p = _prompt(plen, seed=10 + plen)
    np.testing.assert_allclose(te.prefill(0, p), je.prefill(0, p),
                               atol=LOGIT_TOL)
    toks = np.zeros((2, width), np.int32)
    toks[0] = _prompt(width, seed=50 + width)
    pos = np.asarray([plen, 0], np.int32)
    want, got = je.block(toks, pos), te.block(toks, pos)
    assert got.shape == (2, width, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL)
    if plen + width > 32:
        step = (np.asarray([toks[0, 0], 0], np.int32),
                np.asarray([31, 0], np.int32))
        np.testing.assert_allclose(te.step(*step)[0], je.step(*step)[0],
                                   atol=LOGIT_TOL)
    assert te.retraces == 0


def test_block_rows_match_sequential_steps(engines):
    """A width-4 block over the tokens four sequential steps feed gives
    their four logits rows within BLOCK_STEP_TOL (not bitwise: the GEMMs'
    reduction order follows the row count, in the JAX package too)."""
    _, te = engines
    p = _prompt(9, seed=11)
    toks = [int(np.argmax(te.prefill(0, p)))]
    rows = []
    for i in range(4):
        step = te.step(np.asarray([toks[-1], 0], np.int32),
                       np.asarray([len(p) + i, 0], np.int32))
        rows.append(step[0])
        toks.append(int(np.argmax(step[0])))
    blk = te.block(np.asarray([toks[:4], [0] * 4], np.int32),
                   np.asarray([len(p), 0], np.int32))
    for i in range(4):
        assert _rel(blk[0, i], rows[i]) <= BLOCK_STEP_TOL, f"row {i}"


def test_cold_block_width_counts_a_retrace(pair):
    _, tt = pair
    te = TEngine(tt, slots=2, max_seqlen=32, block_widths=(4,))
    te.warmup()
    zeros = np.zeros((2,), np.int32)
    te.block(np.zeros((2, 4), np.int32), zeros)
    assert te.retraces == 0 and te.block_calls == 1
    te.block(np.zeros((2, 3), np.int32), zeros)
    te.block(np.zeros((2, 3), np.int32), zeros)
    assert te.retraces == 1 and te.block_calls == 3
    assert te.stats()["block_calls"] == 3
    with pytest.raises(ValueError, match="block width 40"):
        TEngine(tt, slots=2, max_seqlen=32, block_widths=(40,))


@pytest.mark.parametrize("plen", [1, 15, 16, 17, 32])
def test_chunked_prefill_matches_jax_and_whole_prefill(engines, plen):
    """The prompt streamed through width-16 blocks into slot 1: the last
    prompt position's row within LOGIT_TOL of the JAX package's chunked
    row and of the port's whole-prompt prefill."""
    je, te = engines
    p = _prompt(plen, seed=40 + plen)
    last = {}
    for name, eng in (("jax", je), ("port", te)):
        for off in range(0, plen, 16):
            tokens = np.zeros((2, 16), np.int32)
            chunk = p[off:off + 16]
            tokens[1, :len(chunk)] = chunk
            blk = eng.block(tokens, np.asarray([0, off], np.int32))
        last[name] = blk[1, plen - 1 - off]
    np.testing.assert_allclose(last["port"], last["jax"], atol=LOGIT_TOL)
    np.testing.assert_allclose(last["port"], te.prefill(0, p),
                               atol=LOGIT_TOL)
    assert te.retraces == 0


# ------------------------------------------------------ speculative ids

def _serial_greedy(eng, prompt, max_new):
    seq = [int(np.argmax(eng.prefill(0, prompt)))]
    pos = len(prompt)
    while len(seq) < max_new and pos < eng.max_seqlen:
        step = eng.step(np.asarray([seq[-1], 0], np.int32),
                        np.asarray([pos, 0], np.int32))
        seq.append(int(np.argmax(step[0])))
        pos += 1
    return seq


def _spec_generate(sched_cls, flagship, draft, prompts, max_new, **kw):
    s = sched_cls(flagship, max_new_tokens=max_new, eos=-1, queue_depth=8,
                  draft=draft, spec_k=3, **kw)
    s.start()
    out = [None] * len(prompts)

    def client(i):
        out[i] = list(s.submit(prompts[i], max_new))

    ths = [threading.Thread(target=client, args=(i,), daemon=True)
           for i in range(len(prompts))]
    try:
        for th in ths:
            th.start()
        for th in ths:
            th.join()
    finally:
        s.close()
    return out, s


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("kind", ["self", "shifted", "small"])
def test_spec_greedy_ids_match_plain_and_jax(engines, self_drafts,
                                             small_drafts, kind, chunk):
    """Greedy speculative generation over three concurrent prompts (one
    near the cache end) with a draft that always agrees (the flagship),
    never agrees (shifted logits) or sometimes does (a smaller net),
    with and without chunked prefill: the ids equal the port's plain
    greedy decode and the JAX scheduler's, list for list."""
    je, te = engines
    jd, td = {"self": self_drafts, "shifted": self_drafts,
              "small": small_drafts}[kind]
    if kind == "shifted":
        jd, td = ShiftedDraft(jd), ShiftedDraft(td)
    prompts = [_prompt(5, seed=1), _prompt(17, seed=2),
               _prompt(27, seed=3)]
    plain = [_serial_greedy(te, p, 12) for p in prompts]
    want, js = _spec_generate(JScheduler, je, jd, prompts, 12,
                              prefill_chunk=chunk)
    got, ts = _spec_generate(TScheduler, te, td, prompts, 12,
                             prefill_chunk=chunk)
    assert got == plain
    assert got == want
    st = ts.stats()
    assert st["spec_k"] == 3 and st["verify_calls"] == ts.n_verify_calls > 0
    assert st["draft_steps"] == ts.n_draft_steps > 0
    if kind == "self":
        assert ts.n_spec_accepted == ts.n_spec_proposed > 0
    if kind == "shifted":
        # one token a slot a round: k proposals each after the first
        assert ts.n_spec_accepted == 0
        assert ts.n_spec_proposed == 3 * (sum(len(w) for w in plain)
                                          - len(prompts))
    if chunk:
        assert st["prefill_chunks"] == sum(-(-len(p) // chunk)
                                           for p in prompts)
    assert st["prefills"] == len(prompts)
    assert te.retraces == 0


# -------------------------------------------------------------- sampling

def test_sample_probs_and_draw_from_match_jax():
    from cxxnet_tpu.serve import decode as jdec
    from cxxnet_tpu_torch.serve import decode as tdec
    logits = np.random.RandomState(2).randn(50).astype(np.float32)
    for kind, kw in (("temperature", {"temp": 0.7}),
                     ("topk", {"temp": 1.3, "topk": 5})):
        pj = jdec.sample_probs(logits, kind, **kw)
        pt = tdec.sample_probs(logits, kind, **kw)
        assert pt.dtype == np.float64 and np.array_equal(pt, pj)
        a = [jdec.draw_from(pj, np.random.RandomState(i)) for i in range(30)]
        b = [tdec.draw_from(pt, np.random.RandomState(i)) for i in range(30)]
        assert a == b
        # a draw from sample_probs lands where sample_token's draw does
        c = [tdec.sample_token(logits, kind, rng=np.random.RandomState(i),
                               **kw) for i in range(30)]
        assert b == c
    with pytest.raises(ValueError, match="greedy is argmax"):
        tdec.sample_probs(logits, "greedy")


@pytest.mark.parametrize("kind", ["temperature", "topk"])
def test_spec_rejection_sampling_matches_jax(engines, small_drafts, kind):
    """Non-greedy speculation: rejection sampling off the verified
    distributions with each request's RandomState gives the JAX
    scheduler's ids on the same logits (one prompt a run, so both
    schedulers number it request 1)."""
    je, te = engines
    jd, td = small_drafts
    kw = dict(sample=kind, temp=0.8, topk=8 if kind == "topk" else 0,
              seed=5)
    p = [_prompt(7, seed=21)]
    want, _ = _spec_generate(JScheduler, je, jd, p, 10, **kw)
    got, ts = _spec_generate(TScheduler, te, td, p, 10, **kw)
    assert got == want
    assert ts.n_verify_calls > 0


# ------------------------------------------- scheduler units (fake runners)

class FakeRunner:
    """Logits rigged so greedy always emits token (slot + 1), never the
    eos (0); every block row repeats them."""

    def __init__(self, slots=2, max_seqlen=64, step_sleep=0.004):
        self.slots = slots
        self.max_seqlen = max_seqlen
        self.step_sleep = step_sleep
        self.prefill_log = []
        self.step_actives = []
        self.block_log = []
        self.lock = threading.Lock()

    def _logits(self, slot):
        row = np.zeros(8, np.float32)
        row[slot + 1] = 1.0
        return row

    def prefill(self, slot, tokens):
        with self.lock:
            self.prefill_log.append((slot, len(tokens)))
        return self._logits(slot)

    def step(self, tokens, positions):
        with self.lock:
            self.step_actives.append(
                tuple(int(i) for i in np.nonzero(positions)[0]))
        time.sleep(self.step_sleep)
        return np.stack([self._logits(s) for s in range(self.slots)])

    def block(self, tokens, positions):
        w = tokens.shape[1]
        with self.lock:
            self.block_log.append((w, tuple(int(p) for p in positions)))
        time.sleep(self.step_sleep)
        return np.stack([np.tile(self._logits(s), (w, 1))
                         for s in range(self.slots)])


class FakeDraft:
    """Proposes what the fake flagship verifies: every proposal is
    accepted."""

    def __init__(self, fr):
        self.fr = fr
        self.slots = fr.slots
        self.max_seqlen = fr.max_seqlen
        self.prefills = 0
        self.steps = 0

    def prefill(self, slot, tokens):
        self.prefills += 1
        return self.fr._logits(slot)

    def step(self, tokens, positions):
        self.steps += 1
        return np.stack([self.fr._logits(s) for s in range(self.slots)])


def _spec_accounting(sched_cls):
    fr = FakeRunner(slots=2, step_sleep=0.0)
    fd = FakeDraft(fr)
    s = sched_cls(fr, max_new_tokens=9, eos=0, queue_depth=8, draft=fd,
                  spec_k=3)
    s.start()
    try:
        out = s.submit(np.asarray([1, 2, 3], np.int32), 9)
    finally:
        s.close()
    st = s.stats()
    return (out, fr.prefill_log[0][0], s.n_verify_calls, s.n_spec_proposed,
            s.n_spec_accepted, s.n_draft_steps, fd.steps, fd.prefills,
            st["acceptance_rate"], st["draft_steps"], st["verify_calls"])


def test_scheduler_spec_round_accounting_matches_jax():
    """An always-agreeing fake draft: 1 token at activation, then 2 full
    rounds of 4; draft catch-up only after a full accept (3 + 1 + 3
    draft steps); every counter equal to the JAX scheduler's."""
    got = _spec_accounting(TScheduler)
    assert got == _spec_accounting(JScheduler)
    out, slot, verify, proposed, accepted, dsteps, fsteps, fprefills, \
        rate, st_dsteps, st_verify = got
    assert out == [slot + 1] * 9
    assert (verify, proposed, accepted) == (2, 6, 6)
    assert dsteps == fsteps == st_dsteps == 7 and fprefills == 1
    assert rate == 1.0 and st_verify == 2


def _chunk_interleave(sched_cls):
    fr = FakeRunner(slots=2, step_sleep=0.004)
    s = sched_cls(fr, max_new_tokens=60, eos=0, queue_depth=8,
                  prefill_chunk=4)
    s.start()
    out = {}

    def submit(key, prompt, n):
        out[key] = s.submit(prompt, n)

    try:
        ta = threading.Thread(target=submit, daemon=True,
                              args=("a", np.arange(1, 4, dtype=np.int32),
                                    60))
        ta.start()
        t0 = time.perf_counter()
        while len(fr.step_actives) < 2:
            assert time.perf_counter() - t0 < 5.0
            time.sleep(0.002)
        steps_before = len(fr.step_actives)
        submit("b", np.arange(1, 11, dtype=np.int32), 2)
        a_alive = ta.is_alive()
        ta.join(10.0)
    finally:
        s.close()
    st = s.stats()
    return dict(a=len(out["a"]), b=len(out["b"]), a_alive=a_alive,
                blocks=[w for w, _ in fr.block_log],
                stepped_meanwhile=len(fr.step_actives) > steps_before + 1,
                chunks=st["prefill_chunks"], prefills=st["prefills"])


def test_scheduler_chunked_prefill_interleaves_like_jax():
    """A 10-token prompt joining a busy scheduler streams in 4 columns a
    tick between decode steps, while the in-flight request keeps
    decoding: ceil(3/4) + ceil(10/4) = 4 block ticks of width 4, as in
    the JAX scheduler."""
    got = _chunk_interleave(TScheduler)
    assert got == _chunk_interleave(JScheduler)
    assert got == dict(a=60, b=2, a_alive=True, blocks=[4] * 4,
                       stepped_meanwhile=True, chunks=4, prefills=2)


@pytest.mark.parametrize("where", ["draft", "chunk"])
def test_scheduler_failure_reaches_all_clients(where):
    """A draft step or a chunk tick that raises latches the scheduler:
    the active (or mid-chunk) request and every later one get the
    error, never a hang."""

    class DyingDraft(FakeDraft):
        def step(self, tokens, positions):
            raise RuntimeError("draft fell over")

    class DyingBlock(FakeRunner):
        def block(self, tokens, positions):
            raise RuntimeError("chunk fell over")

    if where == "draft":
        fr = FakeRunner(slots=2, step_sleep=0.0)
        s = TScheduler(fr, max_new_tokens=8, eos=0, queue_depth=8,
                       draft=DyingDraft(fr), spec_k=2)
    else:
        s = TScheduler(DyingBlock(slots=2, step_sleep=0.0),
                       max_new_tokens=8, eos=0, queue_depth=8,
                       prefill_chunk=4)
    s.start()
    try:
        for _ in range(2):
            with pytest.raises(RuntimeError, match="fell over"):
                s.submit(np.asarray([1, 2, 3, 4, 5], np.int32), 8)
    finally:
        s.close()
    assert not s._filling and not s._fill_order and not s._active


# --------------------------------------------------------- KV-cache dtype

def test_bf16_cache_under_f32_net(pair, engines):
    """Half the bytes; the prefill row bitwise the f32 cache's (prefill
    reads no cache); 8 step rows within SERVE_TOL of the f32 cache's; and
    within SERVE_TOL of the JAX package's bf16 cache."""
    jt, tt = pair
    _, te = engines
    t16 = TEngine(tt, slots=2, max_seqlen=32, kv_dtype="bf16")
    j16 = JEngine(jt, slots=2, max_seqlen=32, kv_dtype="bf16")
    j16.warmup()
    assert t16.kv_cache_bytes() * 2 == te.kv_cache_bytes()
    assert t16.stats()["kv_dtype"] == "bf16"
    assert t16.footprint()["kv_saved_bytes"] == t16.kv_cache_bytes()
    p = _prompt(9, seed=77)
    ref = te.prefill(0, p)
    assert np.array_equal(t16.prefill(0, p), ref)
    j16.prefill(0, p)
    seq = [int(np.argmax(ref))]
    worst = worst_jax = 0.0
    for i in range(8):
        args = (np.asarray([seq[-1], 0], np.int32),
                np.asarray([len(p) + i, 0], np.int32))
        r = te.step(*args)[0]
        g = t16.step(*args)[0]
        worst = max(worst, _rel(g, r))
        worst_jax = max(worst_jax, _rel(g, j16.step(*args)[0]))
        seq.append(int(np.argmax(r)))
    assert worst <= SERVE_TOL_BF16, worst
    assert worst_jax <= SERVE_TOL_BF16, worst_jax


def test_f32_cache_under_bf16_net(tmp_path):
    """A bf16 net (a JAX-written snapshot) with a float32 cache: twice
    the bytes of its own bf16 cache, and 8 greedy step rows within
    SERVE_TOL of the bf16 cache's and of the JAX package's f32 cache
    under the same net."""
    from __graft_entry__ import _make_trainer
    jt = _make_trainer(NET, 2, "cpu",
                       extra=JAX_EXTRA + [("dtype", "bfloat16")])
    model = str(tmp_path / "bf16.model")
    jt.save_model(model)
    tt = NetTrainer()
    for k, v in (("batch_size", "2"), ("dev", "cpu"), ("silent", "1"),
                 ("dtype", "bfloat16")):
        tt.set_param(k, v)
    tt.load_model(model)
    assert str(tt.net.dtype) == "torch.bfloat16"
    t32 = TEngine(tt, slots=2, max_seqlen=32, kv_dtype="f32")
    t16 = TEngine(tt, slots=2, max_seqlen=32)
    j32 = JEngine(jt, slots=2, max_seqlen=32, kv_dtype="f32")
    j32.warmup()
    assert t16.kv_dtype == "bf16" and t32.kv_dtype == "f32"
    assert t32.kv_cache_bytes() == 2 * t16.kv_cache_bytes()
    p = _prompt(9, seed=78)
    seq = [int(np.argmax(t32.prefill(0, p)))]
    t16.prefill(0, p)
    j32.prefill(0, p)
    worst = worst_jax = 0.0
    for i in range(8):
        args = (np.asarray([seq[-1], 0], np.int32),
                np.asarray([len(p) + i, 0], np.int32))
        g = t32.step(*args)[0]
        worst = max(worst, _rel(g, t16.step(*args)[0]))
        worst_jax = max(worst_jax, _rel(g, j32.step(*args)[0]))
        seq.append(int(np.argmax(g)))
    assert worst <= SERVE_TOL_BF16, worst
    assert worst_jax <= SERVE_TOL_BF16, worst_jax


# ------------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def lm_files(tmp_path_factory):
    """A JAX-written flagship snapshot of example/LM/serve_lm.conf's net,
    a smaller JAX-written draft of the same vocab and width, and a token
    shard of prompts."""
    from cxxnet_tpu.io.text import write_token_shard
    from cxxnet_tpu.nnet.trainer import NetTrainer as JNetTrainer
    from cxxnet_tpu.utils.config import parse_config_string as jparse
    from __graft_entry__ import _make_trainer
    tmp = tmp_path_factory.mktemp("spec_cli")
    text = open(os.path.join(REPO, "example/LM/serve_lm.conf")).read()
    jt = JNetTrainer()
    for k, v in jparse(text):
        if k != "metrics_sink":
            jt.set_param(k, v)
    jt.set_param("updater", "sgd")
    jt.init_model()
    jt.save_model(str(tmp / "lm.model"))
    draft = _make_trainer(transformer(vocab=512, seq=64, dim=16, nlayer=1,
                                      nhead=2), 4, "cpu",
                          extra=JAX_EXTRA + [("seed", "3")])
    draft.save_model(str(tmp / "lm_draft.model"))
    rng = np.random.RandomState(9)
    write_token_shard(str(tmp / "eval_0.tok"),
                      [rng.randint(0, 512, rng.randint(20, 90))
                       for _ in range(12)], itemsize=2)
    return tmp, text


def _lm_conf(tmp, text, name, kv_dtype):
    text = (text.replace("model_in = models/lm.model",
                         f"model_in = {tmp}/lm.model")
            .replace("path_tok = lm_data/eval_%d.tok",
                     f"path_tok = {tmp}/eval_%d.tok")
            .replace("metrics_sink = jsonl:serve_gen_metrics.jsonl",
                     f"metrics_sink = jsonl:{tmp}/{name}.jsonl")
            .replace("serve_draft_model = models/lm_draft.model",
                     f"serve_draft_model = {tmp}/lm_draft.model")
            .replace("decode_kv_dtype = bf16", f"decode_kv_dtype = {kv_dtype}")
            .replace("pred = gen_out.txt", f"pred = {tmp}/{name}_out.txt"))
    assert "spec_k = 3" in text and "decode_prefill_chunk = 16" in text
    conf = tmp / f"{name}.conf"
    conf.write_text(text)
    return str(conf)


def test_cli_speculative_serve_matches_jax_cli(lm_files):
    """example/LM/serve_lm.conf with its draft snapshot, spec_k = 3 and
    decode_prefill_chunk = 16, at an f32 cache, through both CLIs: the
    port's gen_out equals the JAX package's, line for line."""
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu_torch.main import LearnTask as TTask
    tmp, text = lm_files
    outs = {}
    for name, task in (("jax", JTask), ("port", TTask)):
        assert task().run([_lm_conf(tmp, text, name, "f32")]) == 0
        outs[name] = open(tmp / f"{name}_out.txt").read()
    assert outs["port"] == outs["jax"]
    rows = outs["port"].splitlines()
    assert len(rows) >= 4 and all(len(r.split()) == 16 for r in rows)


def test_cli_serve_gen_record_carries_spec_counters(lm_files):
    """The shipped conf as it is (bf16 KV cache) runs to the end in the
    port, and its serve_gen record carries retraces, block_calls and the
    scheduler's speculative and chunk counters under the JAX record's
    names; LearnTask.last_serve carries the same."""
    from cxxnet_tpu_torch.main import LearnTask
    tmp, text = lm_files
    task = LearnTask()
    assert task.run([_lm_conf(tmp, text, "bf16kv", "bf16")]) == 0
    recs = [json.loads(ln) for ln in open(tmp / "bf16kv.jsonl")]
    [gen] = [r for r in recs if r["kind"] == "serve_gen"]
    assert gen["retraces"] == 0 and gen["kv_dtype"] == "bf16"
    assert gen["spec_k"] == 3 and gen["verify_calls"] > 0
    assert gen["draft_steps"] > 0 and 0.0 <= gen["acceptance_rate"] <= 1.0
    assert gen["draft_ms"] >= 0.0 and gen["verify_ms"] >= 0.0
    assert gen["prefill_chunk"] == 16 and gen["prefill_chunks"] > 0
    assert gen["block_calls"] == gen["verify_calls"] + gen["prefill_chunks"]
    assert gen["prefill_calls"] == 0 and gen["step_calls"] == 0
    assert gen["draft_prefill_calls"] == gen["prefills"] == gen["requests"]
    assert gen["footprint"]["draft_bytes"] > 0
    for key in ("retraces", "block_calls", "verify_calls", "draft_steps",
                "prefill_chunks", "acceptance_rate"):
        assert task.last_serve[key] == gen[key], key
    rows = open(tmp / "bf16kv_out.txt").read().splitlines()
    assert len(rows) == gen["requests"] and all(len(r.split()) == 16
                                                for r in rows)
    assert not [t for t in threading.enumerate()
                if t.name.startswith(("cxxnet-decode", "cxxnet-serve"))]


def test_cli_spec_without_draft_raises_and_draft_without_spec_warns(
        lm_files):
    from cxxnet_tpu_torch.main import LearnTask
    tmp, text = lm_files
    conf = _lm_conf(tmp, text, "nodraft", "f32")
    with pytest.raises(ValueError, match="without serve_draft_model"):
        LearnTask().run([conf, "serve_draft_model="])
    task = LearnTask()
    assert task.run([conf, "spec_k=0", "decode_prefill_chunk=0"]) == 0
    assert "verify_calls" not in task.last_serve
    with pytest.raises(FileNotFoundError):
        LearnTask().run([conf, f"serve_draft_model={tmp}/missing.model"])
