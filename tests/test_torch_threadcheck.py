"""The port's lock witness and interleaving harness
(cxxnet_tpu_torch/monitor/threadcheck.py) over the port's own classes,
its racelint as a tier-1 gate, and the racelint copy held to the JAX
package's.

* witness units, as tests/test_threadcheck.py runs them: ``checked()``
  subclasses of the port's Histogram, sentinel bank, FlightCapture,
  metrics sink and MicroBatcher raise :class:`LockWitnessError` on an
  unlocked touch of a guarded-by attribute and stay silent on the
  disciplined paths; the StepScheduler's guarded counters parse;
* the negative fixture (a pre-fix unlocked read-modify-write driven to
  the schedule that loses an update) and the post-fix stress of the
  shipped classes;
* the gate: ``python -m cxxnet_tpu_torch.analysis.racelint
  cxxnet_tpu_torch/`` and ``tools/disclint.py cxxnet_tpu_torch/`` both
  report 0 findings;
* parity: the port's racelint and the JAX package's give the same
  findings, record for record, on both packages' trees, the tools and a
  fixture source that trips every rule.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import torch_threads  # noqa: E402,F401 — torch threads under xdist

from cxxnet_tpu_torch.analysis import racelint  # noqa: E402
from cxxnet_tpu_torch.monitor import threadcheck  # noqa: E402
from cxxnet_tpu_torch.monitor.metrics import Histogram, Metrics  # noqa: E402
from cxxnet_tpu_torch.monitor.sentinel import SentinelBank  # noqa: E402
from cxxnet_tpu_torch.serve.admin import FlightCapture, copy_racy  # noqa: E402
from cxxnet_tpu_torch.serve.batcher import (MicroBatcher,  # noqa: E402
                                            StepScheduler)


# ------------------------------------------------------------ lock witness

def test_witness_lock_ownership():
    lk = threadcheck.WitnessLock()
    assert not lk.held_by_me() and not lk.locked()
    with lk:
        assert lk.held_by_me() and lk.locked()
        seen = []
        t = threading.Thread(target=lambda: seen.append(lk.held_by_me()),
                             name="cxxnet-test-owner")
        t.start()
        t.join()
        assert seen == [False]
    assert not lk.held_by_me()
    assert lk.acquisitions == 1


def test_held_understands_rlock_and_condition():
    rl = threading.RLock()
    assert not threadcheck._held(rl)
    with rl:
        assert threadcheck._held(rl)
    cv = threading.Condition()
    with cv:
        assert threadcheck._held(cv)


class ToyBox:
    """Witness fixture: one guarded attribute, annotated as production
    code is, so collect_policies() reads the map from this file."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items = []  # racelint: guarded-by(self._lock)

    def put(self, x):
        with self._lock:
            self.items.append(x)


def test_checked_toy_class():
    Checked = threadcheck.checked(ToyBox)
    assert Checked._threadcheck_guarded == {"items": ("_lock",)}
    box = Checked()
    threadcheck.arm(box)
    box.put(1)
    with box._lock:
        assert box.items == [1]
    with pytest.raises(threadcheck.LockWitnessError):
        box.items
    threadcheck.disarm(box)
    assert box.items == [1]
    with pytest.raises(TypeError):
        threadcheck.arm(ToyBox())


def test_checked_histogram_slots_class():
    """The port's Histogram (``__slots__``): observe and summary are
    locked; a bare read of a guarded slot fails armed."""
    h = threadcheck.checked(Histogram)()
    threadcheck.arm(h)
    for v in (1.0, 2.0, 3.0):
        h.observe(v)
    assert h.summary()["count"] == 3 and h.summary()["p50"] == 2.0
    with pytest.raises(threadcheck.LockWitnessError):
        h.count
    with h._lock:
        assert h.count == 3


def test_checked_sentinel_bank_ring():
    bank = threadcheck.checked(SentinelBank)(Metrics())
    threadcheck.arm(bank)
    bank.observe_step({"examples_per_sec": 10.0})
    assert bank.state()["ring"]
    with pytest.raises(threadcheck.LockWitnessError):
        list(bank.ring)


def test_checked_flight_capture():
    fc = threadcheck.checked(FlightCapture)(Metrics(), lambda: 0)
    threadcheck.arm(fc)
    assert fc.trigger("test-anomaly") is True
    assert fc.trigger("second") is False
    assert fc.tick() is None
    with pytest.raises(threadcheck.LockWitnessError):
        fc.armed


def test_checked_metrics_sink(tmp_path):
    """The port's JSONL sink lives in Metrics: its file object is
    guarded, and ``configure_sink`` / ``active`` / ``emit`` /
    ``close`` take the lock."""
    m = threadcheck.checked(Metrics)()
    threadcheck.arm(m)
    m.configure_sink(f"jsonl:{tmp_path / 'm.jsonl'}")
    assert m.active
    m.emit("step", n=1)
    with pytest.raises(threadcheck.LockWitnessError):
        m._fo
    m.close()
    assert not m.active
    assert json.loads(open(tmp_path / "m.jsonl").read())["n"] == 1


def _doubler(x):
    return x * 2.0


def test_checked_micro_batcher_counters():
    """The queue-depth samples are guarded by ``_stats_lock`` on both
    ends (submit and the dispatcher); served rows equal the requests."""
    b = threadcheck.checked(MicroBatcher)(_doubler, max_batch=8,
                                          max_wait_ms=1.0)
    assert set(b._threadcheck_guarded) == {"depth_sum", "depth_samples",
                                           "depth_max"}
    threadcheck.arm(b)
    b.start()
    try:
        threadcheck.stress(lambda i: np.testing.assert_array_equal(
            b.submit(np.full((1, 3), float(i), np.float32)),
            np.full((1, 3), 2.0 * i)), threads=4, iters=25)
    finally:
        b.close()
    st = b.stats()
    assert st["requests"] == 100 and b.rows_served == 100
    with pytest.raises(threadcheck.LockWitnessError):
        b.depth_max


def test_step_scheduler_guarded_counters():
    assert threadcheck.guarded_attrs(StepScheduler) == {
        "_req_seq": ("_stats_lock",), "_tok_lats": ("_stats_lock",)}
    pol = racelint.collect_policies(
        sys.modules[StepScheduler.__module__].__file__)["StepScheduler"]
    assert {a for a, p in pol.items() if p.kind == "atomic"} >= {
        "n_requests", "n_tokens", "n_steps", "occ_hist", "_draft_wall"}
    assert pol["_failed"].kind == "latch"


# ------------------------------------------------------------ interleaving

class RacyCounter:
    """Negative fixture: an unlocked read-modify-write with the harness
    hook between the read and the write."""

    def __init__(self):
        self.count = 0

    def observe(self):
        c = self.count
        threadcheck.hook("racy-counter-mid")
        self.count = c + 1


def test_interleaving_reproduces_the_prefix_lost_update():
    r = RacyCounter()
    threadcheck.run_interleaved(r.observe, r.observe, "racy-counter-mid")
    assert r.count == 1


def test_stress_histogram_keeps_exact_count():
    h = Histogram()
    threadcheck.stress(lambda i: h.observe(float(i)), threads=4, iters=250)
    s = h.summary()
    assert s["count"] == 1000
    assert s["sum"] == 250 * (0.0 + 1.0 + 2.0 + 3.0)


def test_stress_metrics_counters_and_series():
    """counter_inc is one locked bump; first observers of one series
    converge on one Histogram."""
    m = Metrics()
    threadcheck.stress(lambda i: (m.counter_inc("c"), m.observe("lat", 1.0)),
                       threads=4, iters=100)
    assert m.counters["c"] == 400
    assert len(m.histograms) == 1
    assert m.histograms["lat"].summary()["count"] == 400


def test_copy_racy_under_live_writer():
    d = {}
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            d[f"k{i}"] = i
            i += 1

    t = threading.Thread(target=writer, name="cxxnet-test-writer",
                         daemon=True)
    t.start()
    try:
        for _ in range(200):
            snap = copy_racy(d)
            assert isinstance(snap, dict)
    finally:
        stop.set()
        t.join(timeout=10)
    assert all(snap[k] == int(k[1:]) for k in snap)


def test_jsonl_sink_concurrent_writers_no_torn_lines(tmp_path):
    path = str(tmp_path / "m.jsonl")
    m = Metrics()
    m.configure_sink(f"jsonl:{path}")
    threadcheck.stress(
        lambda i: m.emit("ckpt" if i % 2 else "step", worker=i,
                         payload="x" * 256), threads=4, iters=100)
    m.close()
    lines = open(path).read().splitlines()
    assert len(lines) == 400
    assert {json.loads(ln)["kind"] for ln in lines} == {"ckpt", "step"}


def test_emit_concurrent_with_sink_swap(tmp_path):
    path = str(tmp_path / "m.jsonl")
    m = Metrics()
    stop = threading.Event()
    errors = []

    def emitter():
        try:
            while not stop.is_set():
                m.emit("step", n=1)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t = threading.Thread(target=emitter, name="cxxnet-test-emitter",
                         daemon=True)
    t.start()
    try:
        for _ in range(50):
            m.configure_sink(f"jsonl:{path}")
            m.configure_sink("none")
    finally:
        stop.set()
        t.join(timeout=10)
    assert not errors
    for line in open(path).read().splitlines():
        json.loads(line)


def test_tracer_sampling_survives_a_concurrent_disarm():
    """The flight capture's reporter thread restores ``trace_sample`` to
    0 while clients ask the tracer for trace ids; a sampling decision
    must read the rate once (reading it twice divided by 0 mid-serve on
    the card).  The disarm is forced between the tracer's check and its
    modulo: the ``active`` read that sits between them flips it."""
    from cxxnet_tpu_torch.monitor.spans import SpanTracer

    class Flipping:
        def __init__(self):
            self.tracer = None

        @property
        def active(self):
            self.tracer.configure(0)
            return True

    m = Flipping()
    m.tracer = SpanTracer(m, sample=1)
    assert m.tracer.new_trace() == 1
    m.tracer.configure(2)
    assert [m.tracer.sampled(n) for n in (0, 1, 2)] == [True, False, True]


def test_sentinel_ring_append_during_flight_dump():
    bank = SentinelBank(Metrics())
    stop = threading.Event()
    errors = []

    def reporter():
        try:
            while not stop.is_set():
                bank.observe_serve({"serve_p99_ms": 5.0, "qps": 100.0})
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t = threading.Thread(target=reporter, name="cxxnet-test-reporter",
                         daemon=True)
    t.start()
    try:
        for _ in range(100):
            bank.flight_dump("test")
    finally:
        stop.set()
        t.join(timeout=10)
    assert not errors


# -------------------------------------------------------------- the gate

def test_threadcheck_is_test_only():
    """Nothing in serving, checkpoints or I/O imports the witness."""
    pkg = os.path.join(REPO, "cxxnet_tpu_torch")
    users = []
    for root, _, files in os.walk(pkg):
        for fn in files:
            path = os.path.join(root, fn)
            if fn.endswith(".py") and not path.endswith("threadcheck.py"):
                if "threadcheck" in open(path, encoding="utf-8").read():
                    users.append(os.path.relpath(path, REPO))
    assert users == ["cxxnet_tpu_torch/analysis/racelint.py"]


@pytest.mark.parametrize("cmd", [
    [sys.executable, "-m", "cxxnet_tpu_torch.analysis.racelint",
     "cxxnet_tpu_torch/"],
    [sys.executable, "tools/disclint.py", "cxxnet_tpu_torch/"],
], ids=["racelint", "disclint"])
def test_port_lints_are_clean(cmd):
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert r.stdout.rstrip().endswith("0 finding(s)")


FIXTURE = '''
import threading


class Leaky:
    def __init__(self):
        self._lock = threading.Lock()
        self.hits = 0            # racelint: guarded-by(self._lock)
        self.seen = 0            # racelint: atomic(single writer)
        self.raw = 0
        self.bad = 0             # racelint: guarded-by(self._nolock)
        self._t = threading.Thread(target=self._run)

    def _run(self):
        self.hits += 1
        self.seen += 1
        self.raw += 1
        with self._lock:
            ok = self.hits > 3
        if ok:
            with self._lock:
                self.hits = 0

    def poke(self):
        self.seen += 1
        self.raw = 5
        x = 1  # racelint: ok(race_unguarded)
        return x
'''


def _findings(mod, path, src=None):
    return [dataclasses.asdict(f) for f in mod.lint_file(path, src)]


def test_racelint_copy_matches_jax_on_both_trees(tmp_path):
    """Every file of both packages, the tools and chip_smoke.py, and a
    fixture that trips the rules: the same findings from both copies."""
    from cxxnet_tpu.analysis import racelint as jracelint
    paths = list(racelint.iter_py_files(
        [os.path.join(REPO, p) for p in ("cxxnet_tpu", "cxxnet_tpu_torch",
                                         "tools", "chip_smoke.py")]))
    assert paths == list(jracelint.iter_py_files(
        [os.path.join(REPO, p) for p in ("cxxnet_tpu", "cxxnet_tpu_torch",
                                         "tools", "chip_smoke.py")]))
    for path in paths:
        assert _findings(racelint, path) == _findings(jracelint, path), path
    fixture = str(tmp_path / "fixture.py")
    got = _findings(racelint, fixture, FIXTURE)
    assert got == _findings(jracelint, fixture, FIXTURE)
    assert {f["rule"] for f in got} >= {
        "race_undeclared", "race_unguarded", "race_thread_name",
        "race_bad_decl", "race_pragma_reason"}
    assert racelint.RULES == jracelint.RULES

    def policies(mod, path):
        return {c: {a: dataclasses.asdict(p) for a, p in pol.items()}
                for c, pol in mod.collect_policies(path).items()}

    for path in paths:
        assert policies(racelint, path) == policies(jracelint, path), path
