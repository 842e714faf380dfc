"""The port's serving observability plane against the JAX package, on the
CPU (doc/serve.md "Operating a serve host").  Every comparison is exact:
both packages run the same host arithmetic on the same inputs.

* ``Histogram``: the bounded reservoir summarises a seeded 10,000-value
  stream exactly as the JAX package's does (same fixed-seed replacement).
* ``monitor/promtext.py``: ``render`` byte for byte the JAX package's on
  tests/test_admin.py's golden snapshot and on a seeded one; each
  package's ``parse`` reads the other's text into equal families;
  ``counter_values`` / ``live_tables`` equal; the same refusals.
* ``monitor/slo.py``: a seeded ``serve_window`` sequence gives the same
  ``slo`` records (``ts`` left out) and verdicts, fast before slow; an
  SLO without a target stays inactive.
* ``serve/admin.py``: ``FlightCapture`` on dead air and behind a
  sentinel anomaly, record for record the JAX package's; the
  ``AdminServer`` lifecycle on an ephemeral port, its ``/metrics`` byte
  for byte and its ``/statusz`` (uptime aside) the JAX server's over the
  same host; ``copy_racy`` under concurrent growth; ``tools/obsv.py
  --live`` reading the port's endpoint as it reads the JAX one.
* ``ServeConfig``: the eleven keys parsed and refused as the JAX package
  parses and refuses them.
* ``MicroBatcher.window_stats`` and the CLI: ``example/MNIST/serve.conf``
  with the admin endpoint, the sentinels and an SLO on, through both
  CLIs: the same predictions and ``serve`` record, ``serve_window``
  records totalling the served rows, ``/readyz`` 503 -> 200 -> closed;
  and the generation path's ``/statusz`` and occupancy histogram.
"""

import dataclasses
import json
import os
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_threads  # noqa: E402,F401 — torch threads under xdist

from cxxnet_tpu.monitor import promtext as jprom  # noqa: E402
from cxxnet_tpu.monitor.metrics import Histogram as JHistogram  # noqa: E402
from cxxnet_tpu.monitor.metrics import MetricsRegistry  # noqa: E402
from cxxnet_tpu.monitor.sentinel import SentinelBank as JBank  # noqa: E402
from cxxnet_tpu.monitor.slo import SloSpec as JSpec  # noqa: E402
from cxxnet_tpu.monitor.slo import SloTracker as JTracker  # noqa: E402
from cxxnet_tpu.serve import ServeConfig as JConfig  # noqa: E402
from cxxnet_tpu.serve.admin import AdminServer as JAdmin  # noqa: E402
from cxxnet_tpu.serve.admin import FlightCapture as JFlight  # noqa: E402
from cxxnet_tpu_torch.monitor import promtext as tprom  # noqa: E402
from cxxnet_tpu_torch.monitor.metrics import Histogram, Metrics  # noqa: E402
from cxxnet_tpu_torch.monitor.sentinel import SentinelBank  # noqa: E402
from cxxnet_tpu_torch.monitor.slo import SloSpec, SloTracker  # noqa: E402
from cxxnet_tpu_torch.serve import ServeConfig  # noqa: E402
from cxxnet_tpu_torch.serve.admin import (AdminServer,  # noqa: E402
                                          FlightCapture, copy_racy)
from cxxnet_tpu_torch.serve.batcher import MicroBatcher  # noqa: E402
from test_admin import (_FakeBatcherStats, _FakeHost,  # noqa: E402
                        _FakeModel)
from test_torch_serve_batch import _mnist_conf, _records  # noqa: E402
from test_torch_serve_batch import mnist  # noqa: E402,F401 — fixture

def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode("utf-8")


def _admin_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("cxxnet-serve-admin")]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sink_records(path):
    """The records of a sink, ``ts`` left out."""
    return [{k: v for k, v in json.loads(line).items() if k != "ts"}
            for line in open(path) if line.strip()]


# ------------------------------------------------------------- Histogram

@pytest.mark.parametrize("n", [100, 10_000])
def test_histogram_reservoir_matches_jax(n):
    """Below the 2048-value reservoir every value is kept; past it both
    packages replace from Random(0x5EED): equal summaries (exact)."""
    vals = np.random.RandomState(7).lognormal(-5.0, 1.0, n)
    t, j = Histogram(), JHistogram()
    for v in vals:
        t.observe(v)
        j.observe(v)
    assert t.summary() == j.summary()
    assert t.count == n and len(t._samples) == min(n, Histogram._RESERVOIR)
    assert t.summary()["last"] == float(vals[-1])


def test_histogram_empty_and_concurrent():
    assert Histogram().summary() == JHistogram().summary() == {
        "count": 0, "sum": 0.0}
    h = Histogram()

    def obs(i):
        for k in range(500):
            h.observe(i * 1000 + k)

    ths = [threading.Thread(target=obs, args=(i,)) for i in range(4)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    s = h.summary()
    assert s["count"] == 2000 and s["min"] == 0 and s["max"] == 3499


# -------------------------------------------------------------- promtext

def _golden_snapshot():
    """tests/test_admin.py's golden snapshot."""
    snap = {
        "counters": {"serve_flights": 2, "odd name/x": 1},
        "gauges": {"serve_queue_depth": 3.0},
        "histograms": {"serve_latency_sec": {
            "count": 4, "sum": 0.01, "min": 0.001, "max": 0.004,
            "mean": 0.0025, "last": 0.004,
            "p50": 0.002, "p95": 0.004, "p99": 0.004}},
    }
    return snap, {"labels": {"model": 'a\\b"c\nd'},
                  "hists": {"serve_batch_hist": {1: 2, 8: 3}}}


def _seeded_snapshot():
    """A port Metrics fed a seeded stream: odd names, a leading digit,
    infinities, big and tiny values, summaries and exact histograms."""
    rng = np.random.RandomState(3)
    m = Metrics()
    names = ["serve_requests", "slo_burns", "9lives", "a.b-c d", "x:y"]
    for name in names:
        m.counter_inc(name, int(rng.randint(0, 10**6)))
    for name, v in zip(names, [float(rng.randn()) * 1e9, 1e-12, np.inf,
                               -np.inf, 0.5]):
        m.set_gauge("g_" + name, v)
    for name in ("serve_latency_sec", "decode/step"):
        for v in rng.exponential(0.01, 300):
            m.observe(name, v)
    hists = {"serve_batch_hist": {int(k): int(c) for k, c in zip(
        rng.choice(64, 6, replace=False) + 1, rng.randint(1, 100, 6))},
        "decode_occupancy_hist": {4: 17, 1: 3}}
    return m.snapshot(), {"labels": {"host": "h\\1", "zone": 'q"\n'},
                          "hists": hists}


@pytest.mark.parametrize("which", ["golden", "seeded"])
def test_promtext_render_and_parse_match_jax(which):
    """Byte-equal text (exact), and each package's parse reads the
    other's text into equal families."""
    snap, kw = _golden_snapshot() if which == "golden" \
        else _seeded_snapshot()
    text = tprom.render(snap, **kw)
    assert text == jprom.render(snap, **kw)
    assert tprom.render(snap) == jprom.render(snap)
    assert tprom.render(snap, prefix="svc", **kw) \
        == jprom.render(snap, prefix="svc", **kw)
    fams = tprom.parse(text)
    assert fams == jprom.parse(text)
    assert tprom.counter_values(fams) == jprom.counter_values(fams)
    assert tprom.live_tables(fams) == jprom.live_tables(fams)
    if which == "golden":
        name, labels, v = fams["cxxnet_serve_flights_total"]["samples"][0]
        assert labels["model"] == 'a\\b"c\nd' and v == 2
        assert fams["cxxnet_serve_batch_hist"]["type"] == "histogram"
    for name in ("a.b-c d", "9lives", "", "ok_name:1"):
        assert tprom.mangle(name) == jprom.mangle(name)
        assert tprom.escape_label(name + '\\"\n') \
            == jprom.escape_label(name + '\\"\n')


@pytest.mark.parametrize("bad", [
    "# TYPE cxxnet_x enum\ncxxnet_x 1\n",
    "# TYPE cxxnet_x counter\ncxxnet_x one\n",
    "# TYPE cxxnet_x counter\ncxxnet_x_total -1\n",
    "cxxnet_x{a=1} 2\n",
    "1bad 3\n"])
def test_promtext_parse_refuses_as_jax(bad):
    with pytest.raises(ValueError) as te:
        tprom.parse(bad)
    with pytest.raises(ValueError) as je:
        jprom.parse(bad)
    assert str(te.value) == str(je.value)


def test_promtext_counters_monotone_across_scrapes():
    m = Metrics()
    m.counter_inc("slo_burns", 3)
    v1 = tprom.counter_values(tprom.parse(tprom.render(m.snapshot())))
    m.counter_inc("slo_burns", 2)
    v2 = tprom.counter_values(tprom.parse(tprom.render(m.snapshot())))
    assert all(v2[k] >= v for k, v in v1.items())
    assert v2["cxxnet_slo_burns_total"] == 5


# ------------------------------------------------------------------- SLO

def _windows(seed, n=60):
    """A seeded serve_window sequence: a quiet stretch, an acute spike,
    a simmer, and a recovery."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        req = int(rng.randint(50, 150))
        rate = 0.0 if i < 15 else 0.3 if i < 18 else 0.02 if i < 45 else 0.0
        out.append({"requests": req, "viol": int(rng.binomial(req, rate))})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_tracker_matches_jax(seed, tmp_path):
    """Equal ``slo`` records (``ts`` out) and verdicts after every window
    (exact); the fast tier fires before the slow one."""
    spec = dict(p99_ms=10.0, avail=0.99, fast_sec=2.0, slow_sec=10.0,
                fast_burn=5.0, slow_burn=1.5)
    tm, jm = Metrics(), MetricsRegistry()
    tm.configure_sink(f"jsonl:{tmp_path}/t.jsonl")
    jm.configure_sink(f"jsonl:{tmp_path}/j.jsonl")
    burns = {"t": [], "j": []}
    trk = SloTracker(SloSpec(**spec), 1.0, metrics=tm, model="m",
                     on_burn=burns["t"].append)
    jrk = JTracker(JSpec(**spec), 1.0, metrics=jm, model="m",
                   on_burn=burns["j"].append)
    for w in _windows(seed):
        assert trk.observe(w) == jrk.observe(w)
        assert trk.verdict == jrk.verdict
    tm.close()
    jm.close()
    recs = _sink_records(f"{tmp_path}/t.jsonl")
    assert recs == _sink_records(f"{tmp_path}/j.jsonl")
    assert burns["t"] == burns["j"]
    tiers = [r["tier"] for r in recs]
    assert tiers and tiers[0] == "fast" and "slow" in tiers
    assert tm.counters["slo_burns"] == jm.counters["slo_burns"] == len(recs)


def test_slo_inactive_without_target_and_refusals():
    trk = SloTracker(SloSpec(p99_ms=0.0), window_sec=1.0)
    assert trk.observe({"requests": 100, "viol": 100}) is None
    assert trk.verdict == JTracker(JSpec(p99_ms=0.0), 1.0).verdict
    assert trk.verdict["active"] is False
    for kw in ({"p99_ms": 5.0, "avail": 1.0}, {"fast_sec": 0.0},
               {"slow_sec": -1.0}):
        with pytest.raises(ValueError) as te:
            SloSpec(**kw)
        with pytest.raises(ValueError) as je:
            JSpec(**kw)
        assert str(te.value) == str(je.value)


# -------------------------------------------------------- flight capture

def test_flight_capture_completes_on_dead_air(tmp_path):
    """No traffic after the trigger: the record lands after max_ticks
    windows with nothing boosted, the JAX package's record (exact)."""
    recs = {}
    for tag, metrics, cls in (("t", Metrics(), FlightCapture),
                              ("j", MetricsRegistry(), JFlight)):
        metrics.configure_sink(f"jsonl:{tmp_path}/{tag}.jsonl")
        flight = cls(metrics, lambda: 0, requests=8, max_ticks=3)
        assert flight.trigger("slo: fast burn")
        assert not flight.trigger("again")
        got = [flight.tick() for _ in range(4)]
        assert got[:2] == [None, None] and got[3] is None
        assert got[2]["requests_boosted"] == 0
        assert got[2]["trace_first"] == got[2]["trace_last"] == 0
        assert metrics.tracer.sample == 0
        metrics.close()
        recs[tag] = _sink_records(f"{tmp_path}/{tag}.jsonl")
    assert recs["t"] == recs["j"]
    assert [r["kind"] for r in recs["t"]] == ["serve_flight"]


def test_sentinel_anomaly_triggers_one_flight(tmp_path):
    """tests/test_admin.py's scenario in both packages: a p99 spike fires
    an anomaly, the hook arms the capture, trace_sample is boosted for 4
    requests, and one serve_flight record lands with the window ring and
    the boosted trace-id range; the record streams are equal (exact)."""
    streams = {}
    for tag, metrics, flight_cls, bank_cls in (
            ("t", Metrics(), FlightCapture, SentinelBank),
            ("j", MetricsRegistry(), JFlight, JBank)):
        sink = tmp_path / f"{tag}.jsonl"
        metrics.configure_sink(f"jsonl:{sink}")
        served = [0]
        flight = flight_cls(metrics, lambda: served[0], model="m", boost=1,
                            requests=4, ring=4,
                            stats_fn=lambda: {"depth_max": 1})
        bank = bank_cls(metrics, rel=0.2, warmup=3, ring=8,
                        on_anomaly=lambda hit: flight.trigger(
                            f"anomaly: {hit['metric']} {hit['direction']}"))
        base = {"model": "m", "qps": 100.0, "queue_depth": 0,
                "requests": 50}
        for i in range(5):
            rec = dict(base, window=i + 1, p99_ms=5.0)
            flight.note_window(rec)
            bank.observe_serve(rec)
            assert flight.tick() is None
        spike = dict(base, window=6, p99_ms=50.0)
        flight.note_window(spike)
        bank.observe_serve(spike)
        assert flight.armed and not flight.trigger("second")
        for _ in range(4):
            served[0] += 1
            metrics.tracer.new_trace()
        rec = flight.tick()
        assert rec["requests_boosted"] == 4 and rec["n_windows"] == 4
        assert (rec["trace_first"], rec["trace_last"]) == (1, 4)
        assert metrics.tracer.sample == 0 and metrics.tracer.watermark == 4
        metrics.close()
        streams[tag] = _sink_records(sink)
    assert streams["t"] == streams["j"]
    kinds = [r["kind"] for r in streams["t"]]
    assert kinds.count("serve_flight") == 1
    assert kinds.index("flight") < kinds.index("serve_flight")


# ----------------------------------------------------------------- admin

def _twin_metrics():
    """A port Metrics and a JAX registry holding the same instruments."""
    t, j = Metrics(), MetricsRegistry()
    for m in (t, j):
        m.counter_inc("serve_flights")
        m.counter_inc("slo_burns", 2)
        m.set_gauge("serve_queue_depth", 1.0)
        for v in (0.001, 0.002, 0.004):
            m.observe("serve_latency_sec", v)
    return t, j


def test_admin_endpoints_lifecycle_and_jax_parity():
    """/healthz live from bind; /readyz 503 -> 200; /statusz the JAX
    server's over the same host (uptime aside); /metrics byte for byte
    the JAX server's; 404; the acceptor joined and the port closed."""
    tm, jm = _twin_metrics()
    host = _FakeHost(_FakeModel(_FakeBatcherStats()))
    cfg = {"serve_shapes": "1,8"}
    adm = AdminServer(host, tm, port=0, config=cfg)
    jadm = JAdmin(host, jm, port=0, config=cfg)
    try:
        port = adm.start()
        jport = jadm.start()
        base, jbase = f"http://127.0.0.1:{port}", f"http://127.0.0.1:{jport}"
        assert _get(base + "/healthz") == (200, "ok\n")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base + "/readyz")
        assert ei.value.code == 503
        host.ready = True
        for a in (adm, jadm):
            a.note_ready()
            a.note_window("m", {"qps": 50.0, "p99_ms": 3.0,
                                "requests": 25, "queue_depth": 1})
        assert _get(base + "/readyz") == (200, "ready\n")
        st = json.loads(_get(base + "/statusz")[1])
        jst = json.loads(_get(jbase + "/statusz")[1])
        assert st.pop("uptime_sec") >= 0 and jst.pop("uptime_sec") >= 0
        assert st == jst
        m = st["models"]["m"]
        assert m["kind"] == "predict" and m["requests"] == 12
        assert m["last_window"]["p99_ms"] == 3.0
        assert m["footprint"]["total_bytes"] == 4096
        assert st["flights"] == 1
        text = _get(base + "/metrics")[1]
        assert text == _get(jbase + "/metrics")[1]
        fams = tprom.parse(text)
        assert fams["cxxnet_serve_batch_hist"]["type"] == "histogram"
        assert "cxxnet_serve_latency_sec" in fams
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base + "/nope")
        assert ei.value.code == 404
    finally:
        adm.close()
        jadm.close()
    adm.close()  # idempotent
    time.sleep(0.1)
    assert not _admin_threads()
    with pytest.raises(OSError):
        _get(f"http://127.0.0.1:{port}/healthz", timeout=0.5)


def test_copy_racy_survives_concurrent_growth():
    d = {i: i for i in range(64)}
    stop = threading.Event()

    def grow():
        i = 64
        while not stop.is_set():
            d[i] = i
            d.pop(i - 64, None)
            i += 1

    t = threading.Thread(target=grow, daemon=True)
    t.start()
    try:
        for _ in range(200):
            assert isinstance(copy_racy(d), dict)
    finally:
        stop.set()
        t.join()


def test_obsv_live_reads_the_port_endpoint():
    """tools/obsv.py --live, unedited, maps one scrape of the port's
    endpoint into the report it builds from the JAX endpoint."""
    import obsv
    tm, jm = _twin_metrics()
    host = _FakeHost(_FakeModel(_FakeBatcherStats()))
    host.ready = True
    reps = {}
    for tag, cls, m in (("t", AdminServer, tm), ("j", JAdmin, jm)):
        adm = cls(host, m, port=0)
        try:
            adm.start()
            adm.note_ready()
            adm.note_window("m", {"qps": 80.0, "p99_ms": 4.0,
                                  "requests": 40, "queue_depth": 1})
            reps[tag] = obsv.live_report(f"127.0.0.1:{adm.port}")
        finally:
            adm.close()
    rep = reps["t"]
    assert rep["live"]["url"].startswith("http://127.0.0.1:")
    assert reps["t"] == dict(reps["j"], live=dict(
        reps["j"]["live"], url=rep["live"]["url"],
        uptime_sec=rep["live"]["uptime_sec"]))
    assert rep["live"]["ready"] is True and rep["live"]["flights"] == 1
    assert rep["serving"][0]["requests"] == 12
    assert rep["serve_windows"]["p99_ms_max"] == 4.0
    assert rep["latency"][0]["p99"] == pytest.approx(4.0)
    text = obsv.render(rep)
    assert "live:" in text and "serving: 1 run(s)" in text


def test_model_host_owns_the_admin():
    """start_admin once; mark_ready caches footprints; close flips ready
    before the drain and joins the endpoint last."""
    from cxxnet_tpu_torch.serve.host import ModelHost

    class _Model:
        name = "m"
        warmed = True
        retraces = 0
        cfg = ServeConfig()
        engine = None
        closed_ready = None

        def footprint(self):
            return {"total_bytes": 8}

        def warmup(self):
            pass

        def close(self):
            _Model.closed_ready = host.ready

    host = ModelHost()
    host.attach(_Model())
    adm = host.start_admin(Metrics(), port=0)
    with pytest.raises(RuntimeError, match="already started"):
        host.start_admin(Metrics(), port=0)
    port = adm.port
    assert host.mark_ready() and adm._footprints == {
        "m": {"total_bytes": 8}}
    assert _get(f"http://127.0.0.1:{port}/readyz")[0] == 200
    host.close()
    assert _Model.closed_ready is False and host.admin is None
    assert not _admin_threads()
    with pytest.raises(OSError):
        _get(f"http://127.0.0.1:{port}/healthz", timeout=0.5)


# ----------------------------------------------------------- ServeConfig

#: the eleven keys of the plane: a value that parses, per key
PLANE_KEYS = {
    "serve_admin_port": "9100", "serve_sentinel": "1",
    "serve_sentinel_window": "0.25", "serve_slo_p99_ms": "12.5",
    "serve_slo_avail": "0.995", "serve_slo_fast_sec": "30",
    "serve_slo_slow_sec": "300", "serve_slo_fast_burn": "10",
    "serve_slo_slow_burn": "3", "serve_flight_requests": "32",
    "serve_flight_boost": "2"}


@pytest.mark.parametrize("key", sorted(PLANE_KEYS))
def test_serve_config_parses_plane_keys_as_jax(key):
    pairs = [(key, "7"), ("unrelated", "x"), (key, PLANE_KEYS[key])]
    got, want = ServeConfig.from_pairs(pairs), JConfig.from_pairs(pairs)
    for f in dataclasses.fields(JConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("pairs", [
    [("serve_sentinel_window", "0")],
    [("serve_sentinel_window", "-1")],
    [("serve_admin_port", "70000")],
    [("serve_admin_port", "-1")],
    [("serve_slo_p99_ms", "5"), ("serve_slo_avail", "1.0")],
    [("serve_slo_p99_ms", "5"), ("serve_slo_avail", "0")],
    [("serve_slo_fast_sec", "0")],
    [("serve_slo_slow_sec", "-5")],
    [("serve_flight_requests", "many")],
    [("serve_slo_p99_ms", "fast")]])
def test_serve_config_refuses_as_jax(pairs):
    with pytest.raises(ValueError) as te:
        ServeConfig.from_pairs(pairs)
    with pytest.raises(ValueError) as je:
        JConfig.from_pairs(pairs)
    assert str(te.value) == str(je.value)


def test_serve_config_avail_one_without_slo_is_taken():
    pairs = [("serve_slo_avail", "1.0")]
    assert ServeConfig.from_pairs(pairs).slo_avail \
        == JConfig.from_pairs(pairs).slo_avail == 1.0


# --------------------------------------------------------------- batcher

def test_window_stats_count_requests_and_violations():
    """Off by default (nothing kept); on, a window holds its requests
    and, with slo_ms, the ones slower than it; draining empties it.  The
    keys are the JAX batcher's."""
    from cxxnet_tpu.serve.batcher import MicroBatcher as JBatcher

    def slow(x):
        time.sleep(0.004)
        return x

    stats = {}
    for tag, cls in (("t", MicroBatcher), ("j", JBatcher)):
        b = cls(slow, max_batch=4, max_wait_ms=0.5)
        b.start()
        try:
            b.submit(np.ones((1, 2), np.float32))
            assert b.window_stats()["requests"] == 0
            b.track_window = True
            b.slo_ms = 1.0
            for _ in range(5):
                b.submit(np.ones((1, 2), np.float32))
            stats[tag] = b.window_stats()
            assert b.window_stats() == {"requests": 0, "queue_depth": 0,
                                        "viol": 0}
        finally:
            b.close()
    assert set(stats["t"]) == set(stats["j"]) == {
        "requests", "queue_depth", "viol", "p50_ms", "p95_ms", "p99_ms"}
    assert stats["t"]["requests"] == stats["t"]["viol"] == 5
    assert 4.0 <= stats["t"]["p50_ms"] <= stats["t"]["p99_ms"]


# ------------------------------------------------------------------- CLI

def _poll_readyz(base, stop, seen, got):
    """Record each change of /readyz's answer (None: nothing bound);
    while ready, keep the last /statusz and /metrics scrapes."""
    while not stop.is_set():
        try:
            code, _ = _get(base + "/readyz", timeout=0.5)
        except urllib.error.HTTPError as e:
            code = e.code
        except OSError:
            code = None
        if code is not None and (not seen or seen[-1] != code):
            seen.append(code)
        if code == 200:
            try:
                st = json.loads(_get(base + "/statusz")[1])
                if st.get("ready"):
                    got["statusz"] = st
                    got["metrics"] = _get(base + "/metrics")[1]
            except OSError:
                pass
        stop.wait(0.002)


def test_cli_serve_with_admin_sentinel_and_slo_matches_jax(mnist):  # noqa: F811
    """serve.conf with serve_admin_port, serve_sentinel = 1 and an SLO
    through both CLIs: the same predictions and serve record counts;
    serve_window records (each with viol) totalling the served rows;
    /readyz 503 before 200 and closed after the run; /statusz and
    /metrics scraped while ready."""
    from cxxnet_tpu.main import LearnTask as JTask
    from cxxnet_tpu_torch.main import LearnTask as TTask
    tmp, model = mnist
    out = {}
    for tag, task in (("port_admin", TTask), ("jax_admin", JTask)):
        port = _free_port()
        base = f"http://127.0.0.1:{port}"
        seen, got = [], {}
        stop = threading.Event()
        poller = threading.Thread(target=_poll_readyz,
                                  args=(base, stop, seen, got))
        poller.start()
        try:
            assert task().run([
                _mnist_conf(tmp, model, tag), "input_flat=0",
                f"serve_admin_port={port}", "serve_sentinel=1",
                "serve_sentinel_window=0.05", "serve_slo_p99_ms=250",
                "serve_shapes=1,2,4,8,16,32"]) == 0
        finally:
            stop.set()
            poller.join()
        with pytest.raises(OSError):
            _get(base + "/healthz", timeout=0.5)
        out[tag] = dict(seen=seen, got=got, port=port,
                        pred=open(tmp / f"{tag}_out.txt").read(),
                        recs=[json.loads(line) for line in
                              open(tmp / f"{tag}.jsonl")])
    t, j = out["port_admin"], out["jax_admin"]
    assert t["pred"] == j["pred"] and len(t["pred"].splitlines()) == 150
    [srv] = [r for r in t["recs"] if r["kind"] == "serve"]
    [jsrv] = [r for r in j["recs"] if r["kind"] == "serve"]
    for k in ("requests", "rows", "dtype", "shapes", "clients", "retraces"):
        assert srv[k] == jsrv[k], k
    assert srv["retraces"] == 0 and srv["requests"] == 150
    wins = [r for r in t["recs"] if r["kind"] == "serve_window"]
    assert wins and sum(w["requests"] for w in wins) == 150
    assert all("viol" in w for w in wins)
    assert [w["window"] for w in wins] == list(range(1, len(wins) + 1))
    assert set(wins[0]) <= set().union(*(
        set(w) for w in j["recs"] if w["kind"] == "serve_window"))
    assert 503 in t["seen"] and 200 in t["seen"], t["seen"]
    assert t["seen"].index(503) < t["seen"].index(200)
    st = t["got"]["statusz"]
    assert st["models"]["default"]["retraces"] == 0
    assert st["models"]["default"]["kind"] == "predict"
    assert st["slo"]["active"] and st["slo"]["p99_ms_target"] == 250.0
    assert st["config"]["admin_port"] == t["port"] > 0
    fams = tprom.parse(t["got"]["metrics"])
    assert "cxxnet_serve_latency_sec" in fams
    assert not _admin_threads()


def test_cli_serve_sentinel_without_sink_and_slo_without_sentinel(
        mnist, capfd):  # noqa: F811
    """The two warnings of the reference: sentinels need a sink, and the
    SLO needs the sentinels; the run still serves, with no window."""
    from cxxnet_tpu_torch.main import LearnTask
    tmp, model = mnist
    conf = _mnist_conf(tmp, model, "nosink")
    assert LearnTask().run([conf, "input_flat=0", "metrics_sink=none",
                            "serve_sentinel=1"]) == 0
    assert LearnTask().run([conf, "input_flat=0",
                            "serve_slo_p99_ms=5"]) == 0
    err = capfd.readouterr().err
    assert "sentinels disarmed" in err and "targets ignored" in err
    assert not [r for r in _records(tmp / "nosink.jsonl", "serve_window")]


def test_gen_path_admin_serves_scheduler_counters():
    """serve_gen: the admin endpoint alone (no reporter): /statusz says
    kind = generate with tokens, steps and the occupancy histogram, and
    /metrics carries decode_occupancy_hist buckets."""
    from cxxnet_tpu_torch.models import transformer
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    from cxxnet_tpu_torch.serve.host import GenModel, ModelHost
    from cxxnet_tpu_torch.utils.config import parse_config_string
    t = NetTrainer()
    for k, v in parse_config_string(transformer(
            vocab=64, seq=32, dim=32, nlayer=1, nhead=2)) + [
            ("batch_size", "2"), ("dev", "cpu"), ("silent", "1")]:
        t.set_param(k, v)
    t.init_model()
    cfg = ServeConfig(gen=1, slots=2, gen_tokens=4)
    host = ModelHost()
    gm = host.attach(GenModel(t, cfg), warmup=False)
    adm = host.start_admin(t.metrics, port=0,
                           config=dataclasses.asdict(cfg))
    base = f"http://127.0.0.1:{adm.port}"
    try:
        gm.warmup()
        assert host.mark_ready()
        prompts = [np.arange(3 + i, dtype=np.int32) % 64 for i in range(5)]
        ths = [threading.Thread(target=gm.generate, args=(p,))
               for p in prompts]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        st = json.loads(_get(base + "/statusz")[1])
        text = _get(base + "/metrics")[1]
    finally:
        host.close()
    m = st["models"]["default"]
    assert m["kind"] == "generate" and m["requests"] == 5
    assert m["tokens"] == 20 and m["steps"] > 0
    assert sum(m["occupancy_hist"].values()) == m["steps"]
    assert st["config"]["gen"] == 1 and "last_window" not in m
    fams = tprom.parse(text)
    assert fams["cxxnet_decode_occupancy_hist"]["type"] == "histogram"
    buckets = [s for s in fams["cxxnet_decode_occupancy_hist"]["samples"]
               if s[0].endswith("_bucket")]
    assert buckets[-1][1]["le"] == "+Inf" and buckets[-1][2] == m["steps"]
    assert not _admin_threads()
