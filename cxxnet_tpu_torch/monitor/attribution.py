"""Device time per connection: a profile window's events -> the
``layer_profile`` record (the JAX package's ``monitor/attribution.py``).

While a window is open, ``Network.run`` enters a ``record_function``
range named :func:`~..layers.base.conn_scope_name` around each
connection's forward.  This module joins the window's Chrome-trace
events (:func:`~.trace.load_trace`; no torch import) back to those
names:

* a **forward** kernel belongs to the innermost connection range around
  the host call that launched it: the kernel's ``correlation`` names
  its ``cudaLaunchKernel`` (or driver) call, whose thread and time place
  it inside the range;
* a **backward** kernel is launched from the autograd engine's thread,
  outside every range.  The CPU ops around its launch (``autograd::
  engine::evaluate_function: ...Backward``) carry the ``Sequence
  number`` of the forward op that made their autograd node, and that
  forward op sits inside a connection range, so the kernel books there,
  as the JAX package books ``transpose(jvp(...))`` time to its layer.
  The node's forward op is the last op to report its number (an op that
  makes a node takes the number, its successors the next);
* everything else (the updater, the optimizer's kernels, copies of the
  input pipeline) lands in ``(unattributed)``, NCCL kernels in
  ``(collectives)``.

On the CPU the timeline is the outermost CPU ops (:func:`~.trace.timeline`),
each placed the same way from its own thread and time.  Given the
analytic costs (``analysis/costmodel.layer_costs``) and the card's peaks,
each connection's row carries the JAX package's cost columns:
``flops``, ``bytes``, ``mfu_pct``, ``roofline_ms`` and ``roofline_x``.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import LAUNCH_CATS, collective_kind, timeline, union_us

#: pseudo-rows for time the join does not (or should not) name
COMM_ROW = "(collectives)"
OTHER_ROW = "(unattributed)"


class _Nest:
    """One thread's properly nested intervals, for innermost-first
    lookups of the intervals around a time."""

    def __init__(self, items: List[Tuple[float, float, object]]):
        items.sort(key=lambda it: (it[0], -it[1]))
        self.starts = [it[0] for it in items]
        self.items = items
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (a, b, _) in enumerate(items):
            while stack and items[stack[-1]][1] < b:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def around(self, t: float):
        """The payloads of the intervals holding ``t``, innermost
        first."""
        i = bisect_right(self.starts, t) - 1
        while i >= 0:
            a, b, payload = self.items[i]
            if b >= t:
                yield payload
            i = self.parent[i]


def _threads(events, pick) -> Dict[tuple, _Nest]:
    out: Dict[tuple, list] = {}
    for e in events:
        p = pick(e)
        if p is not None:
            out.setdefault((e.get("pid"), e.get("tid")), []).append(
                (e["ts"], e["ts"] + e["dur"], p))
    return {k: _Nest(v) for k, v in out.items()}


def attribute_events(events: Sequence[dict], scopes: Sequence[str]
                     ) -> List[dict]:
    """Each timeline event of a window as ``{name, dur_us, scope,
    backward, comm}``: ``scope`` the connection range it books to (None
    when none), ``backward`` whether it was placed through the autograd
    sequence number, ``comm`` its collective family (None for compute)."""
    names = set(scopes)
    ranges = _threads(events, lambda e: e["name"]
                      if e.get("cat") == "user_annotation"
                      and e.get("name") in names else None)
    ops = _threads(events, lambda e: (e.get("args") or {})
                   if e.get("cat") == "cpu_op" else None)
    # sequence number -> (start, scope) of the last forward op reporting
    # it (a forward op's "Fwd thread id" is 0)
    fwd: Dict[int, Tuple[float, Optional[str]]] = {}
    for e in events:
        args = e.get("args") or {}
        seq = args.get("Sequence number")
        if e.get("cat") != "cpu_op" or seq is None \
                or args.get("Fwd thread id", 0):
            continue
        if seq in fwd and fwd[seq][0] > e["ts"]:
            continue
        nest = ranges.get((e.get("pid"), e.get("tid")))
        fwd[seq] = (e["ts"], next(nest.around(e["ts"]), None)
                    if nest is not None else None)
    launch = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launch[corr] = ((e.get("pid"), e.get("tid")), e["ts"])
    tl, on_device = timeline(events)
    out = []
    for e in tl:
        if on_device:
            where = launch.get((e.get("args") or {}).get("correlation"))
        else:
            where = ((e.get("pid"), e.get("tid")), e["ts"])
        scope, backward = None, False
        if where is not None:
            key, t = where
            nest = ranges.get(key)
            scope = next(nest.around(t), None) if nest is not None else None
            if scope is None and key in ops:
                for args in ops[key].around(t):
                    seq = args.get("Sequence number")
                    if seq is not None and args.get("Fwd thread id", 0):
                        hit = fwd.get(seq)
                        scope = None if hit is None else hit[1]
                        backward = scope is not None
                        break
        out.append({"name": e.get("name", ""), "dur_us": e["dur"],
                    "start": e["ts"], "scope": scope, "backward": backward,
                    "comm": collective_kind(e.get("name", ""))})
    return out


def _cost_columns(row: dict, c: Dict[str, float], sec: float,
                  peak_flops: Optional[float],
                  peak_bw: Optional[float]) -> None:
    """The JAX package's cost columns of one row: the analytic ``flops``
    / ``bytes`` of a step, ``mfu_pct`` (flops over the row's device time
    against the card's peak) and ``roofline_ms`` (the larger of flops
    over the peak and bytes over the bandwidth) with ``roofline_x`` (the
    device time over it).  Without peaks (the CPU) only the analytic
    pair is written."""
    row["flops"] = c["flops"]
    row["bytes"] = c["bytes"]
    if sec > 0 and peak_flops:
        row["mfu_pct"] = round(c["flops"] / sec / peak_flops * 100.0, 2)
    if peak_flops and peak_bw:
        floor_ms = max(c["flops"] / peak_flops, c["bytes"] / peak_bw) * 1e3
        row["roofline_ms"] = round(floor_ms, 4)
        if floor_ms > 0:
            row["roofline_x"] = round(sec * 1e3 / floor_ms, 2)


def layer_table(events: Sequence[dict], scopes: Sequence[str],
                steps: int = 1,
                costs: Optional[Dict[str, Dict[str, float]]] = None,
                peak_flops: Optional[float] = None,
                peak_bw: Optional[float] = None) -> Dict[str, object]:
    """The ``layer_profile`` record's payload: per dispatch,
    ``device_total_ms`` (the timeline's busy union), ``ops_total_ms``
    (summed event time), ``attributed_ms`` and ``coverage``
    (attributed / ops), and ``rows`` by device time, each ``{layer,
    device_ms, bwd_ms, count, share, comm_ms}`` (``bwd_ms``: the part
    placed through the backward join), and a connection's row the cost
    columns of :func:`_cost_columns` where ``costs`` has its scope."""
    steps = max(int(steps), 1)
    placed = attribute_events(events, scopes)
    buckets: Dict[str, List[float]] = {}  # row -> [us, count, comm, bwd]
    ops_us = 0.0
    for p in placed:
        row = p["scope"] or (COMM_ROW if p["comm"] else OTHER_ROW)
        cur = buckets.setdefault(row, [0.0, 0, 0.0, 0.0])
        cur[0] += p["dur_us"]
        cur[1] += 1
        if p["comm"]:
            cur[2] += p["dur_us"]
        if p["backward"]:
            cur[3] += p["dur_us"]
        ops_us += p["dur_us"]
    busy = union_us((p["start"], p["start"] + p["dur_us"]) for p in placed)
    per = lambda us: round(us / 1e3 / steps, 4)  # noqa: E731
    costs = costs or {}
    rows = []
    for row, (us, n, comm, bwd) in sorted(buckets.items(),
                                          key=lambda kv: -kv[1][0]):
        r = {"layer": row, "device_ms": per(us), "bwd_ms": per(bwd),
             "count": n, "share": round(us / ops_us, 4) if ops_us else 0.0,
             "comm_ms": per(comm)}
        if row in costs:
            _cost_columns(r, costs[row], us / 1e6 / steps, peak_flops,
                          peak_bw)
        rows.append(r)
    attributed = sum(v[0] for k, v in buckets.items()
                     if k not in (COMM_ROW, OTHER_ROW))
    return {"steps": steps, "device_total_ms": per(busy or ops_us),
            "ops_total_ms": per(ops_us), "attributed_ms": per(attributed),
            "coverage": round(attributed / ops_us, 4) if ops_us else 0.0,
            "rows": rows}
