"""Memory per connection: one training step's allocator readings -> the
``mem_profile`` record (the counterpart of the JAX package's
``monitor/memory.py``).

The JAX package reads the bytes of the compiled step from its HLO
liveness.  The port reads the CUDA caching allocator instead, during one
step of a profile window: :class:`AllocProbe` takes the live bytes
(``torch.cuda.memory_allocated``) before the step, after each
connection's forward (``Network.run``), after the backward and after the
update, and the allocator's high-water over the step
(``max_memory_allocated``, its peak reset at the step's start).  A
connection's ``act_bytes`` is the rise of the live bytes across its
forward: what it leaves live for the backward.  :func:`mem_table` joins
those rows with the trainer's parameter / optimizer bytes and the
analytic model (``analysis/memmodel.py``) into the JAX package's payload.

The readers are callables, so the table logic runs on the CPU with a
scripted counter; on the card ``NetTrainer.arm_mem_probe`` binds the
allocator's.  No torch import here.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

#: the boundaries of a step that are not a connection's forward
START, BACKWARD, UPDATE = "(start)", "(backward)", "(update)"


class AllocProbe:
    """The live bytes at every boundary of one training step.

    ``read()`` gives the bytes live now, ``peak()`` the high-water since
    ``reset()``.  The trainer calls :meth:`start` before the step's
    forward, the net :meth:`mark` after each connection's forward (with
    its scope), the trainer :meth:`mark` after the backward and after
    the update (``BACKWARD``, ``UPDATE``), and :meth:`finish` at the
    step's end; ``marks`` then holds ``(boundary, bytes)`` in order and
    ``peak_bytes`` the step's high-water."""

    def __init__(self, read: Callable[[], int],
                 peak: Optional[Callable[[], int]] = None,
                 reset: Optional[Callable[[], None]] = None):
        self.read = read
        self.peak = peak
        self.reset = reset
        self.marks: List[Tuple[str, int]] = []
        self.peak_bytes = 0
        self.active = False
        self.done = False

    def start(self) -> None:
        if self.reset is not None:
            self.reset()
        self.marks = [(START, int(self.read()))]
        self.active = True

    def mark(self, label: str) -> None:
        if self.active:
            self.marks.append((label, int(self.read())))

    def finish(self) -> None:
        self.active = False
        self.done = True
        sampled = max(b for _, b in self.marks)
        self.peak_bytes = max(int(self.peak()), sampled) \
            if self.peak is not None else sampled


def _sample(curve: List[int], samples: int) -> List[int]:
    """``samples`` evenly spaced readings of ``curve`` (the JAX
    package's timeline rule)."""
    n = len(curve)
    step = max(n / max(samples, 1), 1.0)
    return [curve[min(int(k * step), n - 1)]
            for k in range(min(samples, n))]


def mem_table(probe: AllocProbe,
              param_rows: Optional[Dict[str, Dict[str, int]]] = None,
              model_rows: Optional[Dict[str, Dict[str, float]]] = None,
              samples: int = 32) -> Dict[str, object]:
    """The ``mem_profile`` record's payload (the JAX package's keys).

    * ``peak_live_bytes``: the step's high-water over the bytes live at
      its start; ``peak_frac`` where in the step's boundaries the
      highest reading fell; ``timeline``: ``samples`` readings of the
      live bytes over the start's, boundary by boundary;
    * ``rows``, by total bytes: ``{layer, param_bytes, opt_bytes,
      act_bytes, total_bytes, model_bytes, model_x, share}``, where
      ``act_bytes`` is the rise of the live bytes across the
      connection's forward (none for a fall) and ``model_bytes`` the
      analytic model's bytes of the same row;
    * ``coverage``: the rows' activations over ``peak_live_bytes``
      (the JAX package's ratio, uncapped: the rises add up without the
      falls between them, so it can pass 1);
    * ``exec``: ``args_bytes`` (live at the start: parameters, optimizer
      state, the batch), ``out_bytes`` (what the step left live beyond
      them) and ``temp_bytes`` (``peak_live_bytes``)."""
    marks = probe.marks
    base = marks[0][1]
    acts: Dict[str, int] = {}
    prev = base
    for label, b in marks[1:]:
        if label not in (BACKWARD, UPDATE):
            acts[label] = acts.get(label, 0) + max(b - prev, 0)
        prev = b
    curve = [b - base for _, b in marks]
    peak = max(int(probe.peak_bytes) - base, 0)
    top = max(range(len(curve)), key=lambda i: curve[i])
    param_rows = param_rows or {}
    model_rows = model_rows or {}
    rows = []
    for scope in sorted(set(acts) | set(param_rows)):
        pr = param_rows.get(scope, {})
        row = {"layer": scope,
               "param_bytes": int(pr.get("param_bytes", 0)),
               "opt_bytes": int(pr.get("opt_bytes", 0)),
               "act_bytes": int(acts.get(scope, 0))}
        row["total_bytes"] = (row["param_bytes"] + row["opt_bytes"]
                              + row["act_bytes"])
        mr = model_rows.get(scope)
        if mr:
            mb = int(sum(mr.values()))
            row["model_bytes"] = mb
            if mb > 0:
                row["model_x"] = round(row["total_bytes"] / mb, 2)
        rows.append(row)
    rows.sort(key=lambda r: -r["total_bytes"])
    total = sum(r["total_bytes"] for r in rows) or 1
    for r in rows:
        r["share"] = round(r["total_bytes"] / total, 4)
    attributed = sum(acts.values())
    return {
        "peak_live_bytes": peak,
        "peak_frac": round(top / max(len(curve) - 1, 1), 4),
        "timeline": [int(v) for v in _sample(curve, samples)],
        "coverage": round(attributed / peak, 4) if peak else 0.0,
        "rows": rows,
        "exec": {"args_bytes": int(base),
                 "out_bytes": int(max(marks[-1][1] - base, 0)),
                 "temp_bytes": peak},
    }
