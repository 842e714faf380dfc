"""Prometheus text exposition of the live metrics (the JAX package's
``monitor/promtext.py``; text format version 0.0.4).

The admin endpoint's ``/metrics`` (serve/admin.py) renders a
:meth:`~.metrics.Metrics.snapshot` here, byte for byte as the JAX
package renders the same snapshot, so a scraper (and ``tools/obsv.py
--live``) reads either package.  :func:`parse` reads the text back and
checks its grammar.

* counters   -> ``<prefix>_<name>_total`` (``# TYPE ... counter``);
* gauges     -> ``<prefix>_<name>`` (``# TYPE ... gauge``);
* histograms (reservoir summaries) -> a ``summary``: ``{quantile=
  "0.5|0.95|0.99"}`` samples plus the exact ``_sum`` / ``_count``;
* exact integer histograms (the batcher's ``batch_hist``, the
  scheduler's ``occ_hist``, passed as ``hists=``) -> a ``histogram``
  with cumulative ``le`` buckets ending in ``+Inf``.

Names: every character outside ``[a-zA-Z0-9_:]`` becomes ``_`` and a
leading digit gets a ``_`` prefix.  Label values are escaped, never
mangled: backslash, double quote and newline get a backslash.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

#: label-value escaping, in the order the format defines (backslash
#: first, or escaping a quote would double-escape its backslash)
_ESCAPES = (("\\", "\\\\"), ("\n", "\\n"), ('"', '\\"'))

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

#: the reservoir quantiles a Histogram.summary carries, in label form
_QUANTILES = (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))


def mangle(name: str) -> str:
    """THE name-mangling rule: invalid chars -> ``_``, leading digit
    gets a ``_`` prefix.  Idempotent."""
    out = _NAME_BAD.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out or "_"


def escape_label(value: str) -> str:
    """THE label-value escaping rule (backslash, newline, quote)."""
    for raw, esc in _ESCAPES:
        value = value.replace(raw, esc)
    return value


def _fmt_value(v: float) -> str:
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels(pairs: Dict[str, str]) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{mangle(k)}="{escape_label(str(v))}"'
                     for k, v in sorted(pairs.items()))
    return "{" + inner + "}"


def _sample(name: str, labels: Dict[str, str], value: float,
            out: List[str]) -> None:
    out.append(f"{name}{_labels(labels)} {_fmt_value(value)}")


def render(snapshot: Dict[str, Any], *, prefix: str = "cxxnet",
           labels: Optional[Dict[str, str]] = None,
           hists: Optional[Dict[str, Dict[int, int]]] = None) -> str:
    """A :meth:`MetricsRegistry.snapshot` (plus optional exact-count
    ``hists``) as Prometheus exposition text.  Pure function of its
    inputs — the scrape path takes no locks; the caller hands it
    already-copied dicts."""
    base = dict(labels or {})
    out: List[str] = []
    for name, v in sorted(snapshot.get("counters", {}).items()):
        m = f"{prefix}_{mangle(name)}_total"
        out.append(f"# TYPE {m} counter")
        _sample(m, base, v, out)
    for name, v in sorted(snapshot.get("gauges", {}).items()):
        m = f"{prefix}_{mangle(name)}"
        out.append(f"# TYPE {m} gauge")
        _sample(m, base, v, out)
    for name, s in sorted(snapshot.get("histograms", {}).items()):
        m = f"{prefix}_{mangle(name)}"
        out.append(f"# TYPE {m} summary")
        for qlabel, key in _QUANTILES:
            if key in s:
                _sample(m, dict(base, quantile=qlabel), s[key], out)
        _sample(m + "_sum", base, s.get("sum", 0.0), out)
        _sample(m + "_count", base, s.get("count", 0), out)
    for name, counts in sorted((hists or {}).items()):
        m = f"{prefix}_{mangle(name)}"
        out.append(f"# TYPE {m} histogram")
        cum = 0
        total = 0.0
        for edge in sorted(int(k) for k in counts):
            cum += int(counts[edge])
            total += edge * int(counts[edge])
            _sample(m + "_bucket", dict(base, le=str(edge)), cum, out)
        _sample(m + "_bucket", dict(base, le="+Inf"), cum, out)
        _sample(m + "_sum", base, total, out)
        _sample(m + "_count", base, cum, out)
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------- parse

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r" (?P<value>[^ ]+)$")
_LABEL_RE = re.compile(
    r'\s*(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"\s*(,|$)')


def _unescape(value: str) -> str:
    out, i = [], 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt,
                                                             "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_value(tok: str) -> float:
    if tok == "+Inf":
        return math.inf
    if tok == "-Inf":
        return -math.inf
    return float(tok)  # "NaN" parses; garbage raises ValueError


def parse(text: str) -> Dict[str, Dict[str, Any]]:
    """Read exposition text back into ``{family: {"type": t, "samples":
    [(name, labels, value), ...]}}``, validating the grammar as it goes
    (malformed lines raise ValueError).  The renderer's own output
    round-trips."""
    fams: Dict[str, Dict[str, Any]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                if parts[3] not in ("counter", "gauge", "summary",
                                    "histogram", "untyped"):
                    raise ValueError(
                        f"promtext line {lineno}: unknown type "
                        f"{parts[3]!r}")
                fams[parts[2]] = {"type": parts[3], "samples": []}
            continue  # HELP / comments pass through unparsed
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"promtext line {lineno}: malformed "
                             f"sample {line!r}")
        name = m.group("name")
        labels: Dict[str, str] = {}
        raw = m.group("labels")
        if raw:
            pos = 0
            while pos < len(raw):
                lm = _LABEL_RE.match(raw, pos)
                if lm is None:
                    raise ValueError(
                        f"promtext line {lineno}: malformed labels "
                        f"{raw!r}")
                labels[lm.group("k")] = _unescape(lm.group("v"))
                pos = lm.end()
        try:
            value = _parse_value(m.group("value"))
        except ValueError:
            raise ValueError(f"promtext line {lineno}: bad value "
                             f"{m.group('value')!r}") from None
        # attach to the declaring family: summaries/histograms own
        # their _sum/_count/_bucket children
        fam = None
        for cand in (name, name.rsplit("_", 1)[0]):
            if cand in fams:
                fam = fams[cand]
                break
        if fam is None:
            fam = fams.setdefault(name, {"type": "untyped",
                                         "samples": []})
        if fam["type"] == "counter" and not math.isnan(value) \
                and value < 0:
            raise ValueError(
                f"promtext line {lineno}: counter {name} < 0")
        fam["samples"].append((name, labels, value))
    return fams


def counter_values(fams: Dict[str, Dict[str, Any]]) -> Dict[str, float]:
    """Flatten parsed counter samples to ``{name: value}`` (label-less
    view): what a check of counter monotonicity across scrapes reads."""
    out: Dict[str, float] = {}
    for fname, fam in fams.items():
        if fam["type"] != "counter":
            continue
        for name, _labels_, value in fam["samples"]:
            out[name] = value
    return out


def live_tables(fams: Dict[str, Dict[str, Any]],
                prefix: str = "cxxnet") -> Dict[str, Any]:
    """Summarize a parsed ``/metrics`` scrape for ``tools/obsv.py
    --live``: counters + gauges flattened, summaries back to
    p50/p95/p99 dicts keyed by the unprefixed registry name."""
    plen = len(prefix) + 1
    out: Dict[str, Any] = {"counters": {}, "gauges": {}, "summaries": {}}
    for fname, fam in fams.items():
        short = fname[plen:] if fname.startswith(prefix + "_") else fname
        if fam["type"] == "counter":
            for _n, _l, v in fam["samples"]:
                out["counters"][short[:-6] if short.endswith("_total")
                                else short] = v
        elif fam["type"] == "gauge":
            for _n, _l, v in fam["samples"]:
                out["gauges"][short] = v
        elif fam["type"] == "summary":
            s: Dict[str, float] = {}
            for name, labels, v in fam["samples"]:
                if name.endswith("_sum"):
                    s["sum"] = v
                elif name.endswith("_count"):
                    s["count"] = v
                elif labels.get("quantile") == "0.5":
                    s["p50"] = v
                elif labels.get("quantile") == "0.95":
                    s["p95"] = v
                elif labels.get("quantile") == "0.99":
                    s["p99"] = v
            out["summaries"][short] = s
    return out
