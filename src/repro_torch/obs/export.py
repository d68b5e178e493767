"""Prometheus text exposition rendering for a MetricsRegistry.

Counters and gauges render as-is; histograms render as summaries
(quantiles over the sliding sample window plus exact lifetime
``_count`` / ``_sum``) because the serving stack wants precise p50/p99
over recent traffic, not fixed buckets chosen ahead of time. The
output parses under the Prometheus text format v0.0.4, which is what
``launch/serve.py --stats-interval`` dumps and the STATS frame ships.
"""
from __future__ import annotations

from .registry import Family, Histogram, MetricsRegistry

QUANTILES = (0.5, 0.9, 0.99)


def _escape(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\"", "\\\"")
            .replace("\n", "\\n"))


def _labels(names: tuple, values: tuple, extra: str = "") -> str:
    parts = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: float) -> str:
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _render_one(lines: list, name: str, metric, label_names: tuple,
                label_values: tuple) -> None:
    if isinstance(metric, Histogram):
        for q in QUANTILES:
            qlab = 'quantile="%s"' % q
            lines.append(
                f"{name}{_labels(label_names, label_values, qlab)}"
                f" {_fmt(metric.percentile(q * 100))}")
        lines.append(f"{name}_count{_labels(label_names, label_values)}"
                     f" {metric.count}")
        lines.append(f"{name}_sum{_labels(label_names, label_values)}"
                     f" {_fmt(metric.sum)}")
    else:
        lines.append(f"{name}{_labels(label_names, label_values)}"
                     f" {_fmt(metric.value)}")


def render_prometheus(registry: MetricsRegistry) -> str:
    lines: list[str] = []
    for name, metric in registry.collect():
        kind = "summary" if metric.kind == "histogram" else metric.kind
        if metric.help:
            lines.append(f"# HELP {name} {metric.help}")
        lines.append(f"# TYPE {name} {kind}")
        if isinstance(metric, Family):
            for values, child in metric.children():
                _render_one(lines, name, child, metric.label_names, values)
        else:
            _render_one(lines, name, metric, (), ())
    return "\n".join(lines) + "\n" if lines else ""


def parse_prometheus(text: str) -> dict[str, float]:
    """Minimal parser for round-trip tests and the STATS smoke: maps
    ``name{labels}`` sample lines back to float values."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, value = line.rpartition(" ")
        try:
            out[key] = float(value)
        except ValueError:
            continue
    return out
