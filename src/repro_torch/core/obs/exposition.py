"""OpenMetrics / Prometheus text exposition of registry snapshots.

``render_openmetrics`` turns any ``MetricsRegistry`` (or a flat
``snapshot()`` dict, or a merge of several) into the OpenMetrics text
format — the lingua franca every scrape pipeline understands — with zero
dependencies:

* flat snapshot keys (``name{k=v,...}``, see ``metrics.format_series``)
  are parsed back into metric family + label set;
* families ending in ``_total`` render as ``counter`` (the OpenMetrics
  family name drops the suffix; samples keep it), histogram values
  (dicts with ``buckets``) render as ``histogram`` with cumulative
  ``_bucket{le=...}`` samples plus ``_sum``/``_count``, everything else
  is a ``gauge``;
* label values are escaped per the spec (backslash, quote, newline) and
  the exposition ends with the mandatory ``# EOF``.

``parse_openmetrics`` is the minimal inverse used by the tests and the
sanity fuzz: it validates line structure and returns the flat
``{sample_name{labels}: value}`` dict, so round-tripping a snapshot is
an executable check that the output actually parses.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple, Union

__all__ = ["render_openmetrics", "parse_openmetrics"]

_LABEL_ESCAPES = {"\\": "\\\\", '"': '\\"', "\n": "\\n"}
_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'                  # sample name
    r'(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*)\})?'
    r'\s+(-?(?:[0-9]*\.)?[0-9]+(?:[eE][+-]?[0-9]+)?|[+-]?Inf|NaN)'
    r'(?:\s+-?[0-9.eE+]+)?$')                       # optional timestamp
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _escape(v: str) -> str:
    return "".join(_LABEL_ESCAPES.get(c, c) for c in str(v))


def _sanitize_name(name: str) -> str:
    """Metric names must match the OpenMetrics charset; the registry's
    names already do, but flattened series from other sources may not."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not out or not _NAME_RE.match(out):
        out = "_" + out
    return out

def _parse_flat(flat: str) -> Tuple[str, List[Tuple[str, str]]]:
    """Split a snapshot key ``name{k=v,...}`` into (name, labels)."""
    if "{" not in flat or not flat.endswith("}"):
        return flat, []
    name, _, inner = flat.partition("{")
    labels = []
    for part in inner[:-1].split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        labels.append((k, v))
    return name, labels


def _fmt_labels(labels: List[Tuple[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
    return "{" + inner + "}"


def render_openmetrics(
        source: Union[Mapping[str, object], object]) -> str:
    """Render a registry (anything with ``snapshot()``) or a flat
    snapshot mapping as OpenMetrics text (terminated by ``# EOF``)."""
    snap = source.snapshot() if hasattr(source, "snapshot") else dict(source)
    # group series by family, preserving first-seen order
    families: "Dict[str, List[Tuple[List[Tuple[str, str]], object]]]" = {}
    for flat, value in snap.items():
        name, labels = _parse_flat(flat)
        families.setdefault(_sanitize_name(name), []).append((labels, value))

    lines: List[str] = []
    for name, series in families.items():
        first = series[0][1]
        if isinstance(first, Mapping) and "buckets" in first:
            lines.append(f"# TYPE {name} histogram")
            for labels, value in series:
                if not (isinstance(value, Mapping) and "buckets" in value):
                    continue
                for le, cum in value["buckets"].items():
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(labels + [('le', str(le))])}"
                        f" {float(cum):g}")
                lines.append(f"{name}_sum{_fmt_labels(labels)}"
                             f" {float(value['sum']):g}")
                lines.append(f"{name}_count{_fmt_labels(labels)}"
                             f" {float(value['count']):g}")
        elif name.endswith("_total"):
            family = name[:-len("_total")]
            lines.append(f"# TYPE {family} counter")
            for labels, value in series:
                if isinstance(value, (int, float)) \
                        and not isinstance(value, bool):
                    lines.append(f"{family}_total{_fmt_labels(labels)}"
                                 f" {float(value):g}")
        else:
            lines.append(f"# TYPE {name} gauge")
            for labels, value in series:
                if isinstance(value, (int, float)) \
                        and not isinstance(value, bool):
                    lines.append(f"{name}{_fmt_labels(labels)}"
                                 f" {float(value):g}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def parse_openmetrics(text: str) -> Dict[str, float]:
    """Minimal OpenMetrics parser: validates structure, returns the flat
    ``{sample{labels}: value}`` dict. Raises ``ValueError`` on malformed
    lines or a missing ``# EOF`` terminator."""
    samples: Dict[str, float] = {}
    saw_eof = False
    for i, line in enumerate(text.splitlines(), start=1):
        line = line.rstrip()
        if not line:
            continue
        if saw_eof:
            raise ValueError(f"line {i}: content after # EOF")
        if line == "# EOF":
            saw_eof = True
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) < 4 or parts[1] not in ("TYPE", "HELP", "UNIT"):
                raise ValueError(f"line {i}: malformed comment {line!r}")
            if parts[1] == "TYPE" and parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "info",
                    "stateset", "unknown"):
                raise ValueError(f"line {i}: unknown type {parts[3]!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {i}: malformed sample {line!r}")
        name, raw_labels, raw_value = m.group(1), m.group(2), m.group(3)
        labels = _LABEL_RE.findall(raw_labels) if raw_labels else []
        key = name + _fmt_labels([(k, v) for k, v in labels])
        if raw_value in ("+Inf", "Inf"):
            value = float("inf")
        elif raw_value == "-Inf":
            value = float("-inf")
        else:
            value = float(raw_value)
        samples[key] = value
    if not saw_eof:
        raise ValueError("missing # EOF terminator")
    return samples
