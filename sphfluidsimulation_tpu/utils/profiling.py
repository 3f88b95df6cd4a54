"""Profiler traces and their reduction to per-phase device time.

The stepper wraps each per-frame phase in a ``jax.named_scope``
(``sim.stepper.PHASES``). XLA keeps the scope path in every instruction's
``op_name`` metadata, and the profiler tags each device kernel with the
instruction it runs (``hlo_op``). :func:`phase_breakdown` joins the two: it
reads an ``.xplane.pb`` trace, attributes every device event to the
innermost phase named in its instruction's scope path, and reports busy
time, idle share and the share of each phase.
"""

from __future__ import annotations

import contextlib
import glob
import os
import re

import jax

_INSTR = re.compile(
    r'^\s*(?:ROOT\s+)?%?([^\s=]+)\s*=.*?op_name="([^"]*)"')
_HLO_OP = re.compile(r"hlo_op=([^,#\s]+)")


@contextlib.contextmanager
def trace(log_dir: str | None):
    """jax.profiler trace context; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield


def _norm(name: str) -> str:
    return re.sub(r"[.\-]", "_", name)


def hlo_phase_map(hlo_text: str, phases) -> dict[str, str]:
    """Instruction name → innermost phase named in its op_name path."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        hit = [c for c in m.group(2).split("/") if c in phases]
        if hit:
            out[_norm(m.group(1))] = hit[-1]
    return out


def latest_xplane(log_dir: str) -> str:
    """Newest ``.xplane.pb`` written under ``log_dir``."""
    paths = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    return max(paths, key=os.path.getmtime)


def _device_events(pd):
    """(start_ns, duration_ns, keys) of every device event.

    GPU traces: the ``/device:GPU:*`` planes, stream lines only (derived
    lines repeat the same time). CPU traces have no device plane; there the
    XLA op events on host threads (those carrying ``hlo_op``) stand in.
    """
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU")]
    out = []
    for plane in planes or pd.planes:
        lines = list(plane.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in streams or lines:
            for e in line.events:
                stats = dict(e.stats)
                keys = []
                if "hlo_op" in stats:
                    keys.append(str(stats["hlo_op"]))
                for v in stats.values():
                    if isinstance(v, str):
                        keys += _HLO_OP.findall(v)
                if not planes and not keys:
                    continue
                keys += [e.name, e.name.split(":")[0]]
                out.append((int(e.start_ns), int(e.duration_ns), keys))
    return out


def _union_ns(intervals) -> int:
    busy, end = 0, None
    for s, d in sorted(intervals):
        e = s + d
        if end is None or s > end:
            busy += d
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def phase_breakdown(xplane_path: str, hlo_texts, phases) -> dict:
    """Reduce one trace to device busy time and per-phase shares.

    ``hlo_texts``: compiled HLO text of every program in the trace
    (``jitted.lower(...).compile().as_text()``). Returns a dict with
    ``window_ns`` (first device event start to last end), ``busy_ns``
    (union of device event intervals), ``idle_share``, ``phase_ns``
    (summed event durations per phase, plus ``other`` for events whose
    instruction carries no phase) and ``phase_share`` of the summed total.
    """
    from jax.profiler import ProfileData

    pmap = {}
    for t in hlo_texts:
        pmap.update(hlo_phase_map(t, phases))
    events = _device_events(ProfileData.from_file(xplane_path))
    if not events:
        raise ValueError(f"no device events in {xplane_path}")
    phase_ns = {ph: 0 for ph in (*phases, "other")}
    other: dict[str, int] = {}
    for _, dur, keys in events:
        ph = next((pmap[_norm(k)] for k in keys if _norm(k) in pmap),
                  "other")
        phase_ns[ph] += dur
        if ph == "other":
            other[keys[-2]] = other.get(keys[-2], 0) + dur
    start = min(s for s, _, _ in events)
    end = max(s + d for s, d, _ in events)
    busy = _union_ns([(s, d) for s, d, _ in events])
    total = sum(phase_ns.values()) or 1
    window = max(end - start, 1)
    return {
        "events": len(events),
        "window_ns": window,
        "busy_ns": busy,
        "idle_share": 1.0 - busy / window,
        "phase_ns": phase_ns,
        "phase_share": {k: v / total for k, v in phase_ns.items()},
        # the longest unattributed events, to read what "other" holds
        "top_other": sorted(other.items(), key=lambda kv: -kv[1])[:8],
    }
