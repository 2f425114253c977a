#!/usr/bin/env python
"""Reduce a jax.profiler trace to device time per kernel.

    python tools/trace_summary.py TRACE_DIR [--top N]

Reads the newest *.xplane.pb under TRACE_DIR (as written by
jax.profiler.start_trace / stop_trace) and prints, for every device plane:
its busy time (the union of its op intervals, so overlapping streams count
once), the span from its first op to its last, and the ops that took the
most device time, summed over all their launches.  Ops are read from the
plane's "XLA Ops" line (HLO op names, which match the optimized HLO) when
the trace has one, otherwise from its "Stream" lines (kernel names).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def _busy_ns(intervals) -> int:
    """Length of the union of [start, end) intervals."""
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def summarize(trace_dir: str, top: int = 12) -> list:
    """One dict per device plane: name, busy_ms, span_ms, n_ops and
    top [(op name, ms, share of busy)]."""
    import jax

    pbs = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                    recursive=True)
    if not pbs:
        raise FileNotFoundError(f"no *.xplane.pb under {trace_dir}")
    pd = jax.profiler.ProfileData.from_file(max(pbs, key=os.path.getmtime))
    out = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = list(plane.lines)
        chosen = [ln for ln in lines if ln.name == "XLA Ops"] or [
            ln for ln in lines if ln.name.startswith("Stream")]
        per_op, spans = {}, []
        for ln in chosen:
            for ev in ln.events:
                per_op[ev.name] = per_op.get(ev.name, 0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
        if not spans:
            continue
        busy = _busy_ns(spans)
        ranked = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
        out.append({
            "plane": plane.name,
            "lines": [ln.name for ln in chosen],
            "busy_ms": busy / 1e6,
            "span_ms": (max(e for _, e in spans)
                        - min(s for s, _ in spans)) / 1e6,
            "n_ops": len(spans),
            "top": [(name, ns / 1e6, ns / busy) for name, ns in ranked],
        })
    return out


def format_summary(planes: list) -> str:
    rows = []
    for pl in planes:
        rows.append(f"{pl['plane']}: busy {pl['busy_ms']:.3f} ms of a "
                    f"{pl['span_ms']:.3f} ms span, {pl['n_ops']} ops "
                    f"(lines: {', '.join(pl['lines'])})")
        for name, ms, share in pl["top"]:
            rows.append(f"  {ms:10.3f} ms  {100 * share:5.1f}%  {name}")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    print(format_summary(summarize(args.trace_dir, args.top)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
