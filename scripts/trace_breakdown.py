"""One traced run of a benchmark cell with the whole idle-gap breakdown.

    python3 scripts/trace_breakdown.py <cell> [--seed S] [--seconds T]
        [--export DIR]

Runs ``ldc_bench``'s cell as a ``--trace 1`` run does, but prints every
name its trace reader gives an idle gap (the benchmark's line keeps the
ten largest), the largest number of the profiler's host events inside
one span of the program (the reader looks back 256 events for the span
that covers a gap) and the time that moves between names when it looks
back without end, and, with ``--export``, writes the traced job's
Chrome trace there and checks in that file that every "Command Buffer
Full" event starts inside an ``anap3.chunk.dispatch`` span. Needs a CUDA
card; the last line is one JSON object.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ldc_bench import run as bench_run  # noqa: E402
from ldc_bench import trace as bench_trace  # noqa: E402

DISPATCH = "anap3.chunk.dispatch"
BUFFER_FULL = "Command Buffer Full"


def span_loads(events) -> dict:
    """For each span name of the program, the most host events (those the
    trace reader keeps) that start inside one of its spans."""
    host = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in events
                  if not str(e.device_type()).endswith("CUDA")
                  and not e.name().startswith(("cu", bench_trace.LABEL)))
    starts = [h[0] for h in host]
    most = Counter()
    for s, e, name in host:
        if name.startswith("anap3."):
            n = bisect.bisect_right(starts, e) - bisect.bisect_right(starts, s)
            most[name] = max(most[name], n)
    return dict(most)


def buffer_full_check(path: Path) -> dict:
    """Command Buffer Full events of a Chrome trace, and how many start
    inside a chunk dispatch span."""
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("name") == DISPATCH and e.get("ph") == "X")
    starts = [s for s, _ in spans]
    full = [e["ts"] for e in events if e.get("name") == BUFFER_FULL]
    inside = 0
    for t in full:
        i = bisect.bisect_right(starts, t) - 1
        inside += i >= 0 and spans[i][1] >= t
    return {"buffer_full": len(full), "inside_dispatch": inside,
            "dispatch_spans": len(spans)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cell")
    ap.add_argument("--seed", type=int, default=20261018)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--export", default=None)
    args = ap.parse_args(argv)
    found = {}
    read = bench_trace.read

    def read_all(events, w0, w1, spans=(), top=10):
        events = list(events)
        found["loads"] = span_loads(events)
        innermost = bench_trace._innermost
        try:
            # where each gap would go if the reader looked back without end
            bench_trace._innermost = (
                lambda host, starts, t, reach=256: innermost(
                    host, starts, t, len(host) + 1))
            whole = dict(read(events, w0, w1, spans, top=1000)["idle_gaps"])
        finally:
            bench_trace._innermost = innermost
        got = read(events, w0, w1, spans, top=1000)
        seen = dict(got["idle_gaps"])
        found["past_reach"] = {
            n: round(whole.get(n, 0.0) - seen.get(n, 0.0), 6)
            for n in set(whole) | set(seen)
            if abs(whole.get(n, 0.0) - seen.get(n, 0.0)) > 1e-5}
        return got

    bench_trace.read = read_all
    if args.export:
        import torch.profiler as tp

        profile = tp.profile

        class Exported(profile):
            def stop(self):
                super().stop()
                out = Path(args.export)
                out.mkdir(parents=True, exist_ok=True)
                path = out / f"{args.cell}.json"
                self.export_chrome_trace(str(path))
                found["buffer_full"] = buffer_full_check(path)

        tp.profile = Exported
    t0 = time.perf_counter()
    out = bench_run.run_cell(args.cell, args.seed, args.seconds, True)
    gaps = out["breakdown"]["idle_gaps"]
    print(json.dumps({"cell": args.cell, "seconds": time.perf_counter() - t0,
                      "metrics": {k: v["value"]
                                  for k, v in out["metrics"].items()},
                      "device": out["device"], "idle_gaps": gaps,
                      "device_ops": out["breakdown"]["device_ops"][:5],
                      **found}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
