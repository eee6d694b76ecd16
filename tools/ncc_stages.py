"""Per-stage device time of the ncc sweep, from a jax.profiler trace.

Runs the canonical ncc workload (README grid, DejaVu Sans Mono 13 px,
x-bits 2, the 74-letter default alphabet = 296 needles) through
NccMatcher.get_hits_many on N dense letter pages: one warm pass, then one
traced pass. The trace's device events are reduced to the stages that
ops/ncc.py names with jax.named_scope (ncc_correlate, ncc_window_stats,
ncc_mask, ncc_top_k, ncc_gather): device ms per page and share of the
ncc_candidates device time. Runs only on a GPU.

XLA runs the kernels between custom calls as one CUDA graph (a command
buffer), and kernels inside a graph carry no name-scope annotation in the
trace; this tool therefore turns command buffers off
(--xla_gpu_enable_command_buffer=), which changes launch overhead but not
any kernel's own duration. A fusion that XLA builds across stages carries
only their common scope and is reported as ncc_other; at the canonical
shapes that is chiefly the ε-mask/key-plane fusion and the count reduction.

Usage: python tools/ncc_stages.py [--pages 16] [--out chiprun_out/ncc_trace]
Prints the stage table and, last, one JSON line; writes the trace and a
sample of its device events under --out.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = ("ncc_correlate", "ncc_window_stats", "ncc_mask", "ncc_top_k", "ncc_gather")


def event_stats(ev) -> list[tuple[str, object]]:
    out = []
    for st in ev.stats:
        try:
            k, v = st
        except (TypeError, ValueError):
            k, v = "", st
        out.append((str(k), v))
    return out


def event_text(ev) -> str:
    """Event name plus every string stat: where the op's scope path lives
    depends on the backend's tracer."""
    return " ".join([ev.name, *(v for _, v in event_stats(ev) if isinstance(v, str))])


def reduce_trace(path: str) -> dict:
    """Device time per stage on each device-plane line of an .xplane.pb:
    {line name: {stage: ns, "ncc_other": ns, "total": ns, "events": n}}.
    An event counts toward ncc only if its text names ncc_candidates."""
    from jax.profiler import ProfileData

    out: dict[str, dict] = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            acc = {s: 0 for s in STAGES}
            acc.update(ncc_other=0, total=0, events=0)
            for ev in line.events:
                acc["total"] += ev.duration_ns
                acc["events"] += 1
                text = event_text(ev)
                if "ncc_candidates" not in text:
                    continue
                stage = next((s for s in STAGES if s in text), "ncc_other")
                acc[stage] += ev.duration_ns
            out[f"{plane.name} | {line.name}"] = acc
    return out


def sample_events(path: str, n: int = 40) -> list[dict]:
    from jax.profiler import ProfileData

    rows = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in list(line.events)[:n]:
                rows.append({
                    "plane": plane.name, "line": line.name, "name": ev.name,
                    "dur_ns": ev.duration_ns,
                    "stats": {k: str(v)[:200] for k, v in event_stats(ev)},
                })
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pages", type=int, default=16)
    ap.add_argument("--out", default="chiprun_out/ncc_trace")
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
    ).strip()
    import jax
    import numpy as np

    if jax.devices()[0].platform != "gpu":
        print("ncc_stages: needs a GPU", file=sys.stderr)
        return 2
    from focr_jax.fonts import DEJAVU_MONO
    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import random_text_lines, synthesize_page
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.types import DecodeOptions, NCC_DEFAULT_ALPHABET, RenderOptions

    face = Face(DEJAVU_MONO)
    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(x_start=45, y_start=39, line_height=12, line_advance=15, width=608)
    rng = np.random.default_rng(7)
    pages = [
        synthesize_page(face, random_text_lines(rng, NCC_DEFAULT_ALPHABET, 48, 77),
                        dopts, ropts, NCC_DEFAULT_ALPHABET, (792, 662))
        for _ in range(args.pages)
    ]
    m = NccMatcher(face, NCC_DEFAULT_ALPHABET, ropts, x_bits=2)
    m.get_hits_many(pages, struct=True)  # warm: compile every shape
    os.makedirs(args.out, exist_ok=True)
    with jax.profiler.trace(args.out):
        m.get_hits_many(pages, struct=True)
    path = sorted(glob.glob(os.path.join(args.out, "plugins/profile/*/*.xplane.pb")))[-1]
    with open(os.path.join(args.out, "sample_events.json"), "w") as f:
        json.dump(sample_events(path), f, indent=1)
    lines = reduce_trace(path)
    # the line whose ncc events carry the most time holds one event per op
    name, best = max(lines.items(), key=lambda kv: sum(kv[1][s] for s in STAGES))
    ncc_ns = sum(best[s] for s in STAGES) + best["ncc_other"]
    print(f"line: {name} ({best['events']} events, {best['total'] / 1e6:.3f} ms busy)")
    stages = {}
    for s in (*STAGES, "ncc_other"):
        ms = best[s] / 1e6 / args.pages
        share = best[s] / ncc_ns if ncc_ns else 0.0
        stages[s] = {"ms_per_page": round(ms, 4), "share": round(share, 4)}
        print(f"{s:18s} {ms:8.4f} ms/page  {share * 100:5.1f} %")
    print(json.dumps({
        "device": jax.devices()[0].device_kind, "pages": args.pages,
        "ncc_device_ms_per_page": round(ncc_ns / 1e6 / args.pages, 4),
        "stages": stages, "lines": {k: v["total"] for k, v in lines.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
