"""ncc CLI — flag/semantics parity with the reference binary (ncc.rs:486-542, 788-878).

stdout: decoded text lines (or --csv rows, or --raw hit dumps); stderr: all
diagnostics. --rust routes to the host differential oracle, exactly like the
reference's flag switches between the C and Rust kernels.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from focr_jax.fonts.ft import Face, HintingOptions
from focr_jax.models.types import BoxSize, NCC_DEFAULT_ALPHABET, RenderOptions


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ncc", description="NCC template-matching OCR")
    p.add_argument("-i", "--img", action="extend", nargs="+", default=[], required=True)
    p.add_argument("-f", "--font", required=True)
    p.add_argument("-t", "--text-size", type=float, required=True)
    p.add_argument("--x-bits", type=int, default=0)
    p.add_argument("--y-bits", type=int, default=0)
    p.add_argument("--hinting", action="store_true")
    p.add_argument("--threshold", type=float, default=0.8)
    p.add_argument("--anchor-threshold", type=float, default=0.95)
    p.add_argument("--overlap", type=int, default=5)
    p.add_argument("-a", "--alphabet", default=NCC_DEFAULT_ALPHABET)
    p.add_argument("--box-size", default="alphabet")
    p.add_argument("--x-padding", type=int, default=0)
    p.add_argument("--y-padding", type=int, default=0)
    p.add_argument("--save-letters", action="store_true")
    p.add_argument("--rust", action="store_true",
                   help="use the host differential-oracle kernel instead of the device path")
    p.add_argument("--engine", choices=["device", "native", "oracle"], default=None,
                   help="execution tier: device (accelerator, default), native (C++ host), "
                        "oracle (NumPy reference). --rust is an alias for oracle.")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--verbose-sync", action="store_true",
                   help="verbose with MEASURED per-search timing: serializes "
                        "each size group's device dispatch (device fence) "
                        "so elapsed/ns-per-pixel are wall-clock measurements "
                        "like the reference's (ncc.rs:657-666); slower — the "
                        "pipelined default prints estimates instead")
    p.add_argument("--csv", action="store_true")
    p.add_argument("--raw", action="store_true")
    p.add_argument("--mesh", choices=["auto", "off"], default="auto",
                   help="shard page batches over all visible chips (auto: on when "
                        ">1 device; single-chip runs are unaffected)")
    p.add_argument("--strict", action="store_true",
                   help="fail on the first unreadable page (reference panic semantics); "
                        "default isolates per-page errors to stderr and continues")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler trace of the search to DIR")
    p.add_argument("--metrics-json", default=None, metavar="PATH",
                   help="write structured run metrics (JSON) to PATH ('-' = stderr)")
    return p


def _verbose_metrics(face: Face, alphabet: str, text_size: float) -> None:
    """Font metrics dump (ncc.rs:791-831)."""
    m = face.metrics
    to_px = (1.0 / m.units_per_em) * text_size
    line_space = m.ascent - m.descent + m.line_gap
    print(
        f"metrics Metrics {{ units_per_em: {m.units_per_em}, ascent: {m.ascent}, "
        f"descent: {m.descent}, line_gap: {m.line_gap}, "
        f"bounding_box: {m.bounding_box} }}",
        file=sys.stderr,
    )
    print(f"ascent  {m.ascent * to_px}px", file=sys.stderr)
    print(f"descent {m.descent * to_px}px", file=sys.stderr)
    bb = m.bounding_box
    print(f"font_bbox size ({bb.width * to_px}, {bb.height * to_px})px", file=sys.stderr)
    print(f"line_space {line_space} {line_space * to_px}px", file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.verbose_sync:
        args.verbose = True

    hinting = HintingOptions(full=True, size=args.text_size) if args.hinting else HintingOptions()
    ropts = RenderOptions(size=args.text_size, hinting=hinting)
    box = BoxSize.parse(args.box_size)

    face = Face(args.font)
    if args.verbose:
        _verbose_metrics(face, args.alphabet, args.text_size)

    from focr_jax.io.images import load_gray, save_gray
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.post import process_hits

    matcher = NccMatcher(
        face,
        args.alphabet,
        ropts,
        box_size=box,
        x_bits=args.x_bits,
        y_bits=args.y_bits,
        padding=(args.x_padding, args.y_padding),
        threshold=args.threshold,
    )

    if args.save_letters:
        os.makedirs("letters", exist_ok=True)
        for nd in matcher.needles:
            x = int(nd.offset[0] * 1000.0)
            y = int(nd.offset[1] * 1000.0)
            # the reference dumps the RAW white-on-black canvas: canvas_to_lum8
            # (ncc.rs:645 -> ncc.rs:917-923) copies pixels without inverting
            save_gray(f"letters/{nd.letter}-{x}_{y}.png", nd.pixels)

    engine = args.engine or ("oracle" if args.rust else "device")
    get = {
        "device": matcher.get_hits,
        "native": matcher.get_hits_native,
        "oracle": matcher.get_hits_oracle,
    }[engine]

    if args.raw:
        assert len(args.img) == 1
        page = load_gray(args.img[0])
        if engine == "device":
            get(page, verbose=args.verbose, raw=True, out=sys.stdout,
                sync=args.verbose_sync)
        else:
            get(page, verbose=args.verbose, raw=True, out=sys.stdout)
        return 0

    from focr_jax.utils.metrics import metrics_run

    errors: list[tuple[int, str]] = []
    loaded: list[tuple[int, np.ndarray]] = []
    for i, path in enumerate(args.img):
        try:
            loaded.append((i, load_gray(path)))
        except Exception as e:  # noqa: BLE001 - per-page isolation (§5.3)
            if args.strict:
                raise
            errors.append((i, f"{type(e).__name__}: {e}"))
            print(f"ERROR {path}: {type(e).__name__}: {e}", file=sys.stderr)

    mesh = None
    if args.mesh == "auto" and engine == "device":
        from focr_jax.parallel.mesh import auto_mesh

        mesh = auto_mesh()

    # the array-form (struct) pipeline skips per-hit object creation; verbose
    # diagnostics need the object form (per-hit dumps). Text output fuses
    # post-processing into the pipeline workers (text_post, the reference's
    # rayon (get_hits, process_hits) task shape, ncc.rs:842-845) — --csv
    # needs full per-hit fields so it post-processes to objects instead.
    struct = engine == "device" and not args.verbose
    text_post = None
    if struct and not args.csv:
        from focr_jax.models.post import process_hits_text

        text_post = lambda hs: process_hits_text(hs, args.anchor_threshold, args.overlap)

    with metrics_run(args.profile) as mrun:
        if engine == "device" and args.verbose_sync:
            # measurement mode: per-page serialized dispatch (no pipelining,
            # no sharding) so the stderr timing lines are wall-clock truth
            hit_lists = [
                matcher.get_hits(p, verbose=True, sync=True) for _, p in loaded
            ]
        elif engine == "device" and mesh is not None and len(loaded) > 1:
            # multi-chip: shard same-shape page buckets over the mesh
            hit_lists = [None] * len(loaded)
            buckets: dict[tuple[int, int], list[int]] = {}
            for j, (_, p) in enumerate(loaded):
                buckets.setdefault(p.shape, []).append(j)
            for idxs in buckets.values():
                outs = matcher.get_hits_many_sharded(
                    [loaded[j][1] for j in idxs], mesh, verbose=args.verbose,
                    struct=struct, post=text_post,
                )
                for j, h in zip(idxs, outs):
                    hit_lists[j] = h
        elif engine == "device":
            # page pipeline: all device sweeps enqueue before any host
            # replay (amortizes dispatch latency across the corpus)
            hit_lists = matcher.get_hits_many(
                [p for _, p in loaded], verbose=args.verbose, struct=struct,
                post=text_post,
            )
        else:
            hit_lists = [get(p, verbose=args.verbose) for _, p in loaded]
        if text_post is not None:
            lines_by_page = {i: h for (i, _), h in zip(loaded, hit_lists)}
        elif struct:
            from focr_jax.models.post import process_hits_struct

            lines_by_page = {
                i: process_hits_struct(h, args.anchor_threshold, args.overlap)
                for (i, _), h in zip(loaded, hit_lists)
            }
        else:
            lines_by_page = {
                i: process_hits(h, args.anchor_threshold, args.overlap, verbose=args.verbose)
                for (i, _), h in zip(loaded, hit_lists)
            }
    pages_out = [(i, lines_by_page.get(i, [])) for i in range(len(args.img))]

    if args.csv:
        for i, lines in pages_out:
            for line in lines:
                for m in line:
                    from focr_jax.models.ncc import _f32

                    cx, cy = m.center
                    print(
                        f"{i},{ord(m.letter)},{_f32(cx)},{_f32(cy)},{m.x},{m.y},{m.w},{m.h}"
                    )
    else:
        for _, lines in pages_out:
            for line in lines:
                print(line if isinstance(line, str) else "".join(m.letter for m in line))

    if args.metrics_json is not None:
        from focr_jax.utils.metrics import write_metrics

        write_metrics(
            args.metrics_json,
            tool="ncc",
            pages=len(args.img),
            decoded_pages=len(args.img) - len(errors),
            lines=sum(len(ls) for _, ls in pages_out),
            hits=sum(len(m) for _, ls in pages_out for m in ls),
            errors=[{"page": args.img[i], "error": e} for i, e in errors],
            search_seconds=mrun.seconds,
            engine=engine,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
