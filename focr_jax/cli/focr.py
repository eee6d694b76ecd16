"""focr CLI — flag/semantics parity with the reference binary (main.rs:342-508).

stdout carries ONLY decoded text lines; every diagnostic goes to stderr
(the contract that makes `focr ... | sed | base64 -d` work, SURVEY.md §5.5).

Additions over the reference (absent flags behave like the reference):
  --batch-size  pages per device batch
"""

from __future__ import annotations

import argparse
import os
import sys

from focr_jax.fonts.ft import Face, HintingOptions
from focr_jax.models.types import DecodeOptions, FOCR_DEFAULT_ALPHABET, RenderOptions


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="focr", description="grid SSD font OCR")
    p.add_argument("-i", "--img", action="extend", nargs="+", default=[], required=True)
    p.add_argument("-f", "--font", required=True)
    p.add_argument("-a", "--alphabet", default=FOCR_DEFAULT_ALPHABET)
    p.add_argument("--hinting", action="store_true")
    p.add_argument("-t", "--text-size", type=float, required=True)
    p.add_argument("-k", "--kerning", type=float, default=1.0)
    p.add_argument("-x", type=int, default=0)
    p.add_argument("-y", type=int, default=0)
    p.add_argument("-w", "--width", type=int, required=True)
    p.add_argument("--line-height", type=int, required=True)
    p.add_argument("--line-advance", type=int, required=True)
    p.add_argument("--test", default=None, metavar="PREFIX",
                   help="write <prefix>-rect.png and <prefix>-text.png, then exit")
    p.add_argument("--verify", default=None, metavar="DIR",
                   help="dir for verify images. Red is reference, Blue is rendered")
    p.add_argument("--batch-size", type=int, default=16, help="pages per device batch")
    p.add_argument("--mesh", choices=["auto", "off"], default="auto",
                   help="shard page batches over all visible chips (auto: on when "
                        ">1 device; single-chip runs are unaffected)")
    p.add_argument("--glyph-shards", type=int, default=1,
                   help="tensor-parallel shards of the glyph template bank "
                        "(must divide the device count)")
    p.add_argument("--strict", action="store_true",
                   help="fail on the first unreadable page (reference panic semantics); "
                        "default isolates per-page errors to stderr and continues")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler trace of the decode to DIR")
    p.add_argument("--metrics-json", default=None, metavar="PATH",
                   help="write structured run metrics (JSON) to PATH ('-' = stderr)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    if args.verify is not None:
        assert os.path.isdir(args.verify), "--verify should be a dir"

    hinting = HintingOptions(full=True, size=args.text_size) if args.hinting else HintingOptions()
    ropts = RenderOptions(size=args.text_size, hinting=hinting, kern_x=args.kerning)
    dopts = DecodeOptions(
        x_start=args.x,
        y_start=args.y,
        width=args.width,
        line_height=args.line_height,
        line_advance=args.line_advance,
    )

    from focr_jax.io.images import load_gray, load_gray_many, save_rgb, save_rgba

    if args.test is not None:
        from focr_jax.io.overlays import draw_test_rectangles, draw_test_text

        img = load_gray(args.img[0])
        save_rgba(f"{args.test}-rect.png", draw_test_rectangles(img, dopts))
        face = Face(args.font)
        save_rgba(f"{args.test}-text.png", draw_test_text(face, args.alphabet, img, ropts))
        return 0

    face = Face(args.font)
    if args.strict:
        pages = load_gray_many(args.img)
        errors: list[tuple[int, str]] = []
    else:
        from focr_jax.io.images import load_gray_many_isolated

        pages, errors = load_gray_many_isolated(args.img)
        for i, err in errors:
            print(f"ERROR {args.img[i]}: {err}", file=sys.stderr)

    from focr_jax.models.focr import decode_pages
    from focr_jax.utils.metrics import metrics_run

    good_idx = [i for i, p in enumerate(pages) if p is not None]
    good_pages = [pages[i] for i in good_idx]

    mesh = None
    if args.mesh == "auto":
        from focr_jax.parallel.mesh import auto_mesh

        mesh = auto_mesh(glyph_shards=args.glyph_shards)

    streamed = len(args.img) == 1 and args.verify is None and bool(good_pages)
    results: list[list] = [[] for _ in pages]
    if streamed:
        # single-image fast path: stream each decoded line to stdout the
        # moment its device results land (main.rs:427-440)
        from focr_jax.models.focr import _cached_decoder, decode_single_stream

        page = good_pages[0]
        dec = _cached_decoder(
            face, args.alphabet, dopts, ropts, page.shape, mesh
        )
        with metrics_run(args.profile) as mrun:
            for line in decode_single_stream(dec, page):
                print(line.text, flush=True)
                results[good_idx[0]].append(line)
    else:
        with metrics_run(args.profile) as mrun:
            good_results = decode_pages(
                good_pages, face, args.alphabet, dopts, ropts,
                batch_size=args.batch_size, mesh=mesh,
            )
        for i, lines in zip(good_idx, good_results):
            results[i] = lines

    if args.verify is not None:
        from focr_jax.io.overlays import draw_verify, red_blue_mse

        for img_path, page, lines in zip(args.img, pages, results):
            if page is None:
                continue
            overlay = draw_verify(page, lines, face, dopts, ropts)
            stem = os.path.splitext(os.path.basename(img_path))[0] + ".png"
            save_rgb(os.path.join(args.verify, stem), overlay)
            diff = red_blue_mse(overlay)
            print(f"{img_path} {diff:.6f}", file=sys.stderr)

    if not streamed:
        out = sys.stdout
        for lines in results:
            for line in lines:
                print(line.text, file=out)

    if args.metrics_json is not None:
        from focr_jax.utils.metrics import write_metrics

        write_metrics(
            args.metrics_json,
            tool="focr",
            pages=len(pages),
            decoded_pages=len(good_idx),
            lines=sum(len(r) for r in results),
            errors=[{"page": args.img[i], "error": e} for i, e in errors],
            decode_seconds=mrun.seconds,
            pages_per_sec=(len(good_idx) / mrun.seconds) if mrun.seconds else None,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
