"""Sustained-throughput soak (not collected by pytest).

Pushes a large FRESH-content corpus through both engines on the default
backend and reports steady-state throughput:

  - focr: N distinct synthesized pages through the batched grid pipeline;
    decoded text must equal the synthesized truth exactly (the grid decoder
    is exact on clean renders).
  - ncc: M dense pages (x-bits 2) through the fused pipeline; each truth
    line must appear up to the reference's duplicate-char semantics
    (subpixel hits > overlap px apart survive the run-anchored dedup, so
    '===' can decode as '====' — see tests/test_ncc_engine.py::
    test_subpixel_duplicate_chars_are_reference_semantics). Engine-vs-truth
    is only a smoke check here; bit parity is established by
    tools/fuzz_soak.py and the test suite's differential fuzz.

Usage: python tools/soak.py [n_focr_pages=256] [n_ncc_pages=64]

Warmup (compile + first uploads) is excluded from the timed region.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

ALPHA = "> =ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/"


def main() -> int:
    from focr_jax.fonts import DEJAVU_MONO
    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import random_text_lines, synthesize_page
    from focr_jax.models.focr import GridDecoder, decode_stream
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.post import line_matches_truth, process_hits_text
    from focr_jax.models.types import (
        DecodeOptions,
        NCC_DEFAULT_ALPHABET,
        RenderOptions,
    )

    n_focr = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    n_ncc = int(sys.argv[2]) if len(sys.argv) > 2 else 64

    face = Face(DEJAVU_MONO)
    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(
        x_start=45, y_start=39, line_height=12, line_advance=15, width=608
    )
    shape = (792, 662)
    rng = np.random.default_rng(616)
    talpha = ALPHA.replace(" ", "A").replace(">", "B")

    truths = [random_text_lines(rng, talpha, 48, 77) for _ in range(n_focr)]
    pages = np.stack(
        [synthesize_page(face, t, dopts, ropts, ALPHA, shape) for t in truths]
    )
    dec = GridDecoder(face, ALPHA, dopts, ropts, shape)
    # warmup on SEPARATE pages, so the timed run sees only fresh content
    warm = np.stack([
        synthesize_page(face, random_text_lines(rng, talpha, 48, 77),
                        dopts, ropts, ALPHA, shape)
        for _ in range(32)
    ])
    for _ in decode_stream(dec, warm, 32):
        pass
    t0 = time.perf_counter()
    out = []
    for _, decoded in decode_stream(dec, pages, 32):
        out.extend(decoded)
    dt = time.perf_counter() - t0
    bad = sum(
        1
        for t, lines in zip(truths, out)
        if [ln.text.rstrip() for ln in lines][: len(t)] != [ln.rstrip() for ln in t]
    )
    print(
        f"focr soak: {n_focr} fresh pages in {dt:.2f}s = {n_focr/dt:.1f} pages/s, "
        f"{bad} mismatches",
        flush=True,
    )
    rc = 1 if bad else 0

    nt = [random_text_lines(rng, NCC_DEFAULT_ALPHABET, 48, 77) for _ in range(n_ncc)]
    npages = [
        synthesize_page(face, t, dopts, ropts, NCC_DEFAULT_ALPHABET, shape)
        for t in nt
    ]
    matcher = NccMatcher(face, NCC_DEFAULT_ALPHABET, ropts, x_bits=2)
    post = lambda hs: process_hits_text(hs, 0.95, 5)
    nwarm = [
        synthesize_page(face, random_text_lines(rng, NCC_DEFAULT_ALPHABET, 48, 77),
                        dopts, ropts, NCC_DEFAULT_ALPHABET, shape)
        for _ in range(4)
    ]
    matcher.get_hits_many(nwarm, struct=True, post=post)  # warmup, fresh pages
    t0 = time.perf_counter()
    texts = matcher.get_hits_many(npages, struct=True, post=post)
    dt = time.perf_counter() - t0
    bad = sum(
        1
        for t, got in zip(nt, texts)
        if any(not any(line_matches_truth(g, ln) for g in got) for ln in t)
    )
    print(
        f"ncc soak: {n_ncc} pages in {dt:.2f}s = {dt/n_ncc*1e3:.1f} ms/page, "
        f"{bad} pages with unmatched truth lines",
        flush=True,
    )
    rc |= 1 if bad else 0
    print("SOAK OK" if rc == 0 else "SOAK FAILED", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
