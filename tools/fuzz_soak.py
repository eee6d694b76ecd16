"""Long-horizon differential fuzz soak (not collected by pytest).

Runs random (font-size, grid, alphabet, noise, threshold, box-size)
configurations for a time budget, asserting on each one that
  - ncc device-tier hits == NumPy-oracle hits, bit for bit,
  - the struct/text post-processing pipelines == the object pipeline, and
  - (every 3rd config) the focr grid decode == the focr NumPy oracle.
Any mismatch is a bit-parity bug by definition (CLAUDE.md invariant).

Usage: python tools/fuzz_soak.py [seconds=3600]
Prints progress every 25 configs; exit code 1 on any failure.

Wide needles (>16 px) are skipped: the oracle raises there exactly like the
reference's panic (ncc.rs:392) while the device tier re-dispatches, so there
is no oracle to differ against.
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from focr_jax.fonts import DEJAVU_MONO as FONT
from focr_jax.fonts.ft import Face
from focr_jax.io.synth import random_text_lines, synthesize_page
from focr_jax.models.ncc import NccMatcher
from focr_jax.models.post import process_hits, process_hits_struct, process_hits_text
from focr_jax.models.types import BoxSize, DecodeOptions, RenderOptions


def main() -> int:
    face = Face(FONT)
    budget = float(sys.argv[1]) if len(sys.argv) > 1 else 3600.0
    t_end = time.time() + budget
    seed = 10_000
    ran = fails = 0
    while time.time() < t_end:
        seed += 1
        rng = np.random.default_rng(seed)
        ropts = RenderOptions(size=float(rng.choice([9.0, 11.0, 13.0, 15.0])))
        # every 3rd config places the text block deep inside a larger page
        # so the ink-bbox crop ENGAGES (nonzero origin, dims < page) and its
        # position remapping is differentially fuzzed, not just unit-tested
        interior = seed % 3 == 1
        dopts = DecodeOptions(
            x_start=int(rng.integers(40, 90)) if interior else int(rng.integers(0, 8)),
            y_start=int(rng.integers(40, 90)) if interior else int(rng.integers(0, 8)),
            line_height=int(rng.integers(10, 18)),
            line_advance=int(rng.integers(14, 21)),
            width=int(rng.integers(60, 140)),
        )
        alphabet = "".join(
            rng.choice(list("ABXYabxy01=+/:;(){}<>-"),
                       size=int(rng.integers(4, 9)), replace=False)
        )
        shape = (
            (int(rng.integers(160, 260)), int(rng.integers(200, 320)))
            if interior
            else (int(rng.integers(48, 110)), int(rng.integers(90, 180)))
        )
        lines = random_text_lines(
            rng, alphabet, int(rng.integers(1, 5)), int(rng.integers(3, 12))
        )
        page = synthesize_page(face, lines, dopts, ropts, alphabet, shape).copy()
        mask = rng.random(page.shape) < float(rng.choice([0.0, 0.02, 0.08]))
        page[mask] = rng.integers(0, 256, int(mask.sum()), dtype=np.uint8)
        threshold = float(rng.uniform(0.25, 0.9))
        m = NccMatcher(
            face, alphabet, ropts,
            box_size=BoxSize(rng.choice(["font", "alphabet", "char"])),
            x_bits=int(rng.integers(0, 3)), y_bits=int(rng.integers(0, 2)),
            threshold=threshold,
            padding=(int(rng.integers(0, 2)), int(rng.integers(0, 2))),
        )
        if any(nd.pixels.shape[1] > 16 for nd in m.needles):
            continue
        ran += 1
        try:
            hd = m.get_hits(page)
            ho = m.get_hits_oracle(page)
            key = lambda hs: [
                (h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes())
                for h in hs
            ]
            assert key(hd) == key(ho), "hit mismatch"
            (struct,) = m.get_hits_many([page], struct=True)
            anchor = float(rng.uniform(threshold, 0.99))
            overlap = int(rng.integers(0, 10))
            a = process_hits_struct(struct, anchor, overlap)
            b = process_hits(ho, anchor, overlap)
            assert [key(ln) for ln in a] == [key(ln) for ln in b], "post mismatch"
            assert process_hits_text(struct, anchor, overlap) == [
                "".join(h.letter for h in ln) for ln in b
            ], "text mismatch"
            # focr grid decode on the same page vs its oracle (every 3rd
            # config: the focr oracle is the slow part)
            if seed % 3 == 0:
                from focr_jax.models.focr import GridDecoder
                from focr_jax.oracle.focr_oracle import decode_image

                fo = RenderOptions(
                    size=ropts.size, kern_x=float(rng.choice([1.0, 1.0, 1.15]))
                )
                dec = GridDecoder(face, alphabet, dopts, fo, page.shape)
                got = dec.decode_batch(page[None])[0]
                want = decode_image(page, face, alphabet, dopts, fo)
                assert [(l.text, l.y) for l in got] == [
                    (l.text, l.y) for l in want
                ], "focr mismatch"
        except Exception as e:  # noqa: BLE001 - crash-class bugs are exactly
            # what a long fuzz exists to find: record the seed and keep going
            # instead of losing the remaining budget to one traceback
            import traceback

            fails += 1
            print(f"SEED {seed} FAIL ({type(e).__name__}): {e}", flush=True)
            traceback.print_exc()
        if ran % 25 == 0:
            print(f"... {ran} configs, {fails} failures", flush=True)
        if ran % 10 == 0:
            # every config compiles fresh XLA programs; without this the
            # accumulated jit caches exhaust host memory (observed: LLVM
            # 'Cannot allocate memory' after ~1h on a 16GB host)
            jax.clear_caches()
    print(f"DONE: {ran} configs, {fails} failures", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
