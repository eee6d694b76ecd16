"""Randomized differential parity: device engines vs the NumPy oracle on
random pages, random grids, random thresholds and random configurations
(SURVEY.md §4 — the differential-oracle strategy, fuzzed). Any mismatch is a
bit-parity bug by definition, never acceptable noise."""

import numpy as np
import pytest

from focr_jax.fonts.ft import Face
from focr_jax.models.types import BoxSize, DecodeOptions, RenderOptions


def _noisy_text_page(rng, face, ropts, dopts, alphabet, shape):
    """Synthesized text plus salt-and-pepper noise (noise exercises the ε
    guard and tie-break paths much harder than clean renders)."""
    from focr_jax.io.synth import synthesize_page, random_text_lines

    n_lines = int(rng.integers(1, 4))
    n_chars = int(rng.integers(3, 9))
    lines = random_text_lines(rng, alphabet, n_lines, n_chars)
    page = synthesize_page(face, lines, dopts, ropts, alphabet, shape).copy()
    mask = rng.random(page.shape) < 0.02
    page[mask] = rng.integers(0, 256, int(mask.sum()), dtype=np.uint8)
    return page


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_ncc_device_vs_oracle(mono_font_path, seed):
    from focr_jax.models.ncc import NccMatcher

    rng = np.random.default_rng(100 + seed)
    face = Face(mono_font_path)
    size = float(rng.choice([9.0, 11.0, 13.0]))
    ropts = RenderOptions(size=size)
    dopts = DecodeOptions(
        x_start=int(rng.integers(0, 8)),
        y_start=int(rng.integers(0, 8)),
        line_height=int(rng.integers(10, 16)),
        line_advance=int(rng.integers(14, 19)),
        width=int(rng.integers(60, 120)),
    )
    alphabet = "".join(rng.choice(list("ABXab01+/=:"), size=5, replace=False))
    shape = (int(rng.integers(48, 90)), int(rng.integers(90, 150)))
    page = _noisy_text_page(rng, face, ropts, dopts, alphabet, shape)
    threshold = float(rng.uniform(0.3, 0.9))
    box = BoxSize(rng.choice(["font", "alphabet", "char"]))

    m = NccMatcher(
        face, alphabet, ropts, box_size=box,
        x_bits=int(rng.integers(0, 2)), y_bits=int(rng.integers(0, 2)),
        threshold=threshold,
    )
    hd = m.get_hits(page)
    ho = m.get_hits_oracle(page)
    key = lambda hs: [
        (h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in hs
    ]
    assert key(hd) == key(ho), f"seed {seed} box={box} thr={threshold}"

    # and the struct post-processing pipeline must agree with the object one
    from focr_jax.models.post import process_hits, process_hits_struct, process_hits_text

    (struct,) = m.get_hits_many([page], struct=True)
    anchor = float(rng.uniform(threshold, 0.98))
    overlap = int(rng.integers(1, 9))
    a = process_hits_struct(struct, anchor, overlap)
    b = process_hits(ho, anchor, overlap)
    assert [key(ln) for ln in a] == [key(ln) for ln in b]
    # the text fast path prints exactly what the object lines would
    assert process_hits_text(struct, anchor, overlap) == [
        "".join(h.letter for h in ln) for ln in b
    ]


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_focr_device_vs_oracle(mono_font_path, sans_font_path, seed):
    from focr_jax.models.focr import GridDecoder
    from focr_jax.oracle.focr_oracle import decode_image

    rng = np.random.default_rng(200 + seed)
    font = mono_font_path if seed % 2 == 0 else sans_font_path
    face = Face(font)
    ropts = RenderOptions(
        size=float(rng.choice([10.0, 12.0])),
        kern_x=float(rng.choice([1.0, 1.0, 1.2])),
    )
    dopts = DecodeOptions(
        x_start=int(rng.integers(0, 6)),
        y_start=int(rng.integers(0, 6)),
        line_height=int(rng.integers(11, 16)),
        line_advance=int(rng.integers(13, 18)),
        width=int(rng.integers(50, 110)),
    )
    alphabet = "ABab01" if seed % 2 == 0 else "AWim01"
    shape = (int(rng.integers(40, 70)), int(rng.integers(80, 130)))
    page = _noisy_text_page(rng, face, ropts, dopts, alphabet, shape)

    dec = GridDecoder(face, alphabet, dopts, ropts, shape)
    got = dec.decode_batch(page[None])[0]
    want = decode_image(page, face, alphabet, dopts, ropts)
    assert [(l.text, l.y) for l in got] == [(l.text, l.y) for l in want], f"seed {seed}"


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_adversarial_low_variance(mono_font_path, seed):
    """High-mean, near-uniform pages with tiny perturbations — the regime
    where f32 variance rounding is most dangerous for the candidate guards.
    The device path must stay hit-for-hit identical to the oracle."""
    from focr_jax.models.ncc import NccMatcher

    rng = np.random.default_rng(300 + seed)
    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    # page: dark near-uniform background (inverted ~230-245) + sparse deltas
    H, W = 56, 96
    page = np.full((H, W), 255 - int(rng.integers(230, 246)), dtype=np.uint8)
    n_spots = int(rng.integers(5, 30))
    ys = rng.integers(0, H, n_spots)
    xs = rng.integers(0, W, n_spots)
    page[ys, xs] = np.clip(
        page[ys, xs].astype(int) + rng.integers(-3, 4, n_spots), 0, 255
    ).astype(np.uint8)
    threshold = float(rng.uniform(0.2, 0.9))
    m = NccMatcher(face, "il.", ropts, box_size=BoxSize.CHAR, threshold=threshold)
    hd = m.get_hits(page)
    ho = m.get_hits_oracle(page)
    key = lambda hs: [
        (h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in hs
    ]
    assert key(hd) == key(ho), f"seed {seed} thr={threshold}"
