"""Font-layer hardening beyond the self-oracle (VERDICT r1 item 2).

Two independent checks:

1. Frozen goldens: live renders must byte-match tests/fixtures/ft_goldens.npz
   across fonts (TTF + CFF/OTF), sizes, hinting none/full, and fractional
   offsets — catches any drift in load flags, bounds rounding
   (main.rs:59-67), or rasterization placement (main.rs:73-83).

2. Ink-extents property: for UNHINTED rendering, font-kit's raster_bounds
   (round_out of the scaled metrics bbox) must bound the actual antialiased
   ink almost exactly — thousands of random (glyph, size, offset) samples,
   slack pinned to [-1, 1] px per side with the overwhelming mass at 0.
   Hinted rendering legitimately spills (grid-fitting moves outlines after
   the metrics are read — same estimate semantics as font-kit), so the
   property is asserted for the unhinted mode the reference defaults to
   (main.rs:394-398).
"""

from __future__ import annotations

import json
import os
import string
import zlib

import numpy as np
import pytest

from focr_jax.fonts.ft import Canvas, Face, HintingOptions
from tests.ft_golden_common import (
    FONTS, available_fonts, entry_key, iter_matrix, render_entry,
)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "ft_goldens.npz")


@pytest.fixture(scope="module")
def goldens():
    data = np.load(FIXTURE)
    keys = json.loads(str(data["keys"]))
    return {
        k: i for i, k in enumerate(keys)
    }, data


def test_goldens_cover_matrix(goldens):
    index, _ = goldens
    fonts = available_fonts()
    expected = sum(
        1 for font_key, *_ in iter_matrix() if font_key in fonts
    )
    assert len(index) == expected and expected >= 480


def test_golden_parity(goldens):
    """Every frozen entry must reproduce exactly: gid, advance, typographic
    bounds, raster bounds, and the full bitmap bytes."""
    index, data = goldens
    faces = {k: Face(p) for k, p in available_fonts().items()}
    blob, off = data["blob"], data["blob_off"]
    checked = 0
    for font_key, _path, size, hint, offset, ch in iter_matrix():
        face = faces.get(font_key)
        key = entry_key(font_key, size, hint, offset, ch)
        if face is None:
            continue
        assert key in index, f"fixture missing {key} — regenerate gen_ft_goldens.py"
        i = index[key]
        e = render_entry(face, size, hint, offset, ch)
        assert int(data["gid"][i]) == int(e["gid"]), key
        assert float(data["advance"][i]) == float(e["advance"]), key
        assert np.array_equal(data["typo"][i], e["typo"]), key
        assert np.array_equal(data["bounds"][i], e["bounds"]), key
        want = blob[off[i] : off[i + 1]].reshape(data["shape"][i])
        assert np.array_equal(want, e["bitmap"]), f"bitmap drift at {key}"
        checked += 1
    assert checked == len(index)


@pytest.mark.parametrize("font_key", sorted(FONTS))
def test_raster_bounds_match_ink_extents(font_key):
    """Property: unhinted raster_bounds == actual ink bbox within 1px/side,
    across ~1200 random (glyph, size, offset) samples per font."""
    path = FONTS[font_key]
    if not os.path.exists(path):
        pytest.skip(f"{path} not in image")
    face = Face(path)
    chars = [c for c in string.printable if not c.isspace()]
    covered = sum(1 for c in chars if face.glyph_for_char(c) != 0)
    # stable seed: hash() is salted per process (PYTHONHASHSEED), which made
    # the sample-count floor below flaky across runs
    rng = np.random.default_rng(zlib.crc32(font_key.encode()))
    h = HintingOptions()
    sides = np.zeros(0, dtype=np.int64)
    M = 40
    # TARGET 3000 samples for every font (the 95%-tight assertion below needs
    # a real sample size); sparse fonts (PyGameMono covers ~6 printable
    # chars) may exhaust the attempt cap first, so the hard assertion FLOOR
    # scales with coverage. The loop is cheap (~ms per sample).
    floor = 3000 if covered >= 30 else 120
    attempts = 0
    while len(sides) < 3000 and attempts < 20000:
        attempts += 1
        ch = chars[int(rng.integers(len(chars)))]
        gid = face.glyph_for_char(ch)
        if gid == 0:
            continue
        size = float(rng.uniform(6.0, 24.0))
        off = (float(rng.uniform(0, 1)), float(rng.uniform(0, 1)))
        rb = face.raster_bounds(gid, size, off, h)
        if rb.width <= 0 or rb.height <= 0:
            continue
        cv = Canvas(rb.width + 2 * M, rb.height + 2 * M)
        face.rasterize_glyph(cv, gid, size, (M - rb.x0 + off[0], M - rb.y0 + off[1]), h)
        nz = np.nonzero(cv.pixels)
        if len(nz[0]) == 0:
            continue
        y0, y1 = nz[0].min(), nz[0].max() + 1
        x0, x1 = nz[1].min(), nz[1].max() + 1
        slack = np.array(
            [x0 - M, y0 - M, (M + rb.width) - x1, (M + rb.height) - y1], dtype=np.int64
        )
        assert slack.min() >= -1 and slack.max() <= 1, (
            f"raster_bounds drift: {font_key} {ch!r} size={size:.3f} off={off} slack={slack}"
        )
        sides = np.concatenate([sides, slack])
    # enough non-empty samples to be meaningful (PyGameMono covers only a
    # handful of printable chars, so scale the floor to the font's coverage)
    assert len(sides) >= floor
    # bounds must be TIGHT, not merely containing: the mass sits at exactly 0
    assert (sides == 0).mean() > 0.95, f"loose bounds: {np.bincount(sides + 1)}"
