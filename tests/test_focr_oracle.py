"""Golden round-trip: synthesized pages decode to their exact source text."""

import numpy as np
import pytest

from focr_jax.fonts.ft import Face
from focr_jax.io.synth import synthesize_page
from focr_jax.models.types import DecodeOptions, FOCR_DEFAULT_ALPHABET, RenderOptions
from focr_jax.oracle.focr_oracle import advance_px, decode_image


@pytest.fixture(scope="module")
def mono(mono_font_path):
    return Face(mono_font_path)


def width_for_cells(face: Face, ropts: RenderOptions, n_cells: int) -> int:
    """Pick a scan width giving exactly n_cells greedy cursor steps."""
    adv = advance_px(face, face.glyph_for_char("A"), ropts)
    pos = np.float32(0.0)
    positions = [pos]
    for _ in range(n_cells):
        pos = pos + adv
        positions.append(pos)
    # need pos_{n-1} < w <= pos_n
    return int(np.floor(positions[n_cells]))


def test_round_trip_exact(mono):
    ropts = RenderOptions(size=13.0)
    alphabet = FOCR_DEFAULT_ALPHABET
    n_chars = 8
    dopts = DecodeOptions(
        x_start=10, y_start=9, line_height=12, line_advance=15,
        width=width_for_cells(mono, ropts, n_chars),
    )
    lines = ["AbzQ+/09", "> =hello", "XYZwvu42"]
    page = synthesize_page(
        mono, lines, dopts, ropts, alphabet, page_shape=(80, 120), blank_rows={1}
    )
    decoded = decode_image(page, mono, alphabet, dopts, ropts)
    assert [d.text for d in decoded] == lines
    # blank row 1 skipped: line y's are rows 0, 2, 3
    assert [d.y for d in decoded] == [9, 9 + 30, 9 + 45]


def test_white_page_decodes_empty(mono):
    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(x_start=0, y_start=0, line_height=12, line_advance=15, width=40)
    page = np.full((60, 60), 255, dtype=np.uint8)
    assert decode_image(page, mono, FOCR_DEFAULT_ALPHABET, dopts, ropts) == []
