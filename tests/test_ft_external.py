"""External (non-self) validation of the font layer (VERDICT r2 next #2).

Every other font test in the repo ultimately trusts fonts/ft.py — the golden
fixtures were generated by the same Face code, so a systematic semantic drift
(wrong ctypes struct field, wrong unit, wrong load flag) would be invisible
to them. These tests pin the font layer against TWO implementations the
builder did not write:

  * fontTools — a pure-Python TTF/CFF table parser with zero FreeType code:
    validates the metric/advance/bounds queries (the font-kit Loader surface,
    reference main.rs:49-67) against the raw font tables.
  * PIL/Pillow's ImageFont — a separate C binding to FreeType with its own
    struct declarations and glyph pipeline: validates that rasterize_glyph's
    bitmaps are byte-identical through an independent call path
    (reference main.rs:73-83).
"""

import numpy as np
import pytest

from focr_jax.fonts.ft import Canvas, Face, HintingOptions
from focr_jax.models.types import FOCR_DEFAULT_ALPHABET, NCC_DEFAULT_ALPHABET

from tests.ft_golden_common import CHARS, available_fonts

fontTools = pytest.importorskip("fontTools.ttLib")

# broad char coverage: both default alphabets + the golden matrix chars
ALL_CHARS = sorted(set(FOCR_DEFAULT_ALPHABET + NCC_DEFAULT_ALPHABET + CHARS + "BC"))


def _tt(path):
    return fontTools.TTFont(path, fontNumber=0)


@pytest.mark.parametrize("font_key", sorted(available_fonts()))
def test_metrics_match_fonttools(font_key):
    """Face.metrics vs the head/hhea/OS2 tables read by fontTools.

    FreeType's SFNT rule: ascender/descender/height come from hhea, unless
    OS/2 fsSelection bit 7 (USE_TYPO_METRICS) is set, in which case the OS/2
    sTypo* values win (FreeType sfobjs.c; observed on PyGameMono.otf)."""
    path = available_fonts()[font_key]
    face = Face(path)
    tt = _tt(path)
    m = face.metrics
    head = tt["head"]
    hhea = tt["hhea"]
    assert m.units_per_em == head.unitsPerEm
    use_typo = "OS/2" in tt and bool(tt["OS/2"].fsSelection & 0x80)
    if use_typo:
        os2 = tt["OS/2"]
        want_asc, want_desc = os2.sTypoAscender, os2.sTypoDescender
        want_gap = os2.sTypoLineGap
    else:
        want_asc, want_desc, want_gap = hhea.ascent, hhea.descent, hhea.lineGap
    assert m.ascent == want_asc
    assert m.descent == want_desc
    assert m.line_gap == want_gap
    bb = m.bounding_box
    assert (bb.x0, bb.y0, bb.x1, bb.y1) == (
        head.xMin, head.yMin, head.xMax, head.yMax,
    )


@pytest.mark.parametrize("font_key", sorted(available_fonts()))
def test_glyph_queries_match_fonttools(font_key):
    """glyph_for_char / advance / typographic_bounds vs fontTools' cmap,
    hmtx, and outline tables for every alphabet character.

    typographic_bounds is FT's unscaled glyph metrics = the outline control
    box: the stored glyf header bounds for TrueType, the charstring control
    bounds (ControlBoundsPen) for CFF."""
    path = available_fonts()[font_key]
    face = Face(path)
    tt = _tt(path)
    cmap = tt.getBestCmap()
    hmtx = tt["hmtx"]
    glyf = tt["glyf"] if "glyf" in tt else None
    glyph_set = tt.getGlyphSet() if glyf is None else None
    checked = 0
    for ch in ALL_CHARS:
        gid = face.glyph_for_char(ch)
        name = cmap.get(ord(ch))
        if name is None:
            assert gid == 0, f"{ch!r}: unmapped char must resolve to .notdef"
            continue
        assert gid == tt.getGlyphID(name), f"{ch!r}: glyph id"
        adv_want, _lsb = hmtx[name]
        assert face.advance(gid) == adv_want, f"{ch!r}: advance"
        tb = face.typographic_bounds(gid)
        got = (tb.x0, tb.y0, tb.x1, tb.y1)
        if glyf is not None:
            g = glyf[name]
            if g.numberOfContours == 0:
                want = (0.0, 0.0, 0.0, 0.0)
            else:
                want = (float(g.xMin), float(g.yMin), float(g.xMax), float(g.yMax))
        else:
            from fontTools.pens.boundsPen import ControlBoundsPen

            pen = ControlBoundsPen(glyph_set)
            glyph_set[name].draw(pen)
            want = (
                (0.0, 0.0, 0.0, 0.0)
                if pen.bounds is None
                else tuple(float(round(v)) for v in pen.bounds)
            )
        assert got == want, f"{ch!r}: typographic_bounds {got} != {want}"
        checked += 1
    assert checked >= 3, "matrix degenerated: almost nothing was compared"


@pytest.mark.parametrize("size", [8, 13, 20])
def test_rasterization_matches_pil(mono_font_path, size):
    """Hinted glyph bitmaps must be BYTE-identical to PIL's ImageFont render
    of the same glyph — same system FreeType, completely independent C
    binding and canvas pipeline (catches ABI-struct or flag drift in the
    ctypes layer). Ink-cropped comparison: the two canvases differ only in
    padding placement."""
    face = Face(mono_font_path)
    from PIL import ImageFont

    pil = ImageFont.truetype(mono_font_path, size)
    hint = HintingOptions(full=True, size=float(size))
    compared = 0
    for ch in "AQgj0=/.":
        gid = face.glyph_for_char(ch)
        rb = face.raster_bounds(gid, float(size), (0.0, 0.0), hint)
        canvas = Canvas(max(rb.width, 1) + 8, max(rb.height, 1) + 8)
        face.rasterize_glyph(canvas, gid, float(size), (4 - rb.x0, 4 - rb.y0), hint)
        ours = canvas.pixels
        oy, ox = np.nonzero(ours)
        mask, _off = pil.getmask2(ch, mode="L")
        arr = np.asarray(mask, dtype=np.uint8).reshape(mask.size[1], mask.size[0])
        py, px = np.nonzero(arr)
        assert (len(oy) > 0) == (len(py) > 0), f"{ch!r}: ink presence differs"
        if not len(oy):
            continue
        ours_crop = ours[oy.min() : oy.max() + 1, ox.min() : ox.max() + 1]
        pil_crop = arr[py.min() : py.max() + 1, px.min() : px.max() + 1]
        assert ours_crop.shape == pil_crop.shape, f"{ch!r}: ink shape"
        np.testing.assert_array_equal(ours_crop, pil_crop, err_msg=f"{ch!r}")
        compared += 1
    assert compared >= 6
