"""Font layer tests: the ctypes FreeType binding and font-kit-equivalent queries."""

import numpy as np
import pytest

from focr_jax.fonts.ft import Canvas, Face, HintingOptions


@pytest.fixture(scope="module")
def mono(mono_font_path):
    return Face(mono_font_path)


def test_metrics(mono):
    m = mono.metrics
    assert m.units_per_em == 2048
    assert m.ascent > 0 > m.descent
    assert m.bounding_box.width > 0


def test_monospace_advances_equal(mono):
    advances = {mono.advance(mono.glyph_for_char(c)) for c in "AZaz09=+/"}
    assert len(advances) == 1


def test_raster_bounds_plausible(mono):
    gid = mono.glyph_for_char("A")
    rb = mono.raster_bounds(gid, 13.0)
    # y-down space: glyph above baseline -> negative y0, y1 ~ 0
    assert rb.y0 < 0 <= rb.y1 + 1
    assert 4 <= rb.width <= 13
    assert 6 <= rb.height <= 14


def test_rasterize_basic(mono):
    gid = mono.glyph_for_char("A")
    c = Canvas(20, 16)
    mono.rasterize_glyph(c, gid, 13.0, (2.0, 12.0))
    assert c.pixels.sum() > 0
    ys, xs = np.nonzero(c.pixels)
    # ink sits above the baseline at y=12, starting near x=2
    assert ys.max() <= 12
    assert xs.min() >= 2


def test_rasterize_fractional_offsets_differ(mono):
    gid = mono.glyph_for_char("o")
    a = Canvas(20, 16)
    b = Canvas(20, 16)
    mono.rasterize_glyph(a, gid, 13.0, (2.0, 12.0))
    mono.rasterize_glyph(b, gid, 13.0, (2.5, 12.0))
    assert not np.array_equal(a.pixels, b.pixels)
    # quantized at 1/64 px: offsets closer than 1/128 round identically
    c = Canvas(20, 16)
    mono.rasterize_glyph(c, gid, 13.0, (2.0 + 1 / 256, 12.0))
    assert np.array_equal(a.pixels, c.pixels)


def test_rasterize_clips_at_canvas_edges(mono):
    gid = mono.glyph_for_char("M")
    c = Canvas(6, 6)
    mono.rasterize_glyph(c, gid, 13.0, (3.0, 5.0))  # extends past right/bottom
    assert c.pixels.shape == (6, 6)
    mono.rasterize_glyph(c, gid, 13.0, (-3.0, 20.0))  # fully off -> no-op ok


def test_hinting_changes_output(mono):
    gid = mono.glyph_for_char("m")
    a = Canvas(20, 16)
    b = Canvas(20, 16)
    mono.rasterize_glyph(a, gid, 13.0, (2.0, 12.0), HintingOptions())
    mono.rasterize_glyph(b, gid, 13.0, (2.0, 12.0), HintingOptions(full=True, size=13.0))
    # hinted and unhinted renders should generally differ at small sizes
    assert a.pixels.sum() > 0 and b.pixels.sum() > 0


def test_advance_px_consistency(mono):
    m = mono.metrics
    gid = mono.glyph_for_char("A")
    adv_px = mono.advance(gid) / m.units_per_em * 13.0
    assert 6.0 < adv_px < 9.0


def test_loads_freetype_from_the_pillow_wheel():
    """Hosts without a system libfreetype load the copy Pillow's wheel ships
    (pillow.libs, no RPATH): the font layer must come up on it alone and
    rasterize."""
    import os
    import subprocess
    import sys

    code = (
        "import ctypes, ctypes.util\n"
        "real = ctypes.CDLL.__init__\n"
        "def init(self, name, *a, **k):\n"
        "    if name in ('libfreetype.so.6', 'libfreetype.so'):\n"
        "        raise OSError(f'{name}: hidden for this test')\n"
        "    real(self, name, *a, **k)\n"
        "ctypes.CDLL.__init__ = init\n"
        "ctypes.util.find_library = lambda name: None\n"
        "from focr_jax.fonts import DEJAVU_MONO\n"
        "from focr_jax.fonts import ft\n"
        "assert 'pillow.libs' in ft._ft._name, ft._ft._name\n"
        "face = ft.Face(DEJAVU_MONO)\n"
        "assert face.glyph_for_char('A') > 0\n"
        "print('vendored OK')\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
        timeout=120, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    if "No module named 'PIL'" in proc.stderr:
        pytest.skip("Pillow not installed")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "vendored OK" in proc.stdout
