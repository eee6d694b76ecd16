"""Proportional-font sequential decoder tests: the lax.scan device path
(models/focr_prop.py) must be char-for-char identical to the host oracle,
which in turn encodes the reference's greedy semantics (main.rs:112-181)."""

import numpy as np
import pytest

from focr_jax.models.types import DecodeOptions, RenderOptions


ALPHA = "AWijm01.:| "  # deliberately wide advance spread (proportional)


@pytest.fixture(scope="module")
def prop_setup(sans_font_path):
    from focr_jax.fonts.bank import is_monospace
    from focr_jax.fonts.ft import Face

    face = Face(sans_font_path)
    ropts = RenderOptions(size=12.0)
    assert not is_monospace(face, ALPHA, ropts)
    return face, ropts


def test_prop_bank_phase_exactness(prop_setup):
    """templates[g, p] must equal a fresh rasterization at any cursor t with
    round(t*64) % 64 == p, shifted by round(t*64)//64 — the shift-equivariance
    the whole design rests on."""
    from focr_jax.fonts.bank import build_prop_bank
    from focr_jax.fonts.ft import Canvas

    face, ropts = prop_setup
    bank = build_prop_bank(face, ALPHA, ropts, 16)
    g = face.glyph_for_char("W")
    gi = ALPHA.index("W")
    for t in (3.140625, 7.0, 10.984375):  # exact 1/64 multiples
        t64 = round(t * 64)
        k, p = t64 // 64, t64 % 64
        canvas = Canvas(bank.wbank + k + 4, 16)
        face.rasterize_glyph(canvas, g, ropts.size, (bank.base + t, float(bank.oy)), ropts.hinting)
        fresh = canvas.pixels
        tmpl = bank.templates[gi, p]
        shifted = np.zeros_like(fresh)
        shifted[:, k : k + bank.wbank] = tmpl
        np.testing.assert_array_equal(fresh, shifted)


def test_prop_decode_matches_oracle(prop_setup):
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.focr import GridDecoder
    from focr_jax.oracle.focr_oracle import decode_image

    face, ropts = prop_setup
    dopts = DecodeOptions(x_start=4, y_start=5, line_height=16, line_advance=19, width=150)
    rng = np.random.default_rng(3)
    pages = []
    for i in range(3):
        lines = ["".join(rng.choice(list(ALPHA.strip()), size=8)) for _ in range(3)]
        pages.append(
            synthesize_page(face, lines, dopts, ropts, ALPHA, (70, 170),
                            blank_rows={1} if i == 1 else None)
        )
    pages = np.stack(pages)

    dec = GridDecoder(face, ALPHA, dopts, ropts, (70, 170))
    assert not dec.monospace and dec.prop_groups
    got = dec.decode_batch(pages)
    for p, lines in zip(pages, got):
        want = decode_image(p, face, ALPHA, dopts, ropts)
        assert [(l.text, l.y) for l in lines] == [(l.text, l.y) for l in want]


def test_prop_edge_clipping_matches_oracle(prop_setup):
    """Narrow crop: glyph ink hangs past the right canvas edge, exercising the
    clipped-||T||^2 cumsum path against the oracle's canvas clipping."""
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.focr import GridDecoder
    from focr_jax.oracle.focr_oracle import decode_image

    face, ropts = prop_setup
    dopts = DecodeOptions(x_start=2, y_start=3, line_height=16, line_advance=18, width=33)
    page = synthesize_page(face, ["WWmW", "ij.5"], dopts, ropts, ALPHA, (45, 40))
    dec = GridDecoder(face, ALPHA, dopts, ropts, (45, 40))
    got = dec.decode_batch(page[None])[0]
    want = decode_image(page, face, ALPHA, dopts, ropts)
    assert [(l.text, l.y) for l in got] == [(l.text, l.y) for l in want]


def test_prop_decode_via_decode_pages(prop_setup):
    """decode_pages routes proportional fonts through the device scan path."""
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.focr import decode_pages
    from focr_jax.oracle.focr_oracle import decode_image

    face, ropts = prop_setup
    dopts = DecodeOptions(x_start=4, y_start=5, line_height=16, line_advance=19, width=120)
    page = synthesize_page(face, ["Wi0m1j"], dopts, ropts, ALPHA, (40, 140))
    got = decode_pages([page], face, ALPHA, dopts, ropts)[0]
    want = decode_image(page, face, ALPHA, dopts, ropts)
    assert [(l.text, l.y) for l in got] == [(l.text, l.y) for l in want]


def test_prop_guess_miss_refetches_full_buffer(prop_setup):
    """A batch whose lines outgrow every previously observed one must decode
    correctly through the full-buffer refetch (a stable shape — the miss path
    must never compile a fresh remainder slice mid-corpus), and the fetch
    guess must stay on the power-of-two chunk ladder the decoder pre-compiles
    at first use."""
    from focr_jax.fonts.bank import build_prop_bank
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.focr_prop import _CHUNK, PropDecoder
    from focr_jax.oracle.focr_oracle import decode_image

    face, ropts = prop_setup
    crop_w = 240
    dopts = DecodeOptions(x_start=4, y_start=5, line_height=16, line_advance=19,
                          width=crop_w)
    bank = build_prop_bank(face, ALPHA, ropts, 16)
    dec = PropDecoder(bank, crop_w)
    total = dec._n_chunks * _CHUNK

    def run(text):
        page = synthesize_page(face, [text], dopts, ropts, ALPHA, (50, 260))
        inv = (255 - page[5:21, 4:4 + crop_w].astype(np.int32)).astype(np.uint8)
        got = dec.decode_lines(inv[None])[0]
        want = decode_image(page, face, ALPHA, dopts, ropts)[0].text
        assert got == want
        g = dec._guess
        c = g // _CHUNK
        assert g == total or (g % _CHUNK == 0 and (c & (c - 1)) == 0)
        return got

    run("W" * 20)  # wide glyphs: few cursor steps, guess shrinks
    g0 = dec._guess
    assert g0 < total, "guess did not shrink; widen the advance spread"
    long_got = run("i" * 70)  # narrow glyphs: more steps than the guess
    assert len(long_got) >= g0, "long line did not exceed the guess (miss path untested)"


def test_host_oracle_decode_is_counted(prop_setup, monkeypatch):
    """A face whose metrics the device decoder cannot take (non-positive
    advance: build_prop_bank raises ValueError) decodes on the host oracle;
    every such page is counted in GridDecoder.n_host_pages, and a device
    decode counts none."""
    import focr_jax.fonts.bank as bank_mod
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.focr import GridDecoder
    from focr_jax.oracle.focr_oracle import decode_image

    face, ropts = prop_setup
    dopts = DecodeOptions(x_start=4, y_start=5, line_height=16, line_advance=19, width=110)
    shape = (65, 130)
    pages = np.stack([
        synthesize_page(face, [t], dopts, ropts, ALPHA, shape) for t in ("AWij01", "10jiWA")
    ])
    device = GridDecoder(face, ALPHA, dopts, ropts, shape)
    want = device.decode_batch(pages)
    assert device.prop_groups and device.n_host_pages == 0

    def degenerate(*a, **k):
        raise ValueError("non-positive glyph advance")

    monkeypatch.setattr(bank_mod, "build_prop_bank", degenerate)
    host = GridDecoder(face, ALPHA, dopts, ropts, shape)
    assert not host.prop_groups
    got = host.decode_batch(pages)
    assert host.n_host_pages == len(pages)
    key = lambda res: [[(l.text, l.y) for l in p] for p in res]
    assert key(got) == key(want) == key([decode_image(p, face, ALPHA, dopts, ropts) for p in pages])
