"""Coverage for the less-common reference configurations: BoxSize.FONT,
--save-letters dumps, kerning scaling (-k), and full hinting — each checked
against the oracle (device results must stay bit-identical under every
config, not just the defaults)."""

import numpy as np
import pytest

from focr_jax.models.types import BoxSize, DecodeOptions, RenderOptions
from focr_jax.fonts.ft import Face, HintingOptions


def test_font_box_matcher_matches_oracle(mono_font_path):
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.ncc import NccMatcher

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=8, line_height=16, line_advance=20, width=110)
    page = synthesize_page(face, ["AB01"], dopts, ropts, "AB01", (70, 128))
    m = NccMatcher(face, "AB01", ropts, box_size=BoxSize.FONT, threshold=0.6)
    hd = m.get_hits(page)
    ho = m.get_hits_oracle(page)
    assert len(hd) > 0
    key = lambda hs: [(h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in hs]
    assert key(hd) == key(ho)


def test_save_letters_dumps(mono_font_path, tmp_path, monkeypatch):
    from focr_jax.cli.ncc import main
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.types import FOCR_DEFAULT_ALPHABET
    from PIL import Image

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    page = synthesize_page(face, ["AB"], dopts, ropts, FOCR_DEFAULT_ALPHABET, (64, 128))
    p = tmp_path / "p.png"
    Image.fromarray(page).save(p)
    monkeypatch.chdir(tmp_path)  # letters/ is written relative to cwd (ncc.rs:642-649)
    rc = main(["-i", str(p), "-f", mono_font_path, "-t", "11", "-a", "AB",
               "--x-bits", "1", "--save-letters"])
    assert rc == 0
    dumps = sorted(f.name for f in (tmp_path / "letters").iterdir())
    # one PNG per (letter, offset): 2 letters x 2 offsets
    assert len(dumps) == 4
    assert any(d.startswith("A-0_0") for d in dumps)
    assert any(d.startswith("A-500_0") for d in dumps)
    # pixel parity: the reference dumps the RAW white-on-black canvas
    # (canvas_to_lum8, ncc.rs:645/917-923 — no inversion)
    from focr_jax.models.ncc import NccMatcher

    matcher = NccMatcher(face, "AB", ropts, x_bits=1)
    for nd in matcher.needles:
        x, y = int(nd.offset[0] * 1000.0), int(nd.offset[1] * 1000.0)
        dumped = np.asarray(Image.open(tmp_path / "letters" / f"{nd.letter}-{x}_{y}.png"))
        assert np.array_equal(dumped, nd.pixels)


@pytest.mark.parametrize("kern", [0.9, 1.5])
def test_kerning_matches_oracle(mono_font_path, kern):
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.focr import GridDecoder
    from focr_jax.oracle.focr_oracle import decode_image

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0, kern_x=kern)
    dopts = DecodeOptions(x_start=4, y_start=5, line_height=13, line_advance=15, width=120)
    page = synthesize_page(face, ["AB01ab"], dopts, ropts, "AB01ab", (60, 140))
    dec = GridDecoder(face, "AB01ab", dopts, ropts, (60, 140))
    got = dec.decode_batch(page[None])[0]
    want = decode_image(page, face, "AB01ab", dopts, ropts)
    assert [(l.text, l.y) for l in got] == [(l.text, l.y) for l in want]


def test_full_hinting_matches_oracle(mono_font_path):
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.focr import GridDecoder
    from focr_jax.oracle.focr_oracle import decode_image

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0, hinting=HintingOptions(full=True, size=11.0))
    dopts = DecodeOptions(x_start=4, y_start=5, line_height=13, line_advance=15, width=120)
    page = synthesize_page(face, ["AB01ab"], dopts, ropts, "AB01ab", (60, 140))
    dec = GridDecoder(face, "AB01ab", dopts, ropts, (60, 140))
    got = dec.decode_batch(page[None])[0]
    want = decode_image(page, face, "AB01ab", dopts, ropts)
    assert got and [(l.text, l.y) for l in got] == [(l.text, l.y) for l in want]


def test_full_hinting_prop_matches_oracle(sans_font_path):
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.focr import GridDecoder
    from focr_jax.oracle.focr_oracle import decode_image

    face = Face(sans_font_path)
    alpha = "AWim01"
    ropts = RenderOptions(size=12.0, hinting=HintingOptions(full=True, size=12.0))
    dopts = DecodeOptions(x_start=4, y_start=5, line_height=16, line_advance=19, width=110)
    page = synthesize_page(face, ["WAim01"], dopts, ropts, alpha, (45, 130))
    dec = GridDecoder(face, alpha, dopts, ropts, (45, 130))
    assert dec.prop_groups
    got = dec.decode_batch(page[None])[0]
    want = decode_image(page, face, alpha, dopts, ropts)
    assert [(l.text, l.y) for l in got] == [(l.text, l.y) for l in want]


def test_f26dot6_ties_away_from_zero():
    """Rust f32::round (font-kit's f32->26.6 conversion) rounds ties AWAY
    from zero; banker's rounding diverges at half-ulp translations and shifts
    rasterization by 1/64 px (e.g. cursor cell 16 of the canonical grid)."""
    from focr_jax.fonts.ft import _to_f26dot6

    assert _to_f26dot6(125.2265625) == 8015  # 8014.5 -> away from zero
    assert _to_f26dot6(0.0078125) == 1  # 0.5 -> 1 (banker's would give 0)
    assert _to_f26dot6(-0.0078125) == -1
    assert _to_f26dot6(0.015625) == 1
    assert _to_f26dot6(3.14) == round(3.14 * 64)  # non-ties unchanged


def test_prop_decoder_tie_rounding_matches_oracle(mono_font_path):
    """Device cursor quantization must round ties away from zero too — the
    monospace DejaVu advance lands exactly on .5/64 boundaries at some cells
    (that is how the divergence was found)."""
    import numpy as np

    from focr_jax.fonts.bank import build_prop_bank
    from focr_jax.fonts.ft import Face
    from focr_jax.models.focr_prop import PropDecoder
    from focr_jax.io.synth import synthesize_page
    from focr_jax.oracle.focr_oracle import decode_image

    # force the sequential path on a MONOSPACE font (advance 7.82617 px at
    # size 13): cell 16 hits tx*64 = .5 exactly
    face = Face(mono_font_path)
    alpha = "AB01ab+/"
    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(x_start=45, y_start=6, line_height=12, line_advance=15, width=200)
    page = synthesize_page(face, ["ABab01+/AB0a1b+/ABAB"], dopts, ropts, alpha, (40, 260))
    bank = build_prop_bank(face, alpha, ropts, 12)
    dec = PropDecoder(bank, 200)
    inv = (255 - page[6:18, 45:245].astype(np.int32)).astype(np.uint8)
    got = dec.decode_lines(inv[None])[0]
    want = decode_image(page, face, alpha, dopts, ropts)[0].text
    assert got == want


def test_wide_needle_overflow_redoes_on_device(mono_font_path, monkeypatch):
    """Needles wider than 16 px overflow-fallback to a device re-dispatch
    (host kernels reject them, like the reference's panic) and stay exact."""
    import numpy as np

    import focr_jax.models.ncc as ncc_mod
    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.ncc import NccMatcher

    monkeypatch.setattr(ncc_mod, "_CAP", 4)  # force overflow
    face = Face(mono_font_path)
    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(x_start=4, y_start=5, line_height=18, line_advance=20, width=140)
    page = synthesize_page(face, ["ABAB", "BABA"], dopts, ropts, "AB", (50, 150))
    m = NccMatcher(face, "AB", ropts, box_size=BoxSize.FONT, threshold=0.3)
    assert all(g.nw > 16 for g in m.groups), "FONT box at 13pt should be wide"
    hits = m.get_hits(page)
    assert len(hits) > 4  # more than the forced cap => the redo path ran
    # device path with a huge cap is the ground truth for wide needles
    monkeypatch.setattr(ncc_mod, "_CAP", 1 << 14)
    m2 = NccMatcher(face, "AB", ropts, box_size=BoxSize.FONT, threshold=0.3)
    want = m2.get_hits(page)
    key = lambda hs: [(h.letter, h.x, h.y, np.float32(h.similarity).tobytes()) for h in hs]
    assert key(hits) == key(want)


def test_low_variance_high_mean_window_not_dropped():
    """A true sim=1.0 match in a near-uniform high-mean window must survive
    the device candidate guard: the denominator must be a certified LOWER
    bound, or f32 rounding of norm2p inflates thr*den past num and drops it
    (execution-confirmed regression)."""
    import jax.numpy as jnp

    from focr_jax.ops import ncc as ncc_ops

    nh, nw = 25, 16
    needle = np.zeros((nh, nw), dtype=np.uint8)
    needle[10, 12] = 128
    inv = np.full((60, 60), 237, dtype=np.uint8)
    inv[20 + 10, 30 + 12] += 1  # exact imprint of the needle's variance
    s_n = needle.astype(np.int64).sum()
    s2 = (needle.astype(np.int64) ** 2).sum()
    idx, acc, sp, s2p, counts = ncc_ops.ncc_candidates(
        jnp.asarray(inv), jnp.asarray(needle[None]),
        jnp.asarray(np.array([s_n])), jnp.asarray(np.array([s2])),
        jnp.asarray(np.float32(0.95)), nw=nw, nh=nh, cap=4096,
    )
    counts = np.asarray(counts)
    assert counts[0] >= 1  # the sim=1.0 window must be a candidate

    # end-to-end: oracle agrees once the exact replay filters
    from focr_jax.models.ncc import exact_similarities

    k = int(counts[0])
    sim = exact_similarities(
        np.asarray(acc)[0, :k], np.asarray(sp)[0, :k], np.asarray(s2p)[0, :k],
        int(s_n), int(s2), nh * nw,
    )
    assert (np.float32(sim) >= np.float32(1.0)).any()


def test_negative_overlap_terminates_and_matches(mono_font_path):
    """--overlap -1 must terminate (each hit its own run) in both pipelines
    (the vectorized one previously looped forever)."""
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.post import process_hits, process_hits_struct

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    page = synthesize_page(face, ["ABAB"], dopts, ropts, "AB", (64, 128))
    m = NccMatcher(face, "AB", ropts, threshold=0.5)
    ho = m.get_hits(page)
    (hs,) = m.get_hits_many([page], struct=True)
    key = lambda lines: [
        [(h.letter, h.x, h.y, np.float32(h.similarity).tobytes()) for h in ln]
        for ln in lines
    ]
    assert key(process_hits_struct(hs, 0.9, -1)) == key(process_hits(ho, 0.9, -1))


def test_empty_row_grid_decodes_to_nothing(mono_font_path):
    """y_start at/past the page bottom: zero lines, no crash (reference row
    loop breaks immediately, main.rs:205-207)."""
    from focr_jax.models.focr import GridDecoder
    from focr_jax.oracle.focr_oracle import decode_image

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=100, line_height=13, line_advance=15, width=110)
    page = np.full((48, 128), 255, dtype=np.uint8)
    dec = GridDecoder(face, "AB01", dopts, ropts, (48, 128))
    assert dec.decode_batch(page[None]) == [[]]
    assert decode_image(page, face, "AB01", dopts, ropts) == []


def test_needle_padding_matches_oracle(mono_font_path):
    """--x-padding/--y-padding enlarge needle canvases (ncc.rs:167); device
    results must stay identical to the oracle with padded needles."""
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.ncc import NccMatcher

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=6, y_start=7, line_height=13, line_advance=16, width=110)
    page = synthesize_page(face, ["AB01"], dopts, ropts, "AB01", (64, 128))
    m = NccMatcher(face, "AB01", ropts, padding=(2, 1), threshold=0.6)
    hd = m.get_hits(page)
    ho = m.get_hits_oracle(page)
    assert len(hd) > 0
    key = lambda hs: [(h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in hs]
    assert key(hd) == key(ho)
    # padding grows the reported rect by 2*pad in each dimension
    m0 = NccMatcher(face, "AB01", ropts, threshold=0.6)
    h0 = m0.get_hits(page)
    assert hd[0].w == h0[0].w + 4 and hd[0].h == h0[0].h + 2


def test_ncc_hinting_matches_oracle(mono_font_path):
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.ncc import NccMatcher

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0, hinting=HintingOptions(full=True, size=11.0))
    dopts = DecodeOptions(x_start=6, y_start=7, line_height=13, line_advance=16, width=110)
    page = synthesize_page(face, ["AB01"], dopts, ropts, "AB01", (64, 128))
    m = NccMatcher(face, "AB01", ropts, threshold=0.6)
    hd = m.get_hits(page)
    ho = m.get_hits_oracle(page)
    assert len(hd) > 0
    key = lambda hs: [(h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in hs]
    assert key(hd) == key(ho)


def test_negative_threshold_matches_oracle(mono_font_path):
    """Negative thresholds are legal (sim spans [-1, 1]); the certified
    denominator bound must flip direction there or anti-correlated
    low-variance windows get dropped (execution-confirmed regression)."""
    from focr_jax.models.ncc import NccMatcher

    rng = np.random.default_rng(1)
    page = np.full((40, 48), 255 - 237, dtype=np.uint8)
    ys = rng.integers(0, 40, 12)
    xs = rng.integers(0, 48, 12)
    page[ys, xs] = np.clip(
        page[ys, xs].astype(int) + rng.integers(-1, 2, 12), 0, 255
    ).astype(np.uint8)
    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    key = lambda hs: [
        (h.letter, h.x, h.y, np.float32(h.similarity).tobytes()) for h in hs
    ]
    m = NccMatcher(face, "il", ropts, box_size=BoxSize.CHAR, threshold=-1.5)
    hd = m.get_hits(page)
    ho = m.get_hits_oracle(page)
    assert key(hd) == key(ho)
