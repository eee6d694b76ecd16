"""Differential tests: native C++ NCC kernel vs the NumPy oracle.

The reference validates its AVX2 kernel by flag-switching against a pure-Rust
implementation on real data (ncc.rs:651-655); here every match (coords and
f32 similarity bits) must be identical between the C++ kernel and the oracle,
on random noise, rendered glyphs, and capacity-overflow inputs.
"""

import numpy as np
import pytest

from focr_jax.models.types import MAX_MATCHES, RenderOptions, BoxSize
from focr_jax.oracle.ncc_oracle import Searcher

native = pytest.importorskip("focr_jax.native.ncc_cpu")
if not native.available():
    pytest.skip("native toolchain unavailable", allow_module_level=True)


def _assert_same(a, b):
    assert len(a) == len(b)
    for ma, mb in zip(a, b):
        assert (ma.x, ma.y, ma.w, ma.h) == (mb.x, mb.y, mb.w, mb.h)
        assert np.float32(ma.similarity).tobytes() == np.float32(mb.similarity).tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("nw,nh", [(5, 7), (8, 8), (13, 9), (16, 4)])
def test_native_matches_oracle_random(seed, nw, nh):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (64, 96), dtype=np.uint8)
    # plant the needle a few times so high-sim hits exist
    needle = rng.integers(0, 256, (nh, nw), dtype=np.uint8)
    for (x, y) in [(5, 9), (40, 30), (70, 50)]:
        img[y : y + nh, x : x + nw] = 255 - needle
    o = Searcher(img)
    n = native.NativeSearcher(img)
    for thr in (0.5, 0.8, 0.95):
        _assert_same(n.search(needle, thr, warn=False), o.search(needle, thr, warn=False))


def test_native_matches_oracle_glyphs(mono_font_path):
    from focr_jax.fonts.ft import Face
    from focr_jax.fonts.bank import build_needles
    from focr_jax.models.types import DecodeOptions
    from focr_jax.io.synth import synthesize_page

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=4, y_start=4, line_height=13, line_advance=15, width=100)
    page = synthesize_page(face, ["ABab01", "b0A1aB"], dopts, ropts, "ABab01", (64, 120))
    needles = build_needles(face, "ABab01", ropts, BoxSize.CHAR, 1, 0)
    o = Searcher(page)
    n = native.NativeSearcher(page)
    total = 0
    for nd in needles:
        if nd.pixels.shape[1] > 16:
            continue
        mo = o.search(nd.pixels, 0.8, warn=False)
        mn = n.search(nd.pixels, 0.8, warn=False)
        _assert_same(mn, mo)
        total += len(mo)
    assert total > 0


def test_native_cap_truncation():
    """Constant-texture page => floods of matches; scan-order cap must agree."""
    rng = np.random.default_rng(3)
    tile = rng.integers(0, 256, (4, 4), dtype=np.uint8)
    img = np.tile(tile, (40, 40))  # 160x160 periodic
    needle = 255 - img[8:16, 8:16].copy()  # period-aligned 8x8
    o = Searcher(img)
    n = native.NativeSearcher(img)
    mo = o.search(needle, 0.5, warn=False)
    mn = n.search(needle, 0.5, warn=False)
    assert len(mo) == MAX_MATCHES
    _assert_same(mn, mo)


def test_search_many_matches_single():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (48, 80), dtype=np.uint8)
    bank = rng.integers(0, 256, (5, 6, 8), dtype=np.uint8)
    img[10:16, 20:28] = 255 - bank[2]
    n = native.NativeSearcher(img)
    many = n.search_many(bank, 0.6)
    for t in range(bank.shape[0]):
        _assert_same(many[t], n.search(bank[t], 0.6, warn=False))


def test_three_way_engine_parity(mono_font_path):
    """Device, native C++, and NumPy oracle paths must agree hit-for-hit."""
    from focr_jax.fonts.ft import Face
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.types import DecodeOptions
    from focr_jax.io.synth import synthesize_page

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    page = synthesize_page(face, ["AB01ab", "10BAba"], dopts, ropts, "AB01ab", (64, 128))
    m = NccMatcher(face, "AB01ab", ropts, x_bits=1, threshold=0.8)
    hd = m.get_hits(page)
    hn = m.get_hits_native(page)
    ho = m.get_hits_oracle(page)
    assert len(hd) > 0
    assert [
        (h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in hd
    ] == [
        (h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in hn
    ] == [
        (h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in ho
    ]


def _no_native(page):
    raise OSError("native toolchain disabled for this test")


@pytest.mark.parametrize("cap", [1, 4, 16])
def test_native_replay_matches_numpy_replay(mono_font_path, monkeypatch, cap):
    """Needles whose device candidates overflow the cap are searched on the
    host: the C++ searcher and the NumPy oracle searcher must give
    bit-identical hits, equal to the all-oracle path, and every such needle
    is counted (NccMatcher.n_host_overflow)."""
    import focr_jax.models.ncc as ncc_mod
    from focr_jax.native import ncc_cpu
    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.types import DecodeOptions, RenderOptions

    monkeypatch.setattr(ncc_mod, "_CAP", cap)
    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    page = synthesize_page(face, ["AB01ab", "10BAba"], dopts, ropts, "AB01ab", (64, 128))
    m = NccMatcher(face, "AB01ab", ropts, x_bits=1, threshold=0.3)
    with_native = m.get_hits(page)
    overflowed = m.n_host_overflow
    assert overflowed > 0, "the cap never overflowed: nothing exercised"
    with monkeypatch.context() as mp:
        mp.setattr(ncc_cpu, "NativeSearcher", _no_native)
        without = m.get_hits(page)
    assert m.n_host_overflow == 2 * overflowed
    key = lambda hs: [
        (h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in hs
    ]
    assert len(with_native) > 0
    assert key(with_native) == key(without) == key(m.get_hits_oracle(page))


@pytest.mark.parametrize("cap,max_matches", [(1 << 14, 2), (16, 1024)])
def test_native_replay_cap_warn_and_overflow(mono_font_path, monkeypatch, cap, max_matches):
    """Dense low-threshold page under (a) a tiny MAX_MATCHES (exercises the
    scan-order truncation + WARN emission of the device replay) and (b) a
    small candidate cap (exercises device replay and host search side by
    side): results and WARN counts must not depend on which host searcher
    (native or NumPy) serves the overflowed needles."""
    import focr_jax.models.ncc as ncc_mod
    from focr_jax.native import ncc_cpu
    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.types import DecodeOptions, RenderOptions

    monkeypatch.setattr(ncc_mod, "MAX_MATCHES", max_matches)
    monkeypatch.setattr(ncc_mod, "_CAP", cap)
    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    page = synthesize_page(face, ["ABABAB", "BABABA"], dopts, ropts, "AB", (64, 128))
    m = NccMatcher(face, "AB", ropts, x_bits=1, threshold=0.1)
    with_native, err_a = _run_capture(m, page)
    with monkeypatch.context() as mp:
        mp.setattr(ncc_cpu, "NativeSearcher", _no_native)
        without, err_b = _run_capture(m, page)
    key = lambda hs: [
        (h.letter, h.x, h.y, np.float32(h.similarity).tobytes()) for h in hs
    ]
    assert len(with_native) > 0
    assert key(with_native) == key(without)
    assert err_a.count("WARN") == err_b.count("WARN")
    if max_matches == 2:
        assert err_a.count("WARN") > 0
        assert m.n_host_overflow == 0
    else:
        assert m.n_host_overflow > 0


def _run_capture(m, page):
    import contextlib
    import io
    import sys

    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        hits = m.get_hits(page)
    return hits, buf.getvalue()
