"""Differential coverage for wide needles (>16 px), VERDICT r2 weak #7.

The reference panics at needle widths over 16 (src/ncc.rs:392); this rebuild
supports them on the device tiers (XLA sweep + _redo_wide). The primary
oracle mirrors the panic, so until now those paths were tested only for
plumbing. oracle/ncc_direct.py::direct_search is the independent
brute-force checker; every test here asserts hit-for-hit equality
(x, y, w, h, f32-sim bytes, scan order) against it.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from focr_jax.models.types import BoxSize, DecodeOptions, RenderOptions
from focr_jax.oracle.ncc_direct import direct_search


def _key(ms):
    return [(m.x, m.y, m.w, m.h, np.float32(m.similarity).tobytes()) for m in ms]


def test_direct_checker_matches_primary_oracle_narrow():
    """Sanity: on narrow needles (<=16 px) the brute-force checker must agree
    with the integral-table Searcher bit for bit — otherwise it proves
    nothing about the wide paths."""
    from focr_jax.oracle.ncc_oracle import Searcher

    rng = np.random.default_rng(11)
    page = rng.integers(180, 256, (56, 90), dtype=np.uint8)
    needle = rng.integers(0, 120, (9, 12), dtype=np.uint8)
    page[10:19, 20:32] = 255 - needle  # plant a perfect match
    page[33:42, 51:63] = 255 - needle
    ms_direct = direct_search(page, needle, 0.8)
    ms_oracle = Searcher(page).search(needle, 0.8)
    assert len(ms_direct) > 0
    assert _key(ms_direct) == _key(ms_oracle)


@pytest.mark.parametrize("seed,nh,nw,thr", [(0, 8, 17, 0.8), (1, 11, 24, 0.7), (2, 6, 32, 0.9)])
def test_xla_wide_sweep_matches_direct(seed, nh, nw, thr):
    """The XLA candidate sweep + exact host replay at nw>16, hit-for-hit vs
    the brute-force checker on noisy pages with planted matches."""
    from focr_jax.models.ncc import exact_similarities
    from focr_jax.ops import ncc as ncc_ops
    from focr_jax.models.types import MAX_MATCHES

    rng = np.random.default_rng(seed)
    H, W, T = 72, 120, 3
    page = rng.integers(150, 256, (H, W), dtype=np.uint8)
    needles = rng.integers(0, 140, (T, nh, nw), dtype=np.uint8)
    for t in range(T):
        for (x, y) in [(3 + 11 * t, 5), (40, 20 + 9 * t), (70, 50)]:
            page[y : y + nh, x : x + nw] = 255 - needles[t]
    inv = (255 - page.astype(np.int32)).astype(np.uint8)
    s_n = needles.reshape(T, -1).astype(np.int64).sum(1)
    s2_n = (needles.reshape(T, -1).astype(np.int64) ** 2).sum(1)
    idx, acc, sp, s2p, counts = (
        np.asarray(o)
        for o in ncc_ops.ncc_candidates(
            jnp.asarray(inv), jnp.asarray(needles), jnp.asarray(s_n),
            jnp.asarray(s2_n), jnp.asarray(np.float32(thr)), nw=nw, nh=nh, cap=4096,
        )
    )
    thr_f64 = np.float64(np.float32(thr))
    W2 = W - nw
    for t in range(T):
        assert counts[t] <= 4096
        cand = slice(0, int(counts[t]))
        sim = exact_similarities(
            acc[t, cand], sp[t, cand], s2p[t, cand], int(s_n[t]), int(s2_n[t]), nh * nw
        )
        keep = (sim != np.inf) & (sim > thr_f64)
        lins = idx[t, cand][keep].astype(np.int64)
        got = [
            (int(x), int(y), np.float32(s).tobytes())
            for x, y, s in zip(1 + lins % W2, 1 + lins // W2, sim[keep])
        ]
        want_ms = direct_search(page, needles[t], thr)
        want = [
            (m.x, m.y, np.float32(m.similarity).tobytes()) for m in want_ms
        ]
        assert len(want) > 0, "planted matches must be found"
        assert got[:MAX_MATCHES] == want, f"needle {t} ({nw}x{nh})"


def test_matcher_wide_needles_match_direct(mono_font_path):
    """Full NccMatcher pipeline with real padded (wide) font needles: each
    needle's hits must equal the brute-force checker's, in order."""
    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.ncc import NccMatcher

    face = Face(mono_font_path)
    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(x_start=8, y_start=8, line_height=14, line_advance=17, width=160)
    page = synthesize_page(
        face, ["A B a", "0 a B"], dopts, ropts, "ABa0 ", (64, 176)
    )
    m = NccMatcher(
        face, "ABa0", ropts, box_size=BoxSize.ALPHABET, x_bits=1,
        padding=(6, 0), threshold=0.6,
    )
    assert any(nd.pixels.shape[1] > 16 for nd in m.needles), "config not wide"
    hits = m.get_hits(page)
    want = []
    for nd in m.needles:
        for mm in direct_search(page, nd.pixels, 0.6):
            want.append((nd.letter, mm.x, mm.y, mm.w, mm.h, np.float32(mm.similarity).tobytes()))
    got = [(h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in hits]
    assert len(got) > 0
    assert got == want


def test_redo_wide_matches_direct(mono_font_path, monkeypatch):
    """Candidate-cap overflow on a wide needle takes _redo_wide (count-sized
    device re-dispatch — no host kernel supports nw>16); results must still
    equal the brute-force checker."""
    import focr_jax.models.ncc as ncc_mod
    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.ncc import NccMatcher

    monkeypatch.setattr(ncc_mod, "_CAP", 8)  # force overflow on dense pages
    redos = []
    orig = NccMatcher._redo_wide

    def spy(self, grp, ti, nd, inv, count):
        redos.append(count)
        return orig(self, grp, ti, nd, inv, count)

    monkeypatch.setattr(NccMatcher, "_redo_wide", spy)
    face = Face(mono_font_path)
    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(x_start=8, y_start=8, line_height=14, line_advance=17, width=160)
    page = synthesize_page(face, ["AAAA", "AAAA"], dopts, ropts, "ABa0", (64, 176))
    m = NccMatcher(
        face, "ABa0", ropts, box_size=BoxSize.ALPHABET,
        padding=(6, 0), threshold=0.35,
    )
    hits = m.get_hits(page)
    assert redos, "cap never overflowed on a wide needle: nothing exercised"
    want = []
    for nd in m.needles:
        for mm in direct_search(page, nd.pixels, 0.35):
            want.append((nd.letter, mm.x, mm.y, np.float32(mm.similarity).tobytes()))
    got = [(h.letter, h.x, h.y, np.float32(h.similarity).tobytes()) for h in hits]
    assert got == want
