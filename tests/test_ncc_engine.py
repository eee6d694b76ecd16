"""NccMatcher device path vs host oracle: exact parity; e2e text recovery."""

import time

import numpy as np
import pytest

from focr_jax.fonts.ft import Face
from focr_jax.models.ncc import NccMatcher
from focr_jax.models.post import process_hits
from focr_jax.models.types import BoxSize, RenderOptions


@pytest.fixture(scope="module")
def mono(mono_font_path):
    return Face(mono_font_path)


def hit_tuples(hits):
    return [(h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity)) for h in hits]


def test_device_matches_oracle_on_noise(mono):
    rng = np.random.default_rng(0)
    page = rng.integers(0, 256, size=(60, 70), dtype=np.uint8)
    # embed a uniform gray block (sp>0, norm2p==0) and a white strip
    page[10:20, 10:20] = 128
    page[30:35, :] = 255
    m = NccMatcher(mono, "AbQ", RenderOptions(size=13.0), threshold=0.3)
    got = m.get_hits(page)
    want = m.get_hits_oracle(page)
    assert hit_tuples(got) == hit_tuples(want)
    assert len(got) > 0  # noise at low threshold should produce some hits


def test_device_matches_oracle_with_offsets(mono):
    rng = np.random.default_rng(1)
    page = rng.integers(100, 256, size=(50, 60), dtype=np.uint8)
    m = NccMatcher(
        mono, "ai", RenderOptions(size=13.0), x_bits=1, y_bits=1, threshold=0.25
    )
    got = m.get_hits(page)
    want = m.get_hits_oracle(page)
    assert hit_tuples(got) == hit_tuples(want)


def test_device_matches_oracle_char_box(mono):
    rng = np.random.default_rng(2)
    page = rng.integers(0, 256, size=(40, 50), dtype=np.uint8)
    m = NccMatcher(
        mono, "lI.", RenderOptions(size=13.0), box_size=BoxSize.CHAR, threshold=0.3
    )
    got = m.get_hits(page)
    want = m.get_hits_oracle(page)
    assert hit_tuples(got) == hit_tuples(want)


def test_e2e_stamped_text_decodes(mono):
    """Stamp rendered needles on a grid; the full pipeline recovers the text."""
    alphabet = "ABCXYZ"
    m = NccMatcher(mono, alphabet, RenderOptions(size=13.0), threshold=0.8)
    by_letter = {nd.letter: nd for nd in m.needles}
    page = np.full((100, 140), 255, dtype=np.uint8)

    lines = ["XABC", "ZYCA"]
    positions_y = [10, 40]
    x_step = 9
    for text, y in zip(lines, positions_y):
        for ci, ch in enumerate(text):
            nd = by_letter[ch]
            nh, nw = nd.pixels.shape
            x = 8 + ci * x_step
            region = page[y : y + nh, x : x + nw]
            np.minimum(region, 255 - nd.pixels, out=region)

    hits = m.get_hits(page)
    out_lines = process_hits(hits, anchor_threshold=0.95, overlap=5)
    texts = ["".join(h.letter for h in line) for line in out_lines]
    assert texts == lines
    # sims at exact stamps are ~1
    assert all(h.similarity > 0.99 for line in out_lines for h in line)


def test_process_hits_dedup_last_max():
    from focr_jax.models.types import MatchWithLetter

    mk = lambda letter, x, sim: MatchWithLetter(letter, x, 5, 4, 4, sim)
    # two hits within overlap, equal sim -> LAST one wins (Rust max_by)
    hits = [mk("A", 10, 0.97), mk("B", 12, 0.97), mk("C", 30, 0.96)]
    lines = process_hits(hits, anchor_threshold=0.95, overlap=5)
    assert [[h.letter for h in line] for line in lines] == [["B", "C"]]


def test_process_hits_anchor_filter():
    from focr_jax.models.types import MatchWithLetter

    mk = lambda letter, x, y, sim: MatchWithLetter(letter, x, y, 4, 4, sim)
    # y=5 has an anchor; y=20 has only weak hits -> dropped entirely
    hits = [mk("A", 10, 5, 0.96), mk("B", 20, 5, 0.90), mk("C", 10, 20, 0.90)]
    lines = process_hits(hits, anchor_threshold=0.95, overlap=5)
    assert [[h.letter for h in line] for line in lines] == [["A", "B"]]


def test_process_hits_empty():
    assert process_hits([], 0.95, 5) == []


def test_get_hits_many_matches_single(mono_font_path):
    """Batched multi-page dispatch must be hit-for-hit identical to per-page."""
    import numpy as np

    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.types import DecodeOptions, RenderOptions

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    pages = [
        synthesize_page(face, [t], dopts, ropts, "AB01ab", (64, 128))
        for t in ("AB01ab", "ba10BA", "A0b1aB")
    ]
    m = NccMatcher(face, "AB01ab", ropts, x_bits=1)
    many = m.get_hits_many(pages)
    single = [m.get_hits(p) for p in pages]
    key = lambda hs: [(h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in hs]
    assert [key(h) for h in many] == [key(h) for h in single]


def test_struct_pipeline_matches_objects(mono_font_path):
    """HitStruct + process_hits_struct must produce the same lines as the
    object pipeline (get_hits + process_hits), including tie-break order."""
    import numpy as np

    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.post import process_hits, process_hits_struct
    from focr_jax.models.types import DecodeOptions, RenderOptions

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    pages = [
        synthesize_page(face, [t, t[::-1]], dopts, ropts, "AB01ab", (64, 128))
        for t in ("AB01ab", "ba10BA")
    ]
    m = NccMatcher(face, "AB01ab", ropts, x_bits=1, threshold=0.5)
    structs = m.get_hits_many(pages, struct=True)
    objects = m.get_hits_many(pages)
    key = lambda lines: [
        [(h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in ln]
        for ln in lines
    ]
    for hs, ho in zip(structs, objects):
        # the struct itself must round-trip to identical objects
        assert key([hs.to_objects()]) == key([ho])
        a = process_hits_struct(hs, 0.95, 5)
        b = process_hits(ho, 0.95, 5)
        assert key(a) == key(b)
        # also exercise a nonstandard overlap that forces multi-hit runs
        assert key(process_hits_struct(hs, 0.8, 9)) == key(process_hits(ho, 0.8, 9))


def test_text_path_and_fused_post_match_objects(mono_font_path):
    """process_hits_text and the pipeline-fused post= callback must yield
    exactly the text the object pipeline prints (ncc.rs:868-877)."""
    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.post import process_hits, process_hits_text
    from focr_jax.models.types import DecodeOptions, RenderOptions

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    pages = [
        synthesize_page(face, [t, t[::-1]], dopts, ropts, "AB01ab", (64, 128))
        for t in ("AB01ab", "ba10BA", "A0b1aB")
    ]
    m = NccMatcher(face, "AB01ab", ropts, x_bits=1, threshold=0.5)
    for anchor, overlap in ((0.95, 5), (0.8, 9), (0.999, 0)):
        fused = m.get_hits_many(
            pages, struct=True,
            post=lambda hs: process_hits_text(hs, anchor, overlap),
        )
        want = [
            ["".join(h.letter for h in ln) for ln in process_hits(ho, anchor, overlap)]
            for ho in m.get_hits_many(pages)
        ]
        assert fused == want
    # empty page: no hits -> no lines through every path
    import numpy as np

    blank = np.full((64, 128), 255, dtype=np.uint8)
    assert m.get_hits_many(
        [blank], struct=True, post=lambda hs: process_hits_text(hs, 0.95, 5)
    ) == [[]]


def test_get_hits_many_mixed_shapes(mono_font_path):
    """Wave-batched uploads group pages by shape; a corpus mixing page sizes
    (and >1 wave of pages) must stay hit-for-hit identical to per-page."""
    import numpy as np

    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.types import DecodeOptions, RenderOptions

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    texts = ["AB01ab", "ba10BA", "A0b1aB", "B1a0bA", "abAB10", "10BAab",
             "Ab01aB", "bA10Ba", "0A1bBa", "aabb01"]
    shapes = [(64, 128), (80, 150), (64, 128), (70, 140), (80, 150),
              (64, 128), (70, 140), (64, 128), (80, 150), (64, 128)]
    pages = [
        synthesize_page(face, [t], dopts, ropts, "AB01ab", sh)
        for t, sh in zip(texts, shapes)
    ]
    m = NccMatcher(face, "AB01ab", ropts, x_bits=1)
    many = m.get_hits_many(pages)
    single = [m.get_hits(p) for p in pages]
    key = lambda hs: [(h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in hs]
    assert [key(h) for h in many] == [key(h) for h in single]


def test_subpixel_duplicate_chars_are_reference_semantics(mono_font_path):
    """With x-bits 2, repeated/periodic glyphs can emit an EXTRA character:
    subpixel needles land anchor-quality hits more than `overlap` px apart, so
    the run-anchored dedup (ncc.rs:753-766, partition anchored at each run's
    FIRST element) keeps both. The reference behaves identically — its README
    describes manually cleaning ncc output. This pins the semantic so corpus
    soaks don't misread it as a parity failure: every engine must produce the
    SAME imperfect text, bit-identically."""
    import numpy as np

    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.post import process_hits, process_hits_text
    from focr_jax.models.types import DecodeOptions, RenderOptions

    face = Face(mono_font_path)
    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(x_start=5, y_start=10, line_height=12, line_advance=15, width=200)
    page = synthesize_page(face, ["Id===1>h"], dopts, ropts, "Id=1>h", (40, 220))
    m = NccMatcher(face, "Id=1>h", ropts, x_bits=2)
    ho = m.get_hits_oracle(page)
    hn = m.get_hits_native(page)
    (hd,) = m.get_hits_many([page])
    key = lambda hs: [(h.letter, h.x, h.y, np.float32(h.similarity).tobytes()) for h in hs]
    assert key(hd) == key(hn) == key(ho)
    lines = ["".join(h.letter for h in ln) for ln in process_hits(ho, 0.95, 5)]
    # the decode is imperfect (doubled '1') and identical across engines
    assert lines == ["Id===11>h"]
    (fused,) = m.get_hits_many(
        [page], struct=True, post=lambda hs: process_hits_text(hs, 0.95, 5)
    )
    assert fused == lines


def test_line_matches_truth_rules():
    """Acceptance rule used by bench/soak truth checks: extra copies INSIDE an
    existing run are tolerated (duplicate-char semantics); anything else is a
    mismatch."""
    from focr_jax.models.post import line_matches_truth as m

    assert m("abc", "abc")
    assert m("ab==c", "ab=c")  # extra '=' inside the '=' run
    assert m("aabbcc", "abc")
    assert not m("abc", "ab==c")  # truth needs MORE than got has
    assert not m("abdc", "abc")  # new run inserted
    assert not m("ac", "abc")  # run missing
    assert not m("abcX", "abc")  # trailing run added
    assert not m("", "a") and m("", "")


def test_adaptive_pipeline_depth(mono_font_path, monkeypatch):
    """A stalled wave fetch must deepen the pipeline (shape-stable adaptive
    knob) without changing results or their order."""
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.types import RenderOptions

    face = Face(mono_font_path)
    rng = np.random.default_rng(2)
    pages = []
    for i in range(8):
        p = np.full((40, 60), 255, np.uint8)
        p[10:19, 5 + i : 12 + i] = rng.integers(0, 120, (9, 7))
        pages.append(p)

    monkeypatch.setenv("FOCR_NCC_WAVE", "1")  # one page per wave: 8 waves
    monkeypatch.delenv("FOCR_NCC_DEPTH", raising=False)

    def run(stall: bool):
        m = NccMatcher(face, "AB", RenderOptions(size=11.0))
        orig = m._fetch_wave
        calls = {"n": 0}

        def stalling(disp):
            calls["n"] += 1
            if stall and calls["n"] == 4:
                time.sleep(0.6)  # > the 0.5s stall floor
            return orig(disp)

        m._fetch_wave = stalling
        hits = m.get_hits_many(pages, struct=True)
        key = [
            (s.needle_id.tobytes(), s.x.tobytes(), s.y.tobytes(),
             s.sim.tobytes())
            for s in hits
        ]
        return m, key

    m0, want = run(stall=False)
    assert m0._last_depth == 3
    m1, got = run(stall=True)
    assert got == want
    assert m1._last_depth > 3, "stall should have deepened the pipeline"


@pytest.mark.parametrize("budget_pages,want_tall", [(1, 1), (3, 2), (100, 8)])
def test_mixed_shape_corpus_waves_sized_from_max_shape(
    monkeypatch, mono_font_path, budget_pages, want_tall
):
    """Wave sizing must bound the PADDED wave x per-page device planes
    (models/ncc.py::_page_bytes) for EVERY shape bucket in a mixed-shape
    corpus, not just pages[0]'s shape (models/ncc.py::_wave_for):
    _dispatch_wave buckets by shape WITHIN a wave, so a small-pages-first
    corpus sized from its first page would overshoot the HBM budget when a
    later bucket holds 2500x2000 pages. Budgets of 1, 3 and 100 tall pages
    give waves of 1, 2 (the {1, 2, 4} padding steps) and the cap of 8. The
    reference's page fan-out is order-independent (ncc.rs:839-847)."""
    from focr_jax.fonts.ft import Face as FtFace
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models import ncc as ncc_mod
    from focr_jax.models.types import DecodeOptions

    face = FtFace(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(
        x_start=5, y_start=6, line_height=13, line_advance=15, width=110
    )
    small = synthesize_page(face, ["AB01"], dopts, ropts, "AB01", (64, 128))
    # tall pages are blank (inverted sum 0 -> no crop, no device sweep), so
    # the test exercises the sizing arithmetic without a 2500x2000 sweep;
    # the budget invariant under test is shape-only arithmetic
    tall = np.full((2500, 2000), 255, np.uint8)
    pages = [small] * 4 + [tall] * 8

    monkeypatch.delenv("FOCR_NCC_WAVE", raising=False)
    m = NccMatcher(face, "AB01", ropts, x_bits=0)

    def plane(H, W):
        return max(
            ncc_mod._page_bytes(g, H, W)
            for g in m.groups
            if g.nh < H and g.nw < W
        )

    # the tall planes dominate: the small page's are far below them
    assert plane(2500, 2000) > 100 * plane(64, 128)
    budget = plane(2500, 2000) * budget_pages
    monkeypatch.setattr(ncc_mod, "_hbm_budget", lambda: budget)
    assert m._wave_for(pages) == want_tall
    assert m._wave_for([small]) == 8  # a small-only corpus keeps full waves

    seen: list[list[tuple[int, int]]] = []
    orig = NccMatcher._dispatch_wave

    def spy(self, batch, *a, **k):
        seen.append([p.shape for p in batch])
        return orig(self, batch, *a, **k)

    monkeypatch.setattr(NccMatcher, "_dispatch_wave", spy)
    hits = m.get_hits_many(pages)
    assert len(hits) == len(pages)
    assert all(h == [] for h in hits[4:])  # blank talls decode to nothing
    assert seen
    for shapes in seen:
        counts: dict[tuple[int, int], int] = {}
        for s in shapes:
            counts[s] = counts.get(s, 0) + 1
        for (H, W), B in counts.items():
            # _dispatch_wave's page-axis padding steps: {1, 2, 4, 8k}
            Bp = B if B in (1, 2) else 4 if B <= 4 else -(-B // 8) * 8
            assert Bp * plane(H, W) <= budget, (H, W, B, Bp)
