"""Oracle internals: integral-table quirk, partition semantics, NCC math."""

import numpy as np

from focr_jax.models.post import partition_by
from focr_jax.models.types import MAX_MATCHES
from focr_jax.oracle.ncc_oracle import (
    Searcher,
    invert_u8,
    rect_sum_nz,
    sum_table,
    sumsqr_table,
)


def literal_sumsqr_table(pixels: np.ndarray) -> np.ndarray:
    """Direct port of the reference recurrence (ncc.rs:957-974) for testing."""
    h, w = pixels.shape
    p = pixels.astype(np.uint64)
    S = np.zeros((h, w), dtype=np.uint64)
    for x in range(w):
        S[0, x] = p[0, x] * p[0, x]
    for y in range(h):
        S[y, 0] = p[y, 0] * p[y, 0]
    for y in range(1, h):
        for x in range(1, w):
            S[y, x] = p[y, x] * p[y, x] + S[y, x - 1] + S[y - 1, x] - S[y - 1, x - 1]
    return S


def test_sumsqr_closed_form_matches_literal_recurrence():
    rng = np.random.default_rng(0)
    for _ in range(5):
        img = rng.integers(0, 256, size=(13, 17), dtype=np.uint8)
        assert np.array_equal(sumsqr_table(img), literal_sumsqr_table(img))


def test_rect_sums_exact_for_x_y_ge_1():
    """The border asymmetry cancels: _nz rect sums are exact everywhere x,y>=1."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(12, 15), dtype=np.uint8)
    st = sum_table(img)
    s2t = sumsqr_table(img)
    p = img.astype(np.int64)
    for y in range(1, 9):
        for x in range(1, 11):
            for w, h in [(1, 1), (3, 2), (4, 4)]:
                if x + w > 15 or y + h > 12:
                    continue
                true_s = int(p[y : y + h, x : x + w].sum())
                true_s2 = int((p[y : y + h, x : x + w] ** 2).sum())
                assert rect_sum_nz(st, x, y, w, h) == true_s
                assert rect_sum_nz(s2t, x, y, w, h) == true_s2


def test_partition_by_first_anchored():
    # runs anchored at their first element: [0, 3, 6, 9] with overlap<=5
    # chains pairwise but splits at 6 against anchor 0.
    xs = [0, 3, 6, 9]
    slices = partition_by(xs, lambda a, b: abs(a - b) <= 5)
    assert slices == [(0, 2), (2, 4)]
    assert partition_by([], lambda a, b: True) == []
    assert partition_by([7], lambda a, b: False) == [(0, 1)]


def test_invert():
    img = np.array([[255, 0], [128, 200]], dtype=np.uint8)
    assert np.array_equal(invert_u8(img), np.array([[0, 255], [127, 55]], dtype=np.uint8))


def _brute_force_ncc(img: np.ndarray, needle: np.ndarray, threshold: float):
    """Independent NCC computation (plain math, f64) for cross-checking."""
    ref = invert_u8(img).astype(np.float64)
    nh, nw = needle.shape
    nd = needle.astype(np.float64)
    n = nh * nw
    s_n, s2_n = nd.sum(), (nd * nd).sum()
    rnorm_n = 1.0 / np.sqrt(s2_n - s_n * s_n / n)
    hits = []
    H, W = ref.shape
    for y in range(1, H - nh + 1):
        for x in range(1, W - nw + 1):
            win = ref[y : y + nh, x : x + nw]
            s_p = win.sum()
            if s_p == 0:
                continue
            norm2_p = (win * win).sum() - s_p * s_p / n
            with np.errstate(divide="ignore", invalid="ignore"):
                rnorm_p = 1.0 / np.sqrt(norm2_p)
                sim = (np.float64((win * nd).sum()) - (s_n * s_p) * (1.0 / n)) * (
                    rnorm_n * rnorm_p
                )
            if sim != np.inf and sim > np.float64(np.float32(threshold)):
                hits.append((x, y, np.float32(sim)))
    return hits


def test_searcher_matches_brute_force():
    rng = np.random.default_rng(2)
    # synthetic page: white with a few dark stamps
    img = np.full((40, 50), 255, dtype=np.uint8)
    needle_src = rng.integers(0, 200, size=(5, 4), dtype=np.uint8)
    for (x, y) in [(5, 3), (20, 10), (33, 27)]:
        img[y : y + 5, x : x + 4] = needle_src
    searcher = Searcher(img)
    needle = invert_u8(needle_src)
    got = searcher.search(needle, threshold=0.8)
    want = _brute_force_ncc(img, needle, 0.8)
    got_t = [(m.x, m.y) for m in got]
    want_t = [(x, y) for x, y, _ in want]
    assert set(got_t) == set(want_t)
    assert (5, 3) in got_t and (20, 10) in got_t and (33, 27) in got_t
    # scan order (row-major)
    assert got_t == sorted(got_t, key=lambda t: (t[1], t[0]))
    # similarity of an exact stamp is ~1.0
    sims = {(m.x, m.y): m.similarity for m in got}
    assert sims[(5, 3)] > 0.999


def test_searcher_blank_needle_no_matches():
    img = np.full((30, 30), 200, dtype=np.uint8)
    searcher = Searcher(img)
    blank = np.zeros((4, 4), dtype=np.uint8)
    assert searcher.search(blank, threshold=0.5) == []


def test_searcher_cap(capsys):
    # a flat-noise page where a 1x1-ish needle matches everywhere would blow
    # past MAX_MATCHES; verify scan-order truncation at the cap.
    rng = np.random.default_rng(3)
    img = rng.integers(0, 40, size=(80, 80), dtype=np.uint8)
    searcher = Searcher(img)
    needle = rng.integers(10, 220, size=(4, 4), dtype=np.uint8)
    got = searcher.search(needle, threshold=-2.0)  # everything passes
    assert len(got) == MAX_MATCHES
    first = got[0]
    assert (first.x, first.y) == (1, 1)


def test_integral_table_wrap_on_huge_dark_page():
    """The u32 sum_table wraps once total inverted ink exceeds 2^32 (~16.8M
    dark pixels); the reference's `as u32` truncation cancels the wrap
    (ncc.rs:977-984), so window sums must stay exact. Widening the table to
    int64 BEFORE differencing (the old bug) yields sums off by k*2^32."""
    import numpy as np

    from focr_jax.oracle.ncc_oracle import Searcher, rect_sum_nz

    H = W = 4200  # 17.6M px, all ink after inversion -> table wraps u32
    page = np.zeros((H, W), dtype=np.uint8)  # black page -> inverted 255
    s = Searcher(page)
    assert int(s.sum_table[-1, -1]) != 255 * H * W % (1 << 64)  # really wrapped
    assert (255 * H * W) >= (1 << 32)
    prep = s.prepare_for_size(8, 8)
    want = 255 * 64
    # rows far enough down that the table has wrapped by then
    for y in (1, H // 2, H - 8):
        st, en = int(prep.start_end[y, 0]), int(prep.start_end[y, 1])
        assert st == 1 and en == W - 8 + 1
        assert int(prep.patch_sum[y, st]) == want
        assert int(prep.patch_sum[y, en - 1]) == want
    assert rect_sum_nz(s.sum_table, W - 8, H - 8, 8, 8) == want
    assert rect_sum_nz(s.sumsqr_table, W - 8, H - 8, 8, 8) == 255 * 255 * 64
