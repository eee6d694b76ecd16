"""GridDecoder (device path) vs the NumPy oracle: exact parity."""

import numpy as np
import pytest

from focr_jax.fonts.ft import Face
from focr_jax.io.synth import synthesize_page
from focr_jax.models.focr import GridDecoder, decode_pages
from focr_jax.models.types import DecodeOptions, FOCR_DEFAULT_ALPHABET, RenderOptions
from focr_jax.oracle import focr_oracle
from tests.test_focr_oracle import width_for_cells


@pytest.fixture(scope="module")
def mono(mono_font_path):
    return Face(mono_font_path)


ALPHABET = FOCR_DEFAULT_ALPHABET


def assert_parity(pages, mono, dopts, ropts):
    dec = GridDecoder(mono, ALPHABET, dopts, ropts, pages[0].shape)
    got = dec.decode_batch(np.stack(pages))
    for i, page in enumerate(pages):
        want = focr_oracle.decode_image(page, mono, ALPHABET, dopts, ropts)
        assert [(l.text, l.y) for l in got[i]] == [(l.text, l.y) for l in want], f"page {i}"


def test_synthetic_pages_parity(mono):
    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(
        x_start=7, y_start=5, line_height=12, line_advance=15,
        width=width_for_cells(mono, ropts, 6),
    )
    rng = np.random.default_rng(0)
    chars = list(ALPHABET)
    pages = []
    for _ in range(3):
        lines = ["".join(rng.choice(chars, size=6)) for _ in range(3)]
        pages.append(
            synthesize_page(mono, lines, dopts, ropts, ALPHABET, (64, 80), blank_rows={1})
        )
    assert_parity(pages, mono, dopts, ropts)


def test_noise_pages_parity(mono):
    """Random noise exercises argmin tie-breaks and arbitrary pixel content."""
    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(x_start=3, y_start=2, line_height=12, line_advance=15, width=30)
    rng = np.random.default_rng(1)
    pages = [
        rng.integers(0, 256, size=(50, 44), dtype=np.uint8) for _ in range(2)
    ]
    # include near-white noise (partially white rows, near-ties)
    pages.append(np.clip(rng.integers(250, 260, size=(50, 44)), 0, 255).astype(np.uint8))
    assert_parity(pages, mono, dopts, ropts)


def test_partial_bottom_row_parity(mono):
    """Page height chosen so the last scan row is a partial crop."""
    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(x_start=2, y_start=3, line_height=12, line_advance=15, width=40)
    rng = np.random.default_rng(2)
    # rows at y=3,18,33,48; H=55 -> last row crop height 55-48=7 (partial)
    pages = [rng.integers(0, 256, size=(55, 50), dtype=np.uint8) for _ in range(2)]
    assert_parity(pages, mono, dopts, ropts)


def test_zero_width_crop(mono):
    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(x_start=100, y_start=0, line_height=12, line_advance=15, width=40)
    page = np.zeros((40, 50), dtype=np.uint8)
    dec = GridDecoder(mono, ALPHABET, dopts, ropts, page.shape)
    assert dec.decode_batch(page[None]) == [[]]


def test_decode_pages_multi_shape(mono):
    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(
        x_start=4, y_start=4, line_height=12, line_advance=15,
        width=width_for_cells(mono, ropts, 5),
    )
    p1 = synthesize_page(mono, ["Hello"], dopts, ropts, ALPHABET, (40, 60))
    p2 = synthesize_page(mono, ["world"], dopts, ropts, ALPHABET, (55, 70))
    p3 = synthesize_page(mono, ["again"], dopts, ropts, ALPHABET, (40, 60))
    res = decode_pages([p1, p2, p3], mono, ALPHABET, dopts, ropts)
    assert [l.text for l in res[0]] == ["Hello"]
    assert [l.text for l in res[1]] == ["world"]
    assert [l.text for l in res[2]] == ["again"]


def test_decode_pages_reuses_decoders(mono_font_path):
    """Repeated decode_pages calls with the same config must reuse the cached
    GridDecoder (no re-tracing), and different configs must not collide."""
    import numpy as np

    import focr_jax.models.focr as focr_mod
    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.focr import decode_pages
    from focr_jax.models.types import DecodeOptions, RenderOptions

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    page = synthesize_page(face, ["AB01"], dopts, ropts, "AB01ab", (64, 128))
    focr_mod._DECODER_CACHE.clear()
    a = decode_pages([page], face, "AB01ab", dopts, ropts)
    n_after_first = len(focr_mod._DECODER_CACHE)
    b = decode_pages([page], face, "AB01ab", dopts, ropts)
    assert len(focr_mod._DECODER_CACHE) == n_after_first  # reused, not rebuilt
    assert [(l.text, l.y) for l in a[0]] == [(l.text, l.y) for l in b[0]]
    # a different grid gets its own decoder
    d2 = DecodeOptions(x_start=4, y_start=6, line_height=13, line_advance=15, width=110)
    decode_pages([page], face, "AB01ab", d2, ropts)
    assert len(focr_mod._DECODER_CACHE) == n_after_first + 1


@pytest.mark.parametrize("K", [128, 1024, 8192])
def test_exact_corr_mat_all_split_regimes(K):
    """The bf16 matmul correlation must equal the exact i64 dot product in
    every split regime: direct (K<=258), template-nibble (K<=4385), and
    both-operand nibble (K<=74565) — the bit-parity invariant behind the SSD
    decoder (ops/ssd.py::_exact_dot)."""
    from focr_jax.ops import ssd

    rng = np.random.default_rng(K)
    wins = rng.integers(0, 256, size=(5, K), dtype=np.int32)
    tmpl = rng.integers(0, 256, size=(7, K), dtype=np.uint8)
    # worst case too: all-255 rows maximize every partial sum
    wins[0] = 255
    tmpl[0] = 255
    got = np.asarray(ssd.exact_corr_mat(wins, tmpl))
    want = wins.astype(np.int64) @ tmpl.T.astype(np.int64)
    assert np.array_equal(got.astype(np.int64), want)


def test_single_stream_parity_and_incrementality(mono):
    """decode_single_stream: bit-identical to decode_batch AND yields early
    rows before later chunks are fetched (main.rs:427-440 streaming)."""
    import focr_jax.models.focr as mf

    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(
        x_start=2, y_start=3, line_height=12, line_advance=15,
        width=width_for_cells(mono, ropts, 5),
    )
    rng = np.random.default_rng(7)
    chars = list(ALPHABET)
    # 8 text rows + partial bottom row; rows_per_chunk=2 -> >=5 chunks
    lines = ["".join(rng.choice(chars, size=5)) for _ in range(8)]
    page = synthesize_page(mono, lines, dopts, ropts, ALPHABET, (130, 70), blank_rows={3})
    dec = GridDecoder(mono, ALPHABET, dopts, ropts, page.shape)
    want = dec.decode_batch(page[None])[0]

    events = []
    orig_get = mf.jax.device_get

    def spy_get(tree):
        events.append("fetch")
        return orig_get(tree)

    mf.jax.device_get = spy_get
    try:
        got = []
        for line in mf.decode_single_stream(dec, page, rows_per_chunk=2):
            events.append("yield")
            got.append(line)
    finally:
        mf.jax.device_get = orig_get

    assert [(l.text, l.y) for l in got] == [(l.text, l.y) for l in want]
    # streaming: some lines must be yielded BEFORE the last chunk is fetched
    last_fetch = len(events) - 1 - events[::-1].index("fetch")
    assert "yield" in events[:last_fetch], events


def test_exact_corr_large_window_no_i32_overflow():
    """The 4-matmul nibble branch must combine in i64 once the true dot can
    exceed 2^31 (n > 33026): all-255 operands at K=40000 overflowed the old
    i32 combine to a negative number inside the certified-exact region."""
    import numpy as np
    import jax.numpy as jnp

    from focr_jax.ops.ssd import exact_corr_mat

    for K in (33100, 40000, 74000):
        w = np.full((2, K), 255, np.uint8)
        t = np.full((3, K), 255, np.uint8)
        got = np.asarray(exact_corr_mat(jnp.asarray(w.astype(np.int32)), jnp.asarray(t)))
        assert (got == K * 255 * 255).all(), (K, int(got[0, 0]))
    rng = np.random.default_rng(0)
    w = rng.integers(0, 256, (4, 40000), dtype=np.uint8)
    t = rng.integers(0, 256, (5, 40000), dtype=np.uint8)
    got = np.asarray(exact_corr_mat(jnp.asarray(w.astype(np.int32)), jnp.asarray(t)))
    assert (got == w.astype(np.int64) @ t.astype(np.int64).T).all()


def test_single_stream_tall_page_bounded_window(mono):
    """A page with more chunks than the 8-deep in-flight window must decode
    bit-identically to decode_batch (the window refills as chunks drain)."""
    import focr_jax.models.focr as mf

    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(
        x_start=2, y_start=3, line_height=12, line_advance=15,
        width=width_for_cells(mono, ropts, 4),
    )
    rng = np.random.default_rng(17)
    chars = list(ALPHABET)
    # 24 text rows; rows_per_chunk=1 -> 24+ chunks, 3x the window depth
    lines = ["".join(rng.choice(chars, size=4)) for _ in range(24)]
    page = synthesize_page(
        mono, lines, dopts, ropts, ALPHABET, (24 * 15 + 10, 60), blank_rows={5, 11}
    )
    dec = GridDecoder(mono, ALPHABET, dopts, ropts, page.shape)
    want = dec.decode_batch(page[None])[0]
    got = list(mf.decode_single_stream(dec, page, rows_per_chunk=1))
    assert [(l.text, l.y) for l in got] == [(l.text, l.y) for l in want]
