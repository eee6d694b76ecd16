"""Card-only checks at the canonical workload (README grid, 792x662 letter
pages): the device integers are exact under the GPU compiler's own choices
of algorithm, and the ncc device path stays bit-identical to the native
engine. They skip on the CPU backend; on the card run

    FOCR_TEST_PLATFORM=cuda python -m pytest tests/ -m gpu
"""

import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def canonical(gpu):
    from focr_jax.fonts import DEJAVU_MONO
    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import random_text_lines, synthesize_page
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.types import DecodeOptions, NCC_DEFAULT_ALPHABET, RenderOptions

    face = Face(DEJAVU_MONO)
    ropts = RenderOptions(size=13.0)
    dopts = DecodeOptions(x_start=45, y_start=39, line_height=12, line_advance=15, width=608)
    rng = np.random.default_rng(3)
    pages = [
        synthesize_page(face, random_text_lines(rng, NCC_DEFAULT_ALPHABET, 48, 77),
                        dopts, ropts, NCC_DEFAULT_ALPHABET, (792, 662))
        for _ in range(2)
    ]
    return NccMatcher(face, NCC_DEFAULT_ALPHABET, ropts, x_bits=2), pages


def test_correlate_and_window_stats_exact_on_card(canonical):
    from focr_jax.ops import ncc as ncc_ops

    m, pages = canonical
    inv = (255 - pages[0]).astype(np.uint8)
    for g in m.groups:
        T, nh, nw = g.bank.shape
        win = np.lib.stride_tricks.sliding_window_view(inv.astype(np.int64), (nh, nw))
        Hs, Ws = win.shape[:2]
        # integers below n·255² < 2⁵³: the f64 BLAS product is exact
        want = (win.reshape(Hs * Ws, -1).astype(np.float64)
                @ g.bank.reshape(T, -1).astype(np.float64).T).T.astype(np.int64)
        got = np.asarray(ncc_ops.correlate(jnp.asarray(inv), jnp.asarray(g.bank)))
        np.testing.assert_array_equal(got.reshape(T, -1).astype(np.int64), want)
        sp, s2p = ncc_ops.window_stats(jnp.asarray(inv), nw, nh)
        np.testing.assert_array_equal(np.asarray(sp), win.sum(axis=(2, 3)))
        np.testing.assert_array_equal(np.asarray(s2p), (win * win).sum(axis=(2, 3)))


def test_ncc_device_matches_native_on_card(canonical):
    m, pages = canonical
    key = lambda hs: [(h.letter, h.x, h.y, np.float32(h.similarity).tobytes()) for h in hs]
    got = m.get_hits_many(pages)
    assert [key(h) for h in got] == [key(m.get_hits_native(p)) for p in pages]
    assert m.n_host_overflow == 0
