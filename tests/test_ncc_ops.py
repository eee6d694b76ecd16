"""ops/ncc.py against plain NumPy: the device correlation and window stats
are exact integers, and the ε-guarded candidate set contains every match the
oracle accepts.

Exactness is the contract that lets the host replay the reference's f64
decision bit for bit (ops/ncc.py docstring), so the comparisons use
tolerance 0 against int64 NumPy.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from focr_jax.ops import ncc as ncc_ops
from focr_jax.oracle.ncc_oracle import Searcher

H, W = 40, 56


def _inv_page(kind: str, rng) -> np.ndarray:
    """Inverted page (0 = white): dense full-range noise, or sparse ink
    blobs on white like a text page."""
    if kind == "noise":
        return rng.integers(0, 256, (H, W), dtype=np.uint8)
    inv = np.zeros((H, W), np.uint8)
    for _ in range(10):
        y, x = rng.integers(0, H - 8), rng.integers(0, W - 6)
        inv[y : y + 8, x : x + 6] = rng.integers(0, 256, (8, 6))
    return inv


def _ref_correlate(inv: np.ndarray, bank: np.ndarray) -> np.ndarray:
    T, nh, nw = bank.shape
    win = np.lib.stride_tricks.sliding_window_view(inv.astype(np.int64), (nh, nw))
    return np.einsum("yxij,tij->tyx", win, bank.astype(np.int64))


def _ref_stats(inv: np.ndarray, nh: int, nw: int):
    win = np.lib.stride_tricks.sliding_window_view(inv.astype(np.int64), (nh, nw))
    return win.sum(axis=(2, 3)), (win * win).sum(axis=(2, 3))


# (nh, nw): small, the canonical 13x8 / 13x9 letter needles, the 16-px
# host-kernel limit, and areas past n·255² < 2²⁴ (the nibble-split GEMM and
# the cumsum window stats)
SHAPES = [(3, 3), (5, 7), (13, 8), (13, 9), (16, 16), (17, 16), (24, 20)]


@pytest.mark.parametrize("kind", ["noise", "text"])
@pytest.mark.parametrize("nh,nw", SHAPES)
def test_correlate_and_window_stats_exact(kind, nh, nw):
    rng = np.random.default_rng(nh * 100 + nw)
    inv = _inv_page(kind, rng)
    bank = rng.integers(0, 256, (3, nh, nw), dtype=np.uint8)
    got = np.asarray(ncc_ops.correlate(jnp.asarray(inv), jnp.asarray(bank)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.astype(np.int64), _ref_correlate(inv, bank))
    sp, s2p = ncc_ops.window_stats(jnp.asarray(inv), nw, nh)
    want_sp, want_s2p = _ref_stats(inv, nh, nw)
    np.testing.assert_array_equal(np.asarray(sp).astype(np.int64), want_sp)
    np.testing.assert_array_equal(np.asarray(s2p).astype(np.int64), want_s2p)


def _superset_case(kind: str, rng):
    """(inverted page, needle bank) for the candidate-superset test. The
    'flat' page is the high-mean, low-variance regime where f32 rounding of
    the window variance is most dangerous for the guard."""
    nh, nw = 9, 7
    sparse = np.zeros((nh, nw), np.uint8)
    sparse[4, 5] = 128  # near-uniform needle: one pixel of variance
    dense = rng.integers(0, 256, (nh, nw), dtype=np.uint8)
    if kind == "flat":
        inv = np.full((H, W), 237, np.uint8)
        inv[20 + 4, 30 + 5] += 1  # an exact imprint of the sparse needle
        ys, xs = rng.integers(0, H, 12), rng.integers(0, W, 12)
        inv[ys, xs] = np.clip(inv[ys, xs].astype(int) + rng.integers(-1, 2, 12), 0, 255)
    else:
        inv = _inv_page(kind, rng)
        inv[10 : 10 + nh, 12 : 12 + nw] = dense  # one planted true match
    return inv.astype(np.uint8), np.stack([dense, sparse])


@pytest.mark.parametrize("kind", ["noise", "text", "flat"])
@pytest.mark.parametrize("threshold", [-0.5, 0.3, 0.8, 0.95])
def test_candidates_contain_oracle_matches(kind, threshold):
    rng = np.random.default_rng(int(threshold * 100) + 100 + len(kind))
    inv, bank = _superset_case(kind, rng)
    T, nh, nw = bank.shape
    s_n = bank.reshape(T, -1).astype(np.int64).sum(axis=1)
    s2_n = (bank.reshape(T, -1).astype(np.int64) ** 2).sum(axis=1)
    W2 = W - nw
    cap = (H - nh) * W2  # every position fits: no truncation
    idx, _, _, _, counts = (
        np.asarray(o)
        for o in ncc_ops.ncc_candidates(
            jnp.asarray(inv), jnp.asarray(bank), jnp.asarray(s_n),
            jnp.asarray(s2_n), jnp.asarray(np.float32(threshold)),
            nw=nw, nh=nh, cap=cap,
        )
    )
    searcher = Searcher(255 - inv)
    found = 0
    for t in range(T):
        assert counts[t] <= cap
        lin = idx[t][idx[t] >= 0]
        cands = set(zip((1 + lin % W2).tolist(), (1 + lin // W2).tolist()))
        accepted = {(m.x, m.y) for m in searcher.search(bank[t], threshold, warn=False)}
        assert accepted <= cands, sorted(accepted - cands)[:5]
        found += len(accepted)
    if kind != "noise" or threshold < 0.9:
        assert found > 0, "nothing accepted: the superset check was vacuous"
