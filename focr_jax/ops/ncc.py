"""Device NCC ops: exact integer correlation + window stats + candidate compaction.

The reference's hot kernel (src/ncc.cpp ncc_8_u8/ncc_16_u8) slides one needle
over the page with AVX2 integer madds, then computes an f64 similarity and
emits thresholded hits. The device formulation computes ALL needles of one
size simultaneously, in plain jax.numpy/lax that XLA compiles:

  * correlation  = needle_bank @ im2col(image), one bf16 GEMM with f32
    accumulation (replaces ncc.cpp:106-166) — bf16 inputs are lossless for u8
    data, f32 accumulation is exact while n*255^2 < 2^24, with a 4-bit-nibble
    split beyond that (same exactness argument as ops/ssd.py).
  * window sums Σp, Σp² = a banded-selector matmul along rows plus a
    shifted-add chain down columns, exact integers.
    SURVEY.md flagged the reference's sumsqr-table border asymmetry
    (ncc.rs:957-974) as a quirk to replicate; algebraically the `_nz`
    accessor's rect sums are EXACT for every window at x,y>=1 (the border
    terms cancel — proved in tests/test_oracle.py), so true window sums give
    bit parity over the whole search domain.
  * similarity is computed in f32 with an ε guard band; every candidate's
    exact integers (acc, Σp, Σp²) are shipped to the host, which replays the
    reference's f64 formula (ncc.cpp:206-215, 233-247) for a bit-exact
    accept/reject and stored-f32 similarity. This split keeps the integer
    work exact on device, where f64 is slow or absent, and the handful of
    f64 flops per candidate on host.
  * compaction: scan-order linear indices through top_k — reproducing the
    row-major emit order and the MAX_MATCHES truncation semantics
    (ncc.cpp:222-229).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_EXACT_F32_LIMIT = 1 << 24


def _patches(img: jax.Array, nh: int, nw: int) -> jax.Array:
    """[H, W] -> [nh·nw, H'·W'] bf16 im2col matrix: row dy·nw + dx holds
    pixel (dy, dx) of every window, windows in row-major scan order. u8
    values are exact in bf16 (8 significant bits)."""
    H, W = img.shape
    Hs, Ws = H - nh + 1, W - nw + 1
    x = img.astype(jnp.bfloat16)
    return jnp.stack(
        [x[dy : dy + Hs, dx : dx + Ws].reshape(-1) for dy in range(nh) for dx in range(nw)]
    )


def correlate(img: jax.Array, needles: jax.Array) -> jax.Array:
    """Exact integer cross-correlation acc[t, y, x] (i32).

    img: [H, W] inverted page (0..255); needles: [T, nh, nw] u8.

    One [T, K] x [K, H'·W'] GEMM over the im2col patches, bf16 operands
    with f32 accumulation. Every product is an exact integer, and every
    partial sum stays below 2²⁴ (n·255² < 2²⁴, else the nibble split keeps
    n·255·15 < 2²⁴), so the f32 sum is exact in any order: the result does
    not depend on which GEMM algorithm, split-K or tile order the compiler
    picks. A convolution would leave that choice to the conv autotuner,
    whose candidates need not all be exact.
    """
    T, nh, nw = needles.shape
    H, W = img.shape
    out_shape = (T, H - nh + 1, W - nw + 1)
    n = nh * nw
    patches = _patches(img, nh, nw)
    flat = needles.reshape(T, n)

    def gemm(rows):
        return jnp.dot(
            rows.astype(jnp.bfloat16), patches, preferred_element_type=jnp.float32
        ).astype(jnp.int32)

    if n * 65025 < _EXACT_F32_LIMIT:
        return gemm(flat).reshape(out_shape)
    nd = flat.astype(jnp.int32)
    both = gemm(jnp.concatenate([jnp.right_shift(nd, 4), jnp.bitwise_and(nd, 15)]))
    return (both[:T] * 16 + both[T:]).reshape(out_shape)


def _sliding_sum(arr: jax.Array, k: int, axis: int) -> jax.Array:
    """Exact sliding-window sum of width k along axis.

    Small k (every needle dimension in practice): a k-term sum of shifted
    slices, which XLA fuses into ONE pass with k reads per output element.
    Large k: cumsum differences. Integer adds are exact under either
    association, and the shifted-add intermediates are window sums (smaller
    than the cumsum's running totals), so the caller's overflow dtype
    bounds hold for both."""
    n = arr.shape[axis]
    lead = tuple(slice(None) for _ in range(axis))
    if k <= 16:
        out = arr[lead + (slice(0, n - k + 1),)]
        for d in range(1, k):
            out = out + arr[lead + (slice(d, d + n - k + 1),)]
        return out
    c = jnp.cumsum(arr, axis=axis)
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (1, 0)
    c = jnp.pad(c, pad)
    hi = c[lead + (slice(k, n + 1),)]
    lo = c[lead + (slice(0, n + 1 - k),)]
    return hi - lo


def _banded_ones(n: int, k: int) -> np.ndarray:
    """[n, n-k+1] f32 selector: column c sums rows [c, c+k)."""
    out = np.zeros((n, n - k + 1), np.float32)
    for d in range(k):
        out[np.arange(n - k + 1) + d, np.arange(n - k + 1)] = 1.0
    return out


def window_stats(img: jax.Array, nw: int, nh: int) -> tuple[jax.Array, jax.Array]:
    """(Σp, Σp²) for every nw×nh window -> two [H-nh+1, W-nw+1] arrays.

    Matmul formulation when the window sums are f32-exact (needle area
    small enough that n·65025 < 2²⁴): the row-axis sliding sum is one
    matmul against a banded 0/1 selector (X @ Csel), and the column-axis sum
    is an nh-term shifted-add chain in i32. Exactness of the matmul stage,
    with the precision pinned so no compiler default can change it:
      * Σp: img (≤ 255) and the 0/1 selector are exact bf16 operands,
        accumulated in f32 (preferred_element_type); partial sums
        < 255·nw < 2²⁴.
      * Σp²: img² has up to 16 significant bits, more than bf16 or TF32
        keep, so the dot runs at Precision.HIGHEST (full f32 operands);
        partial sums < 65025·nw < 2²¹.
    Both are exact under any summation order, and the i32 casts are of
    exact integer f32 values.

    Fallback (big needles / i64 territory): exact integer cumsum
    differences; Σp fits i32 for any sane page; Σp² cumsums can exceed 2^31
    on tall pages, so the accumulation dtype is chosen by a static bound.
    """
    H, W = img.shape
    if nh * nw * 65025 < 2**24:
        csel = jnp.asarray(_banded_ones(W, nw))  # [W, W-nw+1]
        pf = img.astype(jnp.float32)
        r1 = jnp.dot(
            img.astype(jnp.bfloat16), csel.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        ).astype(jnp.int32)
        r2 = jnp.dot(
            pf * pf, csel, precision=jax.lax.Precision.HIGHEST
        ).astype(jnp.int32)
        Hs = H - nh + 1
        sp = r1[0:Hs]
        s2p = r2[0:Hs]
        for d in range(1, nh):
            sp = sp + r1[d : d + Hs]
            s2p = s2p + r2[d : d + Hs]
        return sp, s2p
    i32_ok_sum = W * 255 < 2**31 and H * nw * 255 < 2**31
    i32_ok_sq = W * 65025 < 2**31 and H * nw * 65025 < 2**31
    dt_sum = jnp.int32 if i32_ok_sum else jnp.int64
    dt_sq = jnp.int32 if i32_ok_sq else jnp.int64
    p = img.astype(dt_sum)
    sp = _sliding_sum(_sliding_sum(p, nw, axis=1), nh, axis=0)
    p2 = (img.astype(dt_sq)) ** 2
    s2p = _sliding_sum(_sliding_sum(p2, nw, axis=1), nh, axis=0)
    return sp.astype(jnp.int32), s2p.astype(jnp.int32)


@functools.partial(
    jax.jit, static_argnames=("nw", "nh", "cap", "eps")
)
def ncc_candidates(
    img: jax.Array,  # [H, W] inverted page u8/i32
    needles: jax.Array,  # [T, nh, nw] u8
    s_n: jax.Array,  # [T] i64 needle sums
    s2_n: jax.Array,  # [T] i64 needle sum-of-squares
    threshold: jax.Array,  # f32 scalar
    *,
    nw: int,
    nh: int,
    cap: int,
    eps: float = 1e-3,
):
    """Find candidate match positions for every needle of one size group.

    Returns (idx, acc, sp, s2p, counts):
      idx    [T, cap] i32 — scan-order linear indices into the (y>=1, x>=1)
                            search domain (row-major), -1 padded
      acc    [T, cap] i32 — exact integer correlation at each candidate
      sp     [T, cap] i32 — exact window Σp
      s2p    [T, cap] i32 — exact window Σp²
      counts [T] i32      — total positions passing the ε-guarded threshold
                            (may exceed cap; host falls back if so)

    The candidate set is a superset of the true matches (ε guard band); the
    host replays the exact f64 similarity per candidate.
    """
    n = nw * nh
    with jax.named_scope("ncc_correlate"):
        acc_full = correlate(img, needles)  # [T, H', W'] i32
    with jax.named_scope("ncc_window_stats"):
        sp_full, s2p_full = window_stats(img, nw, nh)

    # search domain excludes x=0 and y=0 (ncc.rs:279, ncc.cpp:98)
    acc = acc_full[:, 1:, 1:]
    sp = sp_full[1:, 1:]
    s2p = s2p_full[1:, 1:]
    T = acc.shape[0]
    H2, W2 = sp.shape

    with jax.named_scope("ncc_mask"):
        nf = jnp.float32(n)
        sp_f = sp.astype(jnp.float32)
        norm2p_f = s2p.astype(jnp.float32) - (sp_f * sp_f) / nf
        norm2p_exact = s2p.astype(jnp.int64) * n - sp.astype(jnp.int64) ** 2
        s_n_f = s_n.astype(jnp.float32)[:, None, None]
        # exact i64 sign for the needle variance (f32 can flip a tiny positive
        # variance of a near-uniform needle to <= 0 and drop all its matches)
        norm2n_int = jnp.int64(n) * s2_n.astype(jnp.int64) - s_n.astype(jnp.int64) ** 2
        norm2n_f = norm2n_int.astype(jnp.float32) / nf  # [T], >= 0 where valid
        num_f = acc.astype(jnp.float32) - s_n_f * sp_f[None] * (jnp.float32(1.0) / nf)
        valid = (sp[None] > 0) & (norm2p_exact[None] > 0) & (norm2n_int[:, None, None] > 0)
        # division-free ε-superset test. Soundness requires BOTH sides bounded:
        #   * num_f >= num_exact - slack (magnitudes <= n·255² so the f32 error
        #     chain is <= ~2⁻²⁴·c·n·65025);
        #   * the denominator must be a certified LOWER bound — norm2p_f can
        #     round ABOVE the exact value, and near zero variance the sqrt
        #     amplifies that error by sqrt(norm2n)/2√norm2p, which no additive
        #     slack covers (a true sim=1.0 match on a high-mean page was dropped
        #     by the previous formulation). Subtracting the absolute error bound
        #     before the sqrt makes den_lo <= den_exact always, so
        #       num_exact > thr·den_exact  =>  num_f + slack > thr·den_lo.
        # Extra candidates are killed by the exact f64 host replay. The error
        # terms bound separately rounded f32 ops; an FMA contraction of
        # a*b+c, which GPU compilers apply by default, rounds once where they
        # allow twice, and sqrt/divide within a few ulp stay inside the
        # 2⁻²¹/2⁻²² factors.
        err_p = jnp.float32(8.0 * 2.0**-24 * n * 65025)  # |norm2p_f - exact| bound
        den_lo = (
            jnp.sqrt(jnp.maximum(norm2n_f * jnp.float32(1.0 - 2.0**-22), 0.0))[:, None, None]
            * jnp.sqrt(jnp.maximum(norm2p_f - err_p, 0.0))[None]
            * jnp.float32(1.0 - 2.0**-21)
        )
        # ... but the bound direction flips with the threshold's sign: for
        # thr_m < 0 (legal: sim ∈ [-1, 1]), thr_m·den_lo >= thr_m·den_exact and
        # a LOWER bound would raise the cut — use the UPPER bound there
        den_hi = (
            jnp.sqrt(norm2n_f * jnp.float32(1.0 + 2.0**-22))[:, None, None]
            * jnp.sqrt(jnp.maximum(norm2p_f + err_p, 0.0))[None]
            * jnp.float32(1.0 + 2.0**-21)
        )
        slack = jnp.float32(32.0 * 2.0**-24 * n * 65025 + 16.0)
        thr_m = threshold.astype(jnp.float32) - jnp.float32(eps)
        den_bound = jnp.where(thr_m >= 0, den_lo, den_hi)
        mask = valid & (num_f > thr_m * den_bound - slack)

        lin = jnp.arange(H2 * W2, dtype=jnp.int32).reshape(H2, W2)
        big = jnp.int32(2**31 - 1)
        key = jnp.where(mask, lin[None], big).reshape(T, H2 * W2)
    with jax.named_scope("ncc_top_k"):
        k = min(cap, H2 * W2)
        neg_top, _ = jax.lax.top_k(-key, k)  # first `k` scan-order indices
        idx = -neg_top  # ascending
    with jax.named_scope("ncc_gather"):
        found = idx < big
        idx_safe = jnp.where(found, idx, 0)
        acc_g = jnp.take_along_axis(acc.reshape(T, -1), idx_safe, axis=1)
        sp_g = jnp.take_along_axis(jnp.broadcast_to(sp.reshape(-1), (T, H2 * W2)), idx_safe, axis=1)
        s2p_g = jnp.take_along_axis(
            jnp.broadcast_to(s2p.reshape(-1), (T, H2 * W2)), idx_safe, axis=1
        )
        counts = mask.reshape(T, -1).sum(axis=1).astype(jnp.int32)
        idx_out = jnp.where(found, idx, -1)
        return idx_out, acc_g, sp_g, s2p_g, counts
