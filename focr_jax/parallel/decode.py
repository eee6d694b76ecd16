"""Mesh-sharded decode steps (focr grid SSD + ncc candidate search).

Replaces the reference's rayon page fan-out (main.rs:442-471, ncc.rs:839-847)
with SPMD over a (pages × glyphs) ``jax.sharding.Mesh``:

  * pages axis: each chip holds a slice of the [B, H, W] page batch (pure DP).
  * glyphs axis: the focr template bank's glyph dimension is sharded (TP);
    each chip computes a partial first-min argmin over its glyph slice and an
    ``all_gather`` over the axis combines the partials. Because shards hold
    contiguous ascending glyph-id ranges and ``jnp.argmin`` takes the first
    occurrence, the combined result reproduces the reference's first-minimum
    tie-break (min_by_key, main.rs:159-172) exactly.

Glyph padding: when the glyph count doesn't divide the shard count, the bank
is padded with copies of glyph 0. A padded duplicate can never win the global
argmin: its metric equals glyph 0's, glyph 0 lives in shard 0 at index 0, and
the first-min combine prefers the earlier index on ties.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from focr_jax.fonts.bank import GridBank
from focr_jax.ops import ssd
from focr_jax.parallel.mesh import GLYPHS_AXIS, PAGES_AXIS


def _pad_glyph_axis(arr: np.ndarray, g_mult: int) -> np.ndarray:
    """Pad axis 1 (glyphs) to a multiple of g_mult with copies of glyph 0."""
    G = arr.shape[1]
    rem = (-G) % g_mult
    if rem == 0:
        return arr
    fill = np.repeat(arr[:, :1], rem, axis=1)
    return np.concatenate([arr, fill], axis=1)


def make_sharded_grid_fn(bank: GridBank, ys: tuple[int, ...], x0: int, mesh: Mesh):
    """[B, H, W] u8 pages -> (ids [B, R, C] i32, white [B, R] bool), SPMD.

    The single-chip equivalent is models/focr.py::make_strip_forward (which
    crops strips on the host); this version takes whole pages, extracts
    strips on-device, and shards pages over PAGES_AXIS and the glyph bank
    over GLYPHS_AXIS.
    B must be a multiple of the pages-axis size (use mesh.pad_batch).
    """
    n_g = mesh.shape[GLYPHS_AXIS]
    tmpl_np = _pad_glyph_axis(bank.templates, n_g)  # [C, Gp, h, win]
    tsq_np = _pad_glyph_axis(bank.tsq[..., None], n_g)[..., 0]  # [C, Gp]
    Gl = tmpl_np.shape[1] // n_g
    win_w = bank.win_w
    crop_w, crop_h = bank.crop_w, bank.crop_h
    wx0 = bank.wx0

    tmpl_sh = NamedSharding(mesh, P(None, GLYPHS_AXIS, None, None))
    tsq_sh = NamedSharding(mesh, P(None, GLYPHS_AXIS))
    tmpl_j = jax.device_put(jnp.asarray(tmpl_np), tmpl_sh)
    tsq_j = jax.device_put(jnp.asarray(tsq_np.astype(np.int32)), tsq_sh)

    def shard_fn(pages_blk, tmpl_blk, tsq_blk):
        # pages_blk [b, H, W]; tmpl_blk [C, Gl, h, win]; tsq_blk [C, Gl]
        inv = 255 - pages_blk.astype(jnp.int32)
        strips = ssd.extract_strips(inv, ys, crop_h, x0, crop_w)  # [b, R, h, crop_w]
        white = jnp.max(strips, axis=(2, 3)) == 0
        wins = ssd.extract_windows(strips, wx0, win_w)  # [b, R, C, h, win]
        metric = ssd.ssd_metric(wins, tmpl_blk, tsq_blk)  # [b, R, C, Gl]
        loc_idx = jnp.argmin(metric, axis=-1).astype(jnp.int32)  # first min
        loc_val = jnp.take_along_axis(metric, loc_idx[..., None], axis=-1)[..., 0]
        g_off = jax.lax.axis_index(GLYPHS_AXIS).astype(jnp.int32) * Gl
        vals = jax.lax.all_gather(loc_val, GLYPHS_AXIS)  # [n_g, b, R, C]
        idxs = jax.lax.all_gather(loc_idx + g_off, GLYPHS_AXIS)
        # first-min across shards == global first-min (shards ascend by id)
        s = jnp.argmin(vals, axis=0)
        ids = jnp.take_along_axis(idxs, s[None], axis=0)[0]
        return ids, white

    mapped = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P((PAGES_AXIS,)),
            P(None, GLYPHS_AXIS, None, None),
            P(None, GLYPHS_AXIS),
        ),
        out_specs=(P((PAGES_AXIS,)), P((PAGES_AXIS,))),
        check_vma=False,
    )

    @jax.jit
    def fn(pages):
        return mapped(pages, tmpl_j, tsq_j)

    return fn


def make_sharded_ncc_fn(
    mesh: Mesh, needles: np.ndarray, s_n, s2_n, threshold, *, cap: int, chunk: int
):
    """Batched ncc candidate search sharded over all devices.

    pages [B, H, W] (B a multiple of the device count) -> per-page candidate
    tuples (idx, acc, sp, s2p, counts), batch axis sharded over the whole mesh
    (NCC has no glyph-parallel axis worth sharding: the template bank is tiny
    and every needle sweeps the full page). Each device sweeps its local
    pages ``chunk`` at a time (lax.map), so its peak memory is that of
    ``chunk`` pages' [T, H', W'] planes, whatever the corpus size."""
    from focr_jax.ops import ncc as ncc_ops

    nh, nw = needles.shape[-2], needles.shape[-1]
    needles_j = jnp.asarray(needles)
    s_n_j = jnp.asarray(s_n)
    s2_n_j = jnp.asarray(s2_n)
    thr = jnp.asarray(np.float32(threshold))
    spec = P((PAGES_AXIS, GLYPHS_AXIS))

    def one_page(page):
        return ncc_ops.ncc_candidates(
            page, needles_j, s_n_j, s2_n_j, thr, nw=nw, nh=nh, cap=cap
        )

    def local(pages_blk):
        return jax.lax.map(one_page, pages_blk, batch_size=chunk)

    return jax.jit(
        shard_map(local, mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
    )
