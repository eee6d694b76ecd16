"""Multi-chip sharding parity tests on the 8-device virtual CPU mesh.

SURVEY.md §4: mesh logic is validated with
XLA_FLAGS=--xla_force_host_platform_device_count=8 (conftest.py) — the
sharded decode must produce bit-identical ids/masks to the single-chip path.
"""

import numpy as np
import jax
import pytest

from focr_jax.fonts.ft import Face
from focr_jax.fonts.bank import build_grid_bank, build_needles
from focr_jax.models.focr import GridDecoder, _row_groups
from focr_jax.models.types import BoxSize, DecodeOptions, RenderOptions
from focr_jax.io.synth import synthesize_page, random_text_lines
from focr_jax.parallel.mesh import page_mesh, pad_batch
from focr_jax.parallel.decode import make_sharded_grid_fn, make_sharded_ncc_fn

ALPHA = "ABC abc019+/"


@pytest.fixture(scope="module")
def setup(mono_font_path):
    face = Face(mono_font_path)
    ropts = RenderOptions(size=10.0)
    dopts = DecodeOptions(x_start=4, y_start=3, line_height=12, line_advance=14, width=120)
    shape = (64, 136)
    rng = np.random.default_rng(7)
    pages = np.stack(
        [
            synthesize_page(
                face, random_text_lines(rng, ALPHA.replace(" ", "A"), 3, 9),
                dopts, ropts, ALPHA, shape,
            )
            for _ in range(6)
        ]
    )
    return face, ropts, dopts, shape, pages


@pytest.mark.parametrize("glyph_shards", [1, 2, 4])
def test_sharded_grid_matches_single_chip(setup, glyph_shards):
    face, ropts, dopts, shape, pages = setup
    mesh = page_mesh(glyph_shards=glyph_shards)
    dec = GridDecoder(face, ALPHA, dopts, ropts, shape)
    padded, B = pad_batch(pages, mesh.shape["pages"])
    from focr_jax.models.focr import crop_strips

    for (grp, fn_single) in dec.groups:
        bank = build_grid_bank(face, ALPHA, ropts, dec.crop_w, grp.crop_h)
        fn_sharded = make_sharded_grid_fn(bank, grp.ys, dec.x0, mesh)
        strips = crop_strips(pages, grp.ys, grp.crop_h, dec.x0, dec.crop_w)
        ids_s, white_s = jax.device_get(fn_single(strips))
        ids_m, white_m = jax.device_get(fn_sharded(padded))
        np.testing.assert_array_equal(ids_m[:B], ids_s)
        np.testing.assert_array_equal(white_m[:B], white_s)


def test_sharded_decode_end_to_end(setup):
    """Full sharded pipeline decodes the synthetic pages to the exact text."""
    face, ropts, dopts, shape, pages = setup
    mesh = page_mesh(glyph_shards=2)
    dec = GridDecoder(face, ALPHA, dopts, ropts, shape)
    expect = dec.decode_batch(pages)
    padded, B = pad_batch(pages, mesh.shape["pages"])
    grp, _ = dec.groups[0]
    bank = build_grid_bank(face, ALPHA, ropts, dec.crop_w, grp.crop_h)
    fn = make_sharded_grid_fn(bank, grp.ys, dec.x0, mesh)
    ids, white = jax.device_get(fn(padded))
    chars = np.array(list(ALPHA))
    for b in range(B):
        got = [
            "".join(chars[ids[b, r]])
            for r, y in enumerate(grp.ys)
            if not white[b, r]
        ]
        want = [ln.text for ln in expect[b] if ln.y in grp.ys]
        assert got == want
    # padded all-white pages decode to nothing
    for b in range(B, padded.shape[0]):
        assert white[b].all()


@pytest.mark.parametrize("n_dev,chunk", [(8, 1), (2, 3), (2, 8)])
def test_sharded_ncc_matches_single_chip(setup, mono_font_path, n_dev, chunk):
    """Each device sweeps its local pages ``chunk`` at a time (lax.map);
    every chunking, remainder included, equals the per-page sweep."""
    face, ropts, dopts, shape, pages = setup
    from focr_jax.ops import ncc as ncc_ops
    import jax.numpy as jnp

    needles = build_needles(face, "AB0", ropts, BoxSize.ALPHABET, 0, 0)
    bank = np.stack([n.pixels for n in needles])
    s_n = np.array([n.s_n for n in needles], dtype=np.int64)
    s2_n = np.array([n.s2_n for n in needles], dtype=np.int64)
    mesh = page_mesh(jax.devices()[:n_dev], glyph_shards=1)
    padded, B = pad_batch(pages, mesh.size)
    inv = (255 - padded.astype(np.int32)).astype(np.uint8)
    fn = make_sharded_ncc_fn(mesh, bank, s_n, s2_n, 0.8, cap=256, chunk=chunk)
    idx_m, acc_m, sp_m, s2p_m, counts_m = jax.device_get(fn(jnp.asarray(inv)))
    for b in range(B):
        idx, acc, sp, s2p, counts = jax.device_get(
            ncc_ops.ncc_candidates(
                jnp.asarray(inv[b]), jnp.asarray(bank), jnp.asarray(s_n),
                jnp.asarray(s2_n), jnp.asarray(np.float32(0.8)),
                nw=bank.shape[2], nh=bank.shape[1], cap=256,
            )
        )
        np.testing.assert_array_equal(idx_m[b], idx)
        np.testing.assert_array_equal(counts_m[b], counts)


def test_grid_decoder_mesh_parity(mono_font_path):
    """GridDecoder(mesh=...) must match the single-chip decoder exactly,
    including batch padding/trim for non-divisible batch sizes."""
    import numpy as np

    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.focr import GridDecoder
    from focr_jax.models.types import DecodeOptions, RenderOptions
    from focr_jax.parallel.mesh import page_mesh

    face = Face(mono_font_path)
    ropts = RenderOptions(size=10.0)
    dopts = DecodeOptions(x_start=3, y_start=4, line_height=12, line_advance=14, width=100)
    shape = (50, 115)
    rng = np.random.default_rng(5)
    pages = np.stack([
        synthesize_page(
            face,
            ["".join(rng.choice(list("AB01ab"), size=9)) for _ in range(3)],
            dopts, ropts, "AB01ab", shape,
        )
        for _ in range(3)  # deliberately not a multiple of the mesh size
    ])
    single = GridDecoder(face, "AB01ab", dopts, ropts, shape)
    mesh = page_mesh(glyph_shards=2)
    sharded = GridDecoder(face, "AB01ab", dopts, ropts, shape, mesh=mesh)
    a = single.decode_batch(pages)
    b = sharded.decode_batch(pages)
    assert [[(l.text, l.y) for l in p] for p in a] == [
        [(l.text, l.y) for l in p] for p in b
    ]


def test_focr_cli_mesh_auto(mono_font_path, tmp_path, capsys):
    """--mesh auto routes through the sharded decoder on the 8-dev CPU mesh."""
    from PIL import Image

    from focr_jax.cli.focr import main
    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.types import DecodeOptions, FOCR_DEFAULT_ALPHABET, RenderOptions

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=120)
    page = synthesize_page(face, ["AB01"], dopts, ropts, FOCR_DEFAULT_ALPHABET, (64, 140))
    p = tmp_path / "m.png"
    Image.fromarray(page).save(p)
    rc = main(["-i", str(p), "-f", mono_font_path, "-t", "11", "-x", "5", "-y", "6",
               "-w", "120", "--line-height", "13", "--line-advance", "15",
               "--glyph-shards", "2"])
    assert rc == 0
    assert "AB01" in capsys.readouterr().out


def test_ncc_sharded_matches_single(mono_font_path):
    """get_hits_many_sharded over the 8-dev mesh == per-page get_hits, bit for
    bit, including batch padding for a non-divisible page count."""
    import numpy as np

    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.types import DecodeOptions, RenderOptions
    from focr_jax.parallel.mesh import page_mesh

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    pages = [
        synthesize_page(face, [t], dopts, ropts, "AB01ab", (64, 128))
        for t in ("AB01ab", "ba10BA", "A0b1aB")
    ]
    m = NccMatcher(face, "AB01ab", ropts, x_bits=1)
    mesh = page_mesh(glyph_shards=1)
    sharded = m.get_hits_many_sharded(pages, mesh)
    single = [m.get_hits(p) for p in pages]
    key = lambda hs: [(h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in hs]
    assert [key(h) for h in sharded] == [key(h) for h in single]


def test_ncc_sharded_fused_post(mono_font_path):
    """post= fused into the sharded path must yield the object pipeline's
    exact text lines."""
    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.post import process_hits, process_hits_text
    from focr_jax.models.types import DecodeOptions, RenderOptions
    from focr_jax.parallel.mesh import page_mesh

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    pages = [
        synthesize_page(face, [t], dopts, ropts, "AB01ab", (64, 128))
        for t in ("AB01ab", "ba10BA", "A0b1aB")
    ]
    mesh = page_mesh(glyph_shards=1)
    post = lambda hs: process_hits_text(hs, 0.95, 5)
    m = NccMatcher(face, "AB01ab", ropts, x_bits=1)
    fused = m.get_hits_many_sharded(pages, mesh, struct=True, post=post)
    want = [
        ["".join(h.letter for h in ln) for ln in process_hits(m.get_hits(p), 0.95, 5)]
        for p in pages
    ]
    assert fused == want


def test_ncc_cli_mesh_auto(mono_font_path, tmp_path, capsys):
    from PIL import Image

    from focr_jax.cli.ncc import main
    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.types import DecodeOptions, RenderOptions

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    paths = []
    for i, t in enumerate(("AB01ab", "ba10BA")):
        page = synthesize_page(face, [t], dopts, ropts, "AB01ab", (64, 128))
        p = tmp_path / f"{i}.png"
        Image.fromarray(page).save(p)
        paths.append(str(p))
    rc = main(["-i", *paths, "-f", mono_font_path, "-t", "11", "-a", "AB01ab",
               "--x-bits", "2"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["AB01ab", "ba10BA"]


def test_prop_decoder_mesh_parity(sans_font_path):
    """Proportional-font sequential decode sharded over the 8-dev mesh must
    equal the single-chip decode exactly (lines are pure DP; padding lines
    are trimmed)."""
    import numpy as np

    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.focr import GridDecoder
    from focr_jax.models.types import DecodeOptions, RenderOptions
    from focr_jax.parallel.mesh import page_mesh

    face = Face(sans_font_path)
    alpha = "AWim01"
    ropts = RenderOptions(size=12.0)
    dopts = DecodeOptions(x_start=4, y_start=5, line_height=16, line_advance=19, width=110)
    shape = (65, 130)
    rng = np.random.default_rng(11)
    pages = np.stack([
        synthesize_page(
            face,
            ["".join(rng.choice(list(alpha), size=7)) for _ in range(3)],
            dopts, ropts, alpha, shape,
        )
        for _ in range(3)  # 3 pages x 3 rows = 9 lines (not a multiple of 8)
    ])
    single = GridDecoder(face, alpha, dopts, ropts, shape)
    sharded = GridDecoder(face, alpha, dopts, ropts, shape, mesh=page_mesh())
    assert sharded.prop_groups and sharded.prop_groups[0][1].mesh is not None
    a = single.decode_batch(pages)
    b = sharded.decode_batch(pages)
    assert [[(l.text, l.y) for l in p] for p in a] == [
        [(l.text, l.y) for l in p] for p in b
    ]


def test_merge_shards_reproduces_global_order(setup):
    """The §5.8 multi-host gather's merge: reassembling a mesh-sharded array
    from its (global_index, data) shards must equal the full device_get —
    this is the exact code path fetch_global takes for each leaf under
    jax.process_count() > 1 (non-addressable-safe), validated here on the
    8-virtual-device mesh where every shard IS addressable."""
    from focr_jax.parallel.mesh import merge_shards, pages_sharding

    mesh = page_mesh()
    arr = np.arange(8 * 3 * 5, dtype=np.int32).reshape(8, 3, 5)
    x = jax.device_put(arr, pages_sharding(mesh))
    shards = x.addressable_shards
    datas = jax.device_get([s.data for s in shards])
    merged = merge_shards(
        zip((s.index for s in shards), datas), x.shape, x.dtype
    )
    np.testing.assert_array_equal(merged, jax.device_get(x))
    # shard order must not matter (processes see shards in device order,
    # which need not be batch order)
    merged_rev = merge_shards(
        zip((s.index for s in reversed(shards)), datas[::-1]), x.shape, x.dtype
    )
    np.testing.assert_array_equal(merged_rev, arr)


def test_put_global_callback_matches_device_put(setup):
    """put_global's multi-process branch (make_array_from_callback slicing
    the full host batch per shard) must build the same global array as the
    single-process device_put branch."""
    from focr_jax.parallel.mesh import pages_sharding

    mesh = page_mesh()
    sh = pages_sharding(mesh)
    arr = np.arange(16 * 4, dtype=np.uint8).reshape(16, 4)
    via_put = jax.device_put(arr, sh)
    via_cb = jax.make_array_from_callback(arr.shape, sh, lambda idx: arr[idx])
    assert via_cb.sharding.is_equivalent_to(via_put.sharding, arr.ndim)
    np.testing.assert_array_equal(jax.device_get(via_cb), jax.device_get(via_put))


def test_fetch_global_multiprocess_branch(setup, monkeypatch):
    """fetch_global under a simulated process_count > 1 must take the
    shard-merge branch and still return the exact global values."""
    import focr_jax.parallel.mesh as mesh_mod
    from focr_jax.parallel.mesh import fetch_global, pages_sharding

    mesh = page_mesh()
    arr = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    x = jax.device_put(arr, pages_sharding(mesh))
    monkeypatch.setattr(mesh_mod.jax, "process_count", lambda: 2)
    out = fetch_global({"a": x, "b": np.int64(3)})
    np.testing.assert_array_equal(out["a"], arr)
    assert out["b"] == 3


def test_sharded_fn_cache_keyed_by_mesh_value(mono_font_path):
    """The per-(mesh, group) jit cache must key meshes by VALUE, not id():
    an id()-keyed cache can silently reuse a compiled fn for a dead mesh
    whose address a different mesh later reuses. Value keying also means two
    equal meshes (same devices + axis names) share one entry — which is
    correct, the compiled fn only depends on the mesh value."""
    from jax.sharding import Mesh

    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.types import DecodeOptions, RenderOptions
    from focr_jax.parallel.mesh import page_mesh

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=110)
    page = synthesize_page(face, ["AB01"], dopts, ropts, "AB01", (64, 128))
    m = NccMatcher(face, "AB01", ropts, x_bits=0)
    mesh = page_mesh(glyph_shards=1)
    m.get_hits_many_sharded([page], mesh)
    assert m._sharded_fns, "sharded path did not populate the cache"
    assert all(isinstance(k[0], Mesh) for k in m._sharded_fns)
    # an equal mesh object hits the same entries (jax may intern equal
    # meshes, so this can be the same object — the invariant under test is
    # VALUE lookup, which holds either way and survives de-interning)
    mesh_eq = Mesh(mesh.devices, mesh.axis_names)
    assert all((mesh_eq, *k[1:]) in m._sharded_fns for k in list(m._sharded_fns))
    # a mesh with different axis names misses, even at whatever address
    mesh_other = Mesh(mesh.devices.reshape(mesh.devices.size, 1), ("rows", "cols"))
    assert all((mesh_other, *k[1:]) not in m._sharded_fns for k in list(m._sharded_fns))


def test_hbm_budget_from_device_memory_stats(monkeypatch):
    """Wave sizing derives its HBM budget from the device's reported
    capacity (45%), falling back to 4 GB when the backend reports none
    (models/ncc.py::_hbm_budget)."""
    from focr_jax.models import ncc as ncc_mod

    class Dev:
        def __init__(self, stats):
            self._stats = stats

        def memory_stats(self):
            return self._stats

    try:
        ncc_mod._hbm_budget.cache_clear()
        monkeypatch.setattr(
            ncc_mod.jax, "local_devices", lambda: [Dev({"bytes_limit": 16 << 30})]
        )
        assert ncc_mod._hbm_budget() == int((16 << 30) * 0.45)
        ncc_mod._hbm_budget.cache_clear()
        monkeypatch.setattr(ncc_mod.jax, "local_devices", lambda: [Dev(None)])
        assert ncc_mod._hbm_budget() == 4 << 30
    finally:
        ncc_mod._hbm_budget.cache_clear()
