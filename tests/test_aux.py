"""Auxiliary-subsystem tests: bank disk cache, per-page error isolation,
structured metrics (SURVEY.md §5.3-§5.5)."""

import io
import json
import os
import sys

import numpy as np
import pytest

from focr_jax.models.types import BoxSize, DecodeOptions, RenderOptions


def test_grid_bank_cache_roundtrip(mono_font_path, tmp_path, monkeypatch):
    from focr_jax.fonts.bank import build_grid_bank
    from focr_jax.fonts.ft import Face

    monkeypatch.setenv("FOCR_CACHE_DIR", str(tmp_path))
    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    cold = build_grid_bank(face, "AB01", ropts, 120, 13)
    assert len(os.listdir(tmp_path)) == 1
    warm = build_grid_bank(face, "AB01", ropts, 120, 13)
    np.testing.assert_array_equal(cold.templates, warm.templates)
    np.testing.assert_array_equal(cold.tsq, warm.tsq)
    np.testing.assert_array_equal(cold.wx0, warm.wx0)
    np.testing.assert_array_equal(cold.positions, warm.positions)
    # a different geometry must not collide
    other = build_grid_bank(face, "AB01", ropts, 121, 13)
    assert other.templates.shape != cold.templates.shape or not np.array_equal(
        other.templates, cold.templates
    )
    assert len(os.listdir(tmp_path)) == 2


def test_needle_bank_cache_roundtrip(mono_font_path, tmp_path, monkeypatch):
    from focr_jax.fonts.bank import build_needles
    from focr_jax.fonts.ft import Face

    monkeypatch.setenv("FOCR_CACHE_DIR", str(tmp_path))
    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    cold = build_needles(face, "AB0", ropts, BoxSize.ALPHABET, 1, 0)
    warm = build_needles(face, "AB0", ropts, BoxSize.ALPHABET, 1, 0)
    assert len(cold) == len(warm) == 6
    for a, b in zip(cold, warm):
        assert a.letter == b.letter
        assert a.offset == b.offset
        assert a.corrected_offset == b.corrected_offset
        assert a.s_n == b.s_n and a.s2_n == b.s2_n
        np.testing.assert_array_equal(a.pixels, b.pixels)


def test_cache_disabled_env(tmp_path, monkeypatch):
    from focr_jax.utils import cache

    monkeypatch.setenv("FOCR_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("FOCR_NO_BANK_CACHE", "1")
    cache.store_arrays("k", {"a": np.arange(3)})
    assert cache.load_arrays("k") is None
    assert os.listdir(tmp_path) == []


def _synth_page(mono_font_path, lines, tmp_path, name):
    from PIL import Image

    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.types import FOCR_DEFAULT_ALPHABET

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=13, line_advance=15, width=120)
    page = synthesize_page(face, lines, dopts, ropts, FOCR_DEFAULT_ALPHABET, (64, 140))
    p = tmp_path / name
    Image.fromarray(page).save(p)
    return str(p), dopts


def test_focr_cli_error_isolation(mono_font_path, tmp_path, capsys):
    from focr_jax.cli.focr import main

    good, dopts = _synth_page(mono_font_path, ["AB01"], tmp_path, "good.png")
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all")
    metrics = tmp_path / "m.json"
    rc = main(
        ["-i", str(bad), good, "-f", mono_font_path, "-t", "11",
         "-x", "5", "-y", "6", "-w", "120", "--line-height", "13",
         "--line-advance", "15", "--metrics-json", str(metrics)]
    )
    assert rc == 0
    cap = capsys.readouterr()
    assert "AB01" in cap.out  # the good page still decoded
    assert "ERROR" in cap.err and "bad.png" in cap.err
    m = json.loads(metrics.read_text())
    assert m["pages"] == 2 and m["decoded_pages"] == 1
    assert m["errors"][0]["page"].endswith("bad.png")
    assert m["pages_per_sec"] > 0

    # --strict restores reference panic semantics
    with pytest.raises(Exception):
        main(
            ["-i", str(bad), "-f", mono_font_path, "-t", "11", "-x", "5",
             "-y", "6", "-w", "120", "--line-height", "13",
             "--line-advance", "15", "--strict"]
        )


def test_ncc_cli_error_isolation(mono_font_path, tmp_path, capsys):
    from focr_jax.cli.ncc import main

    good, _ = _synth_page(mono_font_path, ["AB01"], tmp_path, "good.png")
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"junk")
    metrics = tmp_path / "m.json"
    rc = main(
        ["-i", str(bad), good, "-f", mono_font_path, "-t", "11",
         "-a", "AB01", "--metrics-json", str(metrics)]
    )
    assert rc == 0
    cap = capsys.readouterr()
    assert "AB01" in cap.out
    assert "ERROR" in cap.err
    m = json.loads(metrics.read_text())
    assert m["pages"] == 2 and m["decoded_pages"] == 1 and m["engine"] == "device"
    with pytest.raises(Exception):
        main(["-i", str(bad), "-f", mono_font_path, "-t", "11", "-a", "AB01",
              "--strict"])


def test_metrics_stderr_dash(capsys):
    from focr_jax.utils.metrics import write_metrics

    write_metrics("-", a=1)
    cap = capsys.readouterr()
    assert cap.out == ""  # stdout stays data-only
    assert json.loads(cap.err) == {"a": 1}


def test_load_gray_pnm_formats(tmp_path):
    """The reference's image crate enables png+pnm (Cargo.toml:10); load_gray
    must read PGM/PPM/PBM identically to PNG."""
    import numpy as np
    from PIL import Image

    from focr_jax.io.images import load_gray

    rng = np.random.default_rng(3)
    gray = rng.integers(0, 256, (24, 31), dtype=np.uint8)
    Image.fromarray(gray).save(tmp_path / "p.png")
    Image.fromarray(gray).save(tmp_path / "p.pgm")
    Image.fromarray(np.stack([gray] * 3, -1)).save(tmp_path / "p.ppm")
    want = load_gray(str(tmp_path / "p.png"))
    assert np.array_equal(load_gray(str(tmp_path / "p.pgm")), want)
    # gray RGB -> Rec.709 luma of equal channels == the channel value
    assert np.array_equal(load_gray(str(tmp_path / "p.ppm")), want)
    bits = gray > 127
    Image.fromarray(bits).save(tmp_path / "p.pbm")
    got = load_gray(str(tmp_path / "p.pbm"))
    assert np.array_equal(got, np.where(bits, 255, 0).astype(np.uint8))


def test_ncc_metrics_counts_match_object_path(mono_font_path, tmp_path):
    """--metrics-json lines/hits must be identical whether post-processing ran
    through the fused text path (default) or the object path (--csv forces
    it) — hits == decoded characters either way."""
    from focr_jax.cli.ncc import main

    p, _ = _synth_page(mono_font_path, ["AB01", "10BA"], tmp_path, "p.png")
    vals = []
    for extra in ([], ["--csv"]):
        metrics = tmp_path / f"m{len(extra)}.json"
        rc = main(["-i", p, "-f", mono_font_path, "-t", "11", "-a", "AB01",
                   "--metrics-json", str(metrics), *extra])
        assert rc == 0
        m = json.loads(metrics.read_text())
        vals.append((m["lines"], m["hits"]))
    assert vals[0] == vals[1] and vals[0][0] >= 2 and vals[0][1] >= 6


@pytest.mark.parametrize("backend,env_dir", [("gpu", None), ("gpu", "set"), ("cpu", None)])
def test_compile_cache_placement(backend, env_dir, tmp_path, monkeypatch):
    """Where JAX_COMPILATION_CACHE_DIR is set the package sets no directory
    (JAX reads the variable itself); unset, the cache goes to the fixed
    <repo>/.jax_cache/; on the CPU backend it is never enabled here."""
    import jax

    import focr_jax

    env_value = str(tmp_path / "jaxcache") if env_dir else None
    if env_value:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_value)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(focr_jax, "_compile_cache_decided", False)
    monkeypatch.setattr(focr_jax._jax, "default_backend", lambda: backend)
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", env_value)
        focr_jax.enable_compile_cache()
        got = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = {
        ("gpu", None): os.path.join(repo, ".jax_cache"),
        ("gpu", "set"): env_value,
        ("cpu", None): None,
    }[(backend, env_dir)]
    assert got == want


def test_bank_cache_defaults_inside_checkout(monkeypatch):
    from focr_jax.utils import cache

    monkeypatch.delenv("FOCR_CACHE_DIR", raising=False)
    monkeypatch.delenv("FOCR_NO_BANK_CACHE", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.cache_dir() == os.path.join(repo, ".bank_cache")


def test_device_path_never_imports_pillow():
    """Pillow is only for reading and writing image files: decoding page
    arrays on the device path must not import it."""
    import subprocess

    code = (
        "import sys, numpy as np\n"
        "from focr_jax.fonts import DEJAVU_MONO\n"
        "from focr_jax.fonts.ft import Face\n"
        "from focr_jax.io.synth import synthesize_page\n"
        "from focr_jax.models.focr import decode_pages\n"
        "from focr_jax.models.ncc import NccMatcher\n"
        "from focr_jax.models.types import DecodeOptions, RenderOptions\n"
        "f = Face(DEJAVU_MONO); r = RenderOptions(size=11.0)\n"
        "d = DecodeOptions(x_start=4, y_start=4, line_height=13, line_advance=15, width=100)\n"
        "p = synthesize_page(f, ['AB01'], d, r, 'AB01', (40, 120))\n"
        "decode_pages([p], f, 'AB01', d, r)\n"
        "NccMatcher(f, 'AB', r).get_hits_many([p])\n"
        "assert 'PIL' not in sys.modules, 'PIL imported'\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
        timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
