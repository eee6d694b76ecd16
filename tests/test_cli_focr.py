"""focr CLI end-to-end: stdout/stderr contract, test/verify modes."""

import os

import numpy as np
import pytest

from focr_jax.cli.focr import main as focr_main
from focr_jax.fonts.ft import Face
from focr_jax.io.images import load_gray, save_gray
from focr_jax.io.synth import synthesize_page
from focr_jax.models.types import DecodeOptions, FOCR_DEFAULT_ALPHABET, RenderOptions
from tests.test_focr_oracle import width_for_cells


@pytest.fixture(scope="module")
def mono(mono_font_path):
    return Face(mono_font_path)


@pytest.fixture()
def synth_png(tmp_path, mono):
    ropts = RenderOptions(size=13.0)
    w = width_for_cells(mono, ropts, 6)
    dopts = DecodeOptions(x_start=5, y_start=6, line_height=12, line_advance=15, width=w)
    lines = ["Abc123", "> =xyz"]
    page = synthesize_page(mono, lines, dopts, ropts, FOCR_DEFAULT_ALPHABET, (60, 80))
    path = tmp_path / "page.png"
    save_gray(str(path), page)
    return str(path), dopts, lines


def run_cli(args, capsys):
    rc = focr_main(args)
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


def test_single_image_decode(synth_png, mono_font_path, capsys):
    path, d, lines = synth_png
    rc, out, err = run_cli(
        ["-i", path, "-f", mono_font_path, "-t", "13", "-x", str(d.x_start),
         "-y", str(d.y_start), "-w", str(d.width), "--line-height", "12",
         "--line-advance", "15"],
        capsys,
    )
    assert rc == 0
    assert out.splitlines() == lines


def test_multi_image_order(synth_png, mono_font_path, capsys):
    path, d, lines = synth_png
    rc, out, err = run_cli(
        ["-i", path, path, "-f", mono_font_path, "-t", "13", "-x", str(d.x_start),
         "-y", str(d.y_start), "-w", str(d.width), "--line-height", "12",
         "--line-advance", "15"],
        capsys,
    )
    assert out.splitlines() == lines + lines


def test_verify_mode(synth_png, mono_font_path, tmp_path, capsys):
    path, d, lines = synth_png
    vdir = tmp_path / "verify"
    vdir.mkdir()
    rc, out, err = run_cli(
        ["-i", path, "-f", mono_font_path, "-t", "13", "-x", str(d.x_start),
         "-y", str(d.y_start), "-w", str(d.width), "--line-height", "12",
         "--line-advance", "15", "--verify", str(vdir)],
        capsys,
    )
    assert out.splitlines() == lines
    assert os.path.exists(vdir / "page.png")
    # stderr: "<path> <mse:.6>"
    fields = err.strip().split()
    assert fields[0] == path
    mse = float(fields[1])
    # NOTE: draw_verify pastes each re-rendered line at line.y using the
    # text's own bbox top (main.rs:319-327), so lines whose tallest glyph is
    # shorter than the alphabet's ascent ("> =xyz") sit a few rows lower than
    # the reference ink — nonzero MSE is correct reference behavior (README
    # notes per-page MSE is a relative measure). Line "Abc123" aligns exactly.
    assert 0.0 < mse < 5000.0


def test_test_mode(synth_png, mono_font_path, tmp_path, capsys, monkeypatch):
    path, d, lines = synth_png
    monkeypatch.chdir(tmp_path)
    rc, out, err = run_cli(
        ["-i", path, "-f", mono_font_path, "-t", "13", "-x", str(d.x_start),
         "-y", str(d.y_start), "-w", str(d.width), "--line-height", "12",
         "--line-advance", "15", "--test", "dbg"],
        capsys,
    )
    assert out == ""
    assert os.path.exists(tmp_path / "dbg-rect.png")
    assert os.path.exists(tmp_path / "dbg-text.png")
    rect = load_gray(str(tmp_path / "dbg-rect.png"))
    assert rect.shape == (60, 80)
