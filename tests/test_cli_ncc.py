"""ncc CLI end-to-end: text output, csv, raw, --rust differential path."""

import numpy as np
import pytest

from focr_jax.cli.ncc import main as ncc_main
from focr_jax.fonts.ft import Face
from focr_jax.io.images import save_gray
from focr_jax.models.ncc import NccMatcher
from focr_jax.models.types import RenderOptions


@pytest.fixture(scope="module")
def mono(mono_font_path):
    return Face(mono_font_path)


@pytest.fixture(scope="module")
def stamped_page(tmp_path_factory, mono):
    alphabet = "ABCXYZ"
    m = NccMatcher(mono, alphabet, RenderOptions(size=13.0), threshold=0.8)
    by_letter = {nd.letter: nd for nd in m.needles}
    page = np.full((90, 120), 255, dtype=np.uint8)
    lines = ["XABC", "ZYCA"]
    for text, y in zip(lines, (10, 40)):
        for ci, ch in enumerate(text):
            nd = by_letter[ch]
            nh, nw = nd.pixels.shape
            x = 8 + ci * 9
            region = page[y : y + nh, x : x + nw]
            np.minimum(region, 255 - nd.pixels, out=region)
    path = tmp_path_factory.mktemp("ncc") / "page.png"
    save_gray(str(path), page)
    return str(path), lines


def test_cli_text_output(stamped_page, mono_font_path, capsys):
    path, lines = stamped_page
    rc = ncc_main(["-i", path, "-f", mono_font_path, "-t", "13", "-a", "ABCXYZ"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.splitlines() == lines


def test_cli_rust_flag_same_output(stamped_page, mono_font_path, capsys):
    path, lines = stamped_page
    ncc_main(["-i", path, "-f", mono_font_path, "-t", "13", "-a", "ABCXYZ"])
    device_out = capsys.readouterr().out
    ncc_main(["-i", path, "-f", mono_font_path, "-t", "13", "-a", "ABCXYZ", "--rust"])
    oracle_out = capsys.readouterr().out
    assert device_out == oracle_out == "\n".join(lines) + "\n"


def test_cli_csv(stamped_page, mono_font_path, capsys):
    path, lines = stamped_page
    ncc_main(["-i", path, "-f", mono_font_path, "-t", "13", "-a", "ABCXYZ", "--csv"])
    out = capsys.readouterr().out
    rows = [r.split(",") for r in out.splitlines()]
    assert len(rows) == sum(len(l) for l in lines)
    # page index, codepoint, center x/y, rect x/y/w/h
    assert all(len(r) == 8 for r in rows)
    assert rows[0][0] == "0"
    assert chr(int(rows[0][1])) in "ABCXYZ"


def test_cli_raw(stamped_page, mono_font_path, capsys):
    path, lines = stamped_page
    ncc_main(["-i", path, "-f", mono_font_path, "-t", "13", "-a", "ABCXYZ", "--raw"])
    out = capsys.readouterr().out
    rows = [r.split(",") for r in out.splitlines()]
    assert len(rows) >= sum(len(l) for l in lines)
    assert all(len(r) == 11 for r in rows)


def test_cli_multipage_order(stamped_page, mono_font_path, capsys):
    path, lines = stamped_page
    ncc_main(["-i", path, path, "-f", mono_font_path, "-t", "13", "-a", "ABCXYZ"])
    out = capsys.readouterr().out
    assert out.splitlines() == lines + lines


def test_cli_verbose_per_search_format(stamped_page, mono_font_path, capsys):
    """The default (device) engine must print per-(letter, offset) lines in
    the reference's measured format incl. the elapsed fields (ncc.rs:657-666):
      `X` [fx, fy] needle size WxH hits N elapsed Tms (N.NN ns/pixel)
    """
    import re

    path, _ = stamped_page
    ncc_main(["-i", path, "-f", mono_font_path, "-t", "13", "-a", "ABCXYZ", "-v"])
    err = capsys.readouterr().err
    pat = re.compile(
        r"^`(.)` \[[-0-9.]+, [-0-9.]+\] needle size \d+x\d+ hits \d+ "
        r"elapsed \d+ms \(\d+\.\d\d ns/pixel\)$"
    )
    per_search = [l for l in err.splitlines() if pat.match(l)]
    assert len(per_search) == 6  # one per (letter, offset): 6 letters x 1 offset
    # the group summary flags that device spans are attributed estimates
    assert any("estimated" in l for l in err.splitlines() if l.startswith("["))


def test_cli_verbose_sync_measured_timing(stamped_page, mono_font_path, capsys):
    """--verbose-sync: same decoded stdout as the default run, but the group
    timing lines on stderr are labeled as measured wall time (serialized
    dispatch), not estimates — and per-search lines still carry the
    reference's elapsed/ns-per-pixel format (ncc.rs:657-666)."""
    path, lines = stamped_page
    rc = ncc_main(["-i", path, "-f", mono_font_path, "-t", "13", "-a", "ABCXYZ"])
    assert rc == 0
    default_out = capsys.readouterr().out
    rc = ncc_main(
        ["-i", path, "-f", mono_font_path, "-t", "13", "-a", "ABCXYZ", "--verbose-sync"]
    )
    assert rc == 0
    cap = capsys.readouterr()
    assert cap.out == default_out
    assert "measured wall time" in cap.err
    assert "estimated" not in cap.err
    assert "ns/pixel)" in cap.err
    # the per-search lines (one per needle) are present in reference format
    assert any(
        ln.startswith("`") and "elapsed" in ln for ln in cap.err.splitlines()
    )


@pytest.mark.parametrize("flag", [["--device-kernel", "pallas"], ["--wire", "delta"]])
def test_cli_removed_kernel_flags_rejected(stamped_page, mono_font_path, flag, capsys):
    """The device path has one kernel; the options that chose another are
    gone, and argparse refuses them."""
    path, _ = stamped_page
    with pytest.raises(SystemExit) as e:
        ncc_main(["-i", path, "-f", mono_font_path, "-t", "13", *flag])
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err
