"""chip_smoke.py at a tiny size on the CPU backend: every phase runs and
checks parity here, and the script refuses to report a result without a GPU
(its timings mean something only on the card)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

TINY = chip_smoke.Workload(
    shape=(64, 150), grid=(4, 3, 12, 15, 130), size=11.0, lines=3, chars=14,
    prop_chars=10, focr_pages=3, prop_pages=2, ncc_pages=3, cli_pages=2,
    focr_oracle_pages=1, ncc_oracle_pages=1, batch=2, workers=2,
)


@pytest.fixture(scope="module")
def corpus():
    return chip_smoke.make_corpus(TINY)


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_cpu_backend(argv, capsys):
    assert chip_smoke.main(argv, workload=TINY) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_alone_fails_without_the_repo(tmp_path):
    shutil.copy(chip_smoke.__file__, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_focr_matches_truth(corpus):
    lines, dec = chip_smoke.phase_focr(TINY, corpus, chip_smoke.CompileCounter())
    assert len(lines) == TINY.focr_pages and dec.banks


def test_phase_prop_stays_on_device(corpus):
    lines, dec = chip_smoke.phase_prop(TINY, corpus, chip_smoke.CompileCounter())
    assert len(lines) == TINY.prop_pages and dec.n_host_pages == 0


def test_phase_ncc_no_host_overflow(corpus, capsys):
    got, m = chip_smoke.phase_ncc(TINY, corpus, chip_smoke.CompileCounter())
    assert len(got) == TINY.ncc_pages and m.n_host_overflow == 0
    assert all(keys for keys, _ in got)
    assert "memory_analysis" in capsys.readouterr().out


def test_run_one_card_all_phases(corpus, capsys):
    chip_smoke.run_one_card(TINY, chip_smoke.CompileCounter())
    out = capsys.readouterr().out
    for tag in ("[cli] parity ok", "[exact] parity ok", "[focr] parity ok",
                "[prop] parity ok", "get_hits_native", "get_hits_oracle"):
        assert tag in out, tag


def test_run_four_cards_on_virtual_devices(capsys):
    chip_smoke.run_four_cards(TINY, chip_smoke.CompileCounter(), jax.devices()[:4])
    out = capsys.readouterr().out
    for tag in ("[four focr 4x1] parity ok", "[four focr 2x2] parity ok",
                "[four ncc] parity ok", "[four prop] parity ok"):
        assert tag in out, tag
