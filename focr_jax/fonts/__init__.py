"""L1 font layer. ``data/`` holds the two DejaVu faces that the tests,
benchmark and smoke run use (their license is ``data/copyright``), so a
checkout runs without any system font package."""

import os

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
DEJAVU_MONO = os.path.join(DATA_DIR, "DejaVuSansMono.ttf")
DEJAVU_SANS = os.path.join(DATA_DIR, "DejaVuSans.ttf")
