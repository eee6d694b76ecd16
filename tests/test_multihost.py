"""Real multi-process smoke (SURVEY.md §5.8), CPU only:
tools/multihost_smoke.py spawns 2 jax.distributed processes (4 virtual CPU
devices each) and runs the production sharded focr + ncc paths over the
global 8-device mesh, asserting bit parity with the local engines on every
process. The in-process
8-virtual-device tests cannot catch cross-process (non-addressable-shard)
bugs — this one executes them for real."""

import os
import subprocess
import sys


def test_two_process_sharded_paths_match_local():
    tool = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tools",
        "multihost_smoke.py",
    )
    env = dict(os.environ)
    # the workers set their own JAX env; drop the conftest's single-process
    # virtual-device forcing so it does not leak into them
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, tool],
        capture_output=True,
        text=True,
        timeout=540,
        env=env,
    )
    assert proc.returncode == 0, (
        f"multihost smoke failed rc={proc.returncode}\n"
        f"stdout:\n{proc.stdout[-4000:]}\nstderr:\n{proc.stderr[-4000:]}"
    )
    assert "[p0] multihost smoke OK" in proc.stdout
    assert "[p1] multihost smoke OK" in proc.stdout
