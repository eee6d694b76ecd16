"""REAL multi-process (multi-host-shaped) smoke test, CPU only.

Spawns 2 OS processes, each `jax.distributed.initialize`'d with 4 virtual
CPU devices, and runs the PRODUCTION sharded paths over the resulting
8-device global mesh — the same put_global / fetch_global machinery that a
multi-host deployment uses (SURVEY.md §5.8):

  * focr grid decode via GridDecoder(mesh=...).decode_batch — every process
    must reconstruct the full corpus' decoded text (fetch_global's
    process_allgather branch handles the non-addressable shards);
  * ncc corpus search via NccMatcher.get_hits_many_sharded — the shard_map
    candidate sweep (parallel/decode.py::make_sharded_ncc_fn); the smoke
    asserts that sharded executables were built, not just that results
    match, in both the object and the struct result forms.

Both results are asserted bit-identical to the local single-chip engines.
It never touches an accelerator (JAX_PLATFORMS=cpu in every worker).
The 8-virtual-device dryrun cannot catch cross-process bugs (it is one
process); this tool is the real thing. Exit code 0 = all processes passed.

Usage: python tools/multihost_smoke.py [port]
(pytest wrapper: tests/test_multihost.py)
"""

import os
import sys


def worker(pid: int, port: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=4"
    ).strip()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        f"127.0.0.1:{port}", num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2, jax.process_count()

    import numpy as np

    from focr_jax.fonts import DEJAVU_MONO
    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page
    from focr_jax.models.focr import GridDecoder
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.types import DecodeOptions, RenderOptions
    from focr_jax.parallel.mesh import page_mesh

    mesh = page_mesh(jax.devices())
    face = Face(DEJAVU_MONO)
    ropts = RenderOptions(size=9.0)
    dopts = DecodeOptions(x_start=2, y_start=2, line_height=11, line_advance=12, width=60)
    alphabet = "ABab01"
    shape = (40, 72)
    texts = [["ABab01", "ba10BA"], ["01abAB", "AA11bb"], ["baAB10", "B0a1bA"]]
    pages = np.stack(
        [synthesize_page(face, t, dopts, ropts, alphabet, shape) for t in texts]
    )

    # focr: sharded mesh decode == local single-chip decode, on EVERY process
    dec_sharded = GridDecoder(face, alphabet, dopts, ropts, shape, mesh=mesh)
    dec_local = GridDecoder(face, alphabet, dopts, ropts, shape)
    got = [[ln.text for ln in lines] for lines in dec_sharded.decode_batch(pages)]
    want = [[ln.text for ln in lines] for lines in dec_local.decode_batch(pages)]
    assert got == want, f"[p{pid}] focr sharded != local: {got} vs {want}"
    assert any(any(t.strip() for t in lines) for lines in got), "decoded nothing"

    # ncc: sharded corpus search == per-page local search, on EVERY process
    m = NccMatcher(face, "ABab", ropts, x_bits=1, threshold=0.8)
    key = lambda hs: [
        (h.letter, h.x, h.y, h.w, h.h, np.float32(h.similarity).tobytes()) for h in hs
    ]
    sharded = m.get_hits_many_sharded(list(pages), mesh)
    assert m._sharded_fns, f"[p{pid}] the sharded ncc sweep never ran"
    local = [m.get_hits(p) for p in pages]
    assert any(len(h) > 0 for h in local), "ncc found nothing"
    assert [key(h) for h in sharded] == [key(h) for h in local], (
        f"[p{pid}] ncc sharded != local"
    )
    st = m.get_hits_many_sharded(list(pages), mesh, struct=True)
    got_st = [key(s.to_objects()) for s in st]
    assert got_st == [key(h) for h in local], f"[p{pid}] ncc struct path"
    print(f"[p{pid}] multihost smoke OK", flush=True)


def main() -> int:
    import socket
    import subprocess

    if len(sys.argv) > 2:  # worker invocation: <pid> <port>
        worker(int(sys.argv[1]), int(sys.argv[2]))
        return 0
    if len(sys.argv) > 1:
        port = int(sys.argv[1])
    else:
        with socket.socket() as s:  # pick a free port
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), str(i), str(port)])
        for i in range(2)
    ]
    try:
        # shorter than the pytest wrapper's 540s budget so a rendezvous hang
        # is reaped HERE (both workers killed below) rather than orphaned
        # when pytest kills only this orchestrator
        rcs = [p.wait(timeout=420) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    print(f"multihost smoke rcs={rcs}")
    # signal deaths have NEGATIVE return codes — max() would mask a worker
    # that crashed after printing its OK line
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
