"""Device-mesh construction for multi-chip scale-out.

The reference's only parallelism is a rayon thread pool over page images
(main.rs:442-471; ncc.rs:839-847). The device equivalent (SURVEY.md §2.5,
§5.8) is a 2-D ``jax.sharding.Mesh``:

  * ``pages``  axis — data parallelism: page batches are sharded across chips;
    each chip decodes its shard, results are gathered in page order.
  * ``glyphs`` axis — tensor parallelism over the template bank: the glyph
    axis of the SSD metric is sharded, each chip computes a partial
    (min, argmin) over its glyph slice, and an ``all_gather`` over the axis
    combines them with the reference's first-minimum tie-break.

The glyph-axis all_gather is the only collective (matching is
embarrassingly page-parallel, SURVEY.md §5.8). Every card of a host reaches
every other at the same rate, so the mesh shape follows the algorithm
alone.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PAGES_AXIS = "pages"
GLYPHS_AXIS = "glyphs"


def page_mesh(
    devices: list | None = None, glyph_shards: int = 1
) -> Mesh:
    """Build the (pages × glyphs) mesh over ``devices`` (default: all).

    ``glyph_shards`` must divide the device count; the pages axis takes the
    rest. With a single device this degenerates to a 1×1 mesh and every
    sharded function runs unpartitioned — one code path for 1..N chips.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n % glyph_shards != 0:
        raise ValueError(f"glyph_shards={glyph_shards} must divide device count {n}")
    arr = np.asarray(devices).reshape(n // glyph_shards, glyph_shards)
    return Mesh(arr, (PAGES_AXIS, GLYPHS_AXIS))


def pages_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a [B, ...] page batch: batch split over every device."""
    return NamedSharding(mesh, P((PAGES_AXIS, GLYPHS_AXIS)))


def auto_mesh(glyph_shards: int = 1) -> Mesh | None:
    """The CLIs' --mesh auto policy: bring up multi-host if configured, then
    return the all-devices mesh when more than one device is visible (None =
    single-chip path, identical results)."""
    maybe_init_distributed()
    if jax.device_count() > 1:
        return page_mesh(glyph_shards=glyph_shards)
    return None


def maybe_init_distributed() -> bool:
    """Multi-host bring-up (SURVEY.md §5.8): call jax.distributed.initialize
    when a coordinator is configured, so page batches shard across hosts as
    well as across the devices of one host. No-op for the common
    single-process case.

    Configured by the standard JAX coordinator variables, all three
    required: JAX_COORDINATOR_ADDRESS (host:port), JAX_NUM_PROCESSES and
    JAX_PROCESS_ID.
    """
    import os

    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not addr:
        return False
    jax.distributed.initialize(
        coordinator_address=addr,
        num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
        process_id=int(os.environ["JAX_PROCESS_ID"]),
    )
    return True


def merge_shards(shards, shape, dtype) -> np.ndarray:
    """Ordered merge of ``(global_index, ndarray)`` shards into the dense
    global array. The global index (a tuple of slices) places each shard at
    its batch position, so the merged result reproduces the reference's
    sort-by-page-order contract (main.rs:468) no matter which device produced
    which shard; replicated shards overwrite with identical values."""
    out = np.empty(shape, dtype)
    for idx, data in shards:
        out[idx] = data
    return out


def fetch_global(tree):
    """Fetch (possibly mesh-sharded) device results to host numpy.

    Single-process: ONE jax.device_get — it issues async copies for every
    leaf before blocking, one transfer round trip for the whole tree.

    Multi-process (SURVEY.md §5.8): a bare device_get would throw on
    non-addressable shards, so each leaf is instead (a) reassembled from its
    addressable shards via merge_shards when this process can see all of
    them, or (b) process_allgather'd across processes when it cannot. Every process
    returns the full global value, so downstream page-order assembly is
    identical to the single-host path.
    """
    if jax.process_count() == 1:
        return jax.device_get(tree)
    from jax.experimental import multihost_utils

    def leaf(x):
        if not isinstance(x, jax.Array):
            return np.asarray(x)
        if x.is_fully_addressable:
            shards = x.addressable_shards
            datas = jax.device_get([s.data for s in shards])
            return merge_shards(
                zip((s.index for s in shards), datas), x.shape, x.dtype
            )
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))

    return jax.tree_util.tree_map(leaf, tree)


def put_global(arr: np.ndarray, sharding: NamedSharding):
    """Upload a host batch as a mesh-sharded global array, multi-host safe.

    Assumes every process holds the FULL host batch (the CLI model: each
    process loads the same corpus from shared storage). Single-process this
    is a plain device_put; multi-process each host materializes exactly its
    addressable shards by slicing the full batch with the shard's global
    index, so no process touches a non-addressable device."""
    import jax.numpy as jnp

    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(arr), sharding)
    return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])


def pad_batch(pages: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad the batch axis up to ``multiple`` (padded pages are all-white, so
    the all-white row skip makes them decode to nothing). Returns (padded,
    original_count)."""
    B = pages.shape[0]
    rem = (-B) % multiple
    if rem == 0:
        return pages, B
    pad = np.full((rem,) + pages.shape[1:], 255, dtype=pages.dtype)
    return np.concatenate([pages, pad], axis=0), B
