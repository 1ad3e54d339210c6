"""Multi-process (multi-host) runtime support for the sharded stack.

The reference is strictly single-GPU (SURVEY.md §2b); BASELINE configs
4-5 name two-host deployments.  JAX's multi-host model is SPMD at the HOST
level too: every process runs the same program, sees the same global
``jax.devices()`` list, and must participate in every computation over a
global mesh.  This module packages the three things the host wrappers
need to be process-safe:

- ``initialize()``: ``jax.distributed.initialize`` passthrough
  (idempotent; one process per GPU, coordinator given explicitly).
- ``global_mesh(n)``: a 1-D mesh over the GLOBAL device list — the
  multi-host twin of ``sharded.make_mesh`` (which it now backs).
- ``fetch(arr)`` / ``local_rows(arr)``: process-safe reads.  A
  replicated or fully-addressable array fetches directly; an
  axis-sharded array on a multi-host mesh is NOT fully addressable, so
  ``fetch`` all-gathers it (collective — every process must call) while
  ``local_rows`` returns only this process's shards (no communication —
  the right primitive for per-process BlockStore shards).

Host-logic ground rules under multi-process (documented in
MULTIHOST.md, exercised single-process by the test suite where
addressable == global):

1. Every process feeds the SAME frames and runs the SAME wrapper code;
   decisions derived from replicated fetches (poses, StepInfo) are
   identical everywhere, so no explicit broadcast is needed.
2. Anything derived from PER-PROCESS state (a BlockStore shard) must
   not gate a device dispatch — all processes must dispatch every
   computation over the global mesh.  The streaming cycle therefore
   dispatches its restore with a (possibly empty) padded batch whenever
   ``always_dispatch()`` says a peer might have one.
"""

from __future__ import annotations

import numpy as np

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize multi-process JAX (idempotent).

    Pass ``coordinator_address`` (``host:port`` of process 0),
    ``num_processes`` and ``process_id`` explicitly: nothing on a GPU
    host tells JAX its cluster.  Run one process per GPU; collectives
    go over NCCL.  Call BEFORE any other jax API touches the backend.

    The idempotency guard must NOT touch the backend: an earlier version
    checked ``jax.process_count()``, which itself initializes the XLA
    backend and made every real multi-process launch through this
    wrapper fail with "initialize() must be called before any JAX
    calls" (caught by the real 2-process test,
    tests/test_multiprocess.py)."""
    if jax.distributed.is_initialized():
        return  # already initialized
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["local_device_ids"] = None
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except Exception as e:  # single-process run without a coordinator
        if kwargs:
            raise
        # a bare initialize() with no cluster to join is a no-op
        del e


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def process_index() -> int:
    return jax.process_index()


def global_mesh(n_devices: int | None = None):
    """1-D ("d",) mesh over the global device list (all processes' chips
    — ``jax.devices()`` is global under multi-process JAX).  ``n``
    limits to the first n devices (single-process tests)."""
    from jax.sharding import Mesh

    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("d",))


def fetch(arr) -> np.ndarray:
    """Process-safe global read of a (possibly sharded) array.

    Fully-addressable (single-process, or replicated) arrays fetch
    directly.  Otherwise every process must call this together: the
    gather is a collective (``process_allgather``)."""
    if isinstance(arr, np.ndarray):
        return arr
    if getattr(arr, "is_fully_addressable", True):
        return np.asarray(arr)
    if getattr(arr, "is_fully_replicated", False):
        # replicated but multi-host: read the local copy
        return np.asarray(arr.addressable_shards[0].data)
    from jax.experimental import multihost_utils

    # tiled=True: reassemble the GLOBAL array (axis-0 concatenation of
    # the shards).  tiled=False would stack a new leading process axis
    # and is rejected outright for non-fully-addressable inputs
    # (verified by the real 2-process test, tests/test_multiprocess.py).
    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


def local_rows(arr) -> np.ndarray:
    """This process's rows of an axis-0-sharded array, concatenated in
    shard order (no communication).  With a single process this is the
    whole array — which is why the per-process BlockStore code paths are
    fully exercised by the single-process test suite."""
    if isinstance(arr, np.ndarray):
        return arr
    if getattr(arr, "is_fully_addressable", True):
        return np.asarray(arr)
    shards = sorted(
        arr.addressable_shards, key=lambda s: s.index[0].start or 0
    )
    return np.concatenate([np.asarray(s.data) for s in shards])


def gather_concat(local: np.ndarray) -> np.ndarray:
    """Concatenate per-process host arrays (variable axis-0 length)
    across processes, in process order; identity single-process.

    COLLECTIVE: every process must call together, with its own (possibly
    empty) rows.  This is the checkpoint primitive for per-process
    BlockStore shards — each host holds only its devices' evicted
    blocks, but a checkpoint must record the union (see
    utils/checkpoint.save_slam)."""
    if not is_multiprocess():
        return local
    from jax.experimental import multihost_utils

    counts = multihost_utils.process_allgather(
        np.asarray([local.shape[0]], np.int64)
    ).reshape(-1)
    return _gather_with_counts(local, counts)


def _gather_with_counts(local: np.ndarray, counts) -> np.ndarray:
    """Data half of gather_concat, given the already-gathered per-process
    row counts (collective)."""
    from jax.experimental import multihost_utils

    m = int(counts.max())
    if m == 0:
        return local
    pad_rows = m - local.shape[0]
    padded = np.concatenate(
        [local, np.zeros((pad_rows,) + local.shape[1:], local.dtype)]
    ) if pad_rows else local
    stacked = multihost_utils.process_allgather(padded)  # (P, m, ...)
    return np.concatenate(
        [stacked[i, : int(c)] for i, c in enumerate(counts)]
    )


def gather_concat_many(arrays: dict) -> dict:
    """gather_concat over several SAME-LENGTH per-process arrays with ONE
    counts gather (the checkpoint path gathers the BlockStore shard's
    keys/tsdf/weight/born together; each cross-process gather is a DCN
    round-trip worth saving).  Identity single-process; collective
    otherwise."""
    if not is_multiprocess():
        return dict(arrays)
    from jax.experimental import multihost_utils

    lens = {v.shape[0] for v in arrays.values()}
    assert len(lens) == 1, f"mismatched lengths {lens}"
    counts = multihost_utils.process_allgather(
        np.asarray([lens.pop()], np.int64)
    ).reshape(-1)
    return {k: _gather_with_counts(v, counts) for k, v in arrays.items()}


def psum_host(value: int) -> int:
    """Sum a per-process host scalar across processes (identity
    single-process).  COLLECTIVE under multi-process — every process
    must call together with its own value.  Used where host-side
    accounting derives from per-process state (e.g. a BlockStore shard)
    but the recorded number must be the identical global total on every
    process (the SPMD host-logic invariant, MULTIHOST.md)."""
    if not is_multiprocess():
        return int(value)
    from jax.experimental import multihost_utils

    return int(multihost_utils.process_allgather(
        np.asarray([value], np.int64)).sum())


def owner_process_mask(mesh, owner_pos: np.ndarray) -> np.ndarray:
    """True where the mesh position in ``owner_pos`` belongs to THIS
    process (all-True single-process).  Used to filter a global
    checkpointed store down to this process's shard on load."""
    proc_of_pos = np.asarray(
        [d.process_index for d in mesh.devices.flat], np.int64
    )
    return proc_of_pos[owner_pos] == jax.process_index()


def shard_rows_to_global(local: np.ndarray, mesh, spec):
    """Build a global axis-0-sharded device array from this process's
    local rows (the restore-upload primitive: each process contributes
    the batch slices of the devices it hosts).  Single-process this is
    an ordinary device_put."""
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    if not is_multiprocess():
        return jax.device_put(local, sharding)
    from jax import make_array_from_process_local_data

    return make_array_from_process_local_data(sharding, local)
