"""
Device-mesh helpers for multi-chip inference.

Per-trajectory inference is embarrassingly parallel (SURVEY.md section 2,
"Parallelism inventory"), so the primary mesh axis is ``data`` (trajectories);
a second ``prof`` axis optionally shards the AMIS proposal batch within each
trajectory, whose evidence reductions then ride collectives inserted by XLA
under ``jit``-with-shardings (NCCL over NVLink between the cards of a host).
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_batch", "initialize_distributed",
           "is_multiprocess", "fetch_to_host", "broadcast_from_process0",
           "feed_process_local"]


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, **kw):
    """
    Join a multi-process (multi-host) JAX cluster; idempotent.

    Pass ``coordinator_address='host:port', num_processes, process_id``
    (a cluster manager that JAX detects may supply them instead). One
    process drives all the cards of its host; only a multi-host run needs
    this.

    After this, ``jax.devices()`` is the GLOBAL device list and `make_mesh`
    builds process-spanning meshes. Layout guidance for BILD workloads: put
    the ``data`` (trajectory) axis across hosts — per-trajectory inference
    is embarrassingly parallel, so nothing but input placement and result
    gathering crosses the network; keep any ``prof`` axis within a host so
    AMIS evidence reductions stay on NVLink.
    """
    import jax.distributed
    if jax.distributed.is_initialized():
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kw)


def make_mesh(shape=None, axis_names=("data", "prof"), devices=None,
              distributed=False, **distributed_kw) -> Mesh:
    """
    Build a mesh over the available devices. Default: all devices on the
    ``data`` axis, 1 on ``prof``. With ``distributed=True``, first join the
    multi-process cluster (`initialize_distributed`) and span the mesh over
    the GLOBAL device list.
    """
    if distributed:
        initialize_distributed(**distributed_kw)
    devices = np.asarray(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    n_used = int(np.prod(shape))
    if n_used > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n_used} devices; "
                         f"only {len(devices)} available")
    return Mesh(devices[:n_used].reshape(shape), axis_names)


def is_multiprocess(mesh: Mesh) -> bool:
    """True iff the mesh spans devices owned by more than one process
    (multi-host execution: every participating process must run the same
    program on the same global values)."""
    return len({d.process_index for d in mesh.devices.flat}) > 1


def shard_batch(batch, mesh: Mesh, axis="data"):
    """
    Place a pytree with leading batch axis onto the mesh, sharded over
    ``axis``. Scalars (0-d) are replicated; an array whose leading dimension
    is not divisible by the mesh axis raises — silent replication would
    quietly lose all data parallelism (pad first, e.g. with
    `bild_jax.parallel.pad_batch_rows`; `sample_batch` does this
    automatically).

    Works on process-spanning meshes too: every process passes the same
    HOST-GLOBAL values (the standard bild_jax multi-host model — trajectory
    data is small, so each host holds the full batch and the devices split
    the work); each process materializes only its addressable shards. For
    genuinely process-local feeding (each host holds only its own rows) use
    `feed_process_local`. Already-committed device arrays cannot be
    ``device_put`` across processes, so those reshard through a tiny jitted
    identity program instead.
    """
    n_shards = mesh.shape[axis]
    multi = is_multiprocess(mesh)

    def put(x):
        spec = P() if (not hasattr(x, "ndim") or x.ndim == 0) else P(axis)
        if spec != P() and x.shape[0] % n_shards != 0:
            raise ValueError(
                f"leading dimension {x.shape[0]} is not divisible by mesh "
                f"axis '{axis}' ({n_shards}); pad the batch first "
                f"(bild_jax.parallel.pad_batch_rows)")
        sharding = NamedSharding(mesh, spec)
        if multi and isinstance(x, jax.Array):
            if x.is_fully_addressable:
                # committed process-local array: device_put to a
                # non-addressable sharding is rejected; go via host
                x = np.asarray(x)
            else:
                return _reshard(x, sharding)
        return jax.device_put(x, sharding)

    return jax.tree_util.tree_map(put, batch)


def _identity(x):
    return x


_RESHARD_JITS = {}


def _reshard(x, sharding):
    """Reshard a (possibly non-addressable) global array via a jitted
    identity. The jit wrapper is cached per sharding (a handful per run)
    so repeat calls hit the compiled-program cache instead of retracing."""
    fn = _RESHARD_JITS.get(sharding)
    if fn is None:
        fn = jax.jit(_identity, out_shardings=sharding)
        _RESHARD_JITS[sharding] = fn
    return fn(x)


def feed_process_local(local_rows, mesh: Mesh, axis="data",
                       global_batch: int | None = None):
    """
    Build a global, ``axis``-sharded array from each process's OWN rows
    (``jax.make_array_from_process_local_data``): process p passes the rows
    its addressable devices should own, in mesh order. Use when the dataset
    is too large to replicate per host; `shard_batch` covers the
    host-global case.
    """
    local_rows = np.asarray(local_rows)
    if global_batch is None:
        counts = _process_row_fraction(mesh, axis)
        global_batch = int(round(local_rows.shape[0] / counts))
    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_process_local_data(
        sharding, local_rows, (global_batch,) + local_rows.shape[1:])


def _process_row_fraction(mesh: Mesh, axis: str) -> float:
    """Fraction of the global leading axis owned by THIS process."""
    mine = sum(d.process_index == jax.process_index()
               for d in mesh.devices.flat)
    return mine / mesh.devices.size


def fetch_to_host(x, mesh: Mesh | None = None):
    """
    Device array (tree) -> host numpy on EVERY process. Fully-addressable
    arrays convert directly; global (process-spanning) arrays are first
    replicated by a jitted identity all-gather, then each process reads its
    local copy. This is the result-collection path of multi-host runs —
    every process ends up with the same full result, so downstream host
    logic stays SPMD-identical.
    """
    def one(a):
        if not isinstance(a, jax.Array):
            return np.asarray(a)
        if a.is_fully_addressable:
            return np.asarray(a)
        if mesh is None:
            raise ValueError("fetch_to_host needs the mesh for "
                             "non-addressable (multi-process) arrays")
        rep = _reshard(a, NamedSharding(mesh, P()))
        return np.asarray(rep.addressable_data(0))

    return jax.tree_util.tree_map(one, x)


def broadcast_from_process0(tree):
    """
    Replicate host values from process 0 to every process
    (``multihost_utils.broadcast_one_to_all``). Used for exactly-once
    decisions (checkpoint hits, default PRNG keys) and for detecting
    divergent inputs across hosts. No-op in single-process runs.
    """
    if jax.process_count() == 1:
        return tree
    from jax.experimental import multihost_utils
    return multihost_utils.broadcast_one_to_all(tree)
