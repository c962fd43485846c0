"""
Process-local (sharded) dataset ingestion for multi-host inference.

`sample_dataset` follows the host-global multi-process model: every process
holds the FULL dataset and all host-side work is replicated (DESIGN.md
section 6b) — fine at 10k x 100 frames (~100 MB), wrong for datasets too
large to replicate. `sample_dataset_sharded` is the process-local answer:

- each process loads ONLY its shard of trajectories (e.g. its own CSV
  file(s), `bild_jax.io.load_trajectories_csv(..., return_ids=True)`);
- processes agree on the global schedule (length buckets, chunk
  composition, PRNG keys) from an all-gathered METADATA table — global ids
  and frame counts, 16 bytes per trajectory — never the data;
- each chunk's global device batch is assembled with
  `jax.make_array_from_process_local_data` (`feed_process_local`): process
  p materializes exactly the rows its devices own;
- host-side per-trajectory work (informed-init DP segmentation) runs on
  each process's LOCAL rows only, and its per-row proposal arrays are fed
  the same way;
- per-trajectory PRNG keys derive from the trajectory's GLOBAL ID
  (``fold_in(key, id)``, `sample_batch(row_keys=...)`), not its batch
  position — so results are bit-identical regardless of process count or
  chunk composition: the 2-process disjoint-shard run reproduces the
  single-process full-data run exactly (`tests/test_distributed.py::
  test_two_process_sharded_ingestion`).

Bit-identity scope: exact for a fixed ``chunk_size`` (fixed compiled
shapes) across process counts, shard orderings, and chunk compositions —
the per-row math is row-independent, so where a trajectory lands cannot
change its result. Changing ``chunk_size`` compiles a different program
whose f32 reduction order differs; across chunk sizes results agree at
float32 kernel tolerance, not bitwise.

Results (small: evidence curves + profiles) are still replicated to every
process — that is deliberate, exactly-once checkpointing and SPMD-identical
host control flow depend on it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import List, Optional, Sequence

import numpy as np

import jax

from .batch import TrajectoryBatch, sample_batch, _informed_proposals_all_k_impl
from .dataset import DatasetResults
from .mesh import broadcast_from_process0, feed_process_local, is_multiprocess

__all__ = ["sample_dataset_sharded"]

_FILLER_ID = np.int64(1) << 31     # filler-row key namespace (ids must be < 2^31)


def _allgather_metadata(ids, lengths, digest):
    """All-gather each process's (ids, lengths) metadata table and dataset
    digest. Returns (ids, lengths, owner) over the GLOBAL dataset plus the
    per-process digests. Single-process: trivial."""
    P = jax.process_count()
    me = jax.process_index()
    if P == 1:
        return ids, lengths, np.zeros(len(ids), dtype=int), digest[None]

    from jax.experimental import multihost_utils
    n_local = np.asarray([len(ids)])
    counts = np.asarray(multihost_utils.process_allgather(n_local)).reshape(P)
    n_max = int(counts.max())
    table = np.full((n_max, 2), -1, dtype=np.int64)
    table[: len(ids), 0] = ids
    table[: len(ids), 1] = lengths
    tables = np.asarray(multihost_utils.process_allgather(table))
    tables = tables.reshape(P, n_max, 2)
    digests = np.asarray(multihost_utils.process_allgather(digest))
    digests = digests.reshape(P, -1)

    all_ids, all_len, owner = [], [], []
    for p in range(P):
        all_ids.append(tables[p, : counts[p], 0])
        all_len.append(tables[p, : counts[p], 1])
        owner.append(np.full(counts[p], p))
    return (np.concatenate(all_ids), np.concatenate(all_len),
            np.concatenate(owner), digests)


def _row_owner_map(mesh, chunk_size):
    """Process owning each row of a chunk-sized, data-sharded batch."""
    D = mesh.shape["data"]
    if mesh.devices.size != D:
        raise ValueError(
            "sample_dataset_sharded needs a mesh whose only >1 axis is "
            f"'data'; got shape {dict(mesh.shape)}")
    rows_per_dev = chunk_size // D
    dev_proc = np.asarray([d.process_index for d in mesh.devices.flat])
    return np.repeat(dev_proc, rows_per_dev)         # (chunk_size,)


def sample_dataset_sharded(model, local_trajs: Sequence, local_ids,
                           mesh=None,
                           k_max=10,
                           steps_per_k=20,
                           N=128,
                           dE=0.0,
                           scout_steps=None,
                           refine_top=3,
                           informed_init=True,
                           marginals=False,
                           chunk_size=1024,
                           bucket_edges=(64, 128, 256, 512, 1024),
                           key=None,
                           checkpoint_dir=None,
                           show_progress=False,
                           **sample_kw) -> DatasetResults:
    """
    Full-dataset inference where each process holds only ITS shard.

    Parameters
    ----------
    local_trajs, local_ids : this process's trajectories and their GLOBAL
        integer ids (unique across processes, 0 <= id < 2^31; e.g. the
        ``traj_id`` column of a sharded CSV). Every process calls with its
        own disjoint shard; ids establish the global result order.
    mesh : process-spanning `Mesh` from ``make_mesh(distributed=True)``
        whose only >1 axis is ``data``. ``None`` = single-process
        full-data mode (same scheduler, no feeding) — the reference run
        that sharded launches are bit-identical to.
    Other parameters mirror `sample_dataset`.

    Returns `DatasetResults` (identical on every process) ordered by
    ascending global id; ``DatasetResults.ids`` carries the id per row.

    Notes
    -----
    Chunks are composed so that each process's devices receive rows that
    process already owns (no host-side data exchange); ownership imbalance
    is padded with filler rows, so keep shards of comparable size. PRNG
    streams are keyed by trajectory ID (`sample_batch(row_keys=...)`),
    which is what makes results independent of process count and chunk
    composition. Per-chunk checkpointing works as in `sample_dataset`
    (process 0 writes; content-tagged by metadata + per-process data
    digests + configuration).
    """
    local_ids = np.asarray(local_ids, dtype=np.int64)
    if len(local_ids) != len(local_trajs):
        raise ValueError(f"{len(local_trajs)} trajectories vs "
                         f"{len(local_ids)} ids")
    if len(local_ids) and (local_ids.min() < 0
                           or local_ids.max() >= int(_FILLER_ID)):
        raise ValueError("global ids must be in [0, 2^31)")
    if len(np.unique(local_ids)) != len(local_ids):
        raise ValueError("duplicate ids in the local shard")

    multiproc = mesh is not None and is_multiprocess(mesh)
    if mesh is not None:
        D = mesh.shape["data"]
        if chunk_size % D != 0:
            raise ValueError(f"chunk_size={chunk_size} must be divisible by "
                             f"the mesh data axis ({D})")
    if key is None:
        seed = np.random.randint(2**31)
        if multiproc:
            seed = int(broadcast_from_process0(np.int64(seed)))
        key = jax.random.key(seed)
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)

    # ---- metadata agreement (never the data) -----------------------------
    local_lengths = np.asarray([len(t) for t in local_trajs], dtype=np.int64)
    h = hashlib.sha256()
    for t in local_trajs:
        h.update(np.ascontiguousarray(np.asarray(t.data)).tobytes())
        h.update(np.ascontiguousarray(np.asarray(t.valid)).tobytes())
    digest = np.frombuffer(h.digest(), dtype=np.uint8)
    ids_g, len_g, owner_g, digests = _allgather_metadata(
        local_ids, local_lengths, digest)
    if len(np.unique(ids_g)) != len(ids_g):
        raise ValueError("global ids are not disjoint across processes")
    # canonical global order: ascending id (the result order)
    perm = np.argsort(ids_g, kind="stable")
    ids_g, len_g, owner_g = ids_g[perm], len_g[perm], owner_g[perm]

    # spatial dimension must agree across shards (a process may hold none)
    d_local = np.asarray([local_trajs[0].d if len(local_trajs) else -1])
    if multiproc:
        from jax.experimental import multihost_utils
        d_all = np.asarray(multihost_utils.process_allgather(d_local)).ravel()
    else:
        d_all = d_local
    d_dim = int(d_all.max())
    if d_dim <= 0:
        raise ValueError("no trajectories on any process")
    if np.any((d_all > 0) & (d_all != d_dim)):
        raise ValueError(f"inconsistent trajectory dimension across "
                         f"processes: {d_all.tolist()}")

    local_by_id = {int(i): t for i, t in zip(local_ids, local_trajs)}
    me = jax.process_index()
    P = jax.process_count() if multiproc else 1

    config = ("sharded-v1", k_max, steps_per_k, N, scout_steps, refine_top,
              informed_init, marginals, chunk_size, float(dE),
              np.asarray(jax.random.key_data(key)).tolist(),
              digests.tobytes().hex())
    if sample_kw:
        config += (sorted(sample_kw.items()),)
    fingerprint = getattr(model, "likelihood_fingerprint", lambda: None)()
    if fingerprint is not None:
        config += (fingerprint,)
    config_str = repr(config)

    # ---- schedule: buckets -> ownership-aligned chunks -------------------
    edges = sorted(bucket_edges)
    buckets = {}
    for gi in range(len(ids_g)):
        T = int(len_g[gi])
        pad = next((e for e in edges if T <= e), T)
        buckets.setdefault(pad, []).append(gi)

    if mesh is not None:
        row_owner = _row_owner_map(mesh, chunk_size)
    else:
        row_owner = np.zeros(chunk_size, dtype=int)

    work = []           # (T_pad, row_gidx (chunk_size,), with -1 = filler)
    for pad in sorted(buckets):
        gis = buckets[pad]
        T_pad = min(pad, int(max(len_g[gi] for gi in gis)))
        per_proc = [[gi for gi in gis if owner_g[gi] == p] for p in range(P)]
        quota = [int(np.sum(row_owner == p)) for p in range(P)]
        n_chunks = max(
            -(-len(per_proc[p]) // quota[p]) if quota[p] else 0
            for p in range(P))
        taken = [0] * P
        for c in range(n_chunks):
            rows = np.full(chunk_size, -1, dtype=np.int64)
            for r in range(chunk_size):
                p = row_owner[r]
                if taken[p] < len(per_proc[p]):
                    rows[r] = per_proc[p][taken[p]]
                    taken[p] += 1
            work.append((T_pad, rows))

    # ---- per-chunk inference ---------------------------------------------
    B_total = len(ids_g)
    K1out = k_max + 1
    evidence = np.full((B_total, K1out), np.nan)
    evidence_se = np.full((B_total, K1out), np.nan)
    profiles_by_k: List[Optional[np.ndarray]] = [None] * B_total
    margs_by_traj: List[Optional[np.ndarray]] = [None] * B_total
    mom_all = np.ones((B_total, K1out), dtype=bool)

    iterator = work
    if show_progress:
        try:
            from tqdm.auto import tqdm
            iterator = tqdm(work, desc="chunks")
        except ImportError:
            pass

    for c, (T_pad, rows) in enumerate(iterator):
        ck_path, loaded = None, None
        if checkpoint_dir is not None:
            hh = hashlib.sha256()
            hh.update(config_str.encode())
            hh.update(rows.tobytes())
            hh.update(np.asarray([T_pad]).tobytes())
            ck_path = os.path.join(checkpoint_dir,
                                   f"shard_chunk_{hh.hexdigest()[:16]}.npz")
            hit = os.path.exists(ck_path)
            if multiproc:
                hit = bool(broadcast_from_process0(np.int64(hit)))
                if hit and not os.path.exists(ck_path):
                    raise FileNotFoundError(
                        f"process 0 has checkpoint {ck_path} but this "
                        f"process cannot read it (shared filesystem needed)")
            if hit:
                loaded = np.load(ck_path)

        lengths = np.where(rows >= 0, len_g[np.maximum(rows, 0)], 0)
        if loaded is not None:
            ev, se = loaded["evidence"], loaded["evidence_se"]
            maps = loaded["map_profiles"]
            marg = loaded["marginals"] if marginals else None
            mom = loaded["mom_ok"]
        else:
            # local rows (this process's slots, in row order)
            mine = np.where(row_owner == me)[0] if mesh is not None \
                else np.arange(chunk_size)
            loc_data = np.zeros((len(mine), T_pad, d_dim))
            loc_valid = np.zeros((len(mine), T_pad), dtype=bool)
            for j, r in enumerate(mine):
                gi = rows[r]
                if gi < 0:
                    continue
                t = local_by_id[int(ids_g[gi])]
                loc_data[j, : len(t)] = np.asarray(t.data)
                loc_valid[j, : len(t)] = np.asarray(t.valid)

            # per-trajectory device inputs: model.lockstep_fns on the LOCAL
            # rows only (its host-side table builds — Factorized scipy
            # tables, GGM interval tables — must never see the global
            # batch), leaves fed into one global data-sharded array each
            local_batch = TrajectoryBatch(
                data=loc_data, valid=loc_valid,
                lengths=np.asarray(lengths[mine]))
            per_traj_l, logL_fn = model.lockstep_fns(local_batch)
            if mesh is not None:
                per_traj_g = jax.tree_util.tree_map(
                    lambda x: feed_process_local(np.asarray(x), mesh,
                                                 global_batch=chunk_size),
                    per_traj_l)
            else:
                per_traj_g = per_traj_l
            # the batch argument now only carries shapes + true lengths
            batch = TrajectoryBatch(
                data=np.zeros((chunk_size, T_pad, 0)),
                valid=np.zeros((chunk_size, T_pad), dtype=bool),
                lengths=np.asarray(lengths))

            # informed init: DP on LOCAL rows only, proposal arrays fed
            informed_arrays = None
            if informed_init:
                n_states = len(model.transitions)
                K1 = min(k_max, max(T_pad - 1, 0)) + 1
                inf = _informed_proposals_all_k_impl(
                    model, local_batch, K1, n_states, T_pad)
                if inf is not None and mesh is not None:
                    a_l, lp_l, use_l = inf
                    informed_arrays = tuple(
                        jax.numpy.moveaxis(
                            feed_process_local(
                                np.ascontiguousarray(np.moveaxis(x, 1, 0)),
                                mesh, global_batch=chunk_size),
                            0, 1)
                        for x in (a_l, lp_l, use_l))
                elif inf is not None:
                    informed_arrays = inf

            # PRNG keyed by global trajectory id (filler: disjoint namespace)
            row_ids = np.where(rows >= 0, ids_g[np.maximum(rows, 0)],
                               _FILLER_ID + np.arange(chunk_size))
            row_keys = jax.vmap(
                lambda i: jax.random.fold_in(key, i))(
                    jax.numpy.asarray(row_ids.astype(np.uint32)))

            res = sample_batch(
                model, batch, k_max=k_max, steps_per_k=steps_per_k, N=N,
                dE=dE, scout_steps=scout_steps, refine_top=refine_top,
                informed_init=False, informed_arrays=informed_arrays,
                lockstep=(per_traj_g, logL_fn),
                marginals=marginals, mesh=mesh, key=key, row_keys=row_keys,
                **sample_kw)
            ev, se, maps = res.evidence, res.evidence_se, res.map_profiles
            marg, mom = res.marginals, res.mom_ok
            if ck_path is not None and not (multiproc
                                            and jax.process_index() != 0):
                tmp = ck_path + ".tmp.npz"
                np.savez(tmp, evidence=ev, evidence_se=se,
                         map_profiles=maps,
                         marginals=(marg if marginals else np.zeros(0)),
                         mom_ok=mom)
                os.replace(tmp, ck_path)

        k_here = ev.shape[1]
        for r in range(chunk_size):
            gi = rows[r]
            if gi < 0:
                continue
            evidence[gi, :k_here] = ev[r]
            evidence[gi, k_here:] = -np.inf
            evidence_se[gi, :k_here] = se[r]
            evidence_se[gi, k_here:] = 1e-10
            mom_all[gi, :k_here] = mom[r]
            Ti = int(len_g[gi])
            prof = np.zeros((K1out, Ti), dtype=int)
            prof[:k_here] = maps[:, r, :Ti]
            profiles_by_k[gi] = prof
            if marginals:
                n = marg.shape[2]
                m = np.full((K1out, n, Ti), -np.inf)
                m[:k_here] = marg[:, r, :, :Ti]
                margs_by_traj[gi] = m

    return DatasetResults(
        k=np.arange(K1out),
        evidence=evidence,
        evidence_se=evidence_se,
        profiles_by_k=profiles_by_k,
        dE=dE,
        marginals=margs_by_traj if marginals else None,
        mom_ok=mom_all,
        ids=ids_g,
    )
