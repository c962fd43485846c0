"""Multi-host entry point: a real 2-process jax.distributed CPU cluster
(Gloo collectives), exercising `make_mesh(distributed=True)` and a
process-spanning global reduction. A multi-host GPU cluster uses the same
entry point."""
import socket
import subprocess
import sys
import textwrap

import pytest

pytestmark = pytest.mark.slow  # heavy integration lane

_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    port, pid = sys.argv[1], int(sys.argv[2])
    # under COV=1, collect this worker's line coverage and dump it for the
    # parent test to merge (simplecov.load_data) — the multi-process mesh
    # branches only execute here
    if os.environ.get("COV") not in (None, "", "0"):
        sys.path.insert(0, os.path.join({repo!r}, "tools"))
        import atexit, simplecov
        simplecov.start(os.path.join({repo!r}, "bild_jax"))
        atexit.register(simplecov.dump_data, "cov_worker%d.json" % pid)
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, {repo!r})
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from bild_jax.parallel import make_mesh

    mesh = make_mesh(axis_names=("data",), distributed=True,
                     coordinator_address=f"localhost:{{port}}",
                     num_processes=2, process_id=pid)
    assert len(jax.devices()) == 4, jax.devices()
    assert mesh.shape["data"] == 4

    # per-process local shard -> global array -> cross-process reduction
    arr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("data")), np.full((2,), pid + 1.0))
    total = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(arr)
    assert float(total) == 6.0, float(total)
    print(f"OK {{pid}}", flush=True)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _merge_worker_cov(dirpath):
    """Fold worker-process coverage dumps into this process's collector so
    the suite's COVERAGE.txt counts the multi-process-only branches."""
    import os
    if os.environ.get("COV") in (None, "", "0"):
        return
    import simplecov
    for p in dirpath.glob("cov_worker*.json"):
        simplecov.load_data(str(p))


# Shared dataset builder: executed verbatim in the workers AND in the parent
# test process, so the multi-process run faces the identical inputs as the
# single-process reference run.
_DATASET_SRC = textwrap.dedent("""
    import numpy as np
    import jax
    from scipy import stats as sp_stats
    from bild_jax.models import FactorizedModel

    def build_dataset():
        # the magnitude draws use scipy's global RNG: seed it so every
        # process (and the parent test) builds the identical dataset
        np.random.seed(180355)
        model = FactorizedModel([sp_stats.maxwell(scale=0.1),
                                 sp_stats.maxwell(scale=1)], d=1)
        lengths = [8, 14, 8, 11, 14, 8]
        trajs = []
        for i, T in enumerate(lengths):
            prof = np.zeros(T, dtype=int)
            if i % 2 == 1:
                prof[T // 2:] = 1
            trajs.append(model.trajectory_from_loopingprofile(
                prof, key=jax.random.key(50 + i)))
        return model, trajs

    DATASET_KW = dict(k_max=3, steps_per_k=6, N=24, bucket_edges=(8, 16),
                      chunk_size=2, informed_init=True, marginals=True)
    SCOUT_KW = dict(k_max=3, steps_per_k=6, N=24, bucket_edges=(8, 16),
                    chunk_size=4, scout_steps=2, refine_top=2,
                    informed_init=False)
""")

_DATASET_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    port, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    if os.environ.get("COV") not in (None, "", "0"):
        sys.path.insert(0, os.path.join({repo!r}, "tools"))
        import atexit, simplecov
        simplecov.start(os.path.join({repo!r}, "bild_jax"))
        atexit.register(simplecov.dump_data,
                        os.path.join(outdir, "cov_worker%d.json" % pid))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, {repo!r})
    import numpy as np
    from bild_jax.parallel import make_mesh, sample_dataset

    exec(open(os.path.join(outdir, "dataset_src.py")).read())

    mesh = make_mesh(axis_names=("data",), distributed=True,
                     coordinator_address=f"localhost:{{port}}",
                     num_processes=2, process_id=pid)
    model, trajs = build_dataset()

    # count checkpoint commits (os.replace onto the checkpoint dir) to prove
    # exactly-once I/O: every file must be written by process 0 alone
    ckdir = os.path.join(outdir, "ck")
    os.makedirs(ckdir, exist_ok=True)
    writes = []
    _orig_replace = os.replace
    def counting_replace(src, dst):
        if os.path.dirname(dst) == ckdir:
            writes.append(dst)
        return _orig_replace(src, dst)
    os.replace = counting_replace

    res = sample_dataset(model, trajs, mesh=mesh, checkpoint_dir=ckdir,
                         key=jax.random.key(7), **DATASET_KW)
    res2 = sample_dataset(model, trajs, mesh=mesh,
                          key=jax.random.key(8), **SCOUT_KW)
    np.savez(os.path.join(outdir, f"res{{pid}}.npz"),
             evidence=res.evidence, evidence_se=res.evidence_se,
             profiles=np.concatenate([p.ravel() for p in res.profiles_by_k]),
             marginals=np.concatenate([m.ravel() for m in res.marginals]),
             mom_ok=res.mom_ok,
             s_evidence=res2.evidence,
             s_profiles=np.concatenate([p.ravel()
                                        for p in res2.profiles_by_k]),
             n_ck_writes=len(writes))
    print(f"OK {{pid}}", flush=True)
""")


def test_two_process_sample_dataset(tmp_path):
    """End-to-end multi-host inference: `sample_dataset` over a 2-process x
    2-device CPU cluster — fused + informed-init + marginals + chunk
    checkpointing, and the scout/refine schedule — produces BIT-IDENTICAL
    results to the plain single-process run, with checkpoint files written
    exactly once (by process 0)."""
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    (tmp_path / "dataset_src.py").write_text(_DATASET_SRC)
    worker = tmp_path / "worker.py"
    worker.write_text(_DATASET_WORKER.format(repo=repo))
    port = _free_port()

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(port), str(i), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=str(tmp_path)) for i in range(2)]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-4000:]}"
        assert f"OK {i}" in out
    _merge_worker_cov(tmp_path)

    import numpy as np
    res0 = np.load(tmp_path / "res0.npz")
    res1 = np.load(tmp_path / "res1.npz")

    # exactly-once checkpoint I/O: process 0 wrote every chunk, process 1
    # wrote nothing — and the files exist
    n_chunks = 4  # 2 buckets x 3 trajectories at chunk_size=2
    assert int(res0["n_ck_writes"]) == n_chunks
    assert int(res1["n_ck_writes"]) == 0
    assert len(list((tmp_path / "ck").glob("chunk_*.npz"))) == n_chunks

    # both processes returned the same full result (n_ck_writes is the one
    # field that must DIFFER — exactly-once I/O, asserted above)
    for f in res0.files:
        if f != "n_ck_writes":
            np.testing.assert_array_equal(res0[f], res1[f], err_msg=f)

    # ... identical to the plain single-process run (same keys, no mesh)
    ns = {}
    exec(_DATASET_SRC, ns)
    import jax
    from bild_jax.parallel import sample_dataset
    model, trajs = ns["build_dataset"]()
    ref = sample_dataset(model, trajs, key=jax.random.key(7),
                         **ns["DATASET_KW"])
    ref2 = sample_dataset(model, trajs, key=jax.random.key(8),
                          **ns["SCOUT_KW"])
    np.testing.assert_array_equal(res0["evidence"], ref.evidence)
    np.testing.assert_array_equal(res0["evidence_se"], ref.evidence_se)
    np.testing.assert_array_equal(
        res0["profiles"],
        np.concatenate([p.ravel() for p in ref.profiles_by_k]))
    np.testing.assert_array_equal(
        res0["marginals"],
        np.concatenate([m.ravel() for m in ref.marginals]))
    np.testing.assert_array_equal(res0["mom_ok"], ref.mom_ok)
    np.testing.assert_array_equal(res0["s_evidence"], ref2.evidence)
    np.testing.assert_array_equal(
        res0["s_profiles"],
        np.concatenate([p.ravel() for p in ref2.profiles_by_k]))


def test_two_process_cpu_cluster(tmp_path):
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=repo))
    port = _free_port()

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen([sys.executable, str(worker), str(port), str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env, cwd=str(tmp_path))
             for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"OK {i}" in out
    _merge_worker_cov(tmp_path)


# -- process-local (sharded) ingestion ---------------------------------------
# Each worker reads a DISJOINT CSV shard (no process ever holds the full
# dataset), feeds its rows via jax.make_array_from_process_local_data, and
# the run must reproduce the single-process full-data run bit-exactly
# (trajectory-id-keyed PRNG streams make results composition-invariant).

_SHARD_SRC = textwrap.dedent("""
    import numpy as np
    import jax
    from scipy import stats as sp_stats
    from bild_jax.models import FactorizedModel

    def build_model():
        return FactorizedModel([sp_stats.maxwell(scale=0.1),
                                sp_stats.maxwell(scale=1)], d=1)

    def write_shards(outdir):
        import os
        np.random.seed(180356)
        model = build_model()
        lengths = [8, 14, 8, 11, 14, 8, 11, 8]
        rows_by_shard = {0: [], 1: []}
        for i, T in enumerate(lengths):
            prof = np.zeros(T, dtype=int)
            if i % 2 == 1:
                prof[T // 2:] = 1
            t = model.trajectory_from_loopingprofile(
                prof, key=jax.random.key(60 + i))
            data = np.asarray(t.data)
            for fr in range(T):
                rows_by_shard[i % 2].append(
                    f"{100 + i},{fr},{data[fr, 0]!r}")
        paths = []
        for s, rows in rows_by_shard.items():
            p = os.path.join(outdir, f"shard{s}.csv")
            with open(p, "w") as f:
                f.write("traj_id,frame,x\\n")
                f.write("\\n".join(rows) + "\\n")
            paths.append(p)
        return paths

    SHARD_KW = dict(k_max=3, steps_per_k=6, N=24, bucket_edges=(8, 16),
                    chunk_size=4, informed_init=True, marginals=True)
""")

_SHARD_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    port, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    if os.environ.get("COV") not in (None, "", "0"):
        sys.path.insert(0, os.path.join({repo!r}, "tools"))
        import atexit, simplecov
        simplecov.start(os.path.join({repo!r}, "bild_jax"))
        atexit.register(simplecov.dump_data,
                        os.path.join(outdir, "cov_shard_worker%d.json" % pid))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, {repo!r})
    import numpy as np
    from bild_jax.io import load_trajectories_csv
    from bild_jax.parallel import make_mesh, sample_dataset_sharded

    exec(open(os.path.join(outdir, "shard_src.py")).read())

    mesh = make_mesh(axis_names=("data",), distributed=True,
                     coordinator_address=f"localhost:{{port}}",
                     num_processes=2, process_id=pid)

    # THIS process's shard only — the other file is never read
    trajs, ids = load_trajectories_csv(
        os.path.join(outdir, f"shard{{pid}}.csv"), return_ids=True)
    assert len(trajs) == 4

    ckdir = os.path.join(outdir, "ck")
    os.makedirs(ckdir, exist_ok=True)
    writes = []
    _orig_replace = os.replace
    def counting_replace(src, dst):
        if os.path.dirname(dst) == ckdir:
            writes.append(dst)
        return _orig_replace(src, dst)
    os.replace = counting_replace

    res = sample_dataset_sharded(model=build_model(), local_trajs=trajs,
                                 local_ids=ids, mesh=mesh,
                                 checkpoint_dir=ckdir,
                                 key=jax.random.key(9), **SHARD_KW)
    np.savez(os.path.join(outdir, f"shard_res{{pid}}.npz"),
             ids=res.ids, evidence=res.evidence,
             evidence_se=res.evidence_se,
             profiles=np.concatenate([p.ravel() for p in res.profiles_by_k]),
             marginals=np.concatenate([m.ravel() for m in res.marginals]),
             mom_ok=res.mom_ok, n_ck_writes=len(writes))
    print(f"OK {{pid}}", flush=True)
""")


def test_two_process_sharded_ingestion(tmp_path):
    """Process-local ingestion: two processes each read a DISJOINT CSV file
    shard; `sample_dataset_sharded` over the 2-process mesh must reproduce
    the single-process full-data run BIT-EXACTLY, with exactly-once
    checkpoint writes by process 0."""
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    (tmp_path / "shard_src.py").write_text(_SHARD_SRC)

    # build the shards once (deterministic; workers re-read, not re-write)
    ns = {}
    exec(_SHARD_SRC, ns)
    ns["write_shards"](str(tmp_path))

    worker = tmp_path / "shard_worker.py"
    worker.write_text(_SHARD_WORKER.format(repo=repo))
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(port), str(i), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=str(tmp_path)) for i in range(2)]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-4000:]}"
        assert f"OK {i}" in out
    _merge_worker_cov(tmp_path)

    import numpy as np
    res0 = np.load(tmp_path / "shard_res0.npz")
    res1 = np.load(tmp_path / "shard_res1.npz")

    # exactly-once checkpoint I/O
    assert int(res0["n_ck_writes"]) > 0
    assert int(res1["n_ck_writes"]) == 0
    # identical full results on both processes
    for f in res0.files:
        if f != "n_ck_writes":
            np.testing.assert_array_equal(res0[f], res1[f], err_msg=f)

    # single-process full-data reference: load BOTH shards, no mesh
    from bild_jax.io import load_trajectories_csv
    from bild_jax.parallel import sample_dataset_sharded
    import jax
    t0, i0 = load_trajectories_csv(str(tmp_path / "shard0.csv"),
                                   return_ids=True)
    t1, i1 = load_trajectories_csv(str(tmp_path / "shard1.csv"),
                                   return_ids=True)
    ref = sample_dataset_sharded(
        model=ns["build_model"](), local_trajs=t0 + t1,
        local_ids=np.concatenate([i0, i1]), mesh=None,
        key=jax.random.key(9), **ns["SHARD_KW"])
    np.testing.assert_array_equal(res0["ids"], ref.ids)
    np.testing.assert_array_equal(res0["evidence"], ref.evidence)
    np.testing.assert_array_equal(res0["evidence_se"], ref.evidence_se)
    np.testing.assert_array_equal(
        res0["profiles"],
        np.concatenate([p.ravel() for p in ref.profiles_by_k]))
    np.testing.assert_array_equal(
        res0["marginals"],
        np.concatenate([m.ravel() for m in ref.marginals]))
    np.testing.assert_array_equal(res0["mom_ok"], ref.mom_ok)
