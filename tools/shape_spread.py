"""
How far two runs of the same trajectories drift apart on ONE device when
only the compiled batch shape differs: `sample_batch` on a chunk of
``--rows`` trajectories against the same call on its first
``rows / --split`` rows (the per-device row count of a ``--split``-card data
mesh), with the same key. Per-row PRNG keys are prefix-stable
(``split(k, B)[:b] == split(k, b)``), so the two runs sample the same
streams, and any difference comes from float32 arithmetic compiled for
another shape, amplified by AMIS. A third run repeats the full chunk to
show that the same shape reproduces bit for bit.

The settings are those of ``chip_smoke.py --four-cards`` (one 1024-chunk
of its dataset), so the spread here is the one that phase must tolerate
without any mesh.

  python tools/shape_spread.py [--rows 1024] [--split 4] [--T 100]

Prints one JSON line per comparison (`chip_smoke.compare_runs`).
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--split", type=int, default=4)
    ap.add_argument("--T", type=int, default=100)
    args = ap.parse_args()

    import jax
    import chip_smoke as cs
    from bild_jax.config import enable_compilation_cache
    from bild_jax.parallel import TrajectoryBatch, sample_batch
    from bild_jax.parallel.batch import bucket_trajectories

    enable_compilation_cache()
    dev = jax.devices()[0]
    print(json.dumps(dict(device=dev.device_kind, platform=dev.platform,
                          jax=jax.__version__)), flush=True)
    model = cs.rouse_model(2)
    trajs, _ = cs.dataset_trajectories(model, args.rows, args.T, seed=11)
    (_, batch), = bucket_trajectories(trajs)
    kw = dict(cs.dataset_kwargs(11), informed_init=True)
    kw.pop("chunk_size")
    kw["key"] = jax.random.fold_in(kw["key"], 0)   # the dataset's chunk 0

    def run(rows):
        sub = TrajectoryBatch(
            data=batch.data[:rows], valid=batch.valid[:rows],
            lengths=None if batch.lengths is None else batch.lengths[:rows])
        t0 = time.perf_counter()
        res = sample_batch(model, sub, **kw)
        return res, time.perf_counter() - t0

    part = args.rows // args.split
    full, t_full = run(args.rows)
    small, t_small = run(part)
    again, _ = run(args.rows)

    print(json.dumps(dict(compare=f"rows {args.rows} vs {part}",
                          wall_s=[t_full, t_small],
                          **cs.compare_runs(Head(full, part), small, part))),
          flush=True)
    print(json.dumps(dict(compare=f"rows {args.rows} twice",
                          **cs.compare_runs(full, again, part))), flush=True)


class Head:
    """The first ``rows`` trajectories of a `BatchResults`, with the parts
    `chip_smoke.compare_runs` reads."""

    def __init__(self, res, rows):
        self.evidence = res.evidence[:rows]
        self.evidence_se = res.evidence_se[:rows]
        self._res, self._rows = res, rows

    def best_k(self):
        return self._res.best_k()[:self._rows]

    def best_profile(self):
        return self._res.best_profile()[:self._rows]


if __name__ == "__main__":
    main()
