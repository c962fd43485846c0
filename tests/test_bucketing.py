"""Ragged-length bucketing for dataset batches."""
import numpy as np

from bild_jax import Trajectory
from bild_jax.parallel import stack_trajectories
from bild_jax.parallel.batch import bucket_trajectories


def test_bucket_trajectories():
    lengths = [10, 60, 64, 65, 100, 2000]
    trajs = [Trajectory.create(np.ones((T, 1))) for T in lengths]
    buckets = bucket_trajectories(trajs, bucket_edges=(64, 128))
    pads = sorted(b.T for _, b in buckets)
    assert pads == [64, 128, 2000]

    covered = np.concatenate([idx for idx, _ in buckets])
    assert sorted(covered.tolist()) == list(range(len(trajs)))

    for idx, batch in buckets:
        for row, i in enumerate(idx):
            assert int(np.sum(np.asarray(batch.valid[row]))) == lengths[i]
