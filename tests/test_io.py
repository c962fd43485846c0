"""Dataset IO: native C++ loader vs pure-Python fallback parity."""
import numpy as np
import pytest

from bild_jax import io as bio
from bild_jax import native


def _write_csv(path, two_locus=False):
    rng = np.random.default_rng(3)
    lines = ["id,frame,x,y" if not two_locus else "id,frame,x1,y1,x2,y2"]
    rows = []
    # trajectory 7: frames 0..9 with a gap at 4; trajectory 3: frames 2..6
    for t in range(10):
        if t == 4:
            continue
        vals = rng.normal(size=4 if two_locus else 2)
        rows.append((7, t, vals))
    for t in range(2, 7):
        vals = rng.normal(size=4 if two_locus else 2)
        rows.append((3, t, vals))
    rng.shuffle(rows)
    for tid, frame, vals in rows:
        lines.append(f"{tid},{frame}," + ",".join(f"{v:.6f}" for v in vals))
    path.write_text("\n".join(lines) + "\n")


def test_python_loader(tmp_path):
    p = tmp_path / "d.csv"
    _write_csv(p)
    trajs = bio.load_trajectories_csv_python(p)
    assert len(trajs) == 2
    t3, t7 = trajs  # ascending id order
    assert len(t3) == 5 and t3.count_valid_frames() == 5
    assert len(t7) == 10 and t7.count_valid_frames() == 9
    assert not bool(t7.valid[4])  # the gap became a missing frame


def test_native_matches_python(tmp_path):
    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    p = tmp_path / "d.csv"
    _write_csv(p)
    a = bio.load_trajectories_csv(p)
    b = bio.load_trajectories_csv_python(p)
    assert len(a) == len(b)
    for ta, tb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(ta.valid), np.asarray(tb.valid))
        np.testing.assert_allclose(np.asarray(ta.data), np.asarray(tb.data),
                                   rtol=0, atol=1e-12)


def test_two_locus(tmp_path):
    p = tmp_path / "d2.csv"
    _write_csv(p, two_locus=True)
    a = bio.load_trajectories_csv(p, two_locus=True)
    b = bio.load_trajectories_csv_python(p, two_locus=True)
    assert a[0].d == 2
    np.testing.assert_allclose(np.asarray(a[0].data), np.asarray(b[0].data),
                               atol=1e-12)


def test_native_large_roundtrip(tmp_path):
    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(0)
    B, T = 200, 50
    lines = []
    for i in range(B):
        for t in range(T):
            x, y, z = rng.normal(size=3)
            lines.append(f"{i}\t{t}\t{x}\t{y}\t{z}")
    rng.shuffle(lines)
    p = tmp_path / "big.tsv"
    p.write_text("\n".join(lines) + "\n")
    trajs = bio.load_trajectories_csv(p)
    assert len(trajs) == B
    assert all(len(t) == T and t.d == 3 for t in trajs)


def test_ragged_first_row_uses_max_width(tmp_path):
    # first data row is short: later rows' extra columns must survive (both
    # loaders infer the table width as the MAX row width)
    p = tmp_path / "ragged.csv"
    p.write_text("0,0,1.5\n"
                 "0,1,2.5,7.0,9.0\n"
                 "0,2,3.5,8.0,10.0\n")
    for loader in (bio.load_trajectories_csv_python,
                   bio.load_trajectories_csv):
        trajs = loader(p)
        assert len(trajs) == 1
        t = trajs[0]
        assert t.d == 3
        dat = t[:]
        np.testing.assert_allclose(dat[1], [2.5, 7.0, 9.0])
        np.testing.assert_allclose(dat[2], [3.5, 8.0, 10.0])
        # the short row's frame has NaN-padded columns -> a missing frame
        # under Trajectory semantics (frame valid = no NaN in any dim)
        assert np.all(np.isnan(dat[0]))
