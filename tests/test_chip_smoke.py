"""`chip_smoke.py` refuses to report success anywhere but on a CUDA card."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _run(script, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_no_ok_without_card(tmp_path, alone):
    script = SCRIPT
    if alone:   # a directory holding chip_smoke.py and nothing else
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SCRIPT, script)
    p = _run(script, cwd=os.path.dirname(script))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_require_gpu_refuses_cpu():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert e.value.code != 0


class _Result:
    def __init__(self, evidence):
        self.evidence = evidence
        self.evidence_se = np.full_like(evidence, 0.1)

    def best_k(self):
        return np.argmax(self.evidence, axis=1)

    def best_profile(self):
        return [np.zeros(5, int) for _ in self.evidence]


def test_compare_runs_flags_a_broken_block():
    """A fault confined to one device's rows at one non-best k leaves best k
    and most lanes alone; the four-card gate's block share catches it."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    ev = np.random.default_rng(0).normal(-100.0, 5.0, size=(32, 4))
    ev[:, 0] += 50.0
    broken = ev.copy()
    broken[8:16, 2] += 3.0
    out = chip_smoke.compare_runs(_Result(ev), _Result(broken), block_rows=8)
    assert out["identical_best_k"] and out["best_k_within_z_limit"]
    assert out["lane_frac_agree_within_mnat"] > 0.9
    assert out["min_block_frac_agree_within_mnat"] == 0.0
    assert out["max_z_all_lanes"] > chip_smoke.FOUR_CARD_Z
    same = chip_smoke.compare_runs(_Result(ev), _Result(ev.copy()), 8)
    assert same["min_block_frac_agree_within_mnat"] == 1.0
