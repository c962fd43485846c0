"""The package's former import name stays an alias of `bild_jax`: the same
module objects (no second copy of any module state), and the same CLI."""
import importlib
import os
import pkgutil
import subprocess
import sys

import pytest

import bild_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALIASES = sorted(m.name for m in pkgutil.iter_modules([ROOT])
                 if m.ispkg and m.name.startswith("bild_")
                 and m.name != "bild_jax")


def test_alias_exists():
    assert len(ALIASES) == 1


@pytest.mark.parametrize("sub", ["", ".models.msrouse", ".ops.kalman",
                                 ".fit", ".parallel.dataset", ".config"])
def test_alias_is_the_same_module(sub):
    old = importlib.import_module(ALIASES[0] + sub)
    new = importlib.import_module("bild_jax" + sub)
    if sub:
        assert old is new
        assert new.__spec__.name == "bild_jax" + sub
    else:
        assert old.sample is new.sample and old.models is new.models


def test_alias_cli_help():
    p = subprocess.run([sys.executable, "-m", ALIASES[0], "--help"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert p.returncode == 0, p.stderr
    assert "usage" in p.stdout
