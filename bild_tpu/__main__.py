"""``python -m`` of the former package name: the `bild_jax` CLI."""
import sys

from bild_jax.__main__ import main

if __name__ == "__main__":
    sys.exit(main())
