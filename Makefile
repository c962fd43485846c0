# Convenience targets (analog of the reference Makefile:24-106)

PY ?= python

.PHONY: tests tests-all tests-cov bench bench-e2e native clean docs

# fast lane (default): everything not marked slow; target < 3 min
tests:
	$(PY) -m pytest tests/ -q -m "not slow"

# the whole pyramid, including slow integration tests
tests-all:
	$(PY) -m pytest tests/ -q

# full suite with line coverage (tools/simplecov.py; the `coverage`
# package is not installed in this image) -> COVERAGE.txt
tests-cov:
	COV=1 $(PY) -m pytest tests/ -q

bench:
	$(PY) bench.py

# BASELINE.md configs 2-6 (pass CONFIGS=5 for the 10k-trajectory run)
CONFIGS ?= 2,3,4,6
bench-e2e:
	$(PY) bench_e2e.py --configs $(CONFIGS) --out PERF.json

# build the native loader explicitly (otherwise built on first use)
native:
	g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread \
	    -o bild_jax/native/_loader.so bild_jax/native/loader.cpp

# sphinx when available; otherwise the self-contained autodoc builder
# (tools/docgen.py), which reads the same docs/*.rst sources and fails on
# import errors / missing members exactly like sphinx-autodoc would
docs:
	@$(PY) -c "import sphinx" 2>/dev/null \
	    && $(PY) -m sphinx -b html docs/ docs/_build/html \
	    || $(PY) tools/docgen.py --src docs --out docs/_build/html

clean:
	rm -rf bild_jax/native/_loader.so build .jax_cache **/__pycache__ .pytest_cache docs/_build
