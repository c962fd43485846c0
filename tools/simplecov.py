"""
Minimal line-coverage collector for environments without the ``coverage``
package (this image has no network access). Uses Python 3.12's
``sys.monitoring`` LINE events, restricted to files under ``bild_jax/``;
non-package code locations are DISABLEd at first hit, so overhead stays
bounded.

Reference analog: ``make tests`` runs ``coverage`` with exclusions
(``/root/reference/Makefile:102-106``). Enable via ``COV=1``:

    COV=1 python -m pytest tests/ -q       # report printed at exit
    make tests-cov

Known limitation (same as any tracer on JAX code): jitted function bodies
count only their trace-time execution — which is exactly the Python-line
coverage notion anyway.
"""
from __future__ import annotations

import atexit
import os
import sys

_TOOL = sys.monitoring.COVERAGE_ID if hasattr(sys, "monitoring") else 1
_executed: dict[str, set[int]] = {}
_prefix = ""
_started = False


def start(package_dir):
    """Begin collecting line coverage for files under ``package_dir``."""
    global _prefix, _started
    if _started:
        return
    _prefix = os.path.abspath(package_dir) + os.sep
    mon = sys.monitoring
    mon.use_tool_id(_TOOL, "simplecov")

    def on_line(code, line):
        fn = code.co_filename
        if fn.startswith(_prefix):
            _executed.setdefault(fn, set()).add(line)
            return None
        return mon.DISABLE

    mon.register_callback(_TOOL, mon.events.LINE, on_line)
    mon.set_events(_TOOL, mon.events.LINE)
    _started = True


def _excluded_lines(src_lines):
    """Lines excluded by ``# pragma: no cover`` (the `coverage` package's
    standard marker): the marked line itself plus, when it opens a block
    (``else:`` / ``except ...:`` / ``if ...:``), the whole indented suite."""
    excluded = set()
    for i, line in enumerate(src_lines, start=1):
        if "pragma: no cover" not in line:
            continue
        excluded.add(i)
        code = line.split("#", 1)[0].rstrip()
        if not code.endswith(":"):
            continue
        indent = len(line) - len(line.lstrip())
        for j in range(i + 1, len(src_lines) + 1):
            nxt = src_lines[j - 1]
            if not nxt.strip():
                excluded.add(j)
                continue
            if len(nxt) - len(nxt.lstrip()) <= indent:
                break
            excluded.add(j)
    return excluded


def _executable_lines(path):
    """All line numbers bearing executable code, from the compiled code
    object tree (the same notion `coverage` uses, minus branch analysis),
    minus ``# pragma: no cover`` exclusions."""
    with open(path) as f:
        src = f.read()
    try:
        top = compile(src, path, "exec")
    except SyntaxError:
        return set()
    lines = set()
    stack = [top]
    while stack:
        code = stack.pop()
        for _, _, line in code.co_lines():
            if line is not None and line > 0:
                lines.add(line)
        for const in code.co_consts:
            if hasattr(const, "co_lines"):
                stack.append(const)
    # docstring-only and `pass`-like lines still appear; close enough
    return lines - _excluded_lines(src.splitlines())


def _ranges(lines):
    """Condense sorted line numbers to 'a-b, c, d-e' notation."""
    out = []
    lines = sorted(lines)
    i = 0
    while i < len(lines):
        j = i
        while j + 1 < len(lines) and lines[j + 1] == lines[j] + 1:
            j += 1
        out.append(str(lines[i]) if i == j else f"{lines[i]}-{lines[j]}")
        i = j + 1
    return ", ".join(out)


def report(out=sys.stdout, show_missing=False):
    """Per-file and total coverage for every .py under the package dir.

    ``show_missing`` appends the uncovered line ranges per file (the
    ``coverage report -m`` analog); also enabled via ``COV_MISSING=1``.
    """
    rows = []
    for root, _dirs, files in os.walk(_prefix):
        if "__pycache__" in root:
            continue
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            exe = _executable_lines(path)
            if not exe:
                continue
            hit = _executed.get(path, set()) & exe
            rows.append((os.path.relpath(path), len(hit), len(exe),
                         exe - hit))
    if not rows:
        print("simplecov: no data collected", file=out)
        return
    width = max(len(r[0]) for r in rows)
    print(f"\n{'Name':{width}}  {'Stmts':>6} {'Miss':>6} {'Cover':>6}",
          file=out)
    print("-" * (width + 22), file=out)
    tot_h = tot_e = 0
    for name, h, e, missed in rows:
        tot_h += h
        tot_e += e
        print(f"{name:{width}}  {e:>6} {e - h:>6} {100 * h / e:>5.0f}%",
              file=out)
        if show_missing and missed:
            print(f"{'':{width}}    missing: {_ranges(missed)}", file=out)
    print("-" * (width + 22), file=out)
    print(f"{'TOTAL':{width}}  {tot_e:>6} {tot_e - tot_h:>6} "
          f"{100 * tot_h / tot_e:>5.0f}%", file=out)


def dump_data(path):
    """Write the raw hit data (file -> executed lines) as JSON, for merging
    across processes with `load_data` / the CLI ``merge`` command."""
    import json
    with open(path, "w") as f:
        json.dump({fn: sorted(lines) for fn, lines in _executed.items()}, f)


def load_data(path):
    """Merge a `dump_data` JSON file into the current hit data."""
    import json
    with open(path) as f:
        for fn, lines in json.load(f).items():
            _executed.setdefault(fn, set()).update(lines)


def _report_at_exit():
    # pytest closes the capture streams before atexit runs: write the
    # report to a file and best-effort echo it to the real stderr
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data_path = os.environ.get("COV_DATA")
    if data_path:
        # chunked mode: emit raw data only; a later `merge` builds the
        # report (lets the suite run as several pytest processes, so one
        # tracer-vs-XLA crash — observed rarely on this image — only
        # costs that chunk)
        dump_data(data_path)
        return
    path = os.path.join(here, "COVERAGE.txt")
    show_missing = os.environ.get("COV_MISSING") not in (None, "", "0")
    with open(path, "w") as f:
        report(out=f, show_missing=show_missing)
    try:
        with open(path) as f:
            sys.__stderr__.write(f.read())
        sys.__stderr__.write(f"(written to {path})\n")
    except (ValueError, OSError):
        pass


def start_from_env():
    """Start collection if COV=1, and write COVERAGE.txt (or, with
    COV_DATA=file.json set, the raw mergeable hit data) at interpreter
    exit. Call from conftest before importing the package."""
    if os.environ.get("COV") not in (None, "", "0"):
        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        start(os.path.join(here, "bild_jax"))
        atexit.register(_report_at_exit)


def main(argv):
    """CLI: ``python tools/simplecov.py merge OUT.txt DATA.json [...]`` —
    merge chunked COV_DATA dumps into a COVERAGE.txt-style report."""
    global _prefix
    if len(argv) < 3 or argv[0] != "merge":
        print(__doc__)
        print("usage: simplecov.py merge OUT.txt DATA.json [DATA.json ...]")
        return 2
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _prefix = os.path.join(here, "bild_jax") + os.sep
    for p in argv[2:]:
        load_data(p)
    show_missing = os.environ.get("COV_MISSING") not in (None, "", "0")
    with open(argv[1], "w") as f:
        report(out=f, show_missing=show_missing)
    with open(argv[1]) as f:
        sys.stdout.write(f.read())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
