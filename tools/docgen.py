"""
Minimal autodoc HTML builder for the environments where sphinx is not
installed (this repo's CI image has no network access). Reads the SAME
``docs/*.rst`` sources sphinx would (``make docs`` prefers sphinx when
available), resolves every ``.. automodule::`` directive by importing the
module and collecting its public members, and renders a small static HTML
site to ``docs/_build/html/``.

It is also the docs *correctness check*: a module that fails to import, or
a ``:members:`` name that does not exist, fails the build (exit 1) — the
same errors sphinx-autodoc would raise. Reference analog: the sphinx
pipeline of ``/root/reference/Makefile:90-100``.

Usage: python tools/docgen.py [--src docs] [--out docs/_build/html]
"""
from __future__ import annotations

import argparse
import html
import importlib
import inspect
import os
import re
import sys


# --------------------------------------------------------------------------
# tiny RST subset parser
# --------------------------------------------------------------------------

def parse_rst(text):
    """Parse the subset of RST these docs use into a block list:
    ('title', level, text) | ('para', html) | ('code', text) |
    ('table', header-row, rows) | ('automodule', name, members-or-None)."""
    lines = text.splitlines()
    blocks = []
    i = 0
    while i < len(lines):
        line = lines[i]
        nxt = lines[i + 1] if i + 1 < len(lines) else ""
        # simple table: '====  ====' border, header row(s), border, body
        # rows, closing border
        is_border = lambda s: re.fullmatch(r"\s*=+(?:\s+=+)+\s*", s)
        if is_border(line):
            starts = [s.start() for s in re.finditer(r"=+", line)]
            ends = starts[1:] + [10**9]
            def cells(row):
                return [row[a:b].strip() for a, b in zip(starts, ends)]
            # collect the sections between border lines
            sections, sect, j = [], [], i + 1
            while j < len(lines):
                if is_border(lines[j]):
                    sections.append(sect)
                    sect = []
                    if len(sections) == 2:      # header + body seen
                        break
                elif lines[j].strip():
                    sect.append(cells(lines[j]))
                j += 1
            if len(sections) == 2 and sections[0]:
                # multi-row headers join cell-wise (continuation lines)
                header = [" ".join(filter(None, col)).strip()
                          for col in zip(*sections[0])]
                blocks.append(("table", header, sections[1]))
                i = j + 1
                continue
            # malformed/unclosed table: fail loudly so the docs-build test
            # catches the regression instead of emitting the border line as
            # a paragraph
            raise ValueError(
                f"malformed simple table (border without a complete "
                f"header/body): {line.strip()!r}")
        # section titles: text underlined with = or -
        if line.strip() and re.fullmatch(r"[=\-~^]{3,}", nxt.strip() or "x") \
                and len(nxt.strip()) >= len(line.strip()):
            level = {"=": 1, "-": 2, "~": 3, "^": 4}[nxt.strip()[0]]
            blocks.append(("title", level, line.strip()))
            i += 2
            continue
        # automodule directive
        m = re.match(r"\s*\.\.\s+automodule::\s+(\S+)", line)
        if m:
            name = m.group(1)
            members = None
            j = i + 1
            while j < len(lines) and lines[j].strip().startswith(":"):
                mm = re.match(r"\s*:members:\s*(.*)", lines[j])
                if mm:
                    members = ([s.strip() for s in mm.group(1).split(",")
                                if s.strip()] or None) \
                        if mm.group(1).strip() else None
                j += 1
            blocks.append(("automodule", name, members))
            i = j
            continue
        # literal block introduced by '::'
        if line.rstrip().endswith("::"):
            para = line.rstrip()[:-2].rstrip()
            if para.endswith(":"):      # 'text::' -> 'text:'
                para += ":"
            if para:
                blocks.append(("para", _inline(para)))
            j = i + 1
            while j < len(lines) and not lines[j].strip():
                j += 1
            code = []
            while j < len(lines) and (not lines[j].strip()
                                      or lines[j].startswith((" ", "\t"))):
                code.append(lines[j])
                j += 1
            # dedent
            pad = min((len(c) - len(c.lstrip()) for c in code if c.strip()),
                      default=0)
            blocks.append(("code", "\n".join(c[pad:] for c in code).strip("\n")))
            i = j
            continue
        # plain paragraph
        if line.strip():
            para = [line]
            j = i + 1
            while j < len(lines) and lines[j].strip() \
                    and not lines[j].rstrip().endswith("::") \
                    and not re.fullmatch(r"[=\-~^]{3,}",
                                         (lines[j + 1].strip() if j + 1 < len(lines) else "x") or "x"):
                para.append(lines[j])
                j += 1
            blocks.append(("para", _inline(" ".join(p.strip() for p in para))))
            i = j
            continue
        i += 1
    return blocks


def _inline(text):
    """``code`` and *em* inline markup -> HTML."""
    text = html.escape(text)
    text = re.sub(r"``([^`]+)``", r"<code>\1</code>", text)
    text = re.sub(r"\*([^*]+)\*", r"<em>\1</em>", text)
    return text


# --------------------------------------------------------------------------
# autodoc
# --------------------------------------------------------------------------

class DocError(Exception):
    pass


def _doc_member(name, obj):
    """(kind, name, signature, docstring) for one member."""
    try:
        sig = str(inspect.signature(obj)) if callable(obj) else ""
    except (ValueError, TypeError):
        sig = "(...)"
    doc = inspect.getdoc(obj) or ""
    if inspect.isclass(obj):
        methods = []
        for mname, m in sorted(vars(obj).items()):
            if mname.startswith("_") and mname != "__init__":
                continue
            if callable(m) or isinstance(m, (property, staticmethod,
                                             classmethod)):
                target = m
                if isinstance(m, property):
                    target = m.fget
                    msig = ""
                elif isinstance(m, (staticmethod, classmethod)):
                    target = m.__func__
                    try:
                        msig = str(inspect.signature(target))
                    except (ValueError, TypeError):
                        msig = "(...)"
                else:
                    try:
                        msig = str(inspect.signature(m))
                    except (ValueError, TypeError):
                        msig = "(...)"
                mdoc = inspect.getdoc(target) or ""
                if mdoc or mname == "__init__":
                    methods.append((mname, msig, mdoc))
        return ("class", name, sig, doc, methods)
    return ("function", name, sig, doc, [])


def autodoc(modname, members):
    """Import ``modname`` and document its members. Raises DocError on
    import failure or a requested member that does not exist."""
    try:
        mod = importlib.import_module(modname)
    except Exception as e:                              # noqa: BLE001
        raise DocError(f"automodule {modname}: import failed: {e!r}") from e

    if members is None:
        names = getattr(mod, "__all__", None)
        if names is None:
            names = [n for n, v in vars(mod).items()
                     if not n.startswith("_")
                     and getattr(v, "__module__", None) == modname]
    else:
        names = members

    out = []
    for n in names:
        if not hasattr(mod, n):
            raise DocError(f"automodule {modname}: member {n!r} not found")
        obj = getattr(mod, n)
        if inspect.ismodule(obj):
            continue
        out.append(_doc_member(n, obj))
    return inspect.getdoc(mod) or "", out


# --------------------------------------------------------------------------
# rendering
# --------------------------------------------------------------------------

PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>{{ title }} — bild_jax</title><style>
body { font-family: -apple-system, 'Segoe UI', sans-serif; margin: 0;
       color: #1a202c; line-height: 1.55; }
.wrap { max-width: 60rem; margin: 0 auto; padding: 1rem 2rem 4rem; }
nav { background: #1a365d; color: #fff; padding: .6rem 2rem; }
nav a { color: #bee3f8; margin-right: 1.5rem; text-decoration: none; }
h1 { border-bottom: 2px solid #2b6cb0; padding-bottom: .3rem; }
h2 { margin-top: 2.2rem; color: #2c5282; }
pre { background: #f7fafc; border: 1px solid #e2e8f0; border-radius: 6px;
      padding: .8rem 1rem; overflow-x: auto; font-size: .9rem; }
code { background: #edf2f7; padding: .1em .3em; border-radius: 3px;
       font-size: .92em; }
pre code { background: none; padding: 0; }
.member { margin: 1.2rem 0 1.6rem; border-left: 3px solid #90cdf4;
          padding-left: 1rem; }
.member > .sig { font-family: ui-monospace, monospace; font-weight: 600;
                 background: #ebf8ff; padding: .35rem .6rem;
                 border-radius: 4px; display: inline-block; }
.member .doc, .method .doc { white-space: pre-wrap;
      font-size: .95rem; margin: .5rem 0 0; font-family: inherit;
      background: none; border: none; padding: 0; }
.method { margin: .8rem 0 .8rem 1.5rem; }
.method > .sig { font-family: ui-monospace, monospace; color: #2c5282; }
.modpath { color: #718096; font-size: .85rem; }
table { border-collapse: collapse; margin: 1rem 0; font-size: .92rem; }
th, td { border: 1px solid #e2e8f0; padding: .35rem .7rem; text-align: left; }
th { background: #ebf8ff; color: #2c5282; }
</style></head><body>
<nav><a href="index.html">bild_jax</a><a href="migration.html">Migrating from bild</a><a href="api.html">API reference</a></nav>
<div class="wrap">
{{ body }}
</div></body></html>
"""


def render_blocks(blocks):
    from jinja2 import Template
    parts = []
    for b in blocks:
        if b[0] == "title":
            parts.append(f"<h{b[1]}>{html.escape(b[2])}</h{b[1]}>")
        elif b[0] == "para":
            parts.append(f"<p>{b[1]}</p>")
        elif b[0] == "table":
            head = "".join(f"<th>{_inline(c)}</th>" for c in b[1])
            rows = "".join(
                "<tr>" + "".join(f"<td>{_inline(c)}</td>" for c in row)
                + "</tr>" for row in b[2])
            parts.append(f"<table><thead><tr>{head}</tr></thead>"
                         f"<tbody>{rows}</tbody></table>")
        elif b[0] == "code":
            try:
                from pygments import highlight
                from pygments.lexers import PythonLexer
                from pygments.formatters import HtmlFormatter
                parts.append(highlight(b[1], PythonLexer(),
                                       HtmlFormatter(noclasses=True)))
            except Exception:                           # noqa: BLE001
                parts.append(f"<pre><code>{html.escape(b[1])}</code></pre>")
        elif b[0] == "automodule":
            modname, members = b[1], b[2]
            moddoc, docs = autodoc(modname, members)
            parts.append(f'<div class="modpath">{html.escape(modname)}</div>')
            if moddoc:
                parts.append(f'<pre class="doc">{html.escape(moddoc)}</pre>')
            for kind, name, sig, doc, methods in docs:
                parts.append('<div class="member">')
                label = "class " if kind == "class" else ""
                parts.append(f'<span class="sig">{label}{html.escape(name)}'
                             f'{html.escape(sig)}</span>')
                if doc:
                    parts.append(f'<pre class="doc">{html.escape(doc)}</pre>')
                for mname, msig, mdoc in methods:
                    parts.append('<div class="method">')
                    parts.append(f'<span class="sig">.{html.escape(mname)}'
                                 f'{html.escape(msig)}</span>')
                    if mdoc:
                        parts.append(
                            f'<pre class="doc">{html.escape(mdoc)}</pre>')
                    parts.append("</div>")
                parts.append("</div>")
    return "\n".join(parts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="docs")
    ap.add_argument("--out", default=os.path.join("docs", "_build", "html"))
    args = ap.parse_args()

    sys.path.insert(0, os.getcwd())
    from jinja2 import Template
    os.makedirs(args.out, exist_ok=True)

    n_err = 0
    for rst in sorted(os.listdir(args.src)):
        if not rst.endswith(".rst"):
            continue
        name = rst[:-4]
        text = open(os.path.join(args.src, rst)).read()
        blocks = parse_rst(text)
        try:
            body = render_blocks(blocks)
        except DocError as e:
            print(f"ERROR [{rst}]: {e}", file=sys.stderr)
            n_err += 1
            continue
        title = next((b[2] for b in blocks if b[0] == "title"), name)
        out_path = os.path.join(args.out, f"{name}.html")
        with open(out_path, "w") as f:
            f.write(Template(PAGE).render(title=title, body=body))
        print(f"wrote {out_path}")
    if n_err:
        print(f"{n_err} error(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
