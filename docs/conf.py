"""Sphinx configuration (API reference via autodoc + napoleon, the same
documentation style as the reference's doc/sphinx). Build with `make docs`
where sphinx is installed."""

project = "bild_jax"
author = "bild_jax developers"

extensions = [
    "sphinx.ext.autodoc",
    "sphinx.ext.napoleon",
    "sphinx.ext.viewcode",
]

autodoc_member_order = "bysource"
napoleon_google_docstring = False
napoleon_numpy_docstring = True

html_theme = "alabaster"
