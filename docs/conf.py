# Sphinx configuration for the gppe-tpu documentation
# (role of reference docs/conf.py; the prose sources are the MyST
# markdown files in this directory — index.md, QUICKSTART.md, API.md,
# ARCHITECTURE.md — plus autodoc over the gppe_tpu package).
#
# Build:  pip install .[docs] && make -C docs html
# (sphinx is not baked into the benchmark image, so CI treats the docs
# build as optional — see .github/workflows/ci.yml docs job.)

import os
import sys

sys.path.insert(0, os.path.abspath(".."))

project = "gppe-tpu"
author = "gppe-tpu developers"
copyright = "2026, gppe-tpu developers"
release = "0.1.0"

extensions = [
    "myst_parser",            # markdown sources
    "sphinx.ext.autodoc",     # API reference from docstrings
    "sphinx.ext.napoleon",    # numpy/google docstring styles
    "sphinx.ext.viewcode",
    "sphinx.ext.mathjax",
    "sphinx.ext.intersphinx",
]

source_suffix = {
    ".rst": "restructuredtext",
    ".md": "markdown",
}

myst_enable_extensions = ["dollarmath", "amsmath"]

master_doc = "index"
exclude_patterns = ["_build"]

intersphinx_mapping = {
    "python": ("https://docs.python.org/3", None),
    "numpy": ("https://numpy.org/doc/stable/", None),
    "jax": ("https://docs.jax.dev/en/latest/", None),
}

# autodoc: mock the accelerator stack so docs build on any machine
autodoc_mock_imports = []
autodoc_member_order = "bysource"
autodoc_typehints = "description"

html_theme = "alabaster"
html_static_path = []
html_theme_options = {
    "description": "Gaussian-process hyperparameter estimation "
                   "(JAX/XLA/Pallas)",
    "fixed_sidebar": True,
}
