"""The generic dense Matrix of the apps (reference Matrix.h:17-83).

This is fhe_si_tpu/apps/matrix.py itself, loaded from its file: it
imports only `typing`, but importing it as fhe_si_tpu.apps.matrix runs
fhe_si_tpu/apps/__init__.py, which imports the JAX apps.  Moving the
apps' host helpers into a JAX-free module of fhe_si_tpu (ROADMAP item
15) makes this loader a plain import.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import fhe_si_tpu

_SRC = Path(fhe_si_tpu.__file__).resolve().parent / "apps" / "matrix.py"
_spec = importlib.util.spec_from_file_location(__name__ + "_src", _SRC)
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)

Matrix = _mod.Matrix
