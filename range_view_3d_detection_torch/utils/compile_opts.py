"""Compiler options from the environment for the port's programs
(counterpart of the JAX package's ``utils/compile_opts.py``).

The port runs eagerly. ``jit_env_options(fn)`` reads
``RV3D_COMPILER_OPTIONS`` (a comma list of ``name=value``) when it is
called: unset, it returns ``fn`` itself; set, it returns a callable that
compiles ``fn`` with ``torch.compile(fn, options=..., dynamic=False)`` on
its first call for each argument structure, shape and dtype. The options
are inductor's (``torch._inductor.config``); an unknown name raises. An A/B
of a compiler knob is then one environment variable on an unchanged bench:

    RV3D_COMPILER_OPTIONS=max_autotune=True \\
        python -m range_view_3d_detection_torch.bench

The four kernels are ``torch.library`` ops with fake implementations, so
a compiled program launches them without a graph break.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils import _pytree as pytree

ENV_VAR = "RV3D_COMPILER_OPTIONS"


def parse_options(spec: str) -> Dict[str, str]:
    """``"a=1,b=c"`` -> ``{"a": "1", "b": "c"}`` (empty items skipped)."""
    out: Dict[str, str] = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(
                f"{ENV_VAR} items must be name=value, got {item!r}"
            )
        k, v = item.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def _typed(value: str) -> Any:
    """An option's text as the Python value inductor's config expects."""
    if value in ("True", "true"):
        return True
    if value in ("False", "false"):
        return False
    for kind in (int, float):
        try:
            return kind(value)
        except ValueError:
            pass
    return value


def _arg_key(args) -> Tuple:
    # The argument structure and each leaf's (shape, dtype): two calls with
    # different structures but the same leaves must not share a program.
    leaves, spec = pytree.tree_flatten(args)
    return (
        str(spec),
        tuple(
            (tuple(getattr(a, "shape", ())), str(getattr(a, "dtype", type(a))))
            for a in leaves
        ),
    )


def jit_env_options(fn: Callable) -> Callable:
    """``fn``, or ``torch.compile`` of it under ``RV3D_COMPILER_OPTIONS``
    (see the module docstring)."""
    spec = os.environ.get(ENV_VAR, "")
    if not spec:
        return fn
    options = {k: _typed(v) for k, v in parse_options(spec).items()}
    cache: Dict[Tuple, Callable] = {}

    def wrapper(*args, **kwargs):
        if kwargs:
            raise TypeError(
                "jit_env_options wrapper is positional-only under "
                f"{ENV_VAR} (kwargs are not part of the compile cache key)"
            )
        key = _arg_key(args)
        if key not in cache:
            cache[key] = torch.compile(fn, options=options, dynamic=False)
        return cache[key](*args)

    wrapper.compiled = cache
    return wrapper
