"""The port's ``utils/compile_opts.py`` against the JAX package's
(``tests/test_compile_opts.py``'s three cases), on the CPU.

- ``parse_options`` is the JAX function: the same dicts, the same error
  message for an item without ``=``.
- Unset, ``jit_env_options(fn)`` is ``fn`` itself (the port runs eagerly).
- Set to a real inductor option, the wrapper compiles on first call,
  memoises per argument shape (a new shape compiles anew), refuses keyword
  arguments, and an unknown option raises instead of being dropped.
"""

import numpy as np
import pytest
import torch

from range_view_3d_detection_torch.utils import compile_opts
from range_view_3d_detection_tpu.utils import compile_opts as jax_compile_opts


@pytest.mark.parametrize("spec", ["", "a=1", " a=1, b = x=y ,", "max_autotune=False"])
def test_parse_options(spec):
    assert compile_opts.parse_options(spec) == jax_compile_opts.parse_options(spec)
    assert compile_opts.parse_options(" a=1, b = x=y ,") == {"a": "1", "b": "x=y"}
    with pytest.raises(ValueError) as got:
        compile_opts.parse_options("notakv")
    with pytest.raises(ValueError) as want:
        jax_compile_opts.parse_options("notakv")
    assert str(got.value) == str(want.value)


def test_jit_env_options_unset_is_eager(monkeypatch):
    monkeypatch.delenv(compile_opts.ENV_VAR, raising=False)

    def f(x):
        return x * 2

    assert compile_opts.jit_env_options(f) is f
    np.testing.assert_allclose(compile_opts.jit_env_options(f)(torch.ones(4)).numpy(), 2.0)


def test_jit_env_options_with_option(monkeypatch):
    monkeypatch.setenv(compile_opts.ENV_VAR, "max_autotune=False")
    f = compile_opts.jit_env_options(lambda x: x + 1)
    a = torch.zeros(3)
    np.testing.assert_allclose(f(a).numpy(), 1.0)
    np.testing.assert_allclose(f(a).numpy(), 1.0)  # memoized
    assert len(f.compiled) == 1
    np.testing.assert_allclose(f(torch.zeros(5)).numpy(), 1.0)  # new shape
    assert len(f.compiled) == 2
    with pytest.raises(TypeError, match="positional-only"):
        f(x=a)
    monkeypatch.setenv(compile_opts.ENV_VAR, "no_such_option=1")
    with pytest.raises(RuntimeError, match="no_such_option"):
        compile_opts.jit_env_options(lambda x: x + 1)(a)


@pytest.mark.parametrize("spec, extra", [
    ("max_autotune=False", {"max_autotune": False}),
    ("emulate_precision_casts=False", {"emulate_precision_casts": False}),
])
def test_jit_env_options_start_from_eager_numerics(monkeypatch, spec, extra):
    """A compiled program gets ``EAGER_NUMERICS`` under the environment's
    options, which override them."""
    seen = []

    def fake_compile(fn, *, options, dynamic):
        seen.append((options, dynamic))
        return fn

    monkeypatch.setattr(compile_opts.torch, "compile", fake_compile)
    monkeypatch.setenv(compile_opts.ENV_VAR, spec)
    assert compile_opts.jit_env_options(lambda x: x + 1)(torch.zeros(2)).tolist() == [1.0, 1.0]
    assert seen == [({**compile_opts.EAGER_NUMERICS, **extra}, False)]
    assert compile_opts.EAGER_NUMERICS == {"emulate_precision_casts": True,
                                           "eager_numerics.division_rounding": True}
