"""Shape-only flax inits for the port's tests.

``shapes_of(module, *args, **kwargs)`` is ``jax.eval_shape`` of
``module.init(PRNGKey(0), *args, **kwargs)`` with JAX's random draws
(``normal``, ``truncated_normal``, ``uniform``) standing in as zeros of the
shape and dtype asked for, and flax's per-module key folding skipped, while
it traces: the tests fill every leaf with seeded numpy values, so the draws
would only cost trace time. The tree, shapes and dtypes are the same.
"""
import contextlib

import jax
import jax.numpy as jnp
from flax.core import scope as _scope
from jax._src import random as _random


def _zeros(shape, dtype):
    return jnp.zeros(() if shape is None else shape, dtype)


@contextlib.contextmanager
def _draws_as_zeros():
    saved = {n: getattr(_random, n) for n in ("normal", "truncated_normal", "uniform")}
    fold = _scope._fold_in_static
    _random.normal = lambda key, shape=(), dtype=float, *a, **k: _zeros(shape, dtype)
    _random.uniform = lambda key, shape=(), dtype=float, *a, **k: _zeros(shape, dtype)
    _random.truncated_normal = (lambda key, lower, upper, shape=None, dtype=float, *a, **k:
                                _zeros(shape, dtype))
    _scope._fold_in_static = lambda rng, data: rng
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(_random, name, fn)
        _scope._fold_in_static = fold


def shapes_of(module, *args, **kwargs):
    """The variable tree of ``module.init`` as ``jax.ShapeDtypeStruct`` leaves."""
    with _draws_as_zeros():
        return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
