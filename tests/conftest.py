"""Shared test config.

This container does not ship ``hypothesis`` and the environment bakes its
dependency set (no pip installs), so when the real package is missing we
install a tiny deterministic stand-in implementing exactly the surface the
suite uses (given/settings, sampled_from/integers/floats/booleans/tuples/
data, extra.numpy.arrays).  It runs each property test ``max_examples``
times with a seeded RNG — deterministic across runs, so failures reproduce.
With real hypothesis installed this module is inert.
"""
from __future__ import annotations

import inspect


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test (subprocess compiles)")
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")
import random
import sys
import types

try:  # pragma: no cover - prefer the real thing when available
    import hypothesis  # noqa: F401
except ImportError:
    import numpy as np

    class _Strategy:
        def __init__(self, sample):
            self.sample = sample  # sample(rnd) -> value

    def sampled_from(seq):
        seq = list(seq)
        return _Strategy(lambda rnd: seq[rnd.randrange(len(seq))])

    def integers(min_value, max_value):
        return _Strategy(lambda rnd: rnd.randint(min_value, max_value))

    def floats(min_value, max_value):
        return _Strategy(lambda rnd: rnd.uniform(min_value, max_value))

    def booleans():
        return _Strategy(lambda rnd: bool(rnd.getrandbits(1)))

    def tuples(*strats):
        return _Strategy(lambda rnd: tuple(s.sample(rnd) for s in strats))

    class _Data:
        def __init__(self, rnd):
            self._rnd = rnd

        def draw(self, strategy):
            return strategy.sample(self._rnd)

    def data():
        return _Strategy(lambda rnd: _Data(rnd))

    def _np_arrays(dtype, shape, elements=None):
        def sample(rnd):
            if isinstance(shape, _Strategy):
                shp = shape.sample(rnd)
            else:
                shp = shape
            n = int(np.prod(shp)) if shp else 1
            if elements is None:
                flat = [rnd.random() for _ in range(n)]
            else:
                flat = [elements.sample(rnd) for _ in range(n)]
            return np.asarray(flat, dtype=dtype).reshape(shp)

        return _Strategy(sample)

    def settings(max_examples: int = 20, deadline=None, **_kw):
        def deco(fn):
            fn._stub_max_examples = max_examples
            return fn

        return deco

    def given(**strategy_kw):
        def deco(fn):
            n = getattr(fn, "_stub_max_examples", 20)
            takes_self = next(iter(inspect.signature(fn).parameters), None) == "self"

            if takes_self:
                def wrapper(self):
                    rnd = random.Random(0xC0FFEE)
                    for _ in range(n):
                        fn(self, **{k: s.sample(rnd) for k, s in strategy_kw.items()})
            else:
                def wrapper():
                    rnd = random.Random(0xC0FFEE)
                    for _ in range(n):
                        fn(**{k: s.sample(rnd) for k, s in strategy_kw.items()})

            # no functools.update_wrapper: it would set __wrapped__ and
            # pytest would then see the strategy params as missing fixtures
            wrapper.__name__ = fn.__name__
            wrapper.__qualname__ = fn.__qualname__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            return wrapper

        return deco

    hyp = types.ModuleType("hypothesis")
    hyp.given, hyp.settings = given, settings
    st_mod = types.ModuleType("hypothesis.strategies")
    st_mod.sampled_from, st_mod.integers, st_mod.floats = sampled_from, integers, floats
    st_mod.booleans, st_mod.tuples, st_mod.data = booleans, tuples, data
    extra = types.ModuleType("hypothesis.extra")
    hnp_mod = types.ModuleType("hypothesis.extra.numpy")
    hnp_mod.arrays = _np_arrays
    hyp.strategies, hyp.extra = st_mod, extra
    extra.numpy = hnp_mod
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = st_mod
    sys.modules["hypothesis.extra"] = extra
    sys.modules["hypothesis.extra.numpy"] = hnp_mod
