import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# -- optional-hypothesis shim ------------------------------------------------
# Four test modules property-test with hypothesis.  On environments without
# the package, install a minimal fixed-seed stand-in under the same import
# name BEFORE test modules import it, so the suite still collects and runs
# (fewer examples, deterministic draws — not a replacement for the real
# thing, which requirements-dev.txt installs in CI).
try:
    import hypothesis  # noqa: F401
except ImportError:
    import random
    import types

    _SHIM_MAX_EXAMPLES = 10  # keep the fallback suite fast

    class _Strategy:
        """A draw(rng) callable plus the boundary examples tried first."""

        def __init__(self, draw, boundaries=()):
            self._draw = draw
            self.boundaries = tuple(boundaries)

        def example(self, rng):
            return self._draw(rng)

    def _integers(min_value=0, max_value=1 << 30):
        return _Strategy(lambda rng: rng.randint(min_value, max_value),
                         boundaries=(min_value, max_value))

    def _floats(min_value=0.0, max_value=1.0, **_):
        return _Strategy(lambda rng: rng.uniform(min_value, max_value),
                         boundaries=(min_value, max_value))

    def _sampled_from(seq):
        elems = list(seq)
        return _Strategy(lambda rng: rng.choice(elems),
                         boundaries=(elems[0], elems[-1]))

    def _lists(elem, min_size=0, max_size=10):
        def draw(rng):
            size = rng.randint(min_size, max_size)
            return [elem.example(rng) for _ in range(size)]
        return _Strategy(
            draw, boundaries=([elem.example(random.Random(0))] * min_size,))

    def _tuples(*elems):
        return _Strategy(lambda rng: tuple(e.example(rng) for e in elems))

    def _given(*strategies):
        def deco(fn):
            def wrapper():
                rng = random.Random(0)
                limit = getattr(wrapper, "_shim_max_examples",
                                _SHIM_MAX_EXAMPLES)
                # boundary examples first (min/max of each strategy in
                # lockstep — covers n=1 and n=max), then random draws
                nb = max((len(s.boundaries) for s in strategies), default=0)
                cases = [
                    tuple(s.boundaries[min(i, len(s.boundaries) - 1)]
                          if s.boundaries else s.example(rng)
                          for s in strategies)
                    for i in range(nb)
                ]
                while len(cases) < limit:
                    cases.append(tuple(s.example(rng) for s in strategies))
                for args in cases[:limit]:
                    fn(*args)
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            return wrapper
        return deco

    def _settings(max_examples=_SHIM_MAX_EXAMPLES, deadline=None, **_):
        def deco(fn):
            fn._shim_max_examples = min(max_examples, _SHIM_MAX_EXAMPLES)
            return fn
        return deco

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.floats = _floats
    _st.lists = _lists
    _st.tuples = _tuples
    _st.sampled_from = _sampled_from
    _hyp.strategies = _st
    _hyp.__is_repro_shim__ = True
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    # a test that needs a CUDA card carries this marker and skips without
    # one from inside a fixture (tests/test_torch_paged_decode.py `cuda`);
    # on the card: `python -m pytest -m cuda tests/test_torch_paged_decode.py`
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
