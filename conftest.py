"""Session set-up for the JAX test runs, loaded by pytest with
``tests/conftest.py`` (which sets JAX's platform and device count) and run
after it, in ``pytest_configure``:

- Each test process keeps XLA's persistent compilation cache in a temp dir
  of its own, removed at exit. One config-5 run (``tests/test_config5.py``)
  compiles about 4,500 programs, mostly the same ones again, and the cache
  loads the repeats from disk. Nothing is shared between xdist workers or
  kept between runs.
- The controller builds vxtpu's two native libraries (the DDA oracle and
  the frame sink) before the xdist workers start. Their test files decide
  at import, in every worker, whether they skip, and builds started
  together race on each library's one temp file.

A run that loads no JAX (``vxbench/tests``, or ``--noconftest`` on a
machine without JAX) is left alone.
"""

import atexit
import shutil
import sys
import tempfile


def pytest_configure(config):
    if "jax" not in sys.modules:
        return
    from vxtpu.engine.platform import enable_compilation_cache

    cache = tempfile.mkdtemp(prefix="vxtpu-tests-xla-")
    atexit.register(shutil.rmtree, cache, ignore_errors=True)
    enable_compilation_cache(cache)

    if not hasattr(config, "workerinput"):
        from vxtpu.native.framesink import framesink_available
        from vxtpu.native.oracle import native_available

        native_available()
        framesink_available()
