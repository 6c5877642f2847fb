"""One build of the JAX package's native core for all test workers.

The JAX package's loader (``s3grl_tpu/native/__init__.py``) compiles its
library into ``<cache>/graphcore_<tag>.so.tmp`` and renames it into place.
Test workers that start together and find no library all compile into that
one temporary file; those that lose the race get no library, remember it,
and their JAX native tests skip. The port's own core builds under names of
its own (``s3grl_tpu_torch/native``); the JAX package stays as it is.

So this module builds the JAX core WHEN IT IS IMPORTED, under an exclusive
``fcntl.flock`` on ``<cache>.lock``. Every worker imports every test module
while collecting, before any test runs: the first to take the lock builds
the library, the others wait and then load it. A test module imported
before this one that decides its skip at import can still skip.
"""
import fcntl
import os
import subprocess
import sys

import pytest

import s3grl_tpu.native as jnative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_the_jax_native_core_once() -> bool:
    """Build (or load) the JAX package's native core while holding an
    exclusive lock on ``<its cache dir>.lock``. A process whose earlier try
    lost a concurrent build, and now finds the library built, tries again."""
    cache = jnative._cache_dir().rstrip(os.sep)
    with open(cache + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not jnative.available() and not os.environ.get("S3GRL_TPU_NO_NATIVE"):
                jnative._TRIED = False
            return jnative.available()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


JAX_NATIVE = build_the_jax_native_core_once()

needs_native = pytest.mark.skipif(bool(os.environ.get("S3GRL_TPU_NO_NATIVE")),
                                  reason="S3GRL_TPU_NO_NATIVE turns the JAX native core off")


@needs_native
def test_the_jax_native_core_is_loaded_after_import():
    assert JAX_NATIVE and jnative.available()


@needs_native
def test_processes_that_import_at_once_all_load_the_core(tmp_path):
    """Four processes import this module at once into an empty cache: each
    loads the library, and one library is left, with no temporary file."""
    env = dict(os.environ, S3GRL_TPU_NATIVE_CACHE=str(tmp_path / "cache"),
               JAX_PLATFORMS="cpu")
    code = ("import tests.test_torch_jax_native_build as m, s3grl_tpu.native as n; "
            "print(m.JAX_NATIVE, n.available())")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["True", "True"], (out, err)
    left = sorted(os.listdir(tmp_path / "cache"))
    assert len(left) == 1 and left[0].startswith("graphcore_") and left[0].endswith(".so"), left
