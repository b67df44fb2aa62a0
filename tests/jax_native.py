"""Keeps the port's JAX-parity tests on the JAX package's native BVH route.

spcbpt_tpu/native/loader.py compiles libspcbpt_native.so with g++ in its
own directory at first use, with no lock and no atomic rename, and on any
failure returns None for the rest of the process: a worker that loads the
library while another test process is still linking it, or whose link loses
that race, builds the JAX package's trees with numpy from then on
(spcbpt_tpu/ops/bvh.py catches everything), silently. The port takes the
native route wherever g++ is on the PATH, and the two routes give different
trees, so a parity test would compare mismatched trees and fail far from
the cause.

`require_native_jax` makes the route deterministic. Under an exclusive
`fcntl` lock on a file in the temporary directory, keyed by this checkout's
path, it loads the JAX package's native library; where g++ exists and the
load failed, it clears the loader's memory of the attempt and retries every
POLL_S seconds (a concurrent in-place g++ from a test process that does not
take the lock finishes meanwhile), and after WAIT_S seconds fails the test
with the cause. The module fixture `native_jax_route`, imported by every
test file that builds a scene or a BVH in both packages, runs it before the
file's first JAX build.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import tempfile
import time

import pytest

WAIT_S = 60.0
POLL_S = 0.5
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lock_path() -> str:
    key = hashlib.sha256(_REPO.encode()).hexdigest()[:16]
    return os.path.join(tempfile.gettempdir(),
                        f"spcbpt_native_build_{key}.lock")


def require_native_jax():
    """The JAX package's native library, loaded in this process; None only
    where there is no g++ (both packages then take the numpy route).
    Fails the calling test if g++ exists and the library does not load
    within WAIT_S seconds."""
    from spcbpt_tpu.native import loader

    with open(lock_path(), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            lib = loader.get_lib()
            if lib is None and shutil.which("g++") is not None:
                deadline = time.monotonic() + WAIT_S
                while lib is None and time.monotonic() < deadline:
                    time.sleep(POLL_S)
                    loader._TRIED = False
                    lib = loader.get_lib()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    if lib is None and shutil.which("g++") is not None:
        pytest.fail(
            f"the JAX package's native library (spcbpt_tpu/native/loader.py) "
            f"did not load within {WAIT_S:.0f} s although g++ is on the "
            f"PATH: its in-place g++ build failed or is unfinished, so "
            f"spcbpt_tpu/ops/bvh.py would build numpy trees while the port "
            f"builds native ones, and every tree-comparing parity test would "
            f"compare mismatched trees", pytrace=False)
    return lib


@pytest.fixture(scope="module", autouse=True)
def native_jax_route():
    """Runs require_native_jax once per test module, before its tests and
    their module fixtures build anything in the JAX package."""
    return require_native_jax()
