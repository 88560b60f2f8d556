"""Hold a twin's JAX reference to the key table it runs with.

The JAX package's key dictionary keeps string and int64 keys in its native
library (`flink_tpu/utils/native_bridge.py`), which it builds in place
with g++ at first use and, when a load fails, marks as unavailable for the
life of the process. Under pytest-xdist several workers start that build
together: a worker that loads the library while another worker's g++ is
still writing it gets a truncated file, and for the rest of its run the
JAX dictionary falls back to its dict path, which keeps `np.str_` keys and
emits them as `np.str_('c0')` where the native path emits `'c0'`. The
port's dictionary keys batches as the native path does (C2), so a twin
comparing emitted rows by `repr` would then fail on a worker-order
accident.

A twin file imports `jax_native_library`: the autouse fixture loads the
JAX library before the module's tests and, if this process marked it
unavailable, loads it again once the other workers' builds are done. The
comparison itself stays exact.
"""

import time

import pytest


def load_jax_native_library(attempts: int = 5, wait_s: float = 2.0) -> bool:
    """Load the JAX package's native library in this process, retrying a
    failed load; True once it is loaded."""
    from flink_tpu.utils import native_bridge

    for attempt in range(attempts):
        if native_bridge.get_lib() is not None:
            return True
        if not native_bridge._load_failed:
            return False
        if attempt:
            time.sleep(wait_s)   # another process may still be writing it
        native_bridge._load_failed = False
    return native_bridge.get_lib() is not None


@pytest.fixture(autouse=True, scope="module")
def jax_native_library():
    load_jax_native_library()
    yield
