"""The port's prefetch thread and one-in-flight pipeline, held to the JAX
package's contract: ordering, errors, abandonment, dispatch-before-fetch.

Each contract test runs on both implementations and wants the same
result; ``start_fetch`` (the port's event-based download) runs on the CPU
here, where it copies nothing.
"""

import threading
import time

import numpy as np
import pytest
import torch

from consensuscruncher_tpu.parallel import prefetch as jax_prefetch
from consensuscruncher_tpu_torch.parallel import prefetch as torch_prefetch

IMPLS = {"jax": jax_prefetch, "torch": torch_prefetch}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_preserves_order(impl, depth):
    assert list(IMPLS[impl].prefetch(iter(range(100)), depth=depth)) == list(range(100))


@pytest.mark.parametrize("impl", IMPLS)
def test_prefetch_propagates_producer_exception(impl):
    def gen():
        yield 1
        raise RuntimeError("producer blew up")

    it = IMPLS[impl].prefetch(gen(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer blew up"):
        next(it)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefetch_close_stops_and_joins_producer(impl):
    done = threading.Event()

    def gen():
        try:
            yield from range(10_000)
        finally:
            done.set()

    it = IMPLS[impl].start_prefetch(gen(), depth=1)
    assert next(it) == 0
    it.close()
    it.close()  # idempotent
    assert done.wait(5.0)
    assert "cct-prefetch" not in [t.name for t in threading.enumerate()]


@pytest.mark.parametrize("impl", IMPLS)
def test_start_prefetch_is_eager(impl):
    started = threading.Event()

    def gen():
        started.set()
        yield from range(5)

    it = IMPLS[impl].start_prefetch(gen(), depth=2)
    assert started.wait(5.0)  # produced without any pull
    time.sleep(0.05)
    assert list(it) == list(range(5))


@pytest.mark.parametrize("impl", IMPLS)
def test_pipelined_orders_dispatch_before_fetch(impl):
    events = []

    def dispatch(b):
        events.append(("dispatch", b))
        return b * 10

    def fetch(b, h):
        events.append(("fetch", b))
        yield h

    def on_dispatch(b, h):
        events.append(("captured", b, h))

    out = list(IMPLS[impl].pipelined([1, 2, 3], dispatch, fetch, on_dispatch=on_dispatch))
    assert out == [10, 20, 30]
    assert events == [
        ("dispatch", 1), ("captured", 1, 10), ("dispatch", 2), ("captured", 2, 20),
        ("fetch", 1), ("dispatch", 3), ("captured", 3, 30), ("fetch", 2), ("fetch", 3),
    ]
    assert list(IMPLS[impl].pipelined([], lambda b: b, lambda b, h: [h])) == []


@pytest.mark.parametrize("impl", IMPLS)
def test_pipelined_raises_a_fetch_failure(impl):
    def fetch(b, h):
        if b == 2:
            raise ValueError("fetch of batch 2 failed")
        yield h

    got = []
    with pytest.raises(ValueError, match="batch 2"):
        for x in IMPLS[impl].pipelined([1, 2, 3], lambda b: b, fetch):
            got.append(x)
    assert got == [1]


def test_start_fetch_on_cpu_returns_the_tensors():
    a = torch.arange(6, dtype=torch.uint8).reshape(2, 3)
    b = torch.tensor([7, 8], dtype=torch.int32)
    got = torch_prefetch.start_fetch(a, b).result()
    np.testing.assert_array_equal(got[0], a.numpy())
    np.testing.assert_array_equal(got[1], b.numpy())
