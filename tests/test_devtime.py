"""Device-time reduction (utils/devtime.py) on synthetic events and a
CPU trace (which holds no accelerator plane)."""

import jax
import jax.numpy as jnp
import pytest

from pcrhpg24_tpu.utils import devtime


@pytest.mark.parametrize("name,want", [
    ("/device:GPU:0", True), ("/device:GPU:3", True),
    ("/device:CPU:0", False), ("/host:CPU", False), ("Task Environment", False),
])
def test_device_plane_names(name, want):
    assert devtime.is_device_plane(name) == want


def test_busy_is_the_union_of_intervals():
    ev = [("/device:GPU:0", "s1", "a", 0, 10_000_000),
          ("/device:GPU:0", "s2", "b", 5_000_000, 10_000_000),  # overlaps
          ("/device:GPU:0", "s1", "a", 20_000_000, 1_000_000)]  # after a gap
    assert devtime.busy_ms(ev) == pytest.approx(16.0)
    assert devtime.kernel_ms(ev) == pytest.approx({"a": 11.0, "b": 10.0})
    assert devtime.busy_ms([]) == 0.0


def test_cpu_trace_has_no_device_events(tmp_path):
    f = jax.jit(lambda x: (x * 2).sum())
    x = jnp.ones(1024)
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    assert devtime.device_events(str(tmp_path)) == []
    with pytest.raises(RuntimeError):
        devtime.device_ms(f, x)
