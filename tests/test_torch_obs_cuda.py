"""arec_torch.obs on the card: a span with `stream=` times its device work
by the CUDA events it records, and its main-thread range lands in the
profiler's trace as a user annotation, not as device work.

Marked `cuda`: they skip where no CUDA device is present. On a machine with
one (and no jax), run them without the jax-loading conftest:

    python -m pytest tests/test_torch_obs_cuda.py --noconftest -q
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from arec_torch import obs


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _products(a, n=5):
    for _ in range(n):
        a = a @ a.T
        a = a / a.norm()
    return a


@pytest.mark.cuda
def test_stream_seconds_time_the_spans_device_work(dev):
    a = torch.randn(4096, 4096, device=dev)
    _products(a)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    _products(a)
    e1.record()
    torch.cuda.synchronize()
    alone_s = e0.elapsed_time(e1) / 1e3
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with obs.span("t.products", stream=dev):
                _products(a)
        torch.cuda.synchronize()
    s = obs.snapshot()["spans"]["t.products"]
    obs.reset()
    assert s["count"] == 3
    assert s["stream_s"] == pytest.approx(3 * alone_s, rel=0.25)
    shadows = [e for e in prof.profiler.kineto_results.events()
               if e.name() == "t.products"
               and e.device_type() == torch.autograd.DeviceType.CUDA]
    assert shadows and all(e.is_user_annotation() for e in shadows)
