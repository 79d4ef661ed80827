"""The prefetcher's pinned, side-stream staging on the card: every staged
batch equals its numpy source while the consumer queues GPU work slower
than the producer (which catches a pinned buffer reused before its copy
finished, or device memory handed to the next batch without
`record_stream` while a step still reads it), the staging buffers are
pinned, and the worker's copy call returns while a GPU spin queued on the
consumer's stream still runs (a pageable `.to()` waits for it).

Marked `cuda`: they skip where no CUDA device is present. On a machine with
one (and no jax), run them without the jax-loading conftest:

    python -m pytest tests/test_torch_prefetch_cuda.py --noconftest -q
"""

import time

import numpy as np
import pytest
import torch

from arec_torch.data.prefetch import PinnedStager, prefetch, to_device

SPIN_CYCLES_PER_MS = int(2e6)     # torch.cuda._sleep at up to ~2 GHz


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batches(n, rows=128, L=50):
    for i in range(n):
        rng = np.random.default_rng(i)
        yield {"inputs": rng.integers(0, 1 << 20, (rows, L)).astype(np.int32),
               "mask": rng.random((rows, L)).astype(np.float32),
               "user": np.full(rows, i, np.int32)}


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2, 9])
def test_staged_batches_equal_sources_under_a_slow_consumer(dev, depth):
    outs = []
    for batch in prefetch(_batches(200), depth=depth,
                          transform=to_device(dev, depth)):
        torch.cuda._sleep(SPIN_CYCLES_PER_MS // 2)   # the step, queued
        outs.append({k: v.clone() for k, v in batch.items()})
        del batch                   # freed while the clone is still queued
        time.sleep(0.0005)          # and the host is slower than the worker
    torch.cuda.synchronize()
    assert len(outs) == 200
    for got, want in zip(outs, _batches(200)):
        for k in want:
            assert got[k].device.type == "cuda"
            np.testing.assert_array_equal(got[k].cpu().numpy(), want[k])


@pytest.mark.cuda
def test_staging_buffers_are_pinned(dev):
    stager = to_device(dev, 2)
    assert isinstance(stager, PinnedStager) and len(stager.ring) == 4
    batch = next(_batches(1))
    got = stager(batch).wait()
    buffers, event = stager.ring[0]
    assert event is not None and sorted(buffers) == sorted(batch)
    assert all(b.is_pinned() for b in buffers.values())
    for k in batch:
        np.testing.assert_array_equal(got[k].cpu().numpy(), batch[k])


@pytest.mark.cuda
def test_copy_call_returns_before_a_queued_spin_ends(dev):
    stager = to_device(dev, 2)
    batches = list(_batches(5))
    for b in batches[:4]:                      # every slot allocated
        stager(b).wait()
    torch.cuda.synchronize()
    torch.cuda._sleep(50 * SPIN_CYCLES_PER_MS)      # ≥ 25 ms on the stream
    spin_done = torch.cuda.Event()
    spin_done.record()
    t0 = time.perf_counter()
    staged = stager(batches[4])
    pinned_s = time.perf_counter() - t0
    assert not spin_done.query(), "the pinned copy call waited for the spin"
    got = staged.wait()
    torch.cuda.synchronize()
    for k in batches[4]:
        np.testing.assert_array_equal(got[k].cpu().numpy(), batches[4][k])
    # the yardstick: a pageable copy waits until the spin drains
    torch.cuda._sleep(50 * SPIN_CYCLES_PER_MS)
    spin_done.record()
    t0 = time.perf_counter()
    torch.from_numpy(batches[4]["inputs"]).to(dev)
    pageable_s = time.perf_counter() - t0
    assert spin_done.query()
    assert pinned_s < pageable_s, (pinned_s, pageable_s)
