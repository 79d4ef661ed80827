"""The port's C++ batch packer against arec's and against the numpy twins
(bit for bit), the batch iterators built on it against arec's, its build
(a broken source raises with g++'s message, an edited source gets a new
library), and the prefetcher on the CPU: order, content, the worker's
error raised in the consumer, and close."""

import shutil
import threading
import time

import numpy as np
import pytest
import torch

from arec import native as jnative
from arec.config import DataConfig as JDataConfig
from arec.data import dataset as jdataset
from arec.data.synthetic import generate as jgenerate
from arec_torch import native
from arec_torch.config import DataConfig as TDataConfig
from arec_torch.data import dataset as tdataset
from arec_torch.data.prefetch import prefetch, to_device
from arec_torch.data.synthetic import generate as tgenerate
from arec_torch.native import build

torch.set_num_threads(1)

PAD = 999


def _hist(L):
    """Histories of every length class against L: 0, 1, L, L + 1 and
    longer than L + 1 (up to the table's width), newest last, PAD -1."""
    rng = np.random.default_rng(L)
    width = L + 9
    lens = [0, 1, L, L + 1, L + 2, width] + list(
        rng.integers(0, width + 1, 24))
    h = np.full((len(lens), width), -1, np.int32)
    for u, n in enumerate(lens):
        h[u, :n] = rng.integers(0, 500, n)
    users = np.concatenate([np.arange(len(lens)),
                            rng.integers(0, len(lens), 20)]).astype(np.int32)
    return h, np.asarray(lens, np.int32), users


@pytest.mark.parametrize("L", [1, 8, 40])
@pytest.mark.parametrize("kind", ["train", "eval"])
def test_packer_bit_equal_to_arec_and_numpy(kind, L):
    h, hlen, users = _hist(L)
    fn = f"pack_{kind}_sequences"
    got = getattr(native, fn)(h, hlen, users, L, PAD)
    arec_cpp = getattr(jnative, fn)(h, hlen, users, L, PAD)
    twin = getattr(native, f"{fn}_np")(h, hlen, users, L, PAD)
    assert jnative.available()
    assert len(got) == len(twin) == (3 if kind == "train" else 2)
    for g, a, t in zip(got, arec_cpp, twin):
        assert g.dtype == t.dtype and g.shape == t.shape == (len(users), L)
        np.testing.assert_array_equal(g, a)
        np.testing.assert_array_equal(g, t)


def test_packer_refuses_operands_outside_the_tables():
    h, hlen, users = _hist(8)
    with pytest.raises(ValueError, match="user id"):
        native.pack_train_sequences(h, hlen, np.array([len(h)], np.int32),
                                    8, PAD)
    bad = hlen.copy()
    bad[0] = h.shape[1] + 1
    with pytest.raises(ValueError, match="history length"):
        native.pack_eval_sequences(h, bad, np.array([0], np.int32), 8, PAD)


SYN = dict(dataset="synthetic", syn_users=300, syn_items=200,
           syn_interactions=6000, syn_seed=3)


@pytest.mark.parametrize("L", [1, 8, 40])
def test_batch_iterators_equal_arec(L):
    jds, tds = jgenerate(JDataConfig(**SYN)), tgenerate(TDataConfig(**SYN))
    pairs = [(jdataset.seq_batches(jds, 32, L, 5, 1),
              tdataset.seq_batches(tds, 32, L, 5, 1)),
             (jdataset.eval_batches(jds, 48, max_seq_len=L),
              tdataset.eval_batches(tds, 48, max_seq_len=L))]
    for want_it, got_it in pairs:
        want, got = list(want_it), list(got_it)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], np.asarray(w[k]))


@pytest.fixture
def scratch_build(tmp_path, monkeypatch):
    """The build pointed at a copy of the source and a fresh directory."""
    src = tmp_path / "packer.cpp"
    shutil.copy(build.SRC, src)
    monkeypatch.setattr(build, "SRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return src


def test_a_broken_source_raises_with_gxx_output(scratch_build):
    scratch_build.write_text(scratch_build.read_text()
                             + "\nint broken( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        build.build()
    assert "error" in str(e.value) and "packer.cpp" in str(e.value)
    assert not any(build.BUILD_DIR.glob("*.so"))


def test_an_edited_source_gets_a_new_library(scratch_build):
    first = build.build()
    assert first.exists() and first.parent == build.BUILD_DIR
    assert build.build() == first                  # built once
    scratch_build.write_text(scratch_build.read_text() + "\n// edited\n")
    second = build.library_path()
    assert second != first and not second.exists()
    assert build.build() == second and second.exists()
    assert not list(build.BUILD_DIR.glob("*.tmp"))


def _batches(n):
    rng = np.random.default_rng(0)
    return [{"inputs": rng.integers(0, 9, (4, 3)).astype(np.int32),
             "mask": rng.random((4, 3)).astype(np.float32),
             "step": np.array([i])} for i in range(n)]


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_keeps_order_and_content(depth):
    src = _batches(23)
    got = list(prefetch(iter(src), depth=depth,
                        transform=to_device("cpu", depth)))
    assert len(got) == len(src)
    for g, s in zip(got, src):
        assert g.keys() == s.keys()
        for k in s:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), s[k])


def test_prefetch_raises_the_workers_error_in_the_consumer():
    def failing():
        yield from _batches(3)
        raise KeyError("bad batch")
    it = prefetch(failing(), depth=2, transform=to_device("cpu"))
    assert [int(b["step"]) for b in (next(it), next(it), next(it))] == [
        0, 1, 2]
    with pytest.raises(KeyError, match="bad batch"):
        next(it)


def test_prefetch_close_stops_the_worker():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield {"step": np.array([i])}
            i += 1
    it = prefetch(endless(), depth=2)
    assert next(it)["step"][0] == 0
    it.close()                      # joins the worker
    n = len(produced)
    time.sleep(0.2)
    assert len(produced) == n <= 4      # the queue's depth, plus one held
    assert not [t for t in threading.enumerate()
                if t.name == "arec-prefetch"]
