"""arec_torch stands alone: no module of it (nor chip_smoke.py, nor the
mesh tests' rank worker) imports jax, jaxlib or arec; it serves a request
in a process where those cannot be imported at all, on one device and on
a 2-rank gloo mesh; and its entry point refuses to fall back to the CPU
when no device was asked for and CUDA is absent."""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(glob.glob(os.path.join(ROOT, "arec_torch", "**", "*.py"),
                           recursive=True)) + [
    os.path.join(ROOT, "chip_smoke.py"),
    os.path.join(ROOT, "tests", "torch_mesh_worker.py")]
FORBIDDEN = ("jax", "jaxlib", "arec")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, ROOT) for p in SOURCES])
def test_no_jax_or_arec_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, (path, bad)


_CHILD = textwrap.dedent("""
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "arec"):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import torch
    from arec_torch import bridge
    from arec_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from arec_torch.data.io import load_or_prepare
    from arec_torch.models.seq import SeqSpec, init_seq
    from arec_torch.serve import Recommender

    torch.set_num_threads(1)
    cfg = Config(
        data=DataConfig(data_dir=sys.argv[1], syn_users=60, syn_items=50,
                        syn_interactions=600),
        model=ModelConfig(model="lstm", cell=sys.argv[2], dim=8,
                          max_seq_len=6, use_pallas_scan=True),
        train=TrainConfig(compute_dtype="float32"))
    ds = load_or_prepare(cfg.data)
    spec = SeqSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    params = bridge.to_numpy(init_seq(torch.Generator().manual_seed(0), spec))
    ids = Recommender(cfg, params, serve_batch=4,
                      device="cpu").from_histories([[1, 2, 3]])
    assert ids.shape == (1, 30) and not {1, 2, 3} & set(ids[0].tolist())
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "arec")
                   for m in sys.modules)
    print("served", ids[0][:3].tolist())
""")


def _serve_blocked(tmp_path, cell):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path), cell],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("served")


def test_serves_with_jax_and_arec_blocked(tmp_path):
    _serve_blocked(tmp_path, "lstm")


def test_serves_gru_with_jax_and_arec_blocked(tmp_path):
    """The GRU kernel path (its plain versions on the CPU) also stands
    alone."""
    _serve_blocked(tmp_path, "gru")


def test_recommender_without_device_refuses_cpu_fallback(monkeypatch):
    from arec_torch import resolve_device
    from arec_torch.serve import Recommender

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Recommender(None, None)
    assert resolve_device("cpu") == torch.device("cpu")


_CHILD_MF = textwrap.dedent("""
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "arec"):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import torch
    from arec_torch import bridge
    from arec_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from arec_torch.data.dataset import mf_batches
    from arec_torch.data.io import load_or_prepare
    from arec_torch.models.mf import MFSpec, init_mf
    from arec_torch.serve import Recommender
    from arec_torch.tables.engine import attrs_to_device
    from arec_torch.train import sparse
    from arec_torch.train.step import make_optimizer, step_generator

    torch.set_num_threads(1)
    cfg = Config(
        data=DataConfig(data_dir=sys.argv[1], syn_users=60, syn_items=50,
                        syn_interactions=600),
        model=ModelConfig(model="mf", dim=8, dense_vocab_threshold=12),
        train=TrainConfig(compute_dtype="float32", num_sampled=16,
                          sparse_update=True))
    ds = load_or_prepare(cfg.data)
    spec = MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    devs = [attrs_to_device(a.restrict(e.schema), e)
            for a, e in ((ds.user_attrs, spec.user), (ds.item_attrs, spec.item))]
    opt = make_optimizer("adagrad", 0.3)
    paths = sparse.table_paths(False, spec)
    state = sparse.init_sparse_state(
        init_mf(torch.Generator().manual_seed(0), spec), paths, opt, "adagrad")
    step = sparse.make_sparse_train_step(False, spec, *devs, opt, 0.3,
                                         "adagrad")
    batch = next(mf_batches(ds, 32, 0, 0))
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                    step_generator(0, 0))
    assert torch.isfinite(m["loss"])
    ids = Recommender(cfg, bridge.to_numpy(state.params), serve_batch=4,
                      device="cpu").for_users([1, 2], seen=[[3], []])
    assert ids.shape == (2, 30) and 3 not in ids[0].tolist()
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "arec")
                   for m in sys.modules)
    print("served", ids[0][:3].tolist())
""")


def test_mf_trains_and_serves_with_jax_and_arec_blocked(tmp_path):
    """The MF slice (a sparse step through the row-scatter wrapper, then
    for_users from the packed tree) also stands alone."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _CHILD_MF, str(tmp_path)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("served")


_CHILD_CLI = textwrap.dedent("""
    import io
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "arec"):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import torch
    from arec_torch import serve
    from arec_torch.cli.main import main

    torch.set_num_threads(1)
    tmp, model = sys.argv[1], sys.argv[2]
    k = sys.argv[3] if len(sys.argv) > 3 else "1"
    argv = ["--set", f"model.model={model}", "--set", "model.dim=8",
            "--set", f"train.steps_per_dispatch={k}",
            "--set", "model.max_seq_len=6", "--set", f"data.data_dir={tmp}/d",
            "--set", "data.syn_users=60", "--set", "data.syn_items=50",
            "--set", "data.syn_interactions=600",
            "--set", "train.batch_size=16", "--set", "train.num_sampled=16",
            "--set", "train.max_steps=6", "--set", "train.steps_per_checkpoint=3",
            "--set", f"train.sparse_update={str(model == 'mf').lower()}",
            "--set", "train.async_ckpt=true",
            "--set", "train.compute_dtype=float32",
            "--set", f"train.train_dir={tmp}/t"]
    assert main(argv, device="cpu") == 0
    out = io.StringIO()
    line = "1" if model == "mf" else "1,2,3"
    assert serve.main(argv, io.StringIO(line + "\\n!step\\n"), out,
                      device="cpu") == 0
    lines = out.getvalue().strip().split("\\n")
    assert lines[0].startswith("!ok serving") and lines[2] == "!ok step 6"
    assert lines[1].startswith(line + "\\t"), lines
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "arec")
                   for m in sys.modules)
    print("served", lines[1])
""")


@pytest.mark.parametrize("model", ["mf", "lstm"])
def test_cli_trains_then_serves_from_checkpoint_with_jax_and_arec_blocked(
        tmp_path, model):
    """The entry points (`cli.main.main` training through the Trainer, its
    checkpoint, then `serve.main` restoring it) stand alone."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _CHILD_CLI, str(tmp_path),
                           model], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("served")


@pytest.mark.parametrize("model", ["mf", "lstm"])
def test_cli_trains_k_steps_per_dispatch_with_jax_and_arec_blocked(
        tmp_path, model):
    """The same at steps_per_dispatch 3: the Trainer's multi-step
    (`train/graph.py`, K steps of the core on the CPU) stands alone."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _CHILD_CLI, str(tmp_path),
                           model, "3"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("served")


_CHILD_RAW = textwrap.dedent("""
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "arec"):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import torch
    from arec_torch.cli.main import main

    torch.set_num_threads(1)
    tmp, raw = sys.argv[1], sys.argv[2]
    argv = ["--set", "data.dataset=ml1m", "--set", f"data.raw_dir={raw}",
            "--set", f"data.data_dir={tmp}/d", "--set", "model.model=lstm",
            "--set", "model.dim=8", "--set", "model.max_seq_len=6",
            "--set", "train.batch_size=8", "--set", "train.num_sampled=8",
            "--set", "train.max_steps=4", "--set", "train.steps_per_checkpoint=2",
            "--set", "train.eval_recall_target=0.95",
            "--set", "train.compute_dtype=float32",
            "--set", f"train.train_dir={tmp}/t"]
    assert main(argv, device="cpu") == 0
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "arec")
                   for m in sys.modules)
    print("trained")
""")


def _ml1m_raw(d):
    """A tiny GroupLens `::` dump: users.dat, movies.dat, ratings.dat."""
    d.mkdir()
    rng = np.random.default_rng(0)
    (d / "users.dat").write_text("\n".join(
        f"{u}::{'MF'[u % 2]}::{[1, 18, 25, 35][u % 4]}::{u % 21}::{u:05d}"
        for u in range(1, 31)))
    (d / "movies.dat").write_text("\n".join(
        f"{m}::Movie {m} ({1970 + m})::{['Drama', 'Comedy|Action'][m % 2]}"
        for m in range(1, 41)))
    (d / "ratings.dat").write_text("\n".join(
        f"{u}::{m}::{rng.integers(1, 6)}::{978300000 + 100 * u + n}"
        for u in range(1, 31)
        for n, m in enumerate(rng.choice(np.arange(1, 41), 8,
                                         replace=False))))
    return str(d)


def test_cli_preps_raw_ml1m_and_trains_with_jax_and_arec_blocked(tmp_path):
    """Raw ML-1M prep, the C++ packer and the approximate eval top-k stand
    alone too."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    raw = _ml1m_raw(tmp_path / "ml-1m")
    proc = subprocess.run([sys.executable, "-c", _CHILD_RAW, str(tmp_path),
                           raw], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "trained"
    assert os.listdir(tmp_path / "d")[0].startswith("ml1m-")


_CHILD_MESH = textwrap.dedent("""
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "arec"):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import torch
    from arec_torch import bridge
    from arec_torch.config import (
        Config, DataConfig, MeshConfig, ModelConfig, TrainConfig,
    )
    from arec_torch.data.io import load_or_prepare
    from arec_torch.models.mf import MFSpec, init_mf
    from torch_mesh_worker import run_ranks

    torch.set_num_threads(1)
    cfg = Config(
        data=DataConfig(data_dir=sys.argv[1], syn_users=60, syn_items=50,
                        syn_interactions=600),
        model=ModelConfig(model="mf", dim=8, dense_vocab_threshold=12),
        mesh=MeshConfig(data=1, model=2))
    ds = load_or_prepare(cfg.data)
    spec = MFSpec.from_config(cfg, ds.user_schema, ds.item_schema)
    params = bridge.to_numpy(init_mf(torch.Generator().manual_seed(0), spec))
    res = run_ranks("recommend", 2, sys.argv[1], {"cases": [{
        "config": cfg.to_json(), "params": params, "family": "mf",
        "users": np.array([1, 2, 3, 4], np.int32), "seen": [[3], [], [], []],
        "serve_batch": 4, "out_dir": sys.argv[1]}]})
    ids = [r[0]["ids"] for r in res]
    assert ids[0].shape == (4, 30) and 3 not in ids[0][0].tolist()
    assert (ids[0] == ids[1]).all()
    assert all(r[0]["clean"] for r in res)
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "arec")
                   for m in sys.modules)
    print("served", ids[0][0][:3].tolist())
""")


def test_serves_on_a_gloo_mesh_with_jax_and_arec_blocked(tmp_path):
    """syn MF on a 1 x 2 mesh: two spawned gloo ranks serve the same lists,
    with jax and arec blocked in the parent, and neither imported by the
    ranks."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests")]))
    proc = subprocess.run([sys.executable, "-c", _CHILD_MESH, str(tmp_path)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("served")


_CHILD_MESH_TRAIN = textwrap.dedent("""
    import sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "arec"):
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import torch
    from arec_torch.config import (
        Config, DataConfig, MeshConfig, ModelConfig, TrainConfig,
    )
    from arec_torch.data.io import load_or_prepare
    from torch_mesh_worker import run_ranks

    torch.set_num_threads(1)
    cfg = Config(
        data=DataConfig(data_dir=sys.argv[1], syn_users=60, syn_items=50,
                        syn_interactions=600),
        model=ModelConfig(model="mf", dim=8, dense_vocab_threshold=12),
        train=TrainConfig(sparse_update=True, max_steps=2, batch_size=32,
                          train_dir=sys.argv[1] + "/t"),
        mesh=MeshConfig(data=1, model=2))
    load_or_prepare(cfg.data)
    res = run_ranks("train", 2, sys.argv[1], {"cases": [{
        "config": cfg.to_json(), "train_dir": cfg.train.train_dir}]})
    assert [r[0]["summary"]["steps"] for r in res] == [2, 2]
    assert all(r[0]["clean"] for r in res)
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "arec")
                   for m in sys.modules)
    print("trained", res[0][0]["summary"]["steps"])
""")


def test_trains_on_a_gloo_mesh_with_jax_and_arec_blocked(tmp_path):
    """syn MF's sparse mesh step (train/sparse_mesh.py) on a 1 x 2 mesh:
    two spawned gloo ranks train 2 steps through the Trainer, with jax
    and arec blocked in the parent, and neither imported by the ranks."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests")]))
    proc = subprocess.run([sys.executable, "-c", _CHILD_MESH_TRAIN,
                           str(tmp_path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("trained 2")
