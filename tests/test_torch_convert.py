"""The weight converter (gdkvm_tpu_torch.io.convert), the port's import
isolation from JAX, and the kernel build's laziness, on the CPU."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gdkvm_tpu_torch
from gdkvm_tpu.config import schema as jschema
from gdkvm_tpu.models.gdkvm import GDKVM as JGDKVM
from gdkvm_tpu_torch.config.schema import ModelConfig
from gdkvm_tpu_torch.io.convert import state_dict_from_flax
from gdkvm_tpu_torch.models.gdkvm import GDKVM
from gdkvm_tpu_torch.ops import _build, gdr_cuda

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = Path(gdkvm_tpu_torch.__file__).parent

TS8 = dict(num_classes=2, in_channels=1, enc_channels=(64, 64, 128, 192),
           enc_blocks=(1, 1, 2, 2), num_heads=4, head_dim_k=64, head_dim_v=64,
           kpff_channels=(128, 96))
NARROW = dict(enc_channels=(8, 8, 16, 16), enc_blocks=(1, 1, 1, 1),
              num_heads=1, head_dim_k=8, head_dim_v=8, kpff_channels=(8, 8))


def _flax_params(kw: dict) -> dict:
    """The JAX model's param tree as nested dicts of numpy arrays, shaped by
    jax.eval_shape (no compute), filled with seeded random values."""
    model = JGDKVM(cfg=jschema.ModelConfig(**kw))
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 2, 32, 32, model.cfg.in_channels)), None,
        jnp.zeros((1, 32, 32), jnp.int32))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _tree_items(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _tree_items(v, path)
        else:
            yield path, v


@pytest.mark.parametrize("kw", [TS8, {}], ids=["ts8", "flagship"])
def test_shapes_round_trip(kw):
    """Every leaf of the ts8 and the default (flagship) param tree fills one
    parameter of the port's model, which loads it strictly."""
    params = _flax_params(kw)
    cfg = ModelConfig(**kw)
    sd = state_dict_from_flax(params, cfg)
    n_leaves = sum(1 for _ in _tree_items(params["params"]))
    assert len(sd) == n_leaves
    GDKVM(cfg, device="cpu").load_state_dict(sd, strict=True)
    n_flax = sum(v.size for _, v in _tree_items(params["params"]))
    assert sum(t.numel() for t in sd.values()) == n_flax


def test_layouts():
    """Conv HWIO → OIHW, Dense (in, out) → (out, in), bare KPFF kernels
    squeezed to (in, out), norms copied."""
    params = _flax_params(NARROW)
    p = params["params"]
    sd = state_dict_from_flax(params, ModelConfig(**NARROW))
    conv = p["encoder"]["Conv_1"]["kernel"]                  # (3, 3, I, O)
    np.testing.assert_array_equal(sd["encoder.Conv_1.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    dw = p["decoder"]["kpff8"]["local_dw"]["kernel"]          # (3, 3, 1, C)
    assert sd["decoder.kpff8.local_dw.weight"].shape == (dw.shape[3], 1, 3, 3)
    dense = p["lkva"]["q_proj"]["kernel"]
    np.testing.assert_array_equal(sd["lkva.q_proj.weight"].numpy(), dense.T)
    bare = p["decoder"]["kpff16"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(sd["decoder.kpff16.Conv_0.kernel"].numpy(),
                                  bare[0, 0])
    np.testing.assert_array_equal(sd["lkva.o_norm.scale"].numpy(),
                                  p["lkva"]["o_norm"]["scale"])
    np.testing.assert_array_equal(sd["decoder.head.bias"].numpy(),
                                  p["decoder"]["head"]["bias"])


def test_missing_leaf_raises():
    params = _flax_params(NARROW)
    del params["params"]["lkva"]["beta_proj"]["bias"]
    with pytest.raises(ValueError, match=r"lkva\.beta_proj\.bias"):
        state_dict_from_flax(params, ModelConfig(**NARROW))


def test_extra_leaf_raises():
    params = _flax_params(NARROW)
    params["params"]["lkva"]["eta_proj"] = {"kernel": np.zeros((16, 1), np.float32)}
    with pytest.raises(ValueError, match="lkva/eta_proj/kernel"):
        state_dict_from_flax(params, ModelConfig(**NARROW))


def test_shape_mismatch_raises():
    params = _flax_params(NARROW)
    with pytest.raises(ValueError, match="shapes that differ"):
        state_dict_from_flax(params, ModelConfig(**{**NARROW, "num_classes": 3}))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="gdkvm_tpu_torch."))


_GUARD = r"""
import importlib, sys
BLOCKED = {"jax", "flax", "optax", "orbax", "yaml", "gdkvm_tpu"}
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
for mod in sys.argv[1:]:
    importlib.import_module(mod)
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print("imported", len(sys.argv) - 1)
"""


def test_port_imports_without_jax():
    """Every port module imports in a process that refuses jax, flax,
    optax, orbax, yaml and gdkvm_tpu (the exact top-level name)."""
    mods = _port_modules()
    assert "gdkvm_tpu_torch.models.gdkvm" in mods and len(mods) >= 30
    for name in ("train.loop", "eval.evaluator", "eval.streaming", "eval.parity",
                 "eval.vis", "data.device_cache", "data.camus", "data.camus_raw",
                 "data.echonet", "data.packed", "io.checkpoint", "io.metrics_log",
                 "utils.profiling", "utils.optional", "cli", "__main__",
                 "config.yaml_subset", "eval.infer", "eval.modulebench",
                 "utils.scaling", "ops.gdr_counts", "io.export", "parallel.distributed",
                 "parallel.mesh", "ops.quant", "eval.regression"):
        assert f"gdkvm_tpu_torch.{name}" in mods, name
    res = subprocess.run([sys.executable, "-c", _GUARD, *mods], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(mods)}" in res.stdout


def test_no_jax_imports_in_sources():
    """Static scan: no import of jax, flax, optax, orbax, yaml or gdkvm_tpu
    in the port, in chip_smoke.py or in kernel_turns.py."""
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "kernel_turns.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            bad += [f"{f.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "flax", "optax", "orbax", "yaml",
                                           "gdkvm_tpu")]
    assert not bad, bad


def test_build_is_lazy(monkeypatch):
    """Importing ops/_build.py and running the CPU path compiles nothing:
    nvcc runs only when a CUDA tensor reaches the kernel."""
    def refuse(*a, **k):
        raise AssertionError("nvcc must not run on this path")
    monkeypatch.setattr(_build.subprocess, "run", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.random(s, dtype=np.float32)) for s in
            [(1, 1, 2, 3, 4)] * 3 + [(1, 1, 2, 3), (1, 1, 2), (1, 1, 4, 4)]]
    gdr_cuda.gdr_fwd(*args)
    with pytest.raises(ValueError):
        gdr_cuda.gdr_fwd_cuda(*args)
    path = _build.library_path("gdr_fwd")
    assert path.parent == PKG / "_build" and path.name.startswith("libgdr_fwd-")


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """chip_smoke.py exits nonzero and prints no result line without a CUDA
    device, and also in a directory holding nothing else of the repo."""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_kernel_turns_refuses_to_run_without_cuda(tmp_path):
    """kernel_turns.py exits nonzero without a CUDA device, before it
    starts a turn, and with no tree to compare with."""
    for argv in ([str(tmp_path)], []):
        res = subprocess.run([sys.executable, "kernel_turns.py", *argv], cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert "other/this" not in res.stdout
