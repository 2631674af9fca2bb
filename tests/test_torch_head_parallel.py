"""Head parallelism of the port in one process (parallel/mesh.py's
shardings, models/gdkvm.py's HeadParallel, the serving engine over a
D × M mesh, checkpoints across layouts) against the JAX package's
``param_shardings`` and ``model.apply`` over a ``model`` mesh axis, and
against the port's whole model.  The process-group side is
tests/test_torch_head_parallel_dist.py."""

import jax
import numpy as np
import pytest
import torch

from gdkvm_tpu_torch.config import schema
from gdkvm_tpu_torch.eval.streaming import stream_video
from gdkvm_tpu_torch.io.checkpoint import CheckpointManager
from gdkvm_tpu_torch.io.convert import state_dict_from_flax
from gdkvm_tpu_torch.models.gdkvm import GDKVM, HeadParallel, init_params
from gdkvm_tpu_torch.parallel.mesh import (Mesh, gather_state_dicts, make_mesh,
                                           param_shardings, shard_state_dict)
from gdkvm_tpu_torch.serve import BatchingEngine
from gdkvm_tpu_torch.train.loop import state_for, train_step

from torch_port_util import NARROW, model_pair

torch.set_num_threads(1)
IMAGE = 32
CPU = torch.device("cpu")


def _jax_sharded_names(cfg_kw: dict, m_axis: int) -> dict:
    """{port name: port dim} of the entries JAX's param_shardings leaves
    unreplicated on a data 1 × model ``m_axis`` mesh (shapes only)."""
    import jax.numpy as jnp
    from gdkvm_tpu.config.schema import ModelConfig as JModelConfig
    from gdkvm_tpu.models.gdkvm import GDKVM as JGDKVM
    from gdkvm_tpu.parallel import make_mesh as jmake_mesh
    from gdkvm_tpu.parallel import param_shardings as jshardings
    jmodel = JGDKVM(cfg=JModelConfig(**cfg_kw))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, IMAGE, IMAGE, 1)), None,
                            jnp.zeros((1, IMAGE, IMAGE), jnp.int32))
    mesh = jmake_mesh(data=1, model=m_axis, devices=jax.devices()[:m_axis])
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(jshardings(mesh, shapes))[0]:
        if s.is_fully_replicated:
            continue
        keys = [p.key for p in path if hasattr(p, "key")][1:]      # drop "params"
        assert keys[-1] == "kernel" and len(s.spec) == 2, keys
        # flax's (in, out) kernel is the port's (out, in) weight.
        out[".".join(keys[:-1] + ["weight"])] = 1 - list(s.spec).index("model")
    return out


SHARD_CASES = [
    ("ts8", dict(num_heads=4, head_dim_k=64, head_dim_v=64), 2),
    ("ts8", dict(num_heads=4, head_dim_k=64, head_dim_v=64), 4),
    ("ts8-m3", dict(num_heads=4, head_dim_k=64, head_dim_v=64), 3),
    ("tiny", dict(num_heads=2, head_dim_k=8, head_dim_v=8), 2),
    ("tiny-m4", dict(num_heads=2, head_dim_k=8, head_dim_v=8), 4),
    ("base-h6", dict(num_heads=6, head_dim_k=64, head_dim_v=64), 4),
]


@pytest.mark.parametrize("name,heads,m_axis", SHARD_CASES,
                         ids=[f"{c[0]}-x{c[2]}" for c in SHARD_CASES])
def test_head_param_shardings_match_jax(name, heads, m_axis):
    """The port's param_shardings names exactly the entries (and, on the
    port's (out, in) layout, the dims) that JAX's leaves unreplicated: the
    six head-major projections where the model axis divides their
    features, nothing where it does not (M=3 at H·d = 256), and heads cut
    in half where it divides the features but not H (M=4 at H=2 or H=6).
    Shard then gather is the identity."""
    kw = dict(NARROW, **heads)
    whole = init_params(GDKVM(schema.ModelConfig(**kw), device="cpu"),
                        torch.Generator().manual_seed(0)).state_dict()
    dims = {k: d for k, d in param_shardings(m_axis, whole).items() if d is not None}
    assert dims == _jax_sharded_names(kw, m_axis)
    assert (len(dims) == 6) == (heads["head_dim_k"] * heads["num_heads"] % m_axis == 0)
    shards = [shard_state_dict(whole, m_axis, m) for m in range(m_axis)]
    for name_, d in dims.items():
        assert shards[0][name_].shape[d] * m_axis == whole[name_].shape[d]
    back = gather_state_dicts(shards) if dims else shards[0]
    assert back.keys() == whole.keys()
    assert all(torch.equal(back[k], v) for k, v in whole.items())


def test_head_shard_refuses_an_axis_that_splits_a_head():
    """A model position runs whole heads: a model axis that does not
    divide H raises (the JAX package would shard features mid-head)."""
    cfg = schema.ModelConfig(**NARROW)
    for heads in ((3, 0), (2, 2)):
        with pytest.raises(ValueError, match="must divide num_heads=2"):
            GDKVM(cfg, device="meta", heads=heads)
    with pytest.raises(RuntimeError, match="sums over its model group"):
        GDKVM(cfg, device="cpu", heads=(2, 0))(torch.zeros(1, 1, IMAGE, IMAGE, 1))


@pytest.mark.parametrize("variant", ["gdn", "gdn2"])
def test_head_sharded_forward_matches_jax_and_whole(variant):
    """Two head shards on [cpu] * 2 (HeadParallel, the serving code), with a
    prompted first frame and a carried state (each shard as the converter
    cuts it from JAX's param tree): the logits equal JAX's
    model.apply on make_mesh(data=1, model=2) within its own bound (rtol /
    atol 2e-4, tests/test_sharding.py) and the port's whole model within
    rtol 1e-5 / atol 1e-5; the shards' states put together are the whole
    model's."""
    from gdkvm_tpu.parallel import make_mesh as jmake_mesh
    from gdkvm_tpu.parallel import param_shardings as jshardings
    jmodel, params, model = model_pair(IMAGE, gdr_variant=variant)
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 255, (2, 3, IMAGE, IMAGE, 1), np.uint8).astype(np.float32) / 255
    prompt = rng.integers(0, NARROW["num_classes"], (2, IMAGE, IMAGE)).astype(np.int32)
    mesh = jmake_mesh(data=1, model=2, devices=jax.devices()[:2])
    with mesh:
        jlogits, jstate = jax.jit(jmodel.apply)(
            jax.device_put(params, jshardings(mesh, params)), frames, None, prompt)
    heads = HeadParallel(model, [CPU, CPU])
    with torch.no_grad():
        x, p = torch.from_numpy(frames), torch.from_numpy(prompt)
        whole, wstate = model(x, None, p)
        got, state = heads(x, None, p)
        again, _ = heads(x, state)
        want_again, _ = model(x, wstate)
    assert [m.shape[1] for m in state.mem] == [1, 1]
    # Each shard is what the converter cuts out of JAX's param tree.
    cfg = model.cfg
    for m, lkva in enumerate(heads.lkvas):
        part = state_dict_from_flax(jax.tree.map(np.asarray, params), cfg, heads=(2, m))
        GDKVM(cfg, device="cpu", heads=(2, m)).load_state_dict(part)
        assert all(torch.equal(part["lkva." + k], v) for k, v in lkva.state_dict().items())
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(torch.cat(state.mem, 1).numpy(), np.asarray(jstate.mem),
                               rtol=2e-4, atol=2e-4)
    for a, b in ((got, whole), (again, want_again), (torch.cat(state.mem, 1), wstate.mem)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(state.frames_seen, wstate.frames_seen)


def test_head_checkpoint_restores_into_each_shard(tmp_path):
    """A checkpoint holds whole tensors: written by one process after a
    step, it restores into each head shard of a 1x2 layout (its model,
    AdamW moments and EMA sliced), and the shards put together are the
    whole state again."""
    cfg = schema.load_config(None, ["model.num_heads=2", "model.head_dim_k=8",
                                    "model.head_dim_v=8", "model.enc_channels=[4,8,12,16]",
                                    "model.enc_blocks=[1,1,1,1]", "model.kpff_channels=[12,8,4]",
                                    "model.compute_dtype=float32", "train.ema_decay=0.9",
                                    "train.batch_size=2", "data.clip_len=2"])
    model = init_params(GDKVM(cfg.model, device="cpu"), torch.Generator().manual_seed(0))
    state = state_for(cfg, model)
    rng = np.random.default_rng(0)
    from gdkvm_tpu_torch.data.pipeline import Batch
    batch = Batch(torch.from_numpy(rng.integers(0, 255, (2, 2, 32, 32, 1), np.uint8)),
                  torch.from_numpy(rng.integers(0, 2, (2, 2, 32, 32)).astype(np.uint8)),
                  torch.ones(2, 2))
    cfg.train.warmup_iterations = 1
    for _ in range(2):
        train_step(state, batch, cfg)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(state.step, state)
    ckpt.wait()
    parts = []
    for m in range(2):
        mesh = Mesh(data=1, devices=(CPU,), model=2, model_index=m)
        shard = state_for(cfg, GDKVM(cfg.model, device="cpu", heads=(2, m)), mesh)
        ckpt.restore(shard)
        parts.append(shard)
    assert parts[0].step == state.step and torch.equal(parts[1].gen.get_state(),
                                                       state.gen.get_state())
    back = gather_state_dicts([p.model.state_dict() for p in parts])
    assert all(torch.equal(back[k], v) for k, v in state.model.state_dict().items())
    names = [n for n, _ in model.named_parameters()]
    for key in ("exp_avg", "exp_avg_sq"):
        got = gather_state_dicts([dict(zip(names, p.opt.state_dict()[key])) for p in parts])
        want = dict(zip(names, state.opt.state_dict()[key]))
        assert all(torch.equal(got[k], v) for k, v in want.items()), key
    got = gather_state_dicts([dict(zip(names, p.ema)) for p in parts])
    assert all(torch.equal(got[n], e) for n, e in zip(names, state.ema))


def _video(seed, t=6):
    return np.random.default_rng(seed).integers(0, 255, (t, IMAGE, IMAGE, 1), np.uint8)


def test_head_parallel_engine_2x2_matches_one_device_and_jax():
    """BatchingEngine over a data 2 × model 2 mesh of [cpu] * 4 (two slot
    groups, the heads of each over two places) serves each session as the
    port's one-device engine on ≥ 99.9% of the pixels, and as the JAX
    package's engine on its 2x2 mesh on ≥ 99% (tests/test_serve.py's bar
    for it against one device); /healthz-facing mesh shape and per-place
    state as laid out."""
    from gdkvm_tpu.parallel import make_mesh as jmake_mesh
    from gdkvm_tpu.serve import BatchingEngine as JBatchingEngine
    jmodel, params, model = model_pair(IMAGE)
    videos = [_video(60 + i) for i in range(2)]
    kw = dict(streams=2, chunk=2, image_size=IMAGE)
    mesh = make_mesh(data=2, model=2, devices=[CPU] * 4)
    got = {}
    for name, eng in (("mesh", lambda: BatchingEngine(model=model, mesh=mesh, **kw)),
                      ("one", lambda: BatchingEngine(model=model, **kw)),
                      ("jax", lambda: JBatchingEngine(
                          model=jmodel, params=params,
                          mesh=jmake_mesh(data=2, model=2, devices=jax.devices()[:4]), **kw))):
        e = eng()
        try:
            if name == "mesh":
                assert e._mesh.shape == {"data": 2, "model": 2}
                assert [g.lo for g in e._groups] == [0, 1]
                assert [tuple(m.shape) for m in e._groups[1].mem] == [(1, 1, 16, 16)] * 2
            sids = [e.open_session()["session"] for _ in videos]
            got[name] = [e.infer(s, v) for s, v in zip(sids, videos)]
        finally:
            e.close()
    for i, video in enumerate(videos):
        assert got["mesh"][i].shape == (len(video), IMAGE, IMAGE)
        assert (got["mesh"][i] == got["one"][i]).mean() >= 0.999
        assert (got["mesh"][i] == got["jax"][i]).mean() >= 0.99
        assert (got["one"][i] == stream_video(model, video, chunk=2)).all()
