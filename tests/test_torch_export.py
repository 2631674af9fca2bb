"""The port's serving artifact (gdkvm_tpu_torch.io.export) and the GDR
forward's custom op (``torch.ops.gdkvm_tpu_torch.gdr_fwd``), on the CPU.

The tests of tests/test_export.py on a torch.export program: the artifact
reproduces the port's eager model exactly and carries the state across
chunks, and it matches the JAX package's ``GDKVM.apply`` on converted
weights.  A tiny model (32², fp32) is exported once per module.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from gdkvm_tpu.models.gdkvm import StreamState as JStreamState
from gdkvm_tpu_torch.core import gdr
from gdkvm_tpu_torch.eval.streaming import stream_video
from gdkvm_tpu_torch.io.export import (FORMAT, StreamingStep, load_artifact,
                                       save_artifact)
from gdkvm_tpu_torch.models import decoder
from gdkvm_tpu_torch.ops import gdr_cuda
from gdkvm_tpu_torch.serve import BatchingEngine
from torch_port_util import model_pair

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_export.py's _tiny_model, on the weights of torch_port_util.
TINY = dict(num_classes=3, enc_channels=(8, 16, 24, 32), enc_blocks=(1, 1, 1, 1),
            num_heads=2, head_dim_k=16, head_dim_v=16, kpff_channels=(24, 16, 8),
            compute_dtype="float32")
IMAGE, CHUNK, BATCH = 32, 3, 2
OP_NODE = "gdkvm_tpu_torch.gdr_fwd.default"


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(JAX model, its params, the port's model, the artifact's dir, its
    meta): one export at batch 2, chunk 3."""
    jmodel, params, model = model_pair(IMAGE, **TINY)
    art = str(tmp_path_factory.mktemp("art") / "art")
    meta = save_artifact(art, model, image_size=IMAGE, chunk=CHUNK, batch=BATCH)
    return jmodel, params, model, art, meta


def _frames(seed, t=CHUNK, b=BATCH):
    return np.random.default_rng(seed).integers(0, 255, (b, t, IMAGE, IMAGE, 1), np.uint8)


def _eager(model, frames, state=None):
    with torch.no_grad():
        logits, st = model(torch.from_numpy(frames).to(torch.float32) / 255.0, state)
    return logits, st


def _graph_ops(program) -> list:
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


def test_artifact_equals_the_eager_model(exported):
    """One chunk through the loaded artifact: logits, mem and frames_seen
    equal the port's eager model's (max|Δ| 0 on the CPU; bar 1e-6), and
    the program calls the GDR as one node of the custom op."""
    _, _, model, art, _ = exported
    sm = load_artifact(art)
    assert sm.batch == BATCH and sm.chunk == CHUNK and sm.device == torch.device("cpu")
    assert _graph_ops(sm.program).count(OP_NODE) == 1
    assert not any("linalg_solve_triangular" in op for op in _graph_ops(sm.program))
    frames = _frames(0)
    mem, seen = sm.init_state()
    gdr.CHUNKED_CALLS.reset()
    logits, mem1, seen1 = sm.step(torch.from_numpy(frames), mem, seen)
    assert gdr.CHUNKED_CALLS.n == 1          # the op's CPU implementation
    ref, st = _eager(model, frames)
    assert logits.shape == (BATCH, CHUNK, IMAGE, IMAGE, 3) and logits.dtype == torch.float32
    assert (logits - ref).abs().max().item() <= 1e-6
    assert (mem1 - st.mem).abs().max().item() <= 1e-6
    assert seen1.dtype == torch.int32 and seen1.tolist() == [CHUNK] * BATCH


def test_artifact_state_carry(exported):
    """Two carried chunks of the artifact ≡ one 6-frame eager call."""
    _, _, model, art, _ = exported
    sm = load_artifact(art)
    frames = _frames(1, t=2 * CHUNK)
    mem, seen = sm.init_state()
    lo_a, mem, seen = sm.step(torch.from_numpy(frames[:, :CHUNK]), mem, seen)
    lo_b, mem, seen = sm.step(torch.from_numpy(frames[:, CHUNK:]), mem, seen)
    ref, st = _eager(model, frames)
    torch.testing.assert_close(torch.cat([lo_a, lo_b], 1), ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(mem, st.mem, rtol=1e-5, atol=1e-5)
    assert seen.tolist() == [2 * CHUNK] * BATCH


def test_artifact_matches_jax_apply(exported):
    """Two carried chunks of the artifact against the JAX package's
    GDKVM.apply, chunk by chunk with its state carried, on the same
    weights (converted by io/convert.py): logits and mem within 1e-5 of
    their largest |entry|.  (Element by element, rtol 1e-5 with atol 1e-5
    misses two of the 18432 logits of the first chunk, by 1.08e-5
    absolute at most: the two frameworks' fp32 sums differ so in the eager
    port too, which the artifact equals exactly.)"""
    jmodel, params, _, art, _ = exported
    sm = load_artifact(art)
    frames = _frames(2, t=2 * CHUNK)
    mem, seen = sm.init_state()
    jstate = JStreamState(mem=jnp.zeros(mem.shape), frames_seen=jnp.zeros(BATCH, jnp.int32))
    apply = jax.jit(jmodel.apply)
    for lo in (0, CHUNK):
        part = frames[:, lo:lo + CHUNK]
        logits, mem, seen = sm.step(torch.from_numpy(part), mem, seen)
        want, jstate = apply(params, jnp.asarray(part, jnp.float32) / 255.0, jstate)
        for got, ref in ((logits.numpy(), np.asarray(want)),
                         (mem.numpy(), np.asarray(jstate.mem))):
            assert got.shape == ref.shape
            assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert seen.tolist() == np.asarray(jstate.frames_seen).tolist()


def test_meta_keys_and_signature(exported):
    """meta.json has the JAX package's keys, this package's format, the
    one platform and the model's config; blob_bytes is model.pt2's size."""
    _, _, model, art, meta = exported
    on_disk = json.load(open(os.path.join(art, "meta.json")))
    assert on_disk == json.loads(json.dumps(meta))
    assert set(meta) == {"format", "signature", "num_classes", "platforms",
                         "model_config", "blob_bytes"}
    assert meta["format"] == FORMAT == "gdkvm-torch-export-v1"
    assert meta["signature"] == {
        "frames_u8": [BATCH, CHUNK, IMAGE, IMAGE, 1], "mem": [BATCH, 2, 16, 16],
        "frames_seen": [BATCH],
        "outputs": ["logits (B,T,H,W,K) f32", "mem f32", "frames_seen i32"]}
    assert meta["num_classes"] == 3 and meta["platforms"] == ["cpu"]
    assert meta["blob_bytes"] == os.path.getsize(os.path.join(art, "model.pt2"))
    assert on_disk["model_config"]["kpff_channels"] == [24, 16, 8]
    assert sorted(os.listdir(art)) == ["meta.json", "model.pt2"]


def test_infer_refuses_a_batched_artifact(exported, tmp_path):
    """File inference streams one video: a batch-2 artifact is refused
    before anything is written."""
    from gdkvm_tpu_torch.eval.infer import run_inference
    with pytest.raises(ValueError, match="batch-1 artifact, got 2"):
        run_inference(_frames(5, b=1)[0], str(tmp_path / "out"), artifact=exported[3])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("platforms", [("cpu", "cuda"), ("cuda",)])
def test_export_for_another_platform_raises(exported, platforms, tmp_path):
    """An artifact belongs to one device type: a list of two raises, and
    so does a platform the model is not on; nothing is written."""
    model = exported[2]
    with pytest.raises(ValueError, match="platforms="):
        save_artifact(str(tmp_path / "a"), model, image_size=IMAGE, chunk=CHUNK,
                      platforms=platforms)
    assert not os.listdir(tmp_path)
    with pytest.raises(ValueError, match="exported for cpu"):
        load_artifact(exported[3], "cuda")


def test_export_leaves_eager_calls_real():
    """An export that is the first call to reach the decoder's resize sizes
    leaves no fake tensor behind: eager calls after it return real tensors
    equal to those from before it, and the cache holds no fake tensor."""
    _, _, model = model_pair(IMAGE, **TINY)
    frames = _frames(3, b=1)
    decoder._resize_tensor.cache_clear()
    before, _ = _eager(model, frames)
    decoder._resize_tensor.cache_clear()
    args = (torch.from_numpy(frames), torch.zeros(1, 2, 16, 16),
            torch.zeros(1, dtype=torch.int32))
    with torch.no_grad():
        torch.export.export(StreamingStep(model), args)
    assert decoder._resize_tensor.cache_info().currsize == 0
    after, st = _eager(model, frames)
    assert type(after) is torch.Tensor and type(st.mem) is torch.Tensor
    assert torch.equal(after, before)
    assert decoder._resize_tensor.cache_info().currsize > 0


def test_two_scale_decoder_roundtrip(tmp_path):
    """The 2-scale decoder (stride-8 sub-pixel head) exports, and an engine
    serving the artifact gives stream_video's masks."""
    _, _, model = model_pair(IMAGE, **dict(TINY, kpff_channels=(24, 16)))
    art = str(tmp_path / "art")
    save_artifact(art, model, image_size=IMAGE, chunk=CHUNK, batch=1)
    video = _frames(4, t=6, b=1)[0]
    eng = BatchingEngine(artifact=art, streams=1, chunk=CHUNK)
    try:
        assert eng.image_size == IMAGE and eng.num_classes == 3
        sid = eng.open_session()["session"]
        got = eng.infer(sid, video)
    finally:
        eng.close()
    np.testing.assert_array_equal(got, stream_video(model, video, chunk=CHUNK))


# ------------------------------------------------------------ the custom op


def _op_inputs(seed, dtype=torch.float32, decoupled=False):
    """Seeded GDR operands (B=1, H=2, T=3, N=5, d_k=8, d_v=6)."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    unit = lambda x: x / x.norm(dim=-1, keepdim=True)
    q, k = unit(t(1, 2, 3, 5, 8)), unit(t(1, 2, 3, 5, 8))
    v = t(1, 2, 3, 5, 6)
    beta = torch.sigmoid(t(1, 2, 3, 5))
    alpha = torch.sigmoid(t(1, 2, 3) + 2.0)
    s0 = 0.1 * t(1, 2, 8, 6)
    eta = torch.sigmoid(t(1, 2, 3, 5)) if decoupled else None
    return (q.to(dtype), k.to(dtype), v.to(dtype), beta, alpha, s0, eta)


@pytest.mark.parametrize("decoupled", [False, True], ids=["coupled", "decoupled"])
def test_op_passes_opcheck_and_is_the_plain_scan_on_cpu(decoupled):
    """torch.library.opcheck (schema, fake implementation, dispatch) on CPU
    inputs; the CPU result is gdr_chunked's exactly, and the fake
    implementation's shapes and dtypes are the real one's, in fp32 and with
    bf16 q, k, v."""
    op = torch.ops.gdkvm_tpu_torch.gdr_fwd
    for dtype in (torch.float32, torch.bfloat16):
        args = _op_inputs(5, dtype, decoupled)
        torch.library.opcheck(op, args)
        o, s_t = op(*args)
        want = gdr.gdr_chunked(*args)
        assert torch.equal(o, want[0]) and torch.equal(s_t, want[1])
        with FakeTensorMode() as mode:
            fake = op(*(None if x is None else mode.from_tensor(x) for x in args))
        for f, real in zip(fake, (o, s_t)):
            assert isinstance(f, FakeTensor)
            assert (f.shape, f.dtype, f.stride()) == (real.shape, real.dtype, real.stride())
    assert o.dtype == s_t.dtype == torch.float32 and o.shape == (1, 2, 3, 5, 6)


def test_auto_route_calls_the_op_only_without_grad(monkeypatch):
    """gdr_impl="auto" on CPU tensors: the op without a gradient to take,
    the plain scan under autograd; the kernel route never runs the op's CPU
    implementation (its launchers raise on CPU tensors)."""
    calls = []
    real = gdr_cuda.gdr_fwd_op
    monkeypatch.setattr(gdr_cuda, "gdr_fwd_op", lambda *a: calls.append(1) or real(*a))
    args = [x for x in _op_inputs(6)[:6]]
    with torch.no_grad():
        gdr_cuda.gdr_fwd(*args)
    assert calls == [1]
    o, _ = gdr_cuda.gdr_fwd(args[0].requires_grad_(True), *args[1:])
    assert o.requires_grad and calls == [1]
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        gdr_cuda.gdr_kernel(*args)
    assert calls == [1]


_LOAD = """
import sys, torch
import gdkvm_tpu_torch.ops.gdr_cuda  # registers the op the program calls
ep = torch.export.load(sys.argv[1])
args = torch.load(sys.argv[2])
o, s_t = ep.module()(*args)
torch.save((o, s_t), sys.argv[3])
"""


class _OpModule(torch.nn.Module):
    def forward(self, q, k, v, beta, alpha, s0, eta):
        return torch.ops.gdkvm_tpu_torch.gdr_fwd(q, k, v, beta, alpha, s0, eta)


def test_exported_op_loads_in_a_fresh_process(tmp_path):
    """A program exported from a module that calls the op holds the op's
    node; torch.export.load in another process (which imports
    ops.gdr_cuda) runs it to the same result."""
    args = _op_inputs(7, decoupled=True)
    ep = torch.export.export(_OpModule(), args)
    assert _graph_ops(ep) == [OP_NODE, "<built-in function getitem>",
                              "<built-in function getitem>"]
    torch.export.save(ep, str(tmp_path / "op.pt2"))
    torch.save(args, str(tmp_path / "args.pt"))
    res = subprocess.run([sys.executable, "-c", _LOAD, str(tmp_path / "op.pt2"),
                          str(tmp_path / "args.pt"), str(tmp_path / "out.pt")],
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    got = torch.load(str(tmp_path / "out.pt"))
    want = gdr.gdr_chunked(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
