"""The port's GDR scan (gdkvm_tpu_torch.core.gdr, ops.gdr_cuda) against the
JAX package's, on the CPU.

Inputs are made with numpy from a seed and go to both frameworks.  The CUDA
kernel itself is compared with its plain version on the card by
chip_smoke.py; here the dispatch around it is tested.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdkvm_tpu.core import gdr as jgdr
from gdkvm_tpu.ops import gdr_pallas
from gdkvm_tpu_torch.core import gdr
from gdkvm_tpu_torch.models.gdkvm import GDKVM
from gdkvm_tpu_torch.config.schema import ModelConfig
from gdkvm_tpu_torch.ops import gdr_cuda

torch.set_num_threads(1)

# fp32 on both sides: the two differ only in summation order.
RTOL, ATOL = 1e-4, 1e-5


def _inputs(seed, B=1, H=2, T=3, N=7, dk=16, dv=16):
    """numpy (q, k, v, beta, alpha, s0) shaped as the model feeds the scan:
    unit-norm keys, gates in (0, 1), α near 1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, N, dk), dtype=np.float32)
    k = rng.standard_normal((B, H, T, N, dk), dtype=np.float32)
    k /= np.linalg.norm(k, axis=-1, keepdims=True) + 1e-6
    v = rng.standard_normal((B, H, T, N, dv), dtype=np.float32)
    beta = 1 / (1 + np.exp(-rng.standard_normal((B, H, T, N), dtype=np.float32)))
    alpha = 1 / (1 + np.exp(-rng.standard_normal((B, H, T), dtype=np.float32) - 2))
    s0 = 0.1 * rng.standard_normal((B, H, dk, dv), dtype=np.float32)
    return q, k, v, beta.astype(np.float32), alpha.astype(np.float32), s0


def _t(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _j(args):
    return [jnp.asarray(a) for a in args]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


PLAIN = {"ref": gdr.gdr_ref, "chunked": gdr.gdr_chunked}
JAX = {"ref": jgdr.gdr_ref_bh, "chunked": jgdr.gdr_chunked_bh}


@pytest.mark.parametrize("T,N,dk,dv", [
    (1, 8, 8, 8), (4, 7, 16, 16), (3, 49, 32, 32), (2, 16, 16, 32)])
@pytest.mark.parametrize("port,ref", [
    ("ref", "ref"), ("chunked", "chunked"), ("chunked", "ref")])
def test_plain_matches_jax(port, ref, T, N, dk, dv):
    args = _inputs(0, T=T, N=N, dk=dk, dv=dv)
    o, s = PLAIN[port](*_t(args))
    o_j, s_j = JAX[ref](*_j(args))
    assert o.dtype == s.dtype == torch.float32
    _close(o, o_j)
    _close(s, s_j)


def test_plain_matches_pallas_kernel():
    """Against the Pallas kernel itself (interpret mode on the CPU)."""
    args = _inputs(1, B=1, H=2, T=2, N=7, dk=8, dv=8)
    o_p, s_p = gdr_pallas.gdr_pallas_bh(*_j(args))
    o, s = gdr.gdr_chunked(*_t(args))
    _close(o, o_p)
    _close(s, s_p)


def test_bf16_inputs():
    """bf16 q, k, v with fp32 gates and state.  Against the fp32 reference
    the only loss is the inputs' rounding (the JAX package's bf16 tolerance,
    3e-2); against JAX on the same rounded inputs, summation order only."""
    q, k, v, beta, alpha, s0 = _inputs(2, T=3, N=8)
    to16 = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    o, s = gdr.gdr_chunked(to16(q), to16(k), to16(v), *_t((beta, alpha, s0)))
    o_ref, s_ref = jgdr.gdr_ref_bh(*_j((q, k, v, beta, alpha, s0)))
    _close(o, o_ref, 3e-2, 3e-2)
    _close(s, s_ref, 3e-2, 3e-2)
    j16 = lambda x: jnp.asarray(x).astype(jnp.bfloat16)
    o_j, s_j = jgdr.gdr_chunked_bh(j16(q), j16(k), j16(v), *_j((beta, alpha, s0)))
    _close(o, o_j)
    _close(s, s_j)


@pytest.mark.parametrize("impl", ["ref", "chunked"])
def test_state_carry(impl):
    """T=6 in one call equals 2 + 4 with the state carried."""
    q, k, v, beta, alpha, s0 = _t(_inputs(3, B=2, T=6))
    fn = PLAIN[impl]
    o_full, s_full = fn(q, k, v, beta, alpha, s0)
    sl = lambda x, lo, hi: x[:, :, lo:hi]
    o_a, s_a = fn(*(sl(x, 0, 2) for x in (q, k, v, beta, alpha)), s0)
    o_b, s_b = fn(*(sl(x, 2, 6) for x in (q, k, v, beta, alpha)), s_a)
    _close(torch.cat([o_a, o_b], 2), o_full, 1e-5, 1e-6)
    _close(s_b, s_full, 1e-5, 1e-6)


def test_chunked_beta_zero_is_pure_decay():
    """β = 0 writes nothing: S_T = (Π α_t) S_0 and o_t = q_t (Π_{≤t} α) S_0."""
    q, k, v, beta, alpha, s0 = _inputs(4, T=4)
    beta = np.zeros_like(beta)
    o, s = gdr.gdr_chunked(*_t((q, k, v, beta, alpha, s0)))
    decay = np.cumprod(alpha.astype(np.float64), axis=-1)        # (B,H,T)
    s_dec = decay[..., None, None] * s0[:, :, None].astype(np.float64)
    _close(s, s_dec[:, :, -1])
    _close(o, np.einsum("bhtnk,bhtkv->bhtnv", q.astype(np.float64), s_dec))


def test_chunked_alpha_one_is_delta_rule():
    """α = 1: each frame is the plain delta rule, token by token
    (S ← S + k(βv − β Sᵀk)ᵀ), computed here in float64 numpy."""
    q, k, v, beta, alpha, s0 = _inputs(5, B=1, H=1, T=3, N=6, dk=8, dv=4)
    alpha = np.ones_like(alpha)
    o, s_t = gdr.gdr_chunked(*_t((q, k, v, beta, alpha, s0)))
    s = s0[0, 0].astype(np.float64)
    for t in range(3):
        _close(o[0, 0, t], q[0, 0, t].astype(np.float64) @ s)
        for i in range(6):
            ki, vi, bi = k[0, 0, t, i], v[0, 0, t, i], beta[0, 0, t, i]
            s = s + np.outer(ki, bi * vi - bi * (s.T @ ki))
    _close(s_t[0, 0], s)


def test_write_chunk_matches_jax():
    q, k, v, beta, alpha, s0 = _inputs(6, B=2, H=2, T=1, N=9)
    k, v, beta = k[:, :, 0], v[:, :, 0], beta[:, :, 0]      # (B,H,N,·)
    s = gdr.gdr_write_chunk(*_t((s0, k, v, beta)))
    s_j = jgdr.gdr_write_chunk_bh(*_j((s0, k, v, beta)))
    _close(s, s_j)


def test_wy_transform_matches_jax():
    _, k, v, beta, _, _ = _inputs(7, B=1, H=1, T=1, N=33, dk=16, dv=8)
    u, w = gdr.wy_transform(*_t((k[0, 0, 0], v[0, 0, 0], beta[0, 0, 0])))
    u_j, w_j = jgdr._wy_transform(*_j((k[0, 0, 0], v[0, 0, 0], beta[0, 0, 0])))
    _close(u, u_j)
    _close(w, w_j)


def test_auto_on_cpu_runs_plain_version():
    """gdr_impl="auto" on CPU tensors runs gdr_chunked; the kernel is not
    launched (and not built)."""
    args = _t(_inputs(8))
    gdr_cuda.LAUNCHES.reset()
    gdr.CHUNKED_CALLS.reset()
    o, s = gdr_cuda.gdr_fwd(*args)
    o_c, s_c = gdr.gdr_chunked(*args)
    assert gdr_cuda.LAUNCHES.n == 0
    assert gdr.CHUNKED_CALLS.n == 2
    _close(o, o_c, 0, 0)
    _close(s, s_c, 0, 0)


def test_kernel_refuses_cpu_tensors():
    """The kernel entry point (and gdr_impl="pallas") raises on CPU
    tensors instead of falling back to the plain version."""
    args = _t(_inputs(9))
    gdr_cuda.LAUNCHES.reset()
    gdr.CHUNKED_CALLS.reset()
    with pytest.raises(ValueError, match="CUDA tensors"):
        gdr_cuda.gdr_fwd_cuda(*args)
    cfg = ModelConfig(enc_channels=(8, 8, 16, 16), enc_blocks=(1, 1, 1, 1),
                      num_heads=1, head_dim_k=8, head_dim_v=8,
                      kpff_channels=(8, 8), gdr_impl="pallas",
                      compute_dtype="float32")
    model = GDKVM(cfg, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        model(torch.zeros((1, 1, 32, 32, 1)))
    assert gdr_cuda.LAUNCHES.n == 0 and gdr.CHUNKED_CALLS.n == 0


def test_kernel_shared_memory_limit():
    """The kernels' shared memory fits a Hopper block at the streaming shapes
    (N=49 at 112², N=64) and at the 256² training shape (N=256, d=64).  The
    forward's solve keeps K, [U | W] and A in shared memory up to N=157 at
    d=64 (16-row block substitution), solves by 32-row panels above that,
    and fits beyond N=301; the chain's tiles do not grow with N; the
    backward's phases fit to N=301."""
    limit = gdr_cuda.SMEM_LIMIT_BYTES
    for n in (49, 64, 137, 157):
        assert not gdr_cuda.wy_uses_panels(n, 64, 64)
        assert gdr_cuda.wy_smem_bytes(n, 64, 64) <= limit
    for n in (158, 256, 301):
        assert gdr_cuda.wy_uses_panels(n, 64, 64)
        assert gdr_cuda.wy_smem_bytes(n, 64, 64) <= limit
    assert gdr_cuda.wy_smem_bytes(49, 64, 64) == 52_632
    assert gdr_cuda.wy_smem_bytes(256, 64, 64) == 195_072
    assert gdr_cuda.wy_smem_bytes(327, 64, 64) <= limit < gdr_cuda.wy_smem_bytes(328, 64, 64)
    assert gdr_cuda.chain_smem_bytes(64, True) == 130_304
    assert gdr_cuda.chain_smem_bytes(64, False) == 179_456
    assert gdr_cuda.chain_smem_bytes(gdr_cuda.CHAIN_MAX_DK, False) <= limit
    # The backward's reverse chain like the forward's; its per-frame
    # adjoint small enough for two blocks an SM (2 × 105 KB of 228 KB).
    assert gdr_cuda.bwd_chain_smem_bytes(64, True) == 136_448
    for bf16 in (False, True):
        assert gdr_cuda.bwd_frames_smem_bytes(256, 64, 64, bf16) == 105_120
        assert gdr_cuda.bwd_frames_smem_bytes(301, 64, 64, bf16) <= limit
    assert 2 * (gdr_cuda.bwd_frames_smem_bytes(256, 64, 64, True) + 1024) <= 228 * 1024


def _replaced_fwd_fits(n, dk, dv):
    """Whether the one-block-per-(b, h) forward kernel that this design
    replaced took (N, d_k, d_v): S, Q, padded K, [U | W] and A in shared
    memory, else S, [U | W] and the panel workspace."""
    limit, m = gdr_cuda.SMEM_LIMIT_BYTES, dv + dk
    small = dk * dv + n * dk + n * (dk + 1) + n * m + n * n
    return 4 * min(small, dk * dv + n * m + gdr_cuda._panel_floats(dk, m)) <= limit


@pytest.mark.parametrize("d", [32, 48, 64, 128])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_launch_plan_takes_every_shape_the_old_kernel_took(d, bf16):
    """For every N from 1 to 301 that the replaced forward kernel took at
    d_k = d_v = d, both launches fit a Hopper block, the solve has one
    block a frame and the chain (B·H, d_v/16) blocks, and the scratch holds
    U and W in fp32; the layouts switch to panels where A stops fitting."""
    b, h, t = 2, 3, 5
    taken = [n for n in range(1, 302) if _replaced_fwd_fits(n, d, d)]
    assert taken[0] == 1 and len(taken) == {32: 301, 48: 301, 64: 301, 128: 71}[d]
    for n in taken:
        plan = gdr_cuda.fwd_launch_plan(b, h, t, n, d, d, bf16)
        assert plan["fits"], n
        assert plan["solve"]["grid"] == (b * h * t,)
        assert plan["chain"]["grid"] == (b * h, -(-d // 16))
        assert plan["solve"]["threads"] == plan["chain"]["threads"] == 256
        assert max(plan["solve"]["smem"], plan["chain"]["smem"]) <= gdr_cuda.SMEM_LIMIT_BYTES
        assert plan["scratch_bytes"] == 4 * b * h * t * n * 2 * d
        assert plan["solve"]["panels"] == (4 * gdr_cuda._wy_small_floats(n, d, d)
                                           > gdr_cuda.SMEM_LIMIT_BYTES)
    assert not gdr_cuda.fwd_launch_plan(b, h, t, 8, 136, 64, bf16)["fits"]


def test_serving_shape_fills_the_card():
    """At the serving shape (8 slots × 16 frames at 112², N=49, 4 heads of
    64 × 64) the chain runs at least 128 blocks (the replaced kernel ran
    32) and the solve one block for each of the B·H·T = 512 frames; its
    12.8 MB of U, W scratch fits the 50 MB L2."""
    plan = gdr_cuda.fwd_launch_plan(8, 4, 16, 49, 64, 64, True)
    chain_blocks = plan["chain"]["grid"][0] * plan["chain"]["grid"][1]
    assert chain_blocks >= 128 and plan["solve"]["grid"] == (512,)
    assert not plan["solve"]["panels"]
    assert plan["scratch_bytes"] == 12_845_056 < 50e6
    train = gdr_cuda.fwd_launch_plan(8, 4, 10, 256, 64, 64, True)
    assert train["solve"]["panels"] and train["solve"]["grid"] == (320,)
    # The other documented models: gdkvm_rt_112 (H=2, d=48: 3 column blocks
    # a chain) and gdkvm_base_256 (H=6, N=256).
    rt = gdr_cuda.fwd_launch_plan(8, 2, 16, 49, 48, 48, True)
    assert rt["fits"] and rt["chain"]["grid"] == (16, 3) and not rt["solve"]["panels"]
    base = gdr_cuda.fwd_launch_plan(2, 6, 10, 256, 64, 64, True)
    assert base["fits"] and base["chain"]["grid"] == (12, 4) and base["solve"]["panels"]


def _replaced_bwd_fits(n, dk, dv):
    """Whether the one-block-per-(b, h) backward kernel that this design
    replaced took (N, d_k, d_v): S̃, dS, dS̃ and K in shared memory beside
    the panel workspace (its ``smem_floats``)."""
    m = dv + dk
    floats = (3 * dk * (dv + 1) + n * (dk + 1) + 2 * n + 8 + gdr_cuda._panel_floats(dk, m)
              + gdr_cuda.PANEL * (m + 1) + gdr_cuda.PANEL * dk)
    return 4 * floats <= gdr_cuda.SMEM_LIMIT_BYTES


@pytest.mark.parametrize("d", [32, 48, 64, 128])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_bwd_launch_plan_takes_every_shape_the_old_kernel_took(d, bf16):
    """For every N from 1 to 301 that the replaced backward kernel took at
    d_k = d_v = d (and at d_k = 32, d_v = 64), the three launches fit a
    Hopper block: the solve and the per-frame adjoint one block a frame,
    the reverse chain (B·H, d_v/16) blocks; the adjoint's shared memory
    does not grow past two blocks an SM; the scratch holds U, W, Y and two
    d_k × d_v matrices a frame in fp32."""
    b, h, t = 2, 3, 5
    for dk, dv in {(d, d), (32, 64)}:
        taken = [n for n in range(1, 302) if _replaced_bwd_fits(n, dk, dv)]
        assert len(taken) == {(32, 32): 301, (48, 48): 301, (64, 64): 301,
                              (128, 128): 0, (32, 64): 301}[dk, dv]
        for n in taken:
            plan = gdr_cuda.bwd_launch_plan(b, h, t, n, dk, dv, bf16)
            assert plan["fits"], (n, dk, dv)
            assert plan["solve"]["grid"] == plan["frames"]["grid"] == (b * h * t,)
            assert plan["chain"]["grid"] == (b * h, -(-dv // 16))
            assert {plan[p]["threads"] for p in ("solve", "chain", "frames")} == {256}
            assert plan["solve"] == gdr_cuda.fwd_launch_plan(b, h, t, n, dk, dv, bf16)["solve"]
            assert plan["frames"]["smem"] <= 113 * 1024
            assert plan["scratch_bytes"] == 4 * b * h * t * (2 * n * (dk + dv) + 2 * dk * dv)
    assert not gdr_cuda.bwd_launch_plan(b, h, t, 8, 136, 64, bf16)["fits"]


def test_bwd_plan_at_the_training_shape():
    """At the training shape (B=8 H=4 T=10 N=256 d=64) the per-frame
    phases run 320 blocks and the chain 128, against the replaced kernel's
    32; the scratch is 94.4 MB."""
    plan = gdr_cuda.bwd_launch_plan(8, 4, 10, 256, 64, 64, True)
    assert plan["solve"]["grid"] == plan["frames"]["grid"] == (320,)
    assert plan["chain"]["grid"] == (32, 4) and plan["solve"]["panels"]
    assert plan["scratch_bytes"] == 94_371_840


class _FakeLib:
    """Stands in for a kernel library: records each entry point's
    arguments and returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def __getattr__(self, name):
        if name.endswith("error_string"):
            return lambda err: b"fake error"

        def entry(*args):
            self.calls.append((name, args))
            return self.err
        return entry


@pytest.fixture
def fake_launch(monkeypatch):
    """The wrappers on CPU tensors with both libraries (the forward's,
    which holds the chain too, and the backward's) faked: no device check,
    stream 7."""
    import contextlib
    lib = _FakeLib()
    monkeypatch.setattr(gdr_cuda, "_require_cuda", lambda fn, x: None)
    monkeypatch.setattr(gdr_cuda, "_launching",
                        lambda dev: contextlib.nullcontext(7))
    monkeypatch.setattr(gdr_cuda, "_lib", lambda: lib)
    monkeypatch.setattr(gdr_cuda, "_bwd_lib", lambda: lib)
    for c in (gdr_cuda.LAUNCHES, gdr_cuda.CHAIN_LAUNCHES, gdr_cuda.RESIDUAL_LAUNCHES,
              gdr_cuda.BWD_LAUNCHES):
        c.reset()
    return lib


@pytest.mark.parametrize("save", ["none", "states", "states_uw"])
def test_fwd_wrapper_passes_arguments_in_order(fake_launch, save):
    """One forward is one C call (solve and chain inside) and one count,
    whatever it launches: its pointers in the order of the C prototype, the
    U/W scratch allocated by the wrapper even when it returns no residuals,
    the shapes, the bf16 flag and the stream."""
    q, k, v, beta, alpha, s0 = _t(_inputs(10, B=2, H=2, T=3, N=5, dk=8, dv=4))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    if save == "none":
        out = gdr_cuda.gdr_fwd_cuda(q, k, v, beta, alpha, s0)
        assert len(out) == 2
    else:
        out = gdr_cuda.gdr_fwd_cuda_residuals(q, k, v, beta, alpha, s0,
                                              save_uw=save == "states_uw")
        assert (out[3] is None) == (save == "states")
    [(name, args)] = fake_launch.calls
    assert name == "gdr_fwd" and len(args) == 23
    ptrs, ints, stream = args[:14], args[14:22], args[22]
    want = [x.data_ptr() for x in (q, k, v, beta, beta, alpha, s0, out[0], out[1])]
    assert list(ptrs[:9]) == want            # eta=None passes beta as eta
    assert (ptrs[9] is None) == (save == "none")
    assert ptrs[10] and ptrs[11] and len(set(ptrs[7:12]) - {None}) == 4 + (save != "none")
    assert ptrs[12] is None and ptrs[13] is None     # no bf16 copies
    if save == "states_uw":
        assert (ptrs[9], ptrs[10], ptrs[11]) == tuple(x.data_ptr() for x in out[2:])
        assert out[3].shape == (2, 2, 3, 5, 4) and out[4].shape == (2, 2, 3, 5, 8)
    assert list(ints) == [2, 2, 3, 5, 8, 4, 1, 0] and stream == 7
    assert (gdr_cuda.LAUNCHES.n, gdr_cuda.RESIDUAL_LAUNCHES.n) == (1, int(save != "none"))
    assert gdr_cuda.CHAIN_LAUNCHES.n == 0


def test_wrappers_raise_on_a_failed_launch(fake_launch):
    """A nonzero return from any C entry point raises with CUDA's message,
    and nothing is counted."""
    q, k, v, beta, alpha, s0 = _t(_inputs(11, B=1, T=2))
    fake_launch.err = 98
    u, w = gdr.wy_transform(k, v, beta)
    with pytest.raises(RuntimeError, match="gdr_fwd launch failed: CUDA error 98"):
        gdr_cuda.gdr_fwd_cuda(q, k, v, beta, alpha, s0)
    with pytest.raises(RuntimeError, match="gdr_fwd launch failed: CUDA error 98"):
        gdr_cuda.gdr_fwd_cuda_residuals(q, k, v, beta, alpha, s0)
    with pytest.raises(RuntimeError, match="gdr_chain launch failed: CUDA error 98"):
        gdr_cuda.gdr_chain_cuda(q, k, u.contiguous(), w.contiguous(), alpha, s0,
                                save_states=True)
    assert (gdr_cuda.LAUNCHES.n, gdr_cuda.CHAIN_LAUNCHES.n,
            gdr_cuda.RESIDUAL_LAUNCHES.n) == (0, 0, 0)


def test_fwd_wrapper_passes_decoupled_eta_and_returns_the_solve(fake_launch):
    """With a decoupled η the forward passes it in η's slot (not β), and with
    ``save_uw`` it returns the U, W it allocated for the solve kernel: fp32,
    (…, N, d_v) and (…, N, d_k), the C call's 11th and 12th pointers."""
    q, k, v, beta, alpha, s0 = _t(_inputs(12, B=2, H=3, T=4, N=6, dk=8, dv=12))
    eta = beta * 0.5
    out = gdr_cuda.gdr_fwd_cuda_residuals(q, k, v, beta, alpha, s0, eta)
    [(name, args)] = fake_launch.calls
    assert name == "gdr_fwd"
    assert list(args[:6]) == [x.data_ptr() for x in (q, k, v, beta, eta, alpha)]
    u, w = out[3], out[4]
    assert (args[10], args[11]) == (u.data_ptr(), w.data_ptr())
    assert list(args[12:]) == [None, None, 2, 3, 4, 6, 8, 12, 0, 0, 7]
    assert u.shape == (2, 3, 4, 6, 12) and w.shape == (2, 3, 4, 6, 8)
    assert u.dtype == w.dtype == torch.float32
    assert (gdr_cuda.LAUNCHES.n, gdr_cuda.RESIDUAL_LAUNCHES.n) == (1, 1)


def test_fwd_wrapper_refuses_what_the_kernels_do_not_take(fake_launch):
    """Shapes past the launch plan (d_k over the chain's 128; a solve block
    over 227 KB) raise before anything launches."""
    q, k, v, beta, alpha, s0 = _t(_inputs(13, B=1, H=1, T=1, N=4, dk=136, dv=8))
    with pytest.raises(ValueError, match="d_k <= 128"):
        gdr_cuda.gdr_fwd_cuda(q, k, v, beta, alpha, s0)
    q, k, v, beta, alpha, s0 = _t(_inputs(13, B=1, H=1, T=1, N=400, dk=64, dv=64))
    with pytest.raises(ValueError, match="shared memory"):
        gdr_cuda.gdr_fwd_cuda(q, k, v, beta, alpha, s0)
    with pytest.raises(ValueError, match="shared memory"):
        gdr_cuda.gdr_fwd_cuda_residuals(q, k, v, beta, alpha, s0)
    assert fake_launch.calls == [] and gdr_cuda.LAUNCHES.n == 0


def _bwd_args(seed, B=2, H=3, T=4, N=6, dk=8, dv=12, bf16=False):
    q, k, v, beta, alpha, s0 = _t(_inputs(seed, B=B, H=H, T=T, N=N, dk=dk, dv=dv))
    if bf16:
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    eta = beta * 0.5
    states = torch.randn((B, H, T, dk, dv))
    do = torch.randn((B, H, T, N, dv))
    return q, k, v, beta, eta, alpha, states, do, s0


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_bwd_wrapper_passes_arguments_in_order(fake_launch, bf16):
    """One backward is one C call (three kernels inside) and one count: the
    nine inputs and seven outputs in the order of the C prototype, then the
    scratch the wrapper allocates (U, W, g, dS̃, Y: fp32, distinct, shaped
    as the plan says), the shapes, the bf16 flag and the stream."""
    q, k, v, beta, eta, alpha, states, do, ds_t = _bwd_args(14, bf16=bf16)
    out = gdr_cuda.gdr_bwd_cuda(q, k, v, beta, eta, alpha, states, do, ds_t)
    [(name, args)] = fake_launch.calls
    assert name == "gdr_bwd" and len(args) == 29
    ptrs, ints, stream = args[:21], args[21:28], args[28]
    assert list(ptrs[:9]) == [x.data_ptr() for x in (q, k, v, beta, eta, alpha,
                                                     states, do, ds_t)]
    assert list(ptrs[9:16]) == [x.data_ptr() for x in out]
    assert len(set(ptrs)) == 21 and all(ptrs[16:])
    assert list(ints) == [2, 3, 4, 6, 8, 12, int(bf16)] and stream == 7
    shapes = [tuple(x.shape) for x in out]
    assert shapes == [(2, 3, 4, 6, 8), (2, 3, 4, 6, 8), (2, 3, 4, 6, 12), (2, 3, 4, 6),
                      (2, 3, 4, 6), (2, 3, 4), (2, 3, 8, 12)]
    assert all(x.dtype == torch.float32 for x in out)
    assert gdr_cuda.BWD_LAUNCHES.n == 1


def test_bwd_launch_returns_its_scratch(fake_launch):
    """``_bwd_launch`` is the same one C call and one count as
    ``gdr_bwd_cuda``, and returns the scratch it passed to it: U, W, g and
    dS̃ (the C call's 17th to 20th pointers), fp32, shaped per frame."""
    q, k, v, beta, eta, alpha, states, do, ds_t = _bwd_args(15)
    grads, (u, w, g, dsd) = gdr_cuda._bwd_launch(q, k, v, beta, eta, alpha,
                                                 states, do, ds_t)
    [(name, args)] = fake_launch.calls
    assert name == "gdr_bwd"
    assert list(args[9:16]) == [x.data_ptr() for x in grads]
    assert list(args[16:20]) == [x.data_ptr() for x in (u, w, g, dsd)]
    assert u.shape == (2, 3, 4, 6, 12) and w.shape == (2, 3, 4, 6, 8)
    assert g.shape == dsd.shape == (2, 3, 4, 8, 12)
    assert all(x.dtype == torch.float32 for x in (u, w, g, dsd))
    assert gdr_cuda.BWD_LAUNCHES.n == 1


def test_bwd_wrappers_raise_on_a_failed_launch_or_a_shape_past_the_plan(fake_launch):
    """A nonzero return raises with CUDA's message and counts nothing; a
    d_k past the chain's 128 raises before anything launches."""
    args = _bwd_args(16)
    fake_launch.err = 98
    with pytest.raises(RuntimeError, match="gdr_bwd launch failed: CUDA error 98"):
        gdr_cuda.gdr_bwd_cuda(*args)
    fake_launch.err, fake_launch.calls = 0, []
    with pytest.raises(ValueError, match="d_k <= 128"):
        gdr_cuda.gdr_bwd_cuda(*_bwd_args(16, N=3, dk=136, dv=8))
    assert fake_launch.calls == [] and gdr_cuda.BWD_LAUNCHES.n == 0


def test_fwd_wrapper_bf16_residuals(fake_launch):
    """With ``save_bf16`` the forward passes bf16 S_{t-1} and bf16 copies of
    U, W (the 13th and 14th pointers) beside the fp32 U, W that the chain
    reads, sets the flag, and returns the bf16 ones."""
    q, k, v, beta, alpha, s0 = _t(_inputs(17, B=2, H=3, T=4, N=6, dk=8, dv=12))
    o, s_t, states, u, w = gdr_cuda.gdr_fwd_cuda_residuals(q, k, v, beta, alpha, s0,
                                                           save_bf16=True)
    [(_, args)] = fake_launch.calls
    assert states.dtype == u.dtype == w.dtype == torch.bfloat16
    assert o.dtype == s_t.dtype == torch.float32
    assert (args[9], args[12], args[13]) == (states.data_ptr(), u.data_ptr(), w.data_ptr())
    assert args[10] and args[11] and len(set(args[7:14])) == 7
    assert list(args[14:]) == [2, 3, 4, 6, 8, 12, 0, 1, 7]
