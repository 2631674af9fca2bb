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
    forward keeps Q, K and A in shared memory up to N=137 at d=64 (the
    streaming layout), solves by panels above that, and fits up to N=301;
    the backward fits beyond."""
    limit = gdr_cuda.SMEM_LIMIT_BYTES
    for n in (49, 64, 137):
        assert not gdr_cuda.fwd_uses_panels(n, 64, 64)
        assert gdr_cuda.smem_bytes(n, 64, 64) <= limit
    for n in (138, 256, 301):
        assert gdr_cuda.fwd_uses_panels(n, 64, 64)
        assert gdr_cuda.smem_bytes(n, 64, 64) <= limit
    assert gdr_cuda.smem_bytes(256, 64, 64) == 209_408
    assert gdr_cuda.smem_bytes(301, 64, 64) == limit
    assert gdr_cuda.smem_bytes(302, 64, 64) > limit
    assert gdr_cuda.bwd_smem_bytes(256, 64, 64) == 205_216 <= limit
    assert gdr_cuda.bwd_smem_bytes(301, 64, 64) <= limit
    assert gdr_cuda.bwd_scratch_floats(256, 64, 64) * 4 == 458_752
