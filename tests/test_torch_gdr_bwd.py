"""The port's GDR backward (gdkvm_tpu_torch.core.gdr, ops.gdr_cuda) against
the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go to both frameworks.  The JAX
side runs its Pallas kernels in interpret mode, as its own tests do.  The
CUDA kernels are compared with their plain versions on the card by
chip_smoke.py; here the plain versions and the autograd wiring around the
kernels are tested, with the launchers swapped for their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdkvm_tpu.core import gdr as jgdr
from gdkvm_tpu.ops import gdr_pallas
from gdkvm_tpu_torch.core import gdr
from gdkvm_tpu_torch.ops import gdr_cuda

torch.set_num_threads(1)

# Gradients: the tolerance of the JAX package's own VJP tests (fp32 on both
# sides; the adjoint sums in another order than autograd through a scan).
G_RTOL, G_ATOL = 2e-3, 2e-4
# Forward values: fp32 on both sides, summation order only.
RTOL, ATOL = 1e-4, 1e-5

NAMES = ("dq", "dk", "dv", "dbeta", "dalpha", "ds0")


def _inputs(seed, B=2, H=2, T=4, N=7, dk=16, dv=16):
    """numpy (q, k, v, beta, alpha, s0): unit-norm keys, gates in (0, 1),
    α near 1 — as the model feeds the scan."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, N, dk), dtype=np.float32)
    k = rng.standard_normal((B, H, T, N, dk), dtype=np.float32)
    k /= np.linalg.norm(k, axis=-1, keepdims=True) + 1e-6
    v = rng.standard_normal((B, H, T, N, dv), dtype=np.float32)
    beta = 1 / (1 + np.exp(-rng.standard_normal((B, H, T, N), dtype=np.float32)))
    alpha = 1 / (1 + np.exp(-rng.standard_normal((B, H, T), dtype=np.float32) - 2))
    s0 = 0.1 * rng.standard_normal((B, H, dk, dv), dtype=np.float32)
    return q, k, v, beta.astype(np.float32), alpha.astype(np.float32), s0


def _weights(T, N, dk, dv):
    """Non-uniform loss weights on o and s_T (tests/test_gdr_pallas.py)."""
    w_o = np.cos(np.arange(T * N * dv, dtype=np.float32)).reshape(1, 1, T, N, dv)
    w_s = np.sin(np.arange(dk * dv, dtype=np.float32)).reshape(1, 1, dk, dv)
    return w_o, w_s


def _t(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _close(got, want, rtol=G_RTOL, atol=G_ATOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=name)


def _jax_grads(fn, args, w_o, w_s):
    def loss(*a):
        o, s = fn(*a)
        return jnp.sum(o * w_o) + jnp.sum(s * w_s)
    return jax.grad(loss, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in args))


def _plain_grads(bwd, args, w_o, w_s):
    """The six coupled-rule gradients from a plain backward: forward with
    residuals, then ``bwd``; dβ is the write plus the erase cotangent."""
    q, k, v, beta, alpha, s0 = _t(args)
    _, _, states, u, w = gdr.gdr_chunked_residuals(q, k, v, beta, alpha, s0)
    do = torch.from_numpy(np.broadcast_to(w_o, q.shape[:4] + (v.shape[-1],)).copy())
    ds_t = torch.from_numpy(np.broadcast_to(w_s, s0.shape).copy())
    if bwd == "ref":
        g = gdr.gdr_bwd_ref(q, k, v, beta, beta, alpha, states, do, ds_t)
    else:
        g = gdr.gdr_bwd_stored(q, k, v, beta, beta, alpha, states, u, w, do, ds_t)
    dq, dk, dv, dbeta, deta, dalpha, ds0 = g
    return dq, dk, dv, dbeta + deta, dalpha, ds0


def test_forward_residuals_match_pallas():
    """S_{t-1} per frame and the first N rows of U and W equal the Pallas
    forward's save_states / save_uw outputs (it pads N=7 to 16)."""
    args = _inputs(0)
    q, k, v, beta, alpha, s0 = (jnp.asarray(a) for a in args)
    o_j, s_j, states_j, (u_j, w_j, _) = gdr_pallas._gdr_pallas_fwd_impl(
        q, k, v, beta, beta, alpha, s0, save_states=True, save_uw=True)
    o, s_t, states, u, w = gdr.gdr_chunked_residuals(*_t(args))
    n = args[0].shape[3]
    for name, got, want in (("o", o, o_j), ("s_T", s_t, s_j),
                            ("states", states, states_j),
                            ("u", u, u_j[:, :, :, :n]), ("w", w, w_j[:, :, :, :n])):
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        _close(got, want, RTOL, ATOL, name)


@pytest.mark.parametrize("T,N,dk,dv", [(4, 7, 16, 16), (2, 16, 16, 32),
                                       (3, 49, 32, 32)])
def test_plain_backward_matches_jax_ref(T, N, dk, dv):
    """gdr_bwd_ref and gdr_bwd_stored equal jax.grad through the JAX token
    scan, under a weighted o / s_T loss."""
    args = _inputs(1, T=T, N=N, dk=dk, dv=dv)
    w_o, w_s = _weights(T, N, dk, dv)
    want = _jax_grads(jgdr.gdr_ref_bh, args, w_o, w_s)
    for bwd in ("ref", "stored"):
        for name, got, ref in zip(NAMES, _plain_grads(bwd, args, w_o, w_s), want):
            _close(got, ref, name=f"{bwd} {name}")


@pytest.mark.parametrize("mode,bwd", [("fused", "ref"), ("stored", "stored")])
def test_plain_backward_matches_pallas_vjp(mode, bwd, monkeypatch):
    """Each plain backward equals its JAX counterpart: the fused backward
    kernel's plain version against jax.grad through gdr_pallas_bh under
    GDKVM_GDR_BWD=fused, the stored backward under =stored."""
    monkeypatch.setenv("GDKVM_GDR_BWD", mode)
    args = _inputs(2)
    w_o, w_s = _weights(4, 7, 16, 16)
    want = _jax_grads(gdr_pallas.gdr_pallas_bh, args, w_o, w_s)
    for name, got, ref in zip(NAMES, _plain_grads(bwd, args, w_o, w_s), want):
        _close(got, ref, name=name)


def test_state_carry_gradient_matches_jax():
    """Two chained calls through the Function (state carried, fused mode on
    the plain launchers): ds0 of the second call feeds ds_T of the first.
    Equal to jax.grad through one JAX token scan over all six frames."""
    args = _inputs(3, T=6)

    def loss_ref(*a):
        o, s = jgdr.gdr_ref_bh(*a)
        return jnp.sum(o[:, :, 3:] ** 2) + jnp.sum(s ** 2)

    want = jax.grad(loss_ref, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in args))
    ins = [x.requires_grad_(True) for x in _t(args)]
    q, k, v, beta, alpha, s0 = ins
    sl = lambda x, lo, hi: x[:, :, lo:hi]
    with _plain_launchers("fused"):
        _, s_a = gdr_cuda.GDRFunction.apply(
            *(sl(x, 0, 3) for x in (q, k, v, beta, alpha)), s0, None)
        o_b, s_b = gdr_cuda.GDRFunction.apply(
            *(sl(x, 3, 6) for x in (q, k, v, beta, alpha)), s_a, None)
        got = torch.autograd.grad((o_b ** 2).sum() + (s_b ** 2).sum(), ins)
    for name, g, ref in zip(NAMES, got, want):
        _close(g, ref, name=name)


class _plain_launchers:
    """Swap the Function's kernel launchers for their plain versions (CPU
    tensors only) and set GDKVM_GDR_BWD; count the launcher calls."""

    def __init__(self, mode: str):
        self.mode = mode
        self.mp = pytest.MonkeyPatch()
        self.calls = {"fwd": 0, "fwd_residuals": 0, "bwd": 0}

    def __enter__(self):
        def fwd(*a):
            self.calls["fwd"] += 1
            return gdr.gdr_chunked(*a)

        def fwd_residuals(*a, save_uw):
            self.calls["fwd_residuals"] += 1
            o, s_t, states, u, w = gdr.gdr_chunked_residuals(*a)
            return (o, s_t, states, u, w) if save_uw else (o, s_t, states, None, None)

        def bwd(*a):
            self.calls["bwd"] += 1
            return gdr.gdr_bwd_ref(*a)

        self.mp.setenv("GDKVM_GDR_BWD", self.mode)
        self.mp.setattr(gdr_cuda, "gdr_fwd_cuda", fwd)
        self.mp.setattr(gdr_cuda, "gdr_fwd_cuda_residuals", fwd_residuals)
        self.mp.setattr(gdr_cuda, "gdr_bwd_cuda", bwd)
        return self

    def __exit__(self, *exc):
        self.mp.undo()


# For each mode, the launcher calls of one forward and one backward.
MODE_CALLS = {"stored": {"fwd": 0, "fwd_residuals": 1, "bwd": 0},
              "fused": {"fwd": 0, "fwd_residuals": 1, "bwd": 1},
              "recompute": {"fwd": 1, "fwd_residuals": 0, "bwd": 0}}


@pytest.mark.parametrize("coupled", [True, False], ids=["coupled", "decoupled"])
@pytest.mark.parametrize("mode", sorted(MODE_CALLS))
def test_function_gradients(mode, coupled):
    """The kernel route is differentiable: with the launchers swapped for
    their plain versions, every input (q, k, v, β, α, s0, and η when given)
    gets the gradient autograd through gdr_ref gives, in each mode, and
    each mode calls the launchers it should."""
    q, k, v, beta, alpha, s0 = _t(_inputs(4, B=1, T=3, N=5, dk=8, dv=8))
    eta = None if coupled else torch.sigmoid(torch.linspace(-2, 2, beta.numel())
                                             ).reshape(beta.shape)
    ins = [x.requires_grad_(True) for x in (q, k, v, beta, alpha, s0)
           + (() if eta is None else (eta,))]
    w_o, w_s = (torch.from_numpy(w) for w in _weights(3, 5, 8, 8))
    loss = lambda o, s: (o * w_o).sum() + (s * w_s).sum()
    want = torch.autograd.grad(loss(*gdr.gdr_ref(*ins)), ins)
    gdr.BWD_STORED_CALLS.reset()
    with _plain_launchers(mode) as pl:
        out = gdr_cuda.GDRFunction.apply(*ins[:6], ins[6] if len(ins) > 6 else None)
        got = torch.autograd.grad(loss(*out), ins)
    assert pl.calls == MODE_CALLS[mode]
    assert gdr.BWD_STORED_CALLS.n == (mode == "stored")
    for name, g, ref in zip(NAMES + ("deta",), got, want):
        assert g.dtype == ref.dtype and g.shape == ref.shape, name
        _close(g, ref, 1e-4, 1e-5, name)


def test_coupled_beta_gradient_is_write_plus_erase():
    """eta=None passes β as both gates (gdr_pallas.py:1038-1044): its
    gradient is the write cotangent plus the erase cotangent."""
    q, k, v, beta, alpha, s0 = _t(_inputs(5, B=1, T=2, N=6, dk=8, dv=8))
    w_o, _ = _weights(2, 6, 8, 8)
    w_o = torch.from_numpy(w_o)
    b1 = beta.clone().requires_grad_(True)
    b2, e2 = beta.clone().requires_grad_(True), beta.clone().requires_grad_(True)
    with _plain_launchers("fused"):
        o1, _ = gdr_cuda.GDRFunction.apply(q, k, v, b1, alpha, s0, None)
        o2, _ = gdr_cuda.GDRFunction.apply(q, k, v, b2, alpha, s0, e2)
        (d_coupled,) = torch.autograd.grad((o1 * w_o).sum(), [b1])
        d_write, d_erase = torch.autograd.grad((o2 * w_o).sum(), [b2, e2])
    assert d_write.abs().max() > 0 and d_erase.abs().max() > 0
    torch.testing.assert_close(d_coupled, d_write + d_erase, rtol=0, atol=0)


def test_gradient_dtypes_follow_inputs():
    """bf16 q, k, v get bf16 gradients; the gates and s0 fp32
    (gdr_pallas.py:1261-1264)."""
    q, k, v, beta, alpha, s0 = _t(_inputs(6, B=1, T=2, N=5, dk=8, dv=8))
    ins = [x.to(torch.bfloat16) for x in (q, k, v)] + [beta, alpha, s0]
    ins = [x.requires_grad_(True) for x in ins]
    for mode in sorted(MODE_CALLS):
        with _plain_launchers(mode):
            o, s = gdr_cuda.GDRFunction.apply(*ins, None)
            got = torch.autograd.grad(o.sum() + s.sum(), ins)
        assert [g.dtype for g in got] == [x.dtype for x in ins], mode


def test_no_residuals_without_grad():
    """With no gradient to take the kernel route launches the residual-free
    forward kernel once (the streaming path); under grad it launches the
    forward with residuals."""
    args = [x.requires_grad_(True) for x in _t(_inputs(7, B=1, T=2))]
    with _plain_launchers("stored") as pl:
        with torch.no_grad():
            gdr_cuda.gdr_kernel(*args)
        with torch.inference_mode():
            gdr_cuda.gdr_kernel(*args)
        assert pl.calls == {"fwd": 2, "fwd_residuals": 0, "bwd": 0}
        o, s = gdr_cuda.gdr_kernel(*args)
        assert o.requires_grad and s.requires_grad
        assert pl.calls == {"fwd": 2, "fwd_residuals": 1, "bwd": 0}
        gdr_cuda.gdr_kernel(*(x.detach() for x in args))
        assert pl.calls == {"fwd": 3, "fwd_residuals": 1, "bwd": 0}


def test_bwd_mode_validation(monkeypatch):
    """GDKVM_GDR_BWD takes stored | recompute | fused, defaults to stored,
    and raises on anything else (gdr_pallas.py:1140-1145)."""
    monkeypatch.delenv("GDKVM_GDR_BWD", raising=False)
    assert gdr_cuda._bwd_mode() == "stored"
    for mode in ("stored", "recompute", "fused"):
        monkeypatch.setenv("GDKVM_GDR_BWD", mode)
        assert gdr_cuda._bwd_mode() == mode
    monkeypatch.setenv("GDKVM_GDR_BWD", "Fused")
    with pytest.raises(ValueError, match="stored|recompute|fused"):
        gdr_cuda._bwd_mode()
    args = [x.requires_grad_(True) for x in _t(_inputs(8, B=1, T=1))]
    with pytest.raises(ValueError, match="GDKVM_GDR_BWD"):
        gdr_cuda.GDRFunction.apply(*args, None)


def test_kernels_refuse_cpu_tensors():
    """The launchers raise on CPU tensors instead of running a plain
    version; under grad the kernel route raises too."""
    q, k, v, beta, alpha, s0 = _t(_inputs(9, B=1, T=2))
    states = torch.zeros(q.shape[:3] + (q.shape[-1], v.shape[-1]))
    gdr_cuda.LAUNCHES.reset()
    gdr_cuda.BWD_LAUNCHES.reset()
    with pytest.raises(ValueError, match="CUDA tensors"):
        gdr_cuda.gdr_fwd_cuda_residuals(q, k, v, beta, alpha, s0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gdr_cuda.gdr_bwd_cuda(q, k, v, beta, beta, alpha, states,
                              torch.zeros_like(v), torch.zeros_like(s0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        gdr_cuda.gdr_kernel(q.requires_grad_(True), k, v, beta, alpha, s0)
    assert gdr_cuda.LAUNCHES.n == 0 and gdr_cuda.BWD_LAUNCHES.n == 0


def _ref_f64(q, k, v, beta, alpha, s0):
    """Token-level scan in float64 (gdr_ref's loop without its fp32 cast)."""
    s, outs = s0, []
    for t in range(q.shape[2]):
        s = alpha[:, :, t, None, None] * s
        outs.append(q[:, :, t] @ s)
        for i in range(q.shape[3]):
            k_i = k[:, :, t, i]
            sk = (s.transpose(-1, -2) @ k_i[..., None])[..., 0]
            r = beta[:, :, t, i, None] * (v[:, :, t, i] - sk)
            s = s + k_i[..., :, None] * r[..., None, :]
    return torch.stack(outs, dim=2), s


@pytest.mark.parametrize("bwd", ["ref", "stored"])
def test_plain_backward_large_n_correlated_keys(bwd):
    """N=256 tokens with highly correlated keys (the at-init regime at 256²,
    tests/test_gdr.py): both plain backwards stay finite and close to
    float64 autograd through the token scan.  The bar is the JAX package's
    2e-3 forward bar for this case, relative to each gradient's scale."""
    rng = np.random.default_rng(10)
    T, N, dk, dv = 2, 256, 32, 32
    base = rng.standard_normal(dk)
    k = base + 0.1 * rng.standard_normal((1, 1, T, N, dk))
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    q = rng.standard_normal((1, 1, T, N, dk))
    v = rng.standard_normal((1, 1, T, N, dv))
    beta = np.full((1, 1, T, N), 0.9)
    alpha = np.array([[[1.0, 0.9]]])
    s0 = 0.1 * rng.standard_normal((1, 1, dk, dv))
    w_o = rng.standard_normal((1, 1, T, N, dv))
    w_s = rng.standard_normal((1, 1, dk, dv))
    args = (q, k, v, beta, alpha, s0)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in args]
    o, s = _ref_f64(*ins)
    want = torch.autograd.grad((o * torch.from_numpy(w_o)).sum()
                               + (s * torch.from_numpy(w_s)).sum(), ins)
    got = _plain_grads(bwd, [a.astype(np.float32) for a in args],
                       w_o.astype(np.float32), w_s.astype(np.float32))
    for name, g, ref in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        ref = ref.numpy()
        err = np.abs(g.numpy() - ref).max() / np.abs(ref).max()
        assert err < 2e-3, (name, err)


@pytest.mark.parametrize("mode", sorted(MODE_CALLS))
def test_model_gradients_through_kernel_route(mode):
    """A narrow model on the kernel route (gdr_impl="pallas", launchers
    swapped for their plain versions) gets the gradients of the plain
    chunked route, and the LKVA projections get nonzero ones: the scan is
    not cut out of the graph."""
    import dataclasses
    from gdkvm_tpu_torch.config.schema import ModelConfig
    from gdkvm_tpu_torch.models.gdkvm import GDKVM, init_params
    cfg = ModelConfig(enc_channels=(8, 8, 16, 16), enc_blocks=(1, 1, 1, 1),
                      num_heads=2, head_dim_k=8, head_dim_v=8,
                      kpff_channels=(8, 8), compute_dtype="float32",
                      gdr_impl="pallas")
    kernel = init_params(GDKVM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    plain = GDKVM(dataclasses.replace(cfg, gdr_impl="chunked"), device="cpu")
    plain.load_state_dict(kernel.state_dict())
    frames = torch.from_numpy(np.random.default_rng(11).random(
        (2, 3, 32, 32, 1), dtype=np.float32))
    mask = torch.from_numpy(np.random.default_rng(12).integers(0, 2, (2, 32, 32)))

    def grads(model):
        logits, state = model(frames, None, mask, torch.tensor([1.0, 0.5]))
        loss = (logits ** 2).mean() + (state.mem ** 2).mean()
        return dict(zip([n for n, _ in model.named_parameters()],
                        torch.autograd.grad(loss, list(model.parameters()))))

    want = grads(plain)
    with _plain_launchers(mode) as pl:
        got = grads(kernel)
    assert pl.calls == MODE_CALLS[mode]
    for name in ("q_proj", "k_proj", "v_proj", "beta_proj", "alpha_proj"):
        assert got[f"lkva.{name}.weight"].abs().max() > 0, name
    for name, g in want.items():
        torch.testing.assert_close(got[name], g, rtol=1e-4, atol=1e-6, msg=name)
