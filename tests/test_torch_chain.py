"""The port's chain forward split (core.gdr.gdr_chain and the
GDKVM_GDR_FWD=chain dispatch in ops.gdr_cuda) against the JAX package's, on
the CPU.

Inputs are made with numpy from a seed and go to both frameworks.  The JAX
side runs its chain kernel in interpret mode through
``_gdr_pallas_fwd_impl(..., mode="chain")``, as tests/test_gdr_pallas.py
does.  The CUDA chain kernel is compared with ``gdr_chain`` on the card by
chip_smoke.py; here its plain version and the dispatch around it are
tested, with the launchers swapped for their plain versions.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdkvm_tpu.ops import gdr_pallas
from gdkvm_tpu_torch.core import gdr
from gdkvm_tpu_torch.ops import gdr_cuda
from test_torch_gdr import fake_launch  # noqa: F401  (a fixture)
from test_torch_gdr_bwd import _NO_CALLS, _inputs, _plain_launchers, _t, _weights

torch.set_num_threads(1)

# Forward values: fp32 on both sides, summation order only (the JAX side
# pads N to 16 with zero gates, which adds exact zeros).
RTOL, ATOL = 1e-4, 1e-5


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("save_states", [False, True], ids=["no_states", "states"])
@pytest.mark.parametrize("T,N,dk,dv", [(4, 7, 16, 16), (3, 49, 32, 32),
                                       (2, 16, 16, 32)])
def test_gdr_chain_matches_jax_chain_mode(T, N, dk, dv, save_states):
    """gdr_chain on the port's batched solves equals the JAX chain mode (XLA
    solves, then the chain kernel) in o, s_T and the S_{t-1} checkpoints."""
    args = _inputs(20, T=T, N=N, dk=dk, dv=dv)
    q, k, v, beta, alpha, s0 = (jnp.asarray(a) for a in args)
    o_j, s_j, st_j, uw_j = gdr_pallas._gdr_pallas_fwd_impl(
        q, k, v, beta, beta, alpha, s0, save_states=save_states, mode="chain")
    assert uw_j is None
    tq, tk, tv, tb, ta, ts0 = _t(args)
    u, w = gdr.wy_transform(tk, tv, tb)
    gdr.CHAIN_CALLS.reset()
    o, s_t, states = gdr.gdr_chain(tq, tk, u, w, ta, ts0, save_states=save_states)
    assert gdr.CHAIN_CALLS.n == 1
    assert o.dtype == s_t.dtype == torch.float32
    _close(o, o_j, "o")
    _close(s_t, s_j, "s_T")
    if save_states:
        assert states.shape == (2, 2, T, dk, dv)
        _close(states, st_j, "states")
    else:
        assert states is None and st_j is None


def test_gdr_chain_states_match_chunked_residuals():
    """With states, gdr_chain on wy_transform's U, W is the chain inside
    gdr_chunked_residuals: equal bit for bit, each counted on its own."""
    q, k, v, beta, alpha, s0 = _t(_inputs(21, T=5, N=9, dk=8, dv=12))
    q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
    gdr.CHAIN_CALLS.reset()
    gdr.CHUNKED_CALLS.reset()
    o_r, s_r, st_r, u, w = gdr.gdr_chunked_residuals(q, k, v, beta, alpha, s0)
    o, s_t, states = gdr.gdr_chain(q, k, u, w, alpha, s0, save_states=True)
    assert (gdr.CHAIN_CALLS.n, gdr.CHUNKED_CALLS.n) == (1, 1)
    for got, want in ((o, o_r), (s_t, s_r), (states, st_r)):
        assert torch.equal(got, want)
    torch.testing.assert_close(states[:, :, 0], s0, rtol=0, atol=0)


def test_chain_split_equals_chunked_and_carries_state():
    """The split (batched solves, then the chain) equals gdr_chunked, and
    two chained 2-frame calls equal one 4-frame call."""
    q, k, v, beta, alpha, s0 = _t(_inputs(22, T=4, N=7, dk=16, dv=16))
    u, w = gdr.wy_transform(k, v, beta)
    o, s_t, _ = gdr.gdr_chain(q, k, u, w, alpha, s0)
    o_c, s_c = gdr.gdr_chunked(q, k, v, beta, alpha, s0)
    torch.testing.assert_close(o, o_c, rtol=0, atol=0)
    torch.testing.assert_close(s_t, s_c, rtol=0, atol=0)
    sl = lambda x, lo, hi: x[:, :, lo:hi]
    o_a, s_a, _ = gdr.gdr_chain(*(sl(x, 0, 2) for x in (q, k, u, w, alpha)), s0)
    o_b, s_b, _ = gdr.gdr_chain(*(sl(x, 2, 4) for x in (q, k, u, w, alpha)), s_a)
    torch.testing.assert_close(torch.cat([o_a, o_b], 2), o, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s_b, s_t, rtol=1e-6, atol=1e-6)


# The launcher calls of one chain-mode forward and backward, per backward mode
# (gdr_pallas.py:1108-1120 with _gdr_pallas_fwd_impl's chain branch).
CHAIN_CALLS = {"stored": dict(_NO_CALLS, chain_states=1),
               "fused": dict(_NO_CALLS, chain_states=1, bwd=1),
               "recompute": dict(_NO_CALLS, chain=1)}


@pytest.mark.parametrize("coupled", [True, False], ids=["coupled", "decoupled"])
@pytest.mark.parametrize("mode", sorted(CHAIN_CALLS))
def test_chain_function_gradients(mode, coupled):
    """GDRFunction in chain mode, launchers swapped for their plain versions:
    every input's gradient equals autograd through gdr_chunked (fp32,
    summation order only), and each backward mode calls the launchers it
    should: the chain with S_{t-1} for stored and fused, without for
    recompute; the stored backward on the batched solves' U, W."""
    q, k, v, beta, alpha, s0 = _t(_inputs(23, B=1, T=3, N=5, dk=8, dv=8))
    eta = None if coupled else torch.sigmoid(torch.linspace(-2, 2, beta.numel())
                                             ).reshape(beta.shape)
    ins = [x.requires_grad_(True) for x in (q, k, v, beta, alpha, s0)
           + (() if eta is None else (eta,))]
    w_o, w_s = (torch.from_numpy(w) for w in _weights(3, 5, 8, 8))
    loss = lambda o, s: (o * w_o).sum() + (s * w_s).sum()
    want = torch.autograd.grad(loss(*gdr.gdr_chunked(*ins)), ins)
    gdr.BWD_STORED_CALLS.reset()
    with _plain_launchers(mode, fwd="chain") as pl:
        out = gdr_cuda.GDRFunction.apply(*ins[:6], ins[6] if len(ins) > 6 else None)
        got = torch.autograd.grad(loss(*out), ins)
    assert pl.calls == CHAIN_CALLS[mode]
    assert gdr.BWD_STORED_CALLS.n == (mode == "stored")
    for name, g, ref in zip(("dq", "dk", "dv", "dbeta", "dalpha", "ds0", "deta"),
                            got, want):
        assert g.dtype == ref.dtype and g.shape == ref.shape, name
        torch.testing.assert_close(g, ref, rtol=1e-4, atol=1e-5, msg=name)


def test_chain_without_grad_is_one_residual_free_launch():
    """Without a gradient to take, chain mode launches the chain kernel once
    without S_{t-1}, in every backward mode; its output is gdr_chunked's."""
    args = [x.requires_grad_(True) for x in _t(_inputs(24, B=1, T=2))]
    want = gdr.gdr_chunked(*(x.detach() for x in args))
    for mode in ("stored", "fused", "recompute"):
        with _plain_launchers(mode, fwd="chain") as pl:
            with torch.no_grad():
                o, s = gdr_cuda.gdr_kernel(*args)
            with torch.inference_mode():
                gdr_cuda.gdr_kernel(*args)
        assert pl.calls == dict(_NO_CALLS, chain=2), mode
        torch.testing.assert_close(o, want[0], rtol=0, atol=0)
        torch.testing.assert_close(s, want[1], rtol=0, atol=0)


def test_fwd_mode_validation(monkeypatch):
    """GDKVM_GDR_FWD takes monolith | chain, defaults to monolith, and
    raises the JAX package's message on anything else, when a forward runs
    (gdr_pallas.py:1060-1063)."""
    monkeypatch.delenv("GDKVM_GDR_FWD", raising=False)
    assert gdr_cuda._fwd_mode() == "monolith"
    for mode in ("chain", "monolith"):
        monkeypatch.setenv("GDKVM_GDR_FWD", mode)
        assert gdr_cuda._fwd_mode() == mode
    monkeypatch.setenv("GDKVM_GDR_FWD", "Chain")
    with pytest.raises(ValueError, match="GDKVM_GDR_FWD must be chain|monolith"):
        gdr_cuda._fwd_mode()
    args = _t(_inputs(25, B=1, T=1))
    with pytest.raises(ValueError, match="GDKVM_GDR_FWD"):
        gdr_cuda.gdr_kernel(*args)
    with pytest.raises(ValueError, match="GDKVM_GDR_FWD"):
        gdr_cuda.GDRFunction.apply(*[x.requires_grad_(True) for x in args], None)


def test_chain_kernel_refuses_cpu_tensors(monkeypatch):
    """gdr_chain_cuda raises on CPU tensors instead of running gdr_chain;
    chain mode on the kernel route raises too, with nothing counted."""
    q, k, v, beta, alpha, s0 = _t(_inputs(26, B=1, T=2))
    u, w = gdr.wy_transform(k, v, beta)
    for c in (gdr_cuda.CHAIN_LAUNCHES, gdr_cuda.RESIDUAL_LAUNCHES, gdr.CHAIN_CALLS):
        c.reset()
    with pytest.raises(ValueError, match="CUDA tensors"):
        gdr_cuda.gdr_chain_cuda(q, k, u.contiguous(), w.contiguous(), alpha, s0,
                                save_states=False)
    monkeypatch.setenv("GDKVM_GDR_FWD", "chain")
    with pytest.raises(ValueError, match="CUDA tensors"):
        gdr_cuda.gdr_kernel(q, k, v, beta, alpha, s0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gdr_cuda.gdr_kernel(q.requires_grad_(True), k, v, beta, alpha, s0)
    assert (gdr_cuda.CHAIN_LAUNCHES.n, gdr_cuda.RESIDUAL_LAUNCHES.n,
            gdr.CHAIN_CALLS.n) == (0, 0, 0)


@pytest.mark.parametrize("save_states", [False, True], ids=["no_states", "states"])
def test_chain_wrapper_passes_arguments_in_order(fake_launch, save_states):
    """gdr_chain_cuda with its library faked: one C call with the pointers
    in the order of the prototype, S_{t-1} only on request, the shapes, the
    bf16 flag and the stream; one chain launch counted, and one residual
    launch when it saves S_{t-1}."""
    q, k, v, beta, alpha, s0 = _t(_inputs(29, B=2, T=3, N=5, dk=8, dv=12))
    q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
    u, w = (x.contiguous() for x in gdr.wy_transform(k, v, beta))
    o, s_t, states = gdr_cuda.gdr_chain_cuda(q, k, u, w, alpha, s0,
                                             save_states=save_states)
    [(name, args)] = fake_launch.calls
    assert name == "gdr_chain" and len(args) == 17
    assert list(args[:8]) == [x.data_ptr() for x in (q, k, u, w, alpha, s0, o, s_t)]
    assert args[8] == (states.data_ptr() if save_states else None)
    assert list(args[9:]) == [2, 2, 3, 5, 8, 12, 1, 7]
    assert o.shape == (2, 2, 3, 5, 12) and s_t.shape == (2, 2, 8, 12)
    assert (gdr_cuda.CHAIN_LAUNCHES.n, gdr_cuda.RESIDUAL_LAUNCHES.n,
            gdr_cuda.LAUNCHES.n) == (1, int(save_states), 0)


@pytest.mark.parametrize("mode", sorted(CHAIN_CALLS))
def test_model_gradients_through_chain_route(mode):
    """A narrow model on the kernel route in chain mode (launchers swapped
    for their plain versions) gets the plain chunked route's gradients, and
    its LKVA projections nonzero ones."""
    from gdkvm_tpu_torch.config.schema import ModelConfig
    from gdkvm_tpu_torch.models.gdkvm import GDKVM, init_params
    cfg = ModelConfig(enc_channels=(8, 8, 16, 16), enc_blocks=(1, 1, 1, 1),
                      num_heads=2, head_dim_k=8, head_dim_v=8,
                      kpff_channels=(8, 8), compute_dtype="float32",
                      gdr_impl="pallas")
    kernel = init_params(GDKVM(cfg, device="cpu"), torch.Generator().manual_seed(1))
    plain = GDKVM(dataclasses.replace(cfg, gdr_impl="chunked"), device="cpu")
    plain.load_state_dict(kernel.state_dict())
    frames = torch.from_numpy(np.random.default_rng(27).random(
        (2, 3, 32, 32, 1), dtype=np.float32))
    mask = torch.from_numpy(np.random.default_rng(28).integers(0, 2, (2, 32, 32)))

    def grads(model):
        logits, state = model(frames, None, mask, torch.tensor([1.0, 0.5]))
        loss = (logits ** 2).mean() + (state.mem ** 2).mean()
        return dict(zip([n for n, _ in model.named_parameters()],
                        torch.autograd.grad(loss, list(model.parameters()))))

    want = grads(plain)
    with _plain_launchers(mode, fwd="chain") as pl:
        got = grads(kernel)
    assert pl.calls == CHAIN_CALLS[mode]
    for name in ("q_proj", "k_proj", "v_proj", "beta_proj", "alpha_proj"):
        assert got[f"lkva.{name}.weight"].abs().max() > 0, name
    for name, g in want.items():
        torch.testing.assert_close(got[name], g, rtol=1e-4, atol=1e-6, msg=name)
