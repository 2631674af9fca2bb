"""The decoupled erase gate (η ≠ β): the port's plain GDR math against the
JAX package's ``*_ew_bh`` functions, values and gradients, and the ``gdn2``
model against the JAX model on converted weights.  CPU, fp32.

Inputs are made with numpy from a seed and go to both frameworks; the
Pallas kernel runs in interpret mode, as in tests/test_gdr_pallas.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdkvm_tpu.config import schema as jschema
from gdkvm_tpu.core import gdr as jgdr
from gdkvm_tpu.models.gdkvm import GDKVM as JGDKVM
from gdkvm_tpu.ops import gdr_pallas
from gdkvm_tpu_torch.config.schema import ModelConfig
from gdkvm_tpu_torch.core import gdr
from gdkvm_tpu_torch.io.convert import state_dict_from_flax
from gdkvm_tpu_torch.models.gdkvm import GDKVM, init_params

torch.set_num_threads(1)

NAMES = ("q", "k", "v", "beta", "alpha", "s0", "eta")


def _inputs(seed=0, b=1, h=2, t=3, n=7, dk=16, dv=16):
    """q, k, v, beta, alpha, s0, eta as numpy fp32: unit-norm keys, gates in
    (0, 1), α near 1, η drawn apart from β."""
    rng = np.random.default_rng(seed)
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))
    q = rng.standard_normal((b, h, t, n, dk))
    k = rng.standard_normal((b, h, t, n, dk))
    k /= np.linalg.norm(k, axis=-1, keepdims=True) + 1e-6
    v = rng.standard_normal((b, h, t, n, dv))
    beta = sig(rng.standard_normal((b, h, t, n)))
    alpha = sig(rng.standard_normal((b, h, t)) + 2.0)
    s0 = 0.1 * rng.standard_normal((b, h, dk, dv))
    eta = sig(rng.standard_normal((b, h, t, n)))
    return tuple(x.astype(np.float32) for x in (q, k, v, beta, alpha, s0, eta))


def _close(got, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max(), err_msg=name)


JAX_FNS = {"ref": jgdr.gdr_ref_ew_bh, "chunked": jgdr.gdr_chunked_ew_bh,
           "pallas": gdr_pallas.gdr_pallas_ew_bh}
PORT_FNS = {"ref": gdr.gdr_ref, "chunked": gdr.gdr_chunked,
            "residuals": lambda *a: gdr.gdr_chunked_residuals(*a)[:2]}


@pytest.mark.parametrize("jax_fn", sorted(JAX_FNS))
@pytest.mark.parametrize("port_fn", sorted(PORT_FNS))
def test_decoupled_values_match_jax(port_fn, jax_fn):
    """gdr_ref, gdr_chunked and gdr_chunked_residuals with η ≠ β against
    JAX's token scan, chunked form and Pallas kernel (interpret mode)."""
    args = _inputs(0)
    o_j, s_j = JAX_FNS[jax_fn](*map(jnp.asarray, args))
    o, s = PORT_FNS[port_fn](*map(torch.from_numpy, args))
    _close(o, o_j, "o")
    _close(s, s_j, "s_T")
    # The gates are decoupled for real: the coupled rule gives other values.
    o_c, _ = gdr.gdr_chunked(*map(torch.from_numpy, args[:6]))
    assert (o_c - o).abs().max() > 1e-3


def _jax_grads(fn, args, w_o, w_s):
    loss = lambda *a: (jnp.sum(fn(*a)[0] * w_o) + jnp.sum(fn(*a)[1] * w_s))
    return jax.grad(loss, argnums=tuple(range(7)))(*map(jnp.asarray, args))


@pytest.fixture(scope="module")
def grad_case():
    args = _inputs(1)
    rng = np.random.default_rng(2)
    w_o = rng.standard_normal(args[2].shape).astype(np.float32)
    w_s = rng.standard_normal(args[5].shape).astype(np.float32)
    return args, w_o, w_s


@pytest.mark.parametrize("jax_fn", ["ref", "chunked"])
@pytest.mark.parametrize("port_fn", ["ref", "chunked"])
def test_decoupled_autograd_matches_jax(grad_case, port_fn, jax_fn):
    """Autograd through the port's plain forward, all seven inputs, against
    jax.grad of the JAX scan."""
    args, w_o, w_s = grad_case
    want = _jax_grads(JAX_FNS[jax_fn], args, w_o, w_s)
    ins = [torch.from_numpy(x).requires_grad_(True) for x in args]
    o, s = PORT_FNS[port_fn](*ins)
    got = torch.autograd.grad((o * torch.from_numpy(w_o)).sum()
                              + (s * torch.from_numpy(w_s)).sum(), ins)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, f"d{name}")


@pytest.mark.parametrize("which", ["bwd_ref", "bwd_stored"])
def test_decoupled_backward_matches_jax(grad_case, which):
    """gdr_bwd_ref (the backward kernel's plain version) and gdr_bwd_stored
    from gdr_chunked_residuals' checkpoints, with η ≠ β, against jax.grad
    of the token scan."""
    args, w_o, w_s = grad_case
    want = dict(zip(NAMES, _jax_grads(jgdr.gdr_ref_ew_bh, args, w_o, w_s)))
    q, k, v, beta, alpha, s0, eta = map(torch.from_numpy, args)
    _, _, states, u, w = gdr.gdr_chunked_residuals(q, k, v, beta, alpha, s0, eta)
    do, ds_t = torch.from_numpy(w_o), torch.from_numpy(w_s)
    if which == "bwd_ref":
        got = gdr.gdr_bwd_ref(q, k, v, beta, eta, alpha, states, do, ds_t)
    else:
        got = gdr.gdr_bwd_stored(q, k, v, beta, eta, alpha, states, u, w, do, ds_t)
    for name, g in zip(("q", "k", "v", "beta", "eta", "alpha", "s0"), got):
        _close(g, want[name], f"d{name}")


def test_decoupled_gradient_matches_pallas_interpret(grad_case, monkeypatch):
    """The same gradients against jax.grad through the Pallas kernel's own
    backward (stored mode, interpret)."""
    monkeypatch.setenv("GDKVM_GDR_BWD", "stored")
    args, w_o, w_s = grad_case
    want = _jax_grads(gdr_pallas.gdr_pallas_ew_bh, args, w_o, w_s)
    ins = [torch.from_numpy(x).requires_grad_(True) for x in args]
    o, s = gdr.gdr_chunked(*ins)
    got = torch.autograd.grad((o * torch.from_numpy(w_o)).sum()
                              + (s * torch.from_numpy(w_s)).sum(), ins)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, f"d{name}")


# ------------------------------------------------------------------ model

NARROW = dict(enc_channels=(16, 16, 32, 32), enc_blocks=(1, 1, 1, 1),
              num_heads=2, head_dim_k=16, head_dim_v=16, kpff_channels=(16, 16),
              compute_dtype="float32", gdr_variant="gdn2")
IMAGE, B, T = 32, 2, 3
RTOL, ATOL = 1e-4, 1e-4      # the bars of tests/test_torch_model.py


def _seeded_params(jmodel):
    """The JAX model's param tree, shaped by jax.eval_shape (no compile),
    filled from a numpy seed: kernels N(0, 1/fan_in), biases N(0, 0.1²),
    norm scales 1 + N(0, 0.1²); so η's projection differs from β's."""
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 2, IMAGE, IMAGE, 1)), None, jnp.zeros((1, IMAGE, IMAGE), jnp.int32))
    rng = np.random.default_rng(3)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if "kernel" in name:
            return x / np.sqrt(np.prod(leaf.shape[:-1]))
        return 1.0 + 0.1 * x if "scale" in name else 0.1 * x
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def pair():
    jmodel = JGDKVM(cfg=jschema.ModelConfig(**NARROW))
    params = _seeded_params(jmodel)
    cfg = ModelConfig(**NARROW)
    model = GDKVM(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params), cfg))
    return jmodel, params, cfg, model.eval()


def _frames(seed, b=B, t=T):
    return np.random.default_rng(seed).random((b, t, IMAGE, IMAGE, 1), dtype=np.float32)


@pytest.mark.parametrize("impl", ["chunked", "ref", "auto"])
def test_gdn2_model_matches_jax(pair, impl):
    """Logits and carried state of the gdn2 model, prompted, from a nonzero
    state, under each gdr_impl the port runs on the CPU."""
    jmodel, params, cfg, model = pair
    port = GDKVM(dataclasses.replace(cfg, gdr_impl=impl), device="cpu")
    port.load_state_dict(model.state_dict())
    x, x0 = _frames(1), _frames(2)
    mask = np.random.default_rng(4).integers(0, 2, (B, IMAGE, IMAGE)).astype(np.int32)
    weight = np.array([1.0, 0.3], np.float32)
    apply = jax.jit(jmodel.apply)
    _, state0_j = apply(params, jnp.asarray(x0))
    logits_j, state_j = apply(params, jnp.asarray(x), state0_j,
                              jnp.asarray(mask), jnp.asarray(weight))
    with torch.no_grad():
        _, state0 = port(torch.from_numpy(x0))
        logits, state = port(torch.from_numpy(x), state0, torch.from_numpy(mask),
                             torch.from_numpy(weight))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(state.mem.numpy(), np.asarray(state_j.mem),
                               rtol=RTOL, atol=ATOL)


def test_gdn2_eta_changes_the_output(pair):
    """The gdn2 model reads its η projection: zeroing it moves the logits,
    and the gdn model has no such parameter."""
    _, _, cfg, model = pair
    x = torch.from_numpy(_frames(5))
    other = GDKVM(cfg, device="cpu")
    other.load_state_dict(model.state_dict())
    with torch.no_grad():
        other.lkva.eta_proj.weight.zero_()
        a, _ = model(x)
        b, _ = other(x)
    assert (a - b).abs().max() > 1e-4
    gdn = GDKVM(dataclasses.replace(cfg, gdr_variant="gdn"), device="cpu")
    assert not hasattr(gdn.lkva, "eta_proj")
    with pytest.raises(ValueError, match="gdn|gdn2"):
        GDKVM(dataclasses.replace(cfg, gdr_variant="gdn3"), device="cpu")


def test_gdn2_gradients_match_jax(pair):
    """Gradients of a loss on logits and state for every parameter, the
    JAX gradient tree carried over by the weight converter."""
    jmodel, params, cfg, model = pair
    x = _frames(6, b=1, t=2)
    rng = np.random.default_rng(7)
    w = rng.standard_normal((1, 2, IMAGE, IMAGE, 2)).astype(np.float32)

    def loss_j(p):
        logits, state = jmodel.apply(p, jnp.asarray(x))
        return jnp.sum(logits * w) + jnp.sum(state.mem ** 2)

    want = state_dict_from_flax(jax.tree.map(np.asarray, jax.jit(jax.grad(loss_j))(params)), cfg)
    model.zero_grad()
    logits, state = model(torch.from_numpy(x))
    ((logits * torch.from_numpy(w)).sum() + (state.mem ** 2).sum()).backward()
    for name, p in model.named_parameters():
        wnt = want[name].numpy()
        if p.grad is None:                     # the prompt's projection: unused
            assert name == "lkva.mask_proj.weight" and not wnt.any()
            continue
        g = p.grad.numpy()
        np.testing.assert_allclose(g, wnt, rtol=1e-3, atol=1e-3 * np.abs(wnt).max() + 1e-6,
                                   err_msg=name)
    assert model.lkva.eta_proj.weight.grad.abs().max() > 0


def test_gdn2_init_params():
    """init_params gives the η projection β's bias of −1, and a gdn model's
    weights from the same seed are unchanged by the variant's existence."""
    cfg = ModelConfig(**NARROW)
    m = init_params(GDKVM(cfg, device="cpu"), torch.Generator().manual_seed(0))
    assert torch.all(m.lkva.eta_proj.bias == -1) and torch.all(m.lkva.beta_proj.bias == -1)
    assert m.lkva.eta_proj.weight.abs().max() > 0
