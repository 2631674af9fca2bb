"""``gdr_assoc`` in the port (gdkvm_tpu_torch/core/gdr.py): the GDR as a
log-depth scan of affine maps, against the JAX package's ``gdr_assoc_bh``
and ``gdr_assoc_ew_bh`` (values), the port's ``gdr_chunked`` (gradients by
autograd), and a ``gdr_impl="assoc"`` model against JAX's on converted
weights.  CPU, fp32, numpy-seeded inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdkvm_tpu.core import gdr as jgdr
from gdkvm_tpu_torch.core import gdr
from torch_port_util import model_pair

torch.set_num_threads(1)
RTOL = 1e-5


def _inputs(seed, b=2, h=2, t=5, n=7, dk=16, dv=8):
    """q, k, v, beta, alpha, s0, eta as numpy fp32: unit-norm keys, gates in
    (0, 1), α near 1."""
    rng = np.random.default_rng(seed)
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))
    k = rng.standard_normal((b, h, t, n, dk))
    k /= np.linalg.norm(k, axis=-1, keepdims=True) + 1e-6
    out = (rng.standard_normal((b, h, t, n, dk)), k, rng.standard_normal((b, h, t, n, dv)),
           sig(rng.standard_normal((b, h, t, n))), sig(rng.standard_normal((b, h, t)) + 2.0),
           0.1 * rng.standard_normal((b, h, dk, dv)), sig(rng.standard_normal((b, h, t, n))))
    return tuple(x.astype(np.float32) for x in out)


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("t", [1, 5, 8, 13])
@pytest.mark.parametrize("coupled", [True, False], ids=["gdn", "gdn2"])
def test_port_assoc_values_match_jax(coupled, t):
    """o and s_T against JAX's gdr_assoc (η = β) and its η form, at T a
    power of two, one less than it, one more, and 1."""
    args = _inputs(t, t=t)
    args = args[:6] if coupled else args
    jfn = jgdr.gdr_assoc_bh if coupled else jgdr.gdr_assoc_ew_bh
    o_j, s_j = jfn(*map(jnp.asarray, args))
    o, s = gdr.gdr_assoc(*map(torch.from_numpy, args))
    _close(o, o_j, "o")
    _close(s, s_j, "s_T")


@pytest.mark.parametrize("coupled", [True, False], ids=["gdn", "gdn2"])
def test_port_assoc_matches_chunked_over_a_long_clip(coupled):
    """T = 37 frames: the prefix products stay bounded and equal the
    chunked scan's states."""
    args = tuple(map(torch.from_numpy, _inputs(3, b=1, t=37)))
    args = args[:6] if coupled else args
    o, s = gdr.gdr_assoc(*args)
    o_c, s_c = gdr.gdr_chunked(*args)
    _close(o.numpy(), o_c.numpy(), "o")
    _close(s.numpy(), s_c.numpy(), "s_T")


@pytest.mark.parametrize("coupled", [True, False], ids=["gdn", "gdn2"])
def test_port_assoc_gradients_match_the_chunked_form(coupled):
    """Autograd through the log-depth scan against autograd through the
    chunked form, every input's gradient."""
    args = _inputs(4, t=6)
    args = args[:6] if coupled else args
    grads = {}
    for name, fn in (("assoc", gdr.gdr_assoc), ("chunked", gdr.gdr_chunked)):
        xs = [torch.from_numpy(a).requires_grad_(True) for a in args]
        o, s = fn(*xs)
        wo = torch.from_numpy(np.random.default_rng(5).standard_normal(o.shape).astype(np.float32))
        ws = torch.from_numpy(np.random.default_rng(6).standard_normal(s.shape).astype(np.float32))
        ((o * wo).sum() + (s * ws).sum()).backward()
        grads[name] = [x.grad.numpy() for x in xs]
    for i, (g, g_c) in enumerate(zip(grads["assoc"], grads["chunked"])):
        _close(g, g_c, f"grad {i}")


@pytest.mark.parametrize("variant", ["gdn", "gdn2"])
def test_port_assoc_model_matches_jax(variant):
    """A ``gdr_impl="assoc"`` model against JAX's on converted weights:
    logits and state of two carried chunks."""
    jmodel, params, model = model_pair(32, gdr_impl="assoc", gdr_variant=variant)
    frames = np.random.default_rng(7).random((2, 2, 3, 32, 32, 1)).astype(np.float32)
    apply = jax.jit(jmodel.apply)
    state_j, state = None, None
    for chunk in frames:
        logits_j, state_j = (apply(params, jnp.asarray(chunk)) if state_j is None
                             else apply(params, jnp.asarray(chunk), state_j))
        with torch.no_grad():
            logits, state = model(torch.from_numpy(chunk), state)
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(state.mem.numpy(), np.asarray(state_j.mem),
                                   rtol=1e-4, atol=1e-5)
