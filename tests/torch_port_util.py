"""Helpers shared by the port's tests: a narrow model on both sides with the
same weights (a seeded numpy fill of the flax tree, converted), and the same
settings as a port Config and a JAX Config."""

import jax
import jax.numpy as jnp
import numpy as np

from gdkvm_tpu.config import schema as jschema
from gdkvm_tpu.models.gdkvm import GDKVM as JGDKVM
from gdkvm_tpu_torch.config import schema
from gdkvm_tpu_torch.io.convert import state_dict_from_flax
from gdkvm_tpu_torch.models.gdkvm import GDKVM

NARROW = dict(enc_channels=(16, 16, 32, 32), enc_blocks=(1, 1, 1, 1),
              num_heads=2, head_dim_k=16, head_dim_v=16, kpff_channels=(16, 16),
              compute_dtype="float32", num_classes=4)
# The same model as key=value overrides of the command lines.
NARROW_OVERRIDES = [
    "model.enc_channels=[16,16,32,32]", "model.enc_blocks=[1,1,1,1]",
    "model.num_heads=2", "model.head_dim_k=16", "model.head_dim_v=16",
    "model.kpff_channels=[16,16]", "model.compute_dtype=float32",
    "model.num_classes=4"]


def seeded_params(jmodel, image: int, seed: int = 3):
    """The JAX model's param tree, shaped by jax.eval_shape (no compile),
    filled from a numpy seed: kernels N(0, 1/fan_in), biases N(0, 0.1²),
    norm scales 1 + N(0, 0.1²)."""
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 2, image, image, 1)), None, jnp.zeros((1, image, image), jnp.int32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if "kernel" in name:
            return x / np.sqrt(np.prod(leaf.shape[:-1]))
        return 1.0 + 0.1 * x if "scale" in name else 0.1 * x
    return jax.tree_util.tree_map_with_path(fill, shapes)


def model_pair(image: int, **model_kw):
    """(JAX model, its params, the port's model with the converted weights)."""
    kw = dict(NARROW, **model_kw)
    jmodel = JGDKVM(cfg=jschema.ModelConfig(**kw))
    params = seeded_params(jmodel, image)
    cfg = schema.ModelConfig(**kw)
    model = GDKVM(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params), cfg))
    return jmodel, params, model.eval()


def config_pair(data: dict, run_dir: str, stage: dict | None = None, **model_kw):
    """The same settings as the port's Config and the JAX package's."""
    kw = dict(NARROW, **model_kw)
    stage = dict(wandb_mode="disabled", **(stage or {}))
    cfg = schema.Config(model=schema.ModelConfig(**kw), data=schema.DataConfig(**data),
                        eval_stage=schema.EvalStageConfig(**stage),
                        runtime=schema.RuntimeConfig(run_dir=run_dir))
    jcfg = jschema.Config(model=jschema.ModelConfig(**kw),
                          data=jschema.DataConfig(**data),
                          eval_stage=jschema.EvalStageConfig(**stage),
                          runtime=jschema.RuntimeConfig(run_dir=run_dir + "_j"))
    return cfg, jcfg
