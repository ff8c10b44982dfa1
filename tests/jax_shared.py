"""JAX reference runs that more than one of the port's test files needs,
computed once a test run.

The Tier-1 run spreads the test files over pytest-xdist worker processes,
and a JAX program compiled in one is compiled again in the next. A value
here is computed by the first file that asks for it and written, pickled,
to the run's own directory (the parent of each worker's base temp, which
pytest creates and prunes; the base temp itself without xdist), under a
file lock: a file that asks while another computes waits, then loads.
Only this module writes those files.

``module_step`` is the JAX module train step at 32^2, batch 2, 2 residual
blocks, base 8, SOFT_TISSUE, fp32 from ``create_state(PRNGKey(0))`` on
``batch(0)``: tests/test_torch_train.py and tests/test_torch_packed_engine.py
both hold the port's step against it.
"""
import fcntl
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np

from ducosy_tpu.config import ModelConfig, SOFT_TISSUE, TrainConfig, replace
from ducosy_tpu.losses.suite import discriminator_loss as jax_d_loss
from ducosy_tpu.losses.suite import generator_loss as jax_g_loss
from ducosy_tpu.train import create_state as jax_create_state
from ducosy_tpu.train import make_train_step as jax_make_train_step
from ducosy_tpu.train.step import _forward_all as jax_forward_all
from ducosy_tpu_torch.models.convert import (
    cyclegan_state_dicts_from_jax,
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
)

IMG, BATCH = 32, 2
CFG = replace(TrainConfig(), img_size=IMG, batch_size=BATCH,
              compute_dtype="float32")
MODEL = ModelConfig(num_residual_blocks=2, base_channels=8,
                    disc_base_channels=8)

_memo: dict = {}


def batch(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    return {"a": rng.uniform(-1, 1, (n, IMG, IMG, 1)).astype(np.float32),
            "b": rng.uniform(-1, 1, (n, IMG, IMG, 1)).astype(np.float32),
            "masks": rng.integers(0, 2, (n, IMG, IMG, 2)).astype(np.float32)}


def _run_dir(tmp_path_factory) -> str:
    base = tmp_path_factory.getbasetemp()
    return str(base.parent if os.environ.get("PYTEST_XDIST_WORKER")
               else base)


def shared(tmp_path_factory, name: str, compute):
    """``compute()`` once a test run (a tree of numpy arrays and floats)."""
    if name not in _memo:
        path = os.path.join(_run_dir(tmp_path_factory), f"jax_{name}.pkl")
        with open(path + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        _memo[name] = pickle.load(f)
                else:
                    _memo[name] = compute()
                    with open(path + ".tmp", "wb") as f:
                        pickle.dump(_memo[name], f)
                    os.replace(path + ".tmp", path)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    return _memo[name]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _module_step():
    state, gen, disc = jax_create_state(jax.random.PRNGKey(0), CFG,
                                        SOFT_TISSUE, MODEL, img_size=IMG)
    host = batch(0)
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    step = jax_make_train_step(gen, disc, CFG, donate=False, remat=False,
                               gen_forward="module")
    new_state, metrics = step(state, jb)

    def g_loss(g_params):
        fwd = jax_forward_all(lambda p, x: gen.apply({"params": p}, x),
                              g_params["a2b"], g_params["b2a"], jb)
        fake_a, fake_b, id_a, id_b, rec_a, rec_b = fwd
        terms = jax_g_loss(
            real_a=jb["a"], real_b=jb["b"], fake_a=fake_a, fake_b=fake_b,
            rec_a=rec_a, rec_b=rec_b, id_a=id_a, id_b=id_b,
            d_a_fake_logits=disc.apply({"params": state.params_d_a}, fake_a),
            d_b_fake_logits=disc.apply({"params": state.params_d_b}, fake_b),
            cfg=CFG)
        return terms.total, (fake_a, fake_b)

    (_, (fake_a, fake_b)), g_grads = jax.jit(jax.value_and_grad(
        g_loss, has_aux=True))({"a2b": state.params_g_a2b,
                                "b2a": state.params_g_b2a})
    d_grad = jax.jit(jax.grad(lambda p, real, fake: jax_d_loss(
        disc.apply({"params": p}, real), disc.apply({"params": p}, fake))))
    grads = {"g_a2b": generator_state_dict_from_jax(_np_tree(g_grads["a2b"])),
             "g_b2a": generator_state_dict_from_jax(_np_tree(g_grads["b2a"])),
             "d_a": discriminator_state_dict_from_jax(_np_tree(
                 d_grad(state.params_d_a, jb["a"], fake_a))),
             "d_b": discriminator_state_dict_from_jax(_np_tree(
                 d_grad(state.params_d_b, jb["b"], fake_b)))}
    return dict(init=cyclegan_state_dicts_from_jax(_np_tree(state)),
                new=cyclegan_state_dicts_from_jax(_np_tree(new_state)),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=grads, batch=host)


def module_step(tmp_path_factory) -> dict:
    """The JAX module step's init, updated state, metrics and gradients
    (every network's, as the port's state dicts) and its batch."""
    return shared(tmp_path_factory, "module_step", _module_step)
