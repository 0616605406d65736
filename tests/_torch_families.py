"""Shared helpers of the recurrent and encoder-decoder families' parity
tests (``test_torch_rwkv6.py``, ``test_torch_hymba.py``,
``test_torch_whisper.py``): the reference's ``schema_init`` weights with
non-zero norm gains, carried across by ``params_from_numpy``; tolerance
checks; and the loss with every gradient leaf against
``jax.value_and_grad``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.common import ParamSpec, schema_init
from repro_torch.launch import steps
from repro_torch.models.common import params_from_numpy
from repro_torch.tree import tree_items


def close(got, want, rel):
    """``got`` within ``rel`` of max|want| everywhere, and finite."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def reference_params(schema, seed: int) -> dict:
    """``schema_init`` fp32 params as numpy, each all-zero leaf (the norm
    gains) given 0.1-scaled normals so every ``(1 + gamma)`` is exercised."""
    p = jax.tree.map(np.asarray, schema_init(schema, jax.random.PRNGKey(seed),
                                             jnp.float32))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a if a.any() else
                        (0.1 * rng.standard_normal(a.shape)).astype(np.float32), p)


def both(p_np):
    """The numpy params as the reference's jax arrays and the port's
    tensors (through ``params_from_numpy``)."""
    return jax.tree.map(jnp.asarray, p_np), params_from_numpy(p_np, "cpu")


def t(a):
    return torch.as_tensor(np.asarray(a))


def schema_shapes(schema) -> dict:
    """``{key path: shape}`` of a reference schema."""
    return {tuple(k.key for k in path): spec.shape for path, spec in
            jax.tree_util.tree_flatten_with_path(
                schema, is_leaf=lambda x: isinstance(x, ParamSpec))[0]}


def port_shapes(shapes) -> dict:
    return {path: shape for path, (shape, _) in tree_items(shapes)}


def port_scales(shapes) -> dict:
    return {path: scale for path, (_, scale) in tree_items(shapes)}


def schema_scales(schema) -> dict:
    return {tuple(k.key for k in path): spec.scale for path, spec in
            jax.tree_util.tree_flatten_with_path(
                schema, is_leaf=lambda x: isinstance(x, ParamSpec))[0]}


def check_loss_and_grads(ref_loss, port_loss, p_np, batch_np, loss_rel, grad_rel):
    """``ref_loss(params, batch)`` under ``jax.value_and_grad`` against
    ``port_loss`` under the port's ``steps.value_and_grad``: the loss
    within ``loss_rel``, every gradient leaf within ``grad_rel`` of its
    own max|g| (and finite, and not all zero)."""
    pj, pt = both(p_np)
    loss_r, g_r = jax.value_and_grad(ref_loss)(
        pj, {k: jnp.asarray(v) for k, v in batch_np.items()})
    loss, g = steps.value_and_grad(port_loss, pt,
                                   {k: t(v) for k, v in batch_np.items()})
    close(float(loss), float(loss_r), loss_rel)
    want = dict(tree_items(jax.tree.map(np.asarray, g_r)))
    got = dict(tree_items(g))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert np.abs(want[path]).max() > 0, path
        close(leaf.numpy(), want[path], grad_rel)
    return len(got)
