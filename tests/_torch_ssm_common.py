"""Shared by tests/test_torch_mamba.py and tests/test_torch_hybrid.py: the
same weights for the JAX package and the port, drawn with numpy from the
reference's specs (no JAX init to compile), every leaf away from its init's
trivial value, the (JAX model, JAX params, port model, port params)
quadruple of a smoke config, and the loss and every gradient of a smoke
model against the reference's."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import get_model as j_get_model
from repro.models.base import ParamSpec as JParamSpec
from repro_torch import configs, convert
from repro_torch.models import get_model
from repro_torch.tree import tree_flatten, tree_leaves


def numpy_params(specs, seed: int) -> dict:
    """A numpy tree shaped as ``specs`` (the reference's ParamSpecs), in each
    leaf's dtype: normals at the spec's scale (fan-in: 1/sqrt(fan-in)),
    zeros-initialised leaves (norm gains, conv bias, A_log, dt_bias) drawn
    at 0.1 (0.5 for the f32 SSM leaves), ones-initialised (D) at 1 ± 0.1,
    so no decay, gain or skip is the init's."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        z = rng.standard_normal(spec.shape).astype(np.float32)
        if spec.init == "normal":
            a = z * spec.scale
        elif spec.init == "fan_in":
            a = z / np.sqrt(spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1])
        elif spec.init == "ones":
            a = 1 + 0.1 * z
        else:
            a = z * (0.5 if spec.dtype == np.float32 else 0.1)
        return np.asarray(jax.numpy.asarray(a, spec.dtype))

    return jax.tree.map(draw, specs, is_leaf=lambda x: isinstance(x, JParamSpec))


@functools.lru_cache(maxsize=None)
def pair(arch: str, seed: int = 1):
    """(JAX model, JAX params as numpy, port model, port params) of the smoke
    config, with the same weights."""
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jm = j_get_model(jcfg)
    jp = numpy_params(jm.specs, seed)
    return jm, jp, get_model(tcfg), convert.params_from_numpy(jp, "cpu")


def check_loss_and_grads(arch: str, remat: bool, seed: int, b: int = 2, s: int = 37,
                         grad_tol: float = 1e-4) -> None:
    """The port's loss_fn and the gradient of every leaf against
    ``jax.value_and_grad`` of the reference's loss_fn, both models with
    ``remat``, on `pair`'s weights and a numpy batch of B x S tokens: the
    loss within 1e-5 relative, each leaf within ``grad_tol`` of that leaf's
    largest |g| (the tests' 1e-4 for the port against JAX: f32 sums in
    another order), and every leaf's gradient non-zero."""
    jp = pair(arch)[1]
    jm = j_get_model(dataclasses.replace(jconfigs.get_smoke(arch), remat=remat))
    tm = get_model(dataclasses.replace(configs.get_smoke(arch), remat=remat))
    toks = np.random.default_rng(seed).integers(0, tm.cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    (want, _), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    params = convert.params_from_numpy(jp, "cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    got, _ = tm.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    jl = {tuple(str(getattr(k, "key", k)) for k in p): np.asarray(v)
          for p, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    for (path, _), g in zip(tree_flatten(params), grads):
        jg = jl[tuple(str(k) for k in path)]
        assert g.shape == jg.shape, path
        scale = float(np.abs(jg).max())
        assert scale > 0 and float(g.abs().max()) > 0, path
        np.testing.assert_allclose(g.numpy(), jg, atol=grad_tol * scale, rtol=0,
                                   err_msg=str(path))
