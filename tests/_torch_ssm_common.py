"""Shared by tests/test_torch_mamba.py and tests/test_torch_hybrid.py: the
same weights for the JAX package and the port, drawn with numpy from the
reference's specs (no JAX init to compile), every leaf away from its init's
trivial value, and the (JAX model, JAX params, port model, port params)
quadruple of a smoke config."""
import functools

import jax
import numpy as np

from repro import configs as jconfigs
from repro.models import get_model as j_get_model
from repro.models.base import ParamSpec as JParamSpec
from repro_torch import configs, convert
from repro_torch.models import get_model


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
