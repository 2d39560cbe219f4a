"""The decoder LM stack, dense, MoE, SSM and hybrid (counterpart of
`repro.models`): parameters are a plain nested dict of tensors with the JAX
pytree's key paths and layouts, declared by a tree of `ParamSpec`s and drawn
by `init_params`."""
from repro_torch.models.base import (  # noqa: F401
    ParamSpec, abstract_params, count_params, init_params, param_axes, param_shapes)
from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.zoo import Model, get_model  # noqa: F401
