"""The port's logical-axis rules engine (`repro_torch.distributed.sharding`)
against the reference's (`repro.distributed.sharding`).

The rules engine is pure, so every one of the reference's ten configs
counts, the six families the port does not carry yet included: for each
config (full and smoke) and each mesh's axis sizes, the port's `resolve`
on every leaf of the JAX model's `param_axes` and of `zero1_axes` of them
equals the reference's `_resolve`, under the config's merged rules and
under the sign-majority mode's `strip_dp` rules. The four dense configs'
own specs carry the reference's axes and overrides letter for letter."""
import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.distributed import sharding as jsharding
from repro.models import get_model as j_get_model
from repro.models.base import param_axes as j_param_axes, param_shapes as j_param_shapes
from repro.train import loop as jloop, optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding
from repro_torch.models import get_model, param_axes

SIZES = {"1x1": {"data": 1, "model": 1}, "1x2": {"data": 1, "model": 2},
         "2x1": {"data": 2, "model": 1}, "2x2": {"data": 2, "model": 2},
         "4x2": {"data": 4, "model": 2}, "2x4": {"data": 2, "model": 4},
         "16x16": {"data": 16, "model": 16},
         "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def _leaves(cfg):
    """(path, logical axes, zero1 axes, shape) over the JAX model's leaves."""
    specs = j_get_model(cfg).specs
    axes = j_param_axes(specs)
    z = jopt.zero1_axes(axes)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t, is_leaf=_is_axes)[0]  # noqa: E731
    shapes = [s.shape for _, s in jax.tree_util.tree_flatten_with_path(
        j_param_shapes(specs))[0]]
    return [(jax.tree_util.keystr(p), a, zz, s)
            for (p, a), (_, zz), s in zip(flat(axes), flat(z), shapes)]


@pytest.fixture(scope="module")
def leaves():
    cache = {}

    def get(arch, smoke):
        if (arch, smoke) not in cache:
            cfg = jconfigs.get_smoke(arch) if smoke else jconfigs.get_config(arch)
            cache[(arch, smoke)] = (cfg, _leaves(cfg))
        return cache[(arch, smoke)]

    return get


@pytest.mark.parametrize("sizes", SIZES, ids=str)
@pytest.mark.parametrize("mode", ["merged", "strip_dp"])
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_resolve_equals_the_reference(leaves, arch, smoke, mode, sizes):
    cfg, rows = leaves(arch, smoke)
    jrules = jloop.merged_rules(cfg)
    rules = sharding.merged_rules(cfg)
    assert rules == jrules
    if mode == "strip_dp":
        jrules, rules = jloop._strip_dp(jrules), sharding.strip_dp(rules)
        assert rules == jrules
    ax = SIZES[sizes]
    assert rows
    for path, axes, zaxes, shape in rows:
        for a in (axes, zaxes):
            want = jsharding._resolve(a, jrules, shape, ax)
            assert P(*sharding.resolve(a, shape, ax, rules)) == want, (path, a, shape)
            assert sharding.resolve(a, None, None, rules) == tuple(
                jsharding._resolve(a, jrules, None, None)), (path, a)
        assert sharding.zero1_axes({"x": axes})["x"] == zaxes, path


@pytest.mark.parametrize("arch", tconfigs.DENSE)
def test_dense_specs_carry_the_reference_axes_and_overrides(arch):
    for get in ("get_config", "get_smoke"):
        jcfg, tcfg = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert dict(tcfg.rules_override) == dict(jcfg.rules_override)
        want = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_flatten_with_path(
            j_param_axes(j_get_model(jcfg).specs), is_leaf=_is_axes)[0]}
        got = param_axes(get_model(tcfg).specs)
        flat = {}

        def walk(t, prefix):
            for k, v in t.items():
                if isinstance(v, dict):
                    walk(v, prefix + [k])
                else:
                    flat["".join(f"['{x}']" for x in prefix + [k])] = v
        walk(got, [])
        assert flat == want


def test_resolve_drops_what_the_reference_drops():
    """Spot checks of the engine's rules: a non-dividing axis, an axis used
    twice, an absent axis, the opt-in uneven split, trailing Nones."""
    r = dict(sharding.DEFAULT_RULES)
    assert sharding.resolve(("embed", "heads", "head_dim"), (960, 15, 64),
                            {"data": 1, "model": 2}, r) == ()
    assert sharding.resolve(("batch", "embed"), (8, 64), {"data": 2, "model": 1},
                            r | {"embed": "data"}) == ("data",)
    assert sharding.resolve(("batch",), (8,), {"data": 2, "model": 1}, r) == ("data",)
    assert sharding.resolve(("heads",), (15,), {"model": 4}, r | {"__uneven__": ("heads",)}
                            ) == ("model",)
    with pytest.raises(KeyError):
        sharding.resolve(("nope",), (4,), {"model": 2}, r)
