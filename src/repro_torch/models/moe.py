"""Mixture-of-Experts block (counterpart of `repro/models/moe.py`): grouped,
capacity-based, sort-free dispatch.

GShard/MaxText-style "dropping": the B*S tokens are cut into G dispatch
groups of Tg tokens (the largest divisor of B*S at most ``group_size``),
b-major across the batch rows as ``x.reshape(G, Tg, d)`` cuts them. Within a
group each token's top-k experts (ties to the lower expert index, as
``jax.lax.top_k`` orders them; ``torch.topk`` promises no order among equal
values) are given slots by a slot-major priority cumsum: slot 0 of every
token outranks slot 1. An assignment at position >= C of its expert drops
to the residual path.

Dispatch and combine are dense products over a [G, Tg, E, C] tensor, as in
the reference, which computes them outside any Pallas kernel: cuBLAS here
(`torch.bmm`). The combine weights are scattered into place (each token
holds at most one slot of an expert, so the scatter writes what the
reference's one-hot einsum sums). The expert products accumulate in f32 and
``act(hg) * hu`` is formed in f32 before the cast, as the reference's
``preferred_element_type`` einsums give them (`_bmm_acc`); the dispatch,
the down projection and the combine round their f32 sums to the model's
dtype once, as the reference's ``.astype`` does.

The steps are separate functions (`route`, `combine_weights`, `dispatch`,
`experts`, `combine`), which `apply` runs in order.

Across ranks (``tp``, training) the groups ride the data ranks and the
experts the model ranks, as the reference's GSPMD places its einsums. x is
whole on every model rank, so a rank dispatches its groups to its own
experts locally and the combine, a contraction over the experts, is a sum
over the model group (`collectives.reduce_from_group`): no all-to-all.
With the experts cut (Kimi-K2) the router's expert columns are cut too and
its logits are gathered over the model group before the softmax; with the
expert MLP cut instead (Mixtral's ``expert_mlp: model``) every rank holds
every expert's slice of the hidden width, and the combine's partial sums
are reduced alike. The load-balancing aux takes its means over the global
tokens (averaged over the data ranks before the product), and each data
rank counts 1/D of it, so the data ranks' shares sum to the reference's.
Tg comes from the global token count; a group that would straddle two data
ranks raises.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import collectives
from repro_torch.models.base import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import act_fn


def moe_specs(cfg: ModelConfig, layers: int | None = None) -> dict:
    m = cfg.moe
    l = cfg.n_layers if layers is None else layers
    d, f, e = cfg.d_model, m.d_expert, m.n_experts
    lead = () if l == 0 else (l,)
    la = () if l == 0 else (None,)
    specs = {
        "router": ParamSpec(lead + (d, e), la + ("embed", "experts"), "fan_in",
                            dtype=torch.float32),
        "wg": ParamSpec(lead + (e, d, f), la + ("experts", "embed", "expert_mlp"), "fan_in",
                        dtype=cfg.dtype),
        "wu": ParamSpec(lead + (e, d, f), la + ("experts", "embed", "expert_mlp"), "fan_in",
                        dtype=cfg.dtype),
        "wd": ParamSpec(lead + (e, f, d), la + ("experts", "expert_mlp", "embed"), "fan_in",
                        dtype=cfg.dtype),
    }
    if m.n_shared:
        fs = m.d_expert * m.n_shared
        specs["shared"] = {
            "wg": ParamSpec(lead + (d, fs), la + ("embed", "mlp"), "fan_in", dtype=cfg.dtype),
            "wu": ParamSpec(lead + (d, fs), la + ("embed", "mlp"), "fan_in", dtype=cfg.dtype),
            "wd": ParamSpec(lead + (fs, d), la + ("mlp", "embed"), "fan_in", dtype=cfg.dtype),
        }
    return specs


def _capacity(tg: int, k: int, e: int, factor: float) -> int:
    c = math.ceil(tg * k / e * factor)
    return max(4, ((c + 3) // 4) * 4)


def group_tokens(t: int, group_size: int) -> int:
    """Tg: the largest divisor of the t tokens that is at most group_size."""
    tg = min(group_size, t)
    while t % tg:
        tg -= 1
    return tg


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The type products accumulate in: f32, or f64 for f64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def _bmm_acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, M, K] @ b [N, K, P], summed and returned in `_acc` of their
    dtype (the reference's ``preferred_element_type=f32``): bf16 operands
    on the card write f32 through cuBLAS (``out_dtype``); on the CPU, and
    wherever autograd records (``bmm`` with ``out_dtype`` has no
    derivative), they are widened first, which sums the same exact products
    in f32 and gives the reference's gradients, each cast back to its
    operand's dtype."""
    acc = _acc(a.dtype)
    if a.dtype == acc:
        return torch.bmm(a, b)
    records = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if a.is_cuda and not records:
        return torch.bmm(a, b, out_dtype=acc)
    return torch.bmm(a.to(acc), b.to(acc))


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """One-hot of int64 `idx` over a new last axis of n, by scatter (no
    check of the indices, so nothing is read back to the host)."""
    out = torch.zeros(idx.shape + (n,), dtype=dtype, device=idx.device)
    return out.scatter_(-1, idx[..., None], 1)


@dataclasses.dataclass
class Routing:
    """One MoE call's routing over G groups of Tg tokens: ``probs`` [G, Tg, E]
    (f32; f64 for f64 inputs), each token's experts ``idx`` [G, Tg, K] in
    rank order, their normalised ``gate`` [G, Tg, K], each assignment's
    position ``pos`` [G, Tg, K] in its expert's queue and whether it is
    kept (``keep``, pos < capacity), and the ``capacity`` C."""

    probs: torch.Tensor
    idx: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


def route(router: torch.Tensor, cfg: ModelConfig, xg: torch.Tensor, group=None) -> Routing:
    """The router and the priority slot assignment of xg [G, Tg, d]: logits
    and softmax in f32, the top-k with ties to the lower expert index (a
    stable descending sort), the gates normalised by max(sum, 1e-9), and
    the slot-major cumsum (``moe.py:83-91`` of the reference). With
    ``group`` the router holds this rank's expert columns, and the logits
    are gathered over the group (the gradient reduce-scattered back)."""
    m = cfg.moe
    g, tg, _ = xg.shape
    e, k = m.n_experts, m.top_k
    acc = _acc(xg.dtype)
    logits = collectives.gather_from_group(torch.matmul(xg.to(acc), router.to(acc)), -1, group)
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    gate = probs.gather(-1, idx)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    # slot-major: every token's first choice, then every token's second, ...
    idx_sm = idx.transpose(1, 2).reshape(g, k * tg)
    oh = _one_hot(idx_sm, e, torch.int32)                          # [G, K*Tg, E]
    pos = (torch.cumsum(oh, dim=1) - oh).gather(-1, idx_sm[..., None])[..., 0]
    pos = pos.reshape(g, k, tg).transpose(1, 2).long()             # [G, Tg, K]
    c = _capacity(tg, k, e, m.capacity_factor)
    return Routing(probs, idx, gate, pos, pos < c, c)


def combine_weights(r: Routing, dtype: torch.dtype) -> torch.Tensor:
    """combine [G, Tg, E*C]: at (e, c) the gate (cast to ``dtype``) of the
    token's kept assignment to slot c of expert e, else 0. A dropped
    assignment writes 0 at slot C-1 of its own expert in its own row, where
    nothing else of that row writes."""
    g, tg, _ = r.idx.shape
    e, c = r.probs.shape[-1], r.capacity
    slot = r.idx * c + r.pos.clamp_max(c - 1)
    gatek = (r.gate * r.keep).to(dtype)
    out = torch.zeros((g, tg, e * c), dtype=dtype, device=gatek.device)
    return out.scatter(-1, slot, gatek)


def dispatch(xg: torch.Tensor, comb: torch.Tensor) -> torch.Tensor:
    """xe [G, E*C, d]: each slot's token (zeros in an empty slot), by the
    one-hot product with ``combine > 0``."""
    return torch.bmm((comb > 0).to(comb.dtype).transpose(1, 2), xg)


def experts(p: dict, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """ye [E, N, d] of xe [E, N, d] (N = G*C rows an expert): the gate and up
    products summed in f32, ``act(hg) * hu`` in f32, cast, then the down
    product."""
    hg = _bmm_acc(xe, p["wg"])
    hu = _bmm_acc(xe, p["wu"])
    hidden = (act_fn(cfg.act)(hg) * hu).to(xe.dtype)
    return torch.bmm(hidden, p["wd"])


def combine(comb: torch.Tensor, ye: torch.Tensor) -> torch.Tensor:
    """out [G, Tg, d]: each token's kept slots' outputs weighted by their
    gates."""
    return torch.bmm(comb, ye)


def data_ranks(tp) -> int:
    """The data ranks the rows are cut over (1 without ``tp``):
    ``tp.data_groups`` holds only the data axes a rank's rows are really
    cut over, so a batch whole on every data rank (the B = 1 of a
    long-context decode) counts 1, and its tokens are not multiplied."""
    return math.prod(collectives.ranks(g) for g in tp.data_groups) if tp is not None else 1


def apply(p: dict, cfg: ModelConfig, x: torch.Tensor, tp=None,
          group_size: int | None = None):
    """x [B, S, d] -> (out [B, S, d], aux load-balancing loss, a scalar in
    f32): ``router_aux_coef * E * sum(frac * pmean)``, frac the share of the
    tokens whose first choice is each expert. ``group_size`` overrides the
    config's (1 routes every token as a group of its own). With ``tp`` (a
    `collectives.TensorParallel`) x is this data rank's rows, the weights
    are the rank's shards, and aux is this data rank's share (1/D) of the
    global batch's. A dispatch group that straddles data ranks (a decode's
    B tokens in one group) is refused in training; at inference
    (``tp.infer``) the rows are gathered whole over the data ranks, routed
    as one rank routes them (the same groups, the same capacity drops), and
    each rank keeps its own rows."""
    m = cfg.moe
    b, s, d = x.shape
    n_data = data_ranks(tp)
    t = b * s * n_data
    tg = group_tokens(t, m.group_size if group_size is None else group_size)
    if (b * s) % tg and tp.infer:
        whole = x
        for grp in reversed(tp.data_groups):        # the inner axis first: global row order
            whole = collectives.all_gather_dim(whole, 0, grp)
        out, aux = apply(p, cfg, whole, dataclasses.replace(tp, data_groups=(), data_index=0),
                         group_size)
        return out.narrow(0, tp.data_index * b, b), aux / n_data
    if (b * s) % tg:
        raise ValueError(
            f"{cfg.name}: the global batch's {t} tokens ({b * n_data} x {s}) route in groups "
            f"of {tg}, which straddle the {n_data} data ranks' {b} x {s} = {b * s} tokens "
            "each; choose a batch whose rows a rank holds split into whole groups")
    g = b * s // tg
    e = m.n_experts
    el = p["router"].shape[-1]
    eg = collectives.cut_group(tp, el, e)                        # experts cut (Kimi-K2)
    fg = collectives.cut_group(tp, p["wg"].shape[-1], m.d_expert)  # expert MLP cut (Mixtral)
    group = eg or fg
    xg = x.reshape(g, tg, d)
    xr = collectives.copy_to_group(xg, group)
    r = route(p["router"], cfg, xr if eg is not None else xg, eg)
    c = r.capacity
    comb = combine_weights(r, cfg.dtype)
    if eg is not None:                                  # this rank's experts' slots
        comb = comb.narrow(-1, tp.rank * el * c, el * c)
    elif fg is not None:                                # every rank weighs partial outputs
        comb = collectives.copy_to_group(comb, fg)
    xe = dispatch(xr, comb)                                          # [G, El*C, d]
    xe = xe.reshape(g, el, c, d).transpose(0, 1).reshape(el, g * c, d)
    ye = experts(p, cfg, xe)                                         # [El, G*C, d]
    ye = ye.reshape(el, g, c, d).transpose(0, 1).reshape(g, el * c, d)
    out = combine(comb, ye).reshape(b, s, d)

    if m.n_shared:
        sh = p["shared"]
        sg = collectives.cut_group(tp, sh["wg"].shape[-1], m.d_expert * m.n_shared)
        xs = collectives.copy_to_group(x, sg).reshape(1, b * s, d)
        hs = (act_fn(cfg.act)(_bmm_acc(xs, sh["wg"][None]))
              * _bmm_acc(xs, sh["wu"][None])).to(cfg.dtype)
        shared = torch.matmul(hs, sh["wd"]).reshape(b, s, d)
        if sg is group:
            out = out + shared
        else:
            out = (collectives.reduce_from_group(out, group)
                   + collectives.reduce_from_group(shared, sg))
            group = None
    out = collectives.reduce_from_group(out, group)

    frac = _one_hot(r.idx[..., 0], e, r.probs.dtype).mean(dim=(0, 1))
    pmean = r.probs.mean(dim=(0, 1))
    if eg is not None:                                  # this rank's experts' terms
        frac, pmean = (t_.narrow(0, tp.rank * el, el) for t_ in (frac, pmean))
    if n_data > 1:                                      # the means over the global tokens
        frac = collectives.all_reduce_groups(frac, tp.data_groups) / n_data
        for grp in tp.data_groups:
            pmean = collectives.sum_both_ways(pmean, grp)
        pmean = pmean / n_data
    aux = collectives.reduce_from_group(m.router_aux_coef * e * torch.sum(frac * pmean), eg)
    return out, aux / n_data
