"""Zamba2-style hybrid: Mamba-2 backbone + one *shared* attention block
(counterpart of `repro/models/hybrid.py`).

The stack is G super-groups; each applies the shared transformer block
(attention + MLP with ONE weight set reused by all G invocations, plus
per-group norm gains) and then `shared_attn_every` Mamba-2 layers. The
Mamba-2 leaves are stacked [G, per, ...] as the reference stacks them; a
Python loop runs the groups and, inside each, the group's layers.

As in the reference, the shared block consumes the residual stream
directly (the released model's concat with the original embedding is left
out) and its per-invocation LoRA adapters are replaced by the per-group
norm gains ``ln1``/``ln2``. The prefill attention is the hand-written
forward kernel (`layers.flash_attention`; head dim 80 at Zamba2's widths),
the decode attention the plain `layers.decode_attention`.

Training across ranks (``tp``) runs the shared block as the dense decoder's
tensor-parallel attention and MLP (`transformer._attn_heads`, `_attn_out`,
`mlp_out`) and each Mamba-2 layer on the rank's heads (`mamba.mamba2_block`).

Decode: the shared block runs G times a token on different activations, so
the KV cache carries G entries [G, B, Sc, KH, hd]; the Mamba states are
[G, per, B, ...]. The decode writes the step's K/V and the new conv and SSM
states into the cache's tensors in place. Inference across ranks runs the
same shards over the rank's piece of the cache: the K/V cut by sequence
(`transformer.cache_attend`), the conv states by conv_dim and the SSM
states whole, as the reference's cache axes place them.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.distributed import collectives, sharding
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.base import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import flash_attention, rmsnorm
from repro_torch.models.transformer import (
    _attn_heads,
    _attn_out,
    attn_specs,
    mlp_out,
    mlp_specs,
)


def _counts(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, mamba layers a group)."""
    per = cfg.shared_attn_every
    if per <= 0 or cfg.n_layers % per:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split into groups of "
                         f"shared_attn_every = {per}")
    return cfg.n_layers // per, per


def hybrid_specs(cfg: ModelConfig) -> dict:
    g, per = _counts(cfg)
    d = cfg.d_model
    mamba = {k: ParamSpec((g, per) + s.shape[1:], (None,) + s.axes, s.init, s.scale, s.dtype)
             for k, s in mamba_lib.mamba2_specs(cfg, layers=1).items()}
    return {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), "normal", 0.02, cfg.dtype),
        "shared": {
            "attn": attn_specs(cfg, layers=0),
            "mlp": mlp_specs(cfg, layers=0),
        },
        "groups": {
            "ln1": ParamSpec((g, d), (None, "embed"), "zeros", dtype=cfg.dtype),
            "ln2": ParamSpec((g, d), (None, "embed"), "zeros", dtype=cfg.dtype),
            "mamba": mamba,
        },
        "final_norm": ParamSpec((d,), ("embed",), "zeros", dtype=cfg.dtype),
        "lm_head": ParamSpec((d, cfg.vocab), ("embed", "vocab"), "fan_in", dtype=cfg.dtype),
    }


def _mamba_layer(groups: dict, gi: int, j: int) -> dict:
    """Mamba-2 layer j of group gi (views, no copies)."""
    return {k: v[gi, j] for k, v in groups["mamba"].items()}


def _shared_mlp(shared: dict, ln2: torch.Tensor, cfg: ModelConfig, x: torch.Tensor, tp=None):
    h = rmsnorm(x, ln2, cfg.norm_eps)
    return x + mlp_out(shared["mlp"], cfg, h, tp)


def _shared_attn_train(shared: dict, ln1: torch.Tensor, ln2: torch.Tensor, cfg: ModelConfig,
                       x: torch.Tensor, positions: torch.Tensor, return_kv: bool = False,
                       tp=None):
    """The shared block on a full sequence: (x, (k, v) or None)."""
    h = rmsnorm(x, ln1, cfg.norm_eps)
    q, k, v = _attn_heads(shared["attn"], cfg, h, positions, cfg.rope_theta, tp,
                          whole_kv=return_kv)
    kv = (k, v)
    # a prefill's kv heads, whole on every rank: the rank's attention reads its own
    if return_kv and k.shape[2] == cfg.n_kv_heads and q.shape[2] < cfg.n_heads:
        k, v = (tfm._kv_for_rank(t, tp, q.shape[2], cfg, dim=2).contiguous() for t in kv)
    o = flash_attention(q, k, v, causal=True, block_q=cfg.flash_block_q,
                        block_k=cfg.flash_block_k)
    x = x + _attn_out(shared["attn"], cfg, o, tp)
    return _shared_mlp(shared, ln2, cfg, x, tp), (kv if return_kv else None)


def run_hybrid_train(params: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                     return_kv: bool = False, tp=None):
    """Returns (hidden, aux = 0, ((k, v) [G, B, S, KH, hd], (conv [G, per, B, K-1, Cc],
    ssm [G, per, B, H, N, P])) or None). With ``cfg.remat`` and no states
    asked for, each Mamba-2 layer runs under ``torch.utils.checkpoint``, as
    the reference checkpoints its layer body. ``tp`` (training) runs every
    block on the rank's shards."""
    g, per = _counts(cfg)
    grp = params["groups"]
    ks, vs, convs, ssms = [], [], [], []
    for gi in range(g):
        x, kv = _shared_attn_train(params["shared"], grp["ln1"][gi], grp["ln2"][gi], cfg, x,
                                   positions, return_kv, tp)
        for j in range(per):
            mp = _mamba_layer(grp, gi, j)
            if cfg.remat and not return_kv:
                x = checkpoint(lambda mp, x: mamba_lib.mamba2_block(mp, cfg, x, tp=tp)[0], mp,
                               x, use_reentrant=False, preserve_rng_state=False)
            else:
                x, (cst, sst) = mamba_lib.mamba2_block(mp, cfg, x, tp=tp)
                if return_kv:
                    convs.append(cst)
                    ssms.append(sst)
        if return_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    if not return_kv:
        return x, 0.0, None

    def stack(ts):
        return torch.stack(ts).reshape((g, per) + ts[0].shape)

    return x, 0.0, ((torch.stack(ks), torch.stack(vs)), (stack(convs), stack(ssms)))


def run_hybrid_decode(params: dict, cfg: ModelConfig, x: torch.Tensor, pos, cache: dict,
                      tp=None):
    """One decode step. cache: k/v [G, B, Sc, KH, hd], slot_pos [Sc] (``pos``
    an int) or [B, Sc] (``pos`` an int32 tensor [B], one position a row, as
    `transformer.run_stack_decode` takes it), conv [G, per, B, K-1, Cc], ssm
    [G, per, B, H, N, P]. Writes the step's K/V at each row's slot ``pos %
    Sc`` and the new conv and SSM states into the cache's tensors in place;
    returns (hidden, cache with the new slot_pos). ``tp`` runs the shared
    block over the rank's piece of the K/V cache
    (`transformer.cache_attend`) and each Mamba-2 layer on the rank's heads
    (`mamba.mamba2_decode`), an int ``pos`` only."""
    g, per = _counts(cfg)
    b = x.shape[0]
    slot_pos, where = tfm.decode_slots(cache, pos, tp)
    if isinstance(pos, torch.Tensor):
        positions = pos[:, None]
    else:
        positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    shared, grp = params["shared"], params["groups"]
    with torch.no_grad():
        for gi in range(g):
            h = rmsnorm(x, grp["ln1"][gi], cfg.norm_eps)
            kc, vc = cache["k"][gi], cache["v"][gi]
            q, k, v = _attn_heads(shared["attn"], cfg, h, positions, cfg.rope_theta,
                                  tfm.heads_tp(cfg, kc, slot_pos, tp))
            o = tfm.cache_attend(cfg, q, k, v, kc, vc, slot_pos, pos, -1, where, tp)
            x = _shared_mlp(shared, grp["ln2"][gi], cfg,
                            x + _attn_out(shared["attn"], cfg, o, tp), tp)
            for j in range(per):
                x, cst, sst = mamba_lib.mamba2_decode(_mamba_layer(grp, gi, j), cfg, x,
                                                      cache["conv"][gi, j], cache["ssm"][gi, j],
                                                      tp)
                cache["conv"][gi, j].copy_(cst)
                cache["ssm"][gi, j].copy_(sst)
    return x, dict(cache, slot_pos=slot_pos)


def conv_cut(cfg: ModelConfig, tp) -> bool:
    """Whether the rules engine cuts the cache's conv states over the model
    ranks of ``tp`` (``inner`` on conv_dim, where it divides)."""
    m = collectives.ranks(None if tp is None else tp.group)
    if m == 1:
        return False
    shapes, axes = hybrid_cache_specs(cfg, 1, 1)
    return "model" in sharding.resolve(axes["conv"], shapes["conv"][0], {"model": m},
                                       sharding.merged_rules(cfg))


def hybrid_cache_specs(cfg: ModelConfig, batch: int, seq: int) -> tuple[dict, dict]:
    """Each cache leaf's (shape, dtype), and its logical axes (the batch axis
    is the continuous engine's slot axis)."""
    g, per = _counts(cfg)
    s = cfg.ssm
    din = s.expand * cfg.d_model
    nh = din // s.head_dim
    conv_dim = din + 2 * s.n_groups * s.d_state
    kv = (g, batch, seq, cfg.n_kv_heads, cfg.hd)
    shapes = {
        "k": (kv, cfg.dtype),
        "v": (kv, cfg.dtype),
        "slot_pos": ((seq,), torch.int32),
        "conv": ((g, per, batch, s.d_conv - 1, conv_dim), cfg.dtype),
        "ssm": ((g, per, batch, nh, s.d_state, s.head_dim), torch.float32),
    }
    kv_axes = (None, "batch", "kv_seq", "kv_heads", "head_dim")
    axes = {
        "k": kv_axes,
        "v": kv_axes,
        "slot_pos": (None,),
        "conv": (None, None, "batch", None, "inner"),
        "ssm": (None, None, "batch", None, "state", None),
    }
    return shapes, axes


def hybrid_init_cache(cfg: ModelConfig, batch: int, seq: int, device="cuda") -> dict:
    """An empty cache on ``device`` (the card unless the caller asks for
    another; raises without CUDA): zeros, and slot_pos -1 (every slot empty)."""
    device = resolve(device)
    shapes, _ = hybrid_cache_specs(cfg, batch, seq)
    cache = {k: torch.zeros(shape, dtype=dt, device=device) for k, (shape, dt) in shapes.items()}
    cache["slot_pos"].fill_(-1)
    return cache
