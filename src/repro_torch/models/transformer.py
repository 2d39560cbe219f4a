"""Decoder-only transformer stack (counterpart of
`repro/models/transformer.py`; llama/gemma family, the MoE decoders, whose
block MLP is `moe.apply`, and the VLM's language model, whose RoPE takes
the config's M-RoPE sections over [B, S, 3] positions).

Layers are stacked along a leading L axis, in the reference's layouts
(``wq [L, d, H, hd]``, ``wo [L, H, hd, d]``, ...), and run by a Python loop;
per-layer heterogeneity (sliding window, dual RoPE theta) comes from
`layer_meta`. The decode takes one position for the whole batch (the
static engine) or one a row on the device (the continuous engine's slots),
and the chunked prefill (`run_stack_chunk`) runs one chunk of a prompt on
the attention kernel's ``q_offset``. Training on ranks (``tp=``) runs the
rank's shards of the heads, the MLP and the vocabulary, with the widths read
from the weight shards. Inference on ranks runs the same shards; the
prefill's K/V become the rank's piece of the cache as the rules engine
places the reference's cache axes (`kv_cut`: over the sequence where a
config puts ``kv_seq`` on ``model``), and the decode attends over that
piece (`cache_attend`), a cut sequence's partial softmaxes merged over the
model ranks, where the reference's GSPMD partitions its decode attention
unasked.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.distributed import collectives, sharding
from repro_torch.models import moe as moe_lib
from repro_torch.models.base import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_rope,
    decode_attention,
    flash_attention,
    gated_mlp,
    rmsnorm,
)


# the logical axes of every K/V cache leaf [L, B, Sc, KH, hd] (the reference's)
KV_AXES = (None, "batch", "kv_seq", "kv_heads", "head_dim")


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def attn_specs(cfg: ModelConfig, layers: int | None = None) -> dict:
    l = cfg.n_layers if layers is None else layers
    hd, h, kh, d = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    lead = () if l == 0 else (l,)
    la = () if l == 0 else (None,)
    p = {
        "wq": ParamSpec(lead + (d, h, hd), la + ("embed", "heads", "head_dim"), "fan_in",
                        dtype=cfg.dtype),
        "wk": ParamSpec(lead + (d, kh, hd), la + ("embed", "kv_heads", "head_dim"), "fan_in",
                        dtype=cfg.dtype),
        "wv": ParamSpec(lead + (d, kh, hd), la + ("embed", "kv_heads", "head_dim"), "fan_in",
                        dtype=cfg.dtype),
        "wo": ParamSpec(lead + (h, hd, d), la + ("heads", "head_dim", "embed"), "fan_in",
                        dtype=cfg.dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec(lead + (hd,), la + (None,), "zeros", dtype=cfg.dtype)
        p["k_norm"] = ParamSpec(lead + (hd,), la + (None,), "zeros", dtype=cfg.dtype)
    return p


def mlp_specs(cfg: ModelConfig, layers: int | None = None) -> dict:
    l = cfg.n_layers if layers is None else layers
    d, f = cfg.d_model, cfg.d_ff
    lead = () if l == 0 else (l,)
    la = () if l == 0 else (None,)
    return {
        "wg": ParamSpec(lead + (d, f), la + ("embed", "mlp"), "fan_in", dtype=cfg.dtype),
        "wu": ParamSpec(lead + (d, f), la + ("embed", "mlp"), "fan_in", dtype=cfg.dtype),
        "wd": ParamSpec(lead + (f, d), la + ("mlp", "embed"), "fan_in", dtype=cfg.dtype),
    }


def decoder_specs(cfg: ModelConfig) -> dict:
    l, d = cfg.n_layers, cfg.d_model
    norm = ParamSpec((l, d), (None, "embed"), "zeros", dtype=cfg.dtype)
    blocks: dict[str, Any] = {"attn": attn_specs(cfg), "ln1": norm, "ln2": norm}
    if cfg.sandwich_norm:
        blocks["ln1_post"] = norm
        blocks["ln2_post"] = norm
    blocks["mlp"] = moe_lib.moe_specs(cfg) if cfg.moe else mlp_specs(cfg)
    specs = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), "normal", 0.02, cfg.dtype),
        "blocks": blocks,
        "final_norm": ParamSpec((d,), ("embed",), "zeros", dtype=cfg.dtype),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, cfg.vocab), ("embed", "vocab"), "fan_in",
                                     dtype=cfg.dtype)
    return specs


# ---------------------------------------------------------------------------
# per-layer window / rope theta
# ---------------------------------------------------------------------------

def layer_meta(cfg: ModelConfig) -> tuple[list[int], list[float]]:
    """Each layer's window (-1 = global) and RoPE theta (the local theta on
    windowed layers when the config has one)."""
    windows = list(cfg.windows)
    if cfg.local_rope_theta is not None:
        thetas = [cfg.local_rope_theta if w > 0 else cfg.rope_theta for w in windows]
    else:
        thetas = [cfg.rope_theta] * cfg.n_layers
    return windows, thetas


def _layer(tree: dict, i: int) -> dict:
    """Layer i of a stacked parameter tree (views, no copies)."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i]) for k, v in tree.items()}


def _layers(tree: dict, n: int) -> list[dict]:
    """The n layers of a stacked parameter tree, one ``unbind`` a leaf: its
    backward stacks the layers' gradients once, where indexing layer by
    layer would scatter each layer's gradient into a full-size zero tensor."""
    out: list[dict] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _layers(v, n) if isinstance(v, dict) else v.unbind(0)
        for i in range(n):
            out[i][k] = parts[i]
    return out


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _kv_for_rank(w: torch.Tensor, tp, h: int, cfg: ModelConfig, dim: int = 1
                 ) -> torch.Tensor:
    """The kv heads a rank's ``h`` query heads read, from the whole kv
    projection w [d, KH, hd] (or whole k/v, their heads on ``dim``): global
    q head ``rank*h + j`` reads kv head ``(rank*h + j) // (H/KH)``. A
    contiguous span of whole groups, or one kv head when the rank's heads
    sit inside one group; otherwise one kv head for each q head."""
    g = cfg.n_heads // cfg.n_kv_heads
    first = tp.rank * h
    if h % g == 0:
        return w.narrow(dim, first // g, h // g)
    if g % h == 0:
        return w.narrow(dim, first // g, 1)
    ids = torch.tensor([(first + j) // g for j in range(h)], device=w.device)
    return w.index_select(dim, ids)


def _attn_heads(blk: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                theta: float, tp=None, whole_kv: bool = False):
    """q, k, v [B, S, heads, hd] at the rank's own heads: the widths come
    from the weight shards. With the heads cut over the model group
    (``tp``), x enters through `copy_to_group`; kv heads that are whole on
    every rank are narrowed to the ones the rank's q heads read, through
    `copy_to_group` too, since each rank adds only its heads' part of
    their gradient; so are the whole q and k norms, which act on the
    rank's heads alone. ``whole_kv`` (a prefill on ranks, whose cache
    holds every kv head) projects such kv heads whole; the caller narrows
    them for its attention."""
    b, s, d = x.shape
    h, hd = blk["wq"].shape[-2], blk["wq"].shape[-1]
    wk, wv = blk["wk"], blk["wv"]
    q_norm, k_norm = blk.get("q_norm"), blk.get("k_norm")
    group = collectives.cut_group(tp, h, cfg.n_heads)
    if group is not None:
        x = collectives.copy_to_group(x, group)
        if wk.shape[-2] == cfg.n_kv_heads and not whole_kv:
            wk = _kv_for_rank(collectives.copy_to_group(wk, group), tp, h, cfg)
            wv = _kv_for_rank(collectives.copy_to_group(wv, group), tp, h, cfg)
        if cfg.qk_norm:
            q_norm = collectives.copy_to_group(q_norm, group)
            k_norm = collectives.copy_to_group(k_norm, group)
    kh = wk.shape[-2]
    q = (x @ blk["wq"].reshape(d, h * hd)).reshape(b, s, h, hd)
    k = (x @ wk.reshape(d, kh * hd)).reshape(b, s, kh, hd)
    v = (x @ wv.reshape(d, kh * hd)).reshape(b, s, kh, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, q_norm, cfg.norm_eps)
        k = rmsnorm(k, k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, theta, cfg.mrope_sections)
    k = apply_rope(k, positions, theta, cfg.mrope_sections)
    return q, k, v


def _attn_out(blk: dict, cfg: ModelConfig, o: torch.Tensor, tp=None) -> torch.Tensor:
    """The output projection of the rank's heads; a partial sum over the
    heads when they are cut, summed over the model group."""
    b, s, h, hd = o.shape
    out = o.reshape(b, s, h * hd) @ blk["wo"].reshape(h * hd, -1)
    return collectives.reduce_from_group(out, collectives.cut_group(tp, h, cfg.n_heads))


def mlp_out(mlp: dict, cfg: ModelConfig, h: torch.Tensor, tp=None) -> torch.Tensor:
    """The gated MLP of the normed h; with its hidden width cut over the
    model group (``tp``), the rank's columns of wg/wu and rows of wd, the
    partial sums summed over the group."""
    group = collectives.cut_group(tp, mlp["wg"].shape[-1], cfg.d_ff)
    h = collectives.copy_to_group(h, group)
    m = gated_mlp(h, mlp["wg"], mlp["wu"], mlp["wd"], cfg.act)
    return collectives.reduce_from_group(m, group)


def _mlp_residual(blk: dict, cfg: ModelConfig, x: torch.Tensor, o: torch.Tensor, tp=None,
                  group_size: int | None = None):
    """(x + o + MLP, the MLP's aux loss): the MoE block's on MoE configs
    (routed in groups of ``group_size`` tokens, the config's when None),
    else 0 (a Python float)."""
    if cfg.sandwich_norm:
        o = rmsnorm(o, blk["ln1_post"], cfg.norm_eps)
    x = x + o
    h = rmsnorm(x, blk["ln2"], cfg.norm_eps)
    mlp = blk["mlp"]
    if cfg.moe:
        m, aux = moe_lib.apply(mlp, cfg, h, tp, group_size)
    else:
        m, aux = mlp_out(mlp, cfg, h, tp), 0.0
    if cfg.sandwich_norm:
        m = rmsnorm(m, blk["ln2_post"], cfg.norm_eps)
    return x + m, aux


def attn_block_train(blk: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                     window: int, theta: float, return_kv: bool = False, tp=None):
    """One full-sequence causal block: (x, aux), or (x, aux, (k, v)) with k
    after qk-norm and RoPE when ``return_kv`` (the prefill); aux is the MoE
    block's load-balancing loss (0 on a dense config), summed over the
    layers by `run_stack_train`. ``tp`` (a `collectives.TensorParallel`)
    runs the block on the rank's shards of the heads and the MLP
    (Megatron's split: column-split q/k/v and gate/up, row-split output and
    down projections, one all-reduce after each); the returned k/v are the
    rank's kv heads, or every kv head where they are whole on each rank."""
    h = rmsnorm(x, blk["ln1"], cfg.norm_eps)
    q, k, v = _attn_heads(blk["attn"], cfg, h, positions, theta, tp, whole_kv=return_kv)
    kv = (k, v)
    # a prefill's kv heads, whole on every rank: the rank's attention reads its own
    if return_kv and k.shape[2] == cfg.n_kv_heads and q.shape[2] < cfg.n_heads:
        k, v = (_kv_for_rank(t, tp, q.shape[2], cfg, dim=2).contiguous() for t in kv)
    o = flash_attention(q, k, v, causal=True, window=window,
                        block_q=cfg.flash_block_q, block_k=cfg.flash_block_k)
    x, aux = _mlp_residual(blk, cfg, x, _attn_out(blk["attn"], cfg, o, tp), tp)
    return (x, aux, kv) if return_kv else (x, aux)


def kv_cut(cfg: ModelConfig, slots: int, tp) -> str | None:
    """How the rules engine places a K/V cache of ``slots`` slots on the
    model ranks of ``tp``: "seq" (``kv_seq`` on ``model``, where a config
    overrides it and the slots divide), "heads" (``kv_heads``, where the kv
    heads divide instead), or None (whole on every model rank)."""
    m = collectives.ranks(None if tp is None else tp.group)
    if m == 1:
        return None
    spec = sharding.resolve(KV_AXES, (1, 1, slots, cfg.n_kv_heads, cfg.hd), {"model": m},
                            sharding.merged_rules(cfg))
    spec = spec + (None,) * (len(KV_AXES) - len(spec))
    return "seq" if spec[2] == "model" else "heads" if spec[3] == "model" else None


def heads_tp(cfg: ModelConfig, kc: torch.Tensor, slot_pos: torch.Tensor, tp):
    """``tp`` where the rank's piece of the cache kc [B, Sc, KH, hd] is cut
    by kv heads, so a decode projects as training does (the rank's q heads
    and the kv heads they read); None otherwise: the projections then run
    on the rank's shards as they are, and `cache_attend` gathers them."""
    if tp is None or kc.shape[2] == cfg.n_kv_heads or kc.shape[1] < slot_pos.shape[-1]:
        return None
    return tp


def cache_attend(cfg: ModelConfig, q: torch.Tensor, k, v, kc: torch.Tensor, vc: torch.Tensor,
                 slot_pos: torch.Tensor, pos, window: int, where: tuple, tp=None
                 ) -> torch.Tensor:
    """Write one step's k/v [B, 1, heads, hd] (None: a read-only cache, the
    cross K/V) into the cache kc/vc [B, Sc, KH, hd] at ``where`` and attend
    q over it; returns o at q's heads. On model ranks (``tp``) the cache is
    this rank's piece, as `kv_cut` places it: cut by kv heads, the rank's
    q heads attend over its kv heads, as in training; cut by sequence (its
    slots fewer than slot_pos's) or whole, q and the new k/v are gathered to
    every head, the rank owning slot ``pos % Sc`` writes it, and every rank
    attends over its slots with the partial softmaxes merged over the group
    (`layers.decode_attention`), or over the whole cache; the rank's q heads
    of o are returned."""
    group = None if tp is None else tp.group
    seq_cut = kc.shape[1] < slot_pos.shape[-1]
    if group is None or (kc.shape[2] < cfg.n_kv_heads and not seq_cut):
        if k is not None:
            kc[where] = k[:, 0]
            vc[where] = v[:, 0]
        return decode_attention(q, kc, vc, slot_pos, pos, window=window)
    h = q.shape[2]
    qa = collectives.all_gather_dim(q, 2, group) if h < cfg.n_heads else q
    if k is not None:
        if k.shape[2] < cfg.n_kv_heads:
            k, v = (collectives.all_gather_dim(t, 2, group) for t in (k, v))
        if not seq_cut:
            kc[where] = k[:, 0]
            vc[where] = v[:, 0]
        elif (pos % slot_pos.shape[-1]) // kc.shape[1] == tp.rank:
            kc[:, pos % slot_pos.shape[-1] - tp.rank * kc.shape[1]] = k[:, 0]
            vc[:, pos % slot_pos.shape[-1] - tp.rank * kc.shape[1]] = v[:, 0]
    o = decode_attention(qa, kc, vc, slot_pos, pos, window=window,
                         group=group if seq_cut else None, slot_base=tp.rank * kc.shape[1])
    return o.narrow(2, tp.rank * h, h) if h < cfg.n_heads else o


def attn_block_decode(blk: dict, cfg: ModelConfig, x: torch.Tensor, pos, window: int,
                      theta: float, kc: torch.Tensor, vc: torch.Tensor,
                      slot_pos: torch.Tensor, where: tuple, tp=None) -> torch.Tensor:
    """x [B, 1, d]; kc/vc [B, Sc, KH, hd], written in place at ``where``
    (``(slice(None), slot)`` for one position, ``(rows, slots)`` for one a
    row); pos an int or an int32 tensor [B] (under M-RoPE every stream of
    the [B, 1, 3] positions is ``pos``). An MoE block routes the B
    tokens of one position as one group (t = B), as the reference's decode
    does; at per-row positions each row is a request of its own, which the
    reference decodes as a vmap of B = 1 decodes, so each row is routed as
    a group of its own (its experts never drop for its neighbours). ``tp``
    runs the block on the rank's shards over the rank's piece of the cache
    (`cache_attend`)."""
    per_row = isinstance(pos, torch.Tensor)
    if per_row:
        positions = pos[:, None]
    else:
        positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope_sections is not None:      # every M-RoPE stream at the decode position
        positions = positions[..., None].expand(-1, -1, len(cfg.mrope_sections))
    h = rmsnorm(x, blk["ln1"], cfg.norm_eps)
    q, k, v = _attn_heads(blk["attn"], cfg, h, positions, theta, heads_tp(cfg, kc, slot_pos, tp))
    o = cache_attend(cfg, q, k, v, kc, vc, slot_pos, pos, window, where, tp)
    return _mlp_residual(blk, cfg, x, _attn_out(blk["attn"], cfg, o, tp), tp,
                         group_size=1 if per_row else None)[0]


# ---------------------------------------------------------------------------
# stack runners
# ---------------------------------------------------------------------------

def embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor, tp=None
                 ) -> torch.Tensor:
    """The embedding of ``tokens``; with the vocabulary cut over the model
    group (``tp``) a masked lookup of the rank's rows, summed over it."""
    table = params["embed"]
    group = collectives.cut_group(tp, table.shape[0], cfg.vocab)
    if group is None:
        x = table[tokens]
    else:
        x = collectives.vocab_embed(table, tokens, tp.rank * table.shape[0], group)
    if cfg.emb_scale:    # sqrt(d) rounded to the model's dtype first, as in the reference
        x = x * float(torch.tensor(cfg.d_model**0.5, dtype=cfg.dtype))
    return x.to(cfg.dtype)


def head_weight(params: dict, cfg: ModelConfig) -> torch.Tensor:
    """The vocabulary projection [d, V]: the embedding's transpose when tied."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def logits_head(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm and the vocabulary projection; f32 logits, as the
    reference's f32-accumulated einsum gives them."""
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return torch.matmul(h.float(), head_weight(params, cfg).float())


def run_stack_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, tp=None):
    """Full-sequence causal stack, without autograd: (hidden [B, S, d],
    (k, v) stacks [L, B, S, KH, hd]); ``tp`` runs the training blocks on
    the rank's shards, the stacks at the rank's kv heads or, where they are
    whole on each rank, every kv head."""
    windows, thetas = layer_meta(cfg)
    ks, vs = [], []
    with torch.no_grad():
        for i in range(cfg.n_layers):
            x, _, (k, v) = attn_block_train(_layer(params["blocks"], i), cfg, x, positions,
                                            windows[i], thetas[i], return_kv=True, tp=tp)
            ks.append(k)
            vs.append(v)
    return x, (torch.stack(ks), torch.stack(vs))


def run_stack_train(params: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, tp=None):
    """Full-sequence causal stack for training: (hidden [B, S, d], aux loss
    summed over the layers in f32: the MoE blocks', 0 for the dense
    decoder). With ``cfg.remat`` each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
    reference's ``jax.checkpoint(body)``: the forward keeps only each
    layer's input and the backward recomputes the layer, attention kernel
    included, before its gradient (the aux loss comes out of the
    checkpointed function too). ``tp`` runs each block on the rank's
    shards (`attn_block_train`); the recompute calls the block's forward
    collectives again, on every rank in the same order."""
    windows, thetas = layer_meta(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk, window, theta in zip(_layers(params["blocks"], cfg.n_layers), windows, thetas):
        if cfg.remat:
            # the block draws no random numbers: no RNG state to keep
            x, a = checkpoint(attn_block_train, blk, cfg, x, positions, window, theta, False,
                              tp, use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = attn_block_train(blk, cfg, x, positions, window, theta, tp=tp)
        aux = aux + a
    return x, aux


def cache_from_kv(cfg: ModelConfig, kv, seq: int, pad_to: int | None = None, tp=None
                  ) -> dict:
    """Build a decode cache from prefill K/V stacks [L, B, S, KH, hd].

    For pure sliding-window models the cache is a ring of the largest window
    (slot = pos % window; further decodes wrap correctly). Otherwise the cache
    is full-length, optionally padded to `pad_to` capacity so decode can extend
    beyond the prompt without evicting position 0. On model ranks (``tp``)
    the stacks hold the rank's kv heads or every kv head, and the cache is
    the rank's piece as `recut_kv` places it.
    """
    k, v = kv
    dev = k.device
    sc = seq if cfg.max_window < 0 else min(seq, cfg.max_window)
    if sc < seq:  # ring buffer holds the last sc positions at slot = pos % sc
        shift = seq % sc
        k = torch.roll(k[:, :, seq - sc:], shift, dims=2)
        v = torch.roll(v[:, :, seq - sc:], shift, dims=2)
        pos = torch.arange(seq - sc, seq, dtype=torch.int32, device=dev)
        cache = {"k": k, "v": v, "slot_pos": torch.roll(pos, shift)}
    else:
        slot_pos = torch.arange(seq, dtype=torch.int32, device=dev)
        cache = pad_kv_cache({"k": k, "v": v, "slot_pos": slot_pos}, pad_to)
    return recut_kv(cfg, cache, tp)


def recut_kv(cfg: ModelConfig, cache: dict, tp, names=("k", "v")) -> dict:
    """The rank's piece of whole-slot K/V leaves [L, B, Sc, heads, hd] as
    `kv_cut` places them: the rank's kv heads re-cut by sequence with one
    all-to-all over the model group, or whole kv heads narrowed to the
    rank's slots; kept as they are where the cut is by kv heads (they are
    the rank's) or there is none (every kv head). slot_pos stays whole."""
    cut = kv_cut(cfg, cache[names[0]].shape[2], tp)
    if cut != "seq":
        return cache
    out = dict(cache)
    for name in names:
        t = cache[name]
        if t.shape[3] < cfg.n_kv_heads:
            out[name] = collectives.all_to_all_dim(t, 2, 3, tp.group)
        else:
            n = t.shape[2] // collectives.ranks(tp.group)
            out[name] = t.narrow(2, tp.rank * n, n).contiguous()
    return out


def pad_kv_cache(cache: dict, pad_to: int | None) -> dict:
    """Grow a full-length cache's capacity (axis 2 of k/v) to `pad_to` slots."""
    seq = cache["k"].shape[2]
    if pad_to is None or pad_to <= seq:
        return cache
    extra = pad_to - seq
    out = dict(cache)
    for name in ("k", "v"):
        t = cache[name]
        shape = list(t.shape)
        shape[2] = extra
        out[name] = torch.cat([t, t.new_zeros(shape)], dim=2)
    out["slot_pos"] = torch.cat([cache["slot_pos"],
                                 cache["slot_pos"].new_full((extra,), -1)])
    return out


def decode_slots(cache: dict, pos, tp=None) -> tuple[torch.Tensor, tuple]:
    """(the new slot_pos, ``where`` the step writes a whole-slot cache):
    ``pos`` an int (``slot_pos`` [Sc], one slot ``pos % Sc`` for the batch)
    or an int32 tensor [B] (``slot_pos`` [B, Sc], each row's slot). On
    ranks (``tp``) ``pos`` must be an int: the engines, whose slots decode
    at positions of their own, stay off ranks, as the reference's take no
    mesh. slot_pos is whole on every rank."""
    slot_pos = cache["slot_pos"].clone()
    per_row = isinstance(pos, torch.Tensor)
    if per_row and tp is not None:
        raise ValueError("a decode on ranks takes one int position for the batch: per-row "
                         "positions are the continuous engine's, which stays off ranks as "
                         "the reference's engines take no mesh")
    if per_row != (slot_pos.dim() == 2):
        raise ValueError("per-row positions need a per-row slot_pos [B, Sc], an int "
                         "position a shared slot_pos [Sc]")
    sc = slot_pos.shape[-1]
    if per_row:
        where = (torch.arange(pos.shape[0], device=pos.device), (pos % sc).long())
        slot_pos[where] = pos
    else:
        where = (slice(None), pos % sc)
        slot_pos[pos % sc] = pos
    return slot_pos, where


def run_stack_decode(params: dict, cfg: ModelConfig, x: torch.Tensor, pos, cache: dict,
                     tp=None):
    """One decode step. ``pos`` is an int (every row at one position; the
    cache's ``slot_pos`` [Sc]) or an int32 tensor [B] on the device (one
    position a row; ``slot_pos`` [B, Sc]): each row writes its K/V at its
    own slot ``pos % Sc`` with one indexed write a layer, and nothing is
    read back to the host. Writes the step's K/V into the cache's k/v
    tensors in place (the reference returns new arrays; the port saves the
    copy) and returns (hidden, cache with the new slot_pos). ``tp`` runs
    each block on the rank's shards over its piece of the cache (an int
    ``pos`` only; see `decode_slots`)."""
    windows, thetas = layer_meta(cfg)
    slot_pos, where = decode_slots(cache, pos, tp)
    with torch.no_grad():
        for i in range(cfg.n_layers):
            x = attn_block_decode(_layer(params["blocks"], i), cfg, x, pos, windows[i],
                                  thetas[i], cache["k"][i], cache["v"][i], slot_pos, where, tp)
    return x, dict(cache, slot_pos=slot_pos)


def run_stack_chunk(params: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, cache: dict, start: int):
    """One prefill chunk: x [B, cs, d] at positions [start, start + cs) of a
    prompt, attending over the K/V that earlier chunks wrote plus its own.

    Each layer writes the chunk's K/V at [start, stop) of the full-capacity
    cache, in place, and runs the attention kernel on the cache's prefix
    ``[:, :stop]`` with ``q_offset = start``: chunks fill the cache front to
    back, so the causal mask over keys [0, stop) is the full prefill's. The
    prefix of a B = 1 cache is contiguous, as the kernel needs. Returns
    (hidden, cache with slot_pos[start:stop] set). Dense decoder only, as
    in the reference (the MoE routes over the token axis, so chunk
    boundaries would change its drops); the cache must not be a ring (the
    engine checks)."""
    if cfg.moe is not None:
        raise ValueError("chunked prefill is dense-decoder only: the MoE block routes "
                         "over the token axis, so chunk boundaries would change its drops")
    windows, thetas = layer_meta(cfg)
    stop = start + x.shape[1]
    if stop > cache["k"].shape[2]:
        raise ValueError(f"chunk [{start}, {stop}) past the cache's {cache['k'].shape[2]} slots")
    slot_pos = cache["slot_pos"].clone()
    slot_pos[start:stop] = torch.arange(start, stop, dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        blk = _layer(params["blocks"], i)
        h = rmsnorm(x, blk["ln1"], cfg.norm_eps)
        q, k, v = _attn_heads(blk["attn"], cfg, h, positions, thetas[i])
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, start:stop] = k
        vc[:, start:stop] = v
        o = flash_attention(q, kc[:, :stop], vc[:, :stop], causal=True, window=windows[i],
                            q_offset=start,
                            block_q=cfg.flash_block_q, block_k=cfg.flash_block_k)
        x, _ = _mlp_residual(blk, cfg, x, _attn_out(blk["attn"], cfg, o))
    return x, dict(cache, slot_pos=slot_pos)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq: int, layers: int | None = None,
               device="cuda") -> dict:
    """An empty KV cache on ``device`` (the card unless the caller asks for
    another; raises without CUDA, as every entry point does). For pure
    sliding-window models the cache is a ring buffer of the largest window;
    otherwise full length."""
    device = resolve(device)
    l = layers if layers is not None else cfg.n_layers
    sc = seq if cfg.max_window < 0 else min(seq, cfg.max_window)
    kv = (l, batch, sc, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(kv, dtype=cfg.dtype, device=device),
        "v": torch.zeros(kv, dtype=cfg.dtype, device=device),
        "slot_pos": torch.full((sc,), -1, dtype=torch.int32, device=device),
    }
