"""Mamba-1 (selective scan) and Mamba-2 (SSD) blocks (counterpart of
`repro/models/mamba.py`).

Both scans are the reference's chunked formulations in plain PyTorch: a
Python loop over chunks carrying the SSM state, with the work inside a chunk
written as (a) a log-step (Hillis–Steele) scan of the pairs (a, b) under the
reference's ``combine`` (mamba-1, a diagonal state per channel) or (b) the
SSD matmuls against the masked segment sums (mamba-2). Mamba-1's
``dA``/``dBu`` [B, Q, D_in, N] exist one chunk at a time, never over the
whole sequence. A sequence that is no multiple of the chunk is padded with
dt = 0 steps (decay 1, zero input: the state is unchanged) and the output
sliced, as in the reference. The sequential ``*_ref`` recurrences are the
oracles. No kernel runs here: each op is PyTorch's own (cuBLAS for the
products on the card).

Precision follows the reference's defaults: products accumulate in f32; the
in/out projections return the activation dtype, while ``x_proj``'s output
(dt_raw, B, C) and ``dt_proj`` stay f32 in a bf16 model (the reference's
``preferred_element_type=f32``, `_dot_f32`); the recurrences run in f32.
``softplus`` is `F.softplus`, whose threshold of 20 differs from
``jax.nn.softplus`` by under 3e-9 relative.

Both blocks have a full-sequence form, returning the final (conv_state,
ssm_state) for the decode, and a single-token decode against that cache.
The conv state after a prefill is the last K-1 *pre-conv* inputs, zero-padded
in front for prompts shorter than K-1.

Across ranks (``tp``, training) a model rank runs its contiguous 1/S of
the d_inner channels (Mamba-2: of the heads): the conv and the scan are
elementwise across channels and need no collective, and the products out
of d_inner are partial sums over the model group (the out projection;
Mamba-1's x_proj, whose dt, B and C every rank then uses; Mamba-2's gated
norm's sum of squares). The rules engine cuts the concatenated in_proj
columns (x|z, z|xBC|dt) and Mamba-2's conv channels (x|B|C) into
contiguous blocks, as the reference's ``NamedSharding`` does, which do not
line up with the channels; a rank gathers such a leaf whole (the autograd
gather, whose backward reduce-scatters the gradient) and takes its
channels' columns (`_spans`). Mamba-2's B and C (one group) are whole on
every rank, and its per-head A_log, D and dt_bias, replicated, are
narrowed to the rank's heads. The decodes on ranks run the same split over
the cache's placement: Mamba-1's states are the rank's channels; Mamba-2's
conv state is cut by conv_dim (gathered whole for a step) and its SSM
state is whole (the rank's heads updated, then gathered).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives
from repro_torch.models.base import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense, rmsnorm


def _dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] summed and returned in f32 (the reference's
    ``preferred_element_type=f32`` kept as f32): bf16 operands on the card
    write f32 through cuBLAS (``out_dtype``); on the CPU, and wherever
    autograd records (``mm`` with ``out_dtype`` has no derivative), they are
    widened first, which sums the same exact products in f32 and gives the
    reference's gradients: each cast back to its operand's dtype."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    records = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if x.is_cuda and not records:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(x.shape[:-1] + (w.shape[-1],))
    return torch.matmul(x.float(), w.float())


def _model_split(tp, whole: int, unit: int = 1) -> tuple:
    """(model group or None, this rank's place in it, its first channel,
    its channel count) for ``whole`` channels cut into contiguous blocks of
    whole ``unit``s (heads) over the model ranks."""
    group = tp.group if tp is not None else None
    n, rank = collectives.ranks(group), tp.rank if group is not None else 0
    if whole % (n * unit):
        raise ValueError(f"{whole} channels ({whole // unit} of {unit}) do not split over "
                         f"{n} model ranks")
    return group, rank, rank * (whole // n), whole // n


def _spans(w: torch.Tensor, dim: int, whole: int, group, spans, rank: int = 0
           ) -> torch.Tensor:
    """The entries ``spans`` [(start, length), ...] of dimension ``dim`` of a
    leaf of ``whole`` entries there, concatenated, from this rank's shard
    ``w`` (piece ``rank`` of the group when the leaf is cut): ``w`` itself
    when the spans, adjacent ones merged, are that piece or the whole leaf;
    otherwise the leaf gathered whole over the group when it is cut (the
    gradient reduce-scattered back), or passed through `copy_to_group` when
    it is whole (the gradient summed), since each rank then adds only its
    channels' part of the gradient."""
    merged = [list(spans[0])]
    for a, k in spans[1:]:
        if a == merged[-1][0] + merged[-1][1]:
            merged[-1][1] += k
        else:
            merged.append([a, k])
    n = w.shape[dim]
    if len(merged) == 1 and merged[0] == [rank * n if n < whole else 0, n]:
        return w
    full = (collectives.gather_from_group(w, dim, group) if n < whole
            else collectives.copy_to_group(w, group))
    parts = [full.narrow(dim, a, k) for a, k in spans]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``pad`` zero steps appended on axis 1."""
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], dim=1)


def _last_inputs(x: torch.Tensor, k: int) -> torch.Tensor:
    """The conv state after a prefill: the last k-1 steps of x [B, S, C],
    zero-padded in front when S < k-1 (the reference's dynamic slice of the
    front-padded stream)."""
    s = x.shape[1]
    if s >= k - 1:
        return x[:, s - (k - 1):].clone()
    return torch.cat([x.new_zeros((x.shape[0], k - 1 - s, x.shape[2])), x], dim=1)


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [B, S, C], w [C, K], b [C]: depthwise causal conv (tap K-1 = current),
    summed in f32 tap by tap, in x's dtype."""
    k = w.shape[-1]
    s = x.shape[1]
    xp = torch.cat([x.new_zeros((x.shape[0], k - 1, x.shape[2])), x], dim=1)
    wf = w.float()
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + xp[:, j:j + s].float() * wf[:, j]
    return (out + b.float()).to(x.dtype)


def conv_step(state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Decode: state [B, K-1, C] (oldest first), x_t [B, C] -> (new_state, out [B, C])."""
    window = torch.cat([state, x_t[:, None, :]], dim=1)                 # [B, K, C]
    out = (window.float() * w.T[None].float()).sum(1) + b.float()
    return window[:, 1:, :], out.to(x_t.dtype)


# ---------------------------------------------------------------------------
# Mamba-1: diagonal selective scan
# ---------------------------------------------------------------------------

def mamba1_specs(cfg: ModelConfig, layers: int | None = None) -> dict:
    s = cfg.ssm
    l = cfg.n_layers if layers is None else layers
    d = cfg.d_model
    din = s.expand * d
    r = s.dt_rank or d // 16
    n = s.d_state
    lead, la = ((l,), (None,)) if l else ((), ())
    f32 = torch.float32
    return {
        "norm": ParamSpec(lead + (d,), la + ("embed",), "zeros", dtype=cfg.dtype),
        "in_proj": ParamSpec(lead + (d, 2 * din), la + ("embed", "inner"), "fan_in",
                             dtype=cfg.dtype),
        "conv_w": ParamSpec(lead + (din, s.d_conv), la + ("inner", None), "fan_in",
                            dtype=cfg.dtype),
        "conv_b": ParamSpec(lead + (din,), la + ("inner",), "zeros", dtype=cfg.dtype),
        "x_proj": ParamSpec(lead + (din, r + 2 * n), la + ("inner", None), "fan_in",
                            dtype=cfg.dtype),
        "dt_proj": ParamSpec(lead + (r, din), la + (None, "inner"), "fan_in", dtype=cfg.dtype),
        "dt_bias": ParamSpec(lead + (din,), la + ("inner",), "zeros", dtype=f32),
        "A_log": ParamSpec(lead + (din, n), la + ("inner", None), "zeros", dtype=f32),
        "D": ParamSpec(lead + (din,), la + ("inner",), "ones", dtype=f32),
        "out_proj": ParamSpec(lead + (din, d), la + ("inner", "embed"), "fan_in",
                              dtype=cfg.dtype),
    }


def _hillis_steele(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 of the pairs (a, b) under the reference's
    ``combine((a_l, b_l), (a_r, b_r)) = (a_l a_r, b_l a_r + b_r)``, in
    log2(Q) steps: at offset d each step t >= d combines step t - d into t.

    Each step reads what it overwrites, so it writes into a second pair of
    buffers (the products straight into rows d.. through ``out=``, the first
    d rows copied) and the pairs swap: ~7 passes over a chunk a step. When
    autograd records the scan (``out=`` cannot be differentiated), each
    step joins the untouched rows to the products with ``torch.cat``
    instead, whose copy kernel took half of Falcon-Mamba-7B's prefill on an
    H100 (PERF.md §6); the two paths do the same arithmetic."""
    q = a.shape[1]
    d = 1
    if a.requires_grad or b.requires_grad:
        while d < q:
            b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], b[:, :-d], a[:, d:])], dim=1)
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
            d *= 2
        return a, b
    a2, b2 = torch.empty_like(a), torch.empty_like(b)
    while d < q:
        b2[:, :d] = b[:, :d]
        torch.addcmul(b[:, d:], b[:, :-d], a[:, d:], out=b2[:, d:])
        a2[:, :d] = a[:, :d]
        torch.mul(a[:, :-d], a[:, d:], out=a2[:, d:])
        a, a2, b, b2 = a2, a, b2, b
        d *= 2
    return a, b


def selective_scan(u, dt, A, B, C, D, h0, chunk: int):
    """Chunked diagonal selective scan.

    u, dt [B, S, D_in]; A [D_in, N]; B, C [B, S, N]; D [D_in]; h0 [B, D_in, N] f32.
    Returns (y [B, S, D_in] in u's dtype, h_final f32). h_t = exp(dt_t A) h_{t-1}
    + dt_t B_t u_t; y_t = C_t · h_t + D u_t.
    """
    b, s, din = u.shape
    q = min(chunk, s)
    if s % q:  # pad with dt=0 steps: decay exp(0)=1, zero input -> state unchanged
        pad = q - s % q
        y, h = selective_scan(*(_pad_seq(t, pad) for t in (u, dt)), A,
                              *(_pad_seq(t, pad) for t in (B, C)), D, h0, chunk)
        return y[:, :s], h
    dtf, uf = dt.float(), u.float()
    dtu = dtf * uf
    Bf, Cf = B.float(), C.float()
    h = h0
    ys = []
    for c0 in range(0, s, q):
        a = torch.exp(dtf[:, c0:c0 + q, :, None] * A)                     # [B, Q, din, N]
        bb = dtu[:, c0:c0 + q, :, None] * Bf[:, c0:c0 + q, None, :]
        acum, bcum = _hillis_steele(a, bb)
        h_t = torch.addcmul(bcum, acum, h[:, None])                       # [B, Q, din, N]
        ys.append(torch.einsum("bqdn,bqn->bqd", h_t, Cf[:, c0:c0 + q]))
        h = h_t[:, -1].clone()
        del a, bb, acum, bcum, h_t
    y = torch.cat(ys, dim=1) + uf * D
    return y.to(u.dtype), h


def selective_scan_ref(u, dt, A, B, C, D, h0):
    """Naive sequential oracle, in the dtype of ``h0`` (f32 as the reference;
    f64 for a yardstick)."""
    s = u.shape[1]
    acc = h0.dtype
    A, D = A.to(acc), D.to(acc)
    h = h0
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t].to(acc)[..., None] * A[None])
        h = dA * h + (dt[:, t].to(acc) * u[:, t].to(acc))[..., None] * B[:, t].to(acc)[:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t].to(acc)))
    y = torch.stack(ys, 1) + u.to(acc) * D[None, None]
    return y.to(u.dtype) if acc == torch.float32 else y, h


def mamba1_block(p: dict, cfg: ModelConfig, x: torch.Tensor, state=None, tp=None):
    """Full-sequence mamba-1 block. state=None -> zero initial state; ``tp``
    runs the rank's d_inner channels (training; see the module's note).

    Returns (x + out [B, S, d], (conv_state, ssm_state)) — final states for chaining.
    """
    s_cfg = cfg.ssm
    b, s, d = x.shape
    din = s_cfg.expand * d
    r = s_cfg.dt_rank or d // 16
    n = s_cfg.d_state
    group, rank, c0, dl = _model_split(tp, din)

    def mine(name, dim):
        return _spans(p[name], dim, din, group, [(c0, dl)], rank)

    h = collectives.copy_to_group(rmsnorm(x, p["norm"], cfg.norm_eps), group)
    xz = dense(h, _spans(p["in_proj"], -1, 2 * din, group, [(c0, dl), (din + c0, dl)], rank))
    xin, z = xz.split(dl, dim=-1)
    xc = causal_conv1d(xin, mine("conv_w", 0), mine("conv_b", 0))
    xc = F.silu(xc.float()).to(x.dtype)
    dbc = collectives.sum_both_ways(_dot_f32(xc, mine("x_proj", 0)), group)
    dt_raw, Bm, Cm = dbc.split([r, n, n], dim=-1)
    dt = F.softplus(torch.matmul(dt_raw, mine("dt_proj", -1).float()) + mine("dt_bias", 0))
    A = -torch.exp(mine("A_log", 0))
    h0 = torch.zeros((b, dl, n), dtype=torch.float32, device=x.device) if state is None else state
    y, h_fin = selective_scan(xc, dt, A, Bm, Cm, mine("D", 0), h0, s_cfg.chunk)
    y = (y.float() * F.silu(z.float())).to(x.dtype)
    out = collectives.reduce_from_group(dense(y, mine("out_proj", 0)), group)
    return x + out, (_last_inputs(xin, s_cfg.d_conv), h_fin)


def mamba1_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, conv_state: torch.Tensor,
                  ssm_state: torch.Tensor, tp=None):
    """x [B, 1, d]; conv_state [B, K-1, din]; ssm_state [B, din, N] f32.
    Returns (x + out, new conv_state, new ssm_state). ``tp`` runs the
    rank's d_inner channels, as `mamba1_block` does: both states are the
    rank's channels (the cache's ``inner`` cut), x_proj's product is summed
    over the model group and out_proj's reduced."""
    s_cfg = cfg.ssm
    d = x.shape[-1]
    din = s_cfg.expand * d
    r = s_cfg.dt_rank or d // 16
    n = s_cfg.d_state
    group, rank, c0, dl = _model_split(tp, din)

    def mine(name, dim):
        return _spans(p[name], dim, din, group, [(c0, dl)], rank)

    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    xz = dense(h, _spans(p["in_proj"], -1, 2 * din, group, [(c0, dl), (din + c0, dl)], rank))
    xin, z = xz[:, 0].split(dl, dim=-1)
    conv_state, xc = conv_step(conv_state, xin, mine("conv_w", 0), mine("conv_b", 0))
    xc = F.silu(xc.float()).to(x.dtype)
    dbc = collectives.reduce_from_group(_dot_f32(xc, mine("x_proj", 0)), group)
    dt_raw, Bm, Cm = dbc.split([r, n, n], dim=-1)
    dt = F.softplus(torch.matmul(dt_raw, mine("dt_proj", -1).float()) + mine("dt_bias", 0))
    A = -torch.exp(mine("A_log", 0))
    dA = torch.exp(dt[..., None] * A[None])
    xcf = xc.float()
    ssm_state = dA * ssm_state + (dt * xcf)[..., None] * Bm[:, None, :]
    y = torch.einsum("bdn,bn->bd", ssm_state, Cm) + xcf * mine("D", 0)[None]
    y = (y * F.silu(z.float())).to(x.dtype)
    out = collectives.reduce_from_group(dense(y, mine("out_proj", 0)), group)
    return x + out[:, None], conv_state, ssm_state


# ---------------------------------------------------------------------------
# Mamba-2: SSD (scalar decay per head, matmul formulation)
# ---------------------------------------------------------------------------

def mamba2_specs(cfg: ModelConfig, layers: int | None = None) -> dict:
    s = cfg.ssm
    l = cfg.n_layers if layers is None else layers
    d = cfg.d_model
    din = s.expand * d
    nh = din // s.head_dim
    gn = s.n_groups * s.d_state
    conv_dim = din + 2 * gn
    lead, la = ((l,), (None,)) if l else ((), ())
    f32 = torch.float32
    return {
        "norm": ParamSpec(lead + (d,), la + ("embed",), "zeros", dtype=cfg.dtype),
        "in_proj": ParamSpec(lead + (d, 2 * din + 2 * gn + nh), la + ("embed", "inner"),
                             "fan_in", dtype=cfg.dtype),
        "conv_w": ParamSpec(lead + (conv_dim, s.d_conv), la + ("inner", None), "fan_in",
                            dtype=cfg.dtype),
        "conv_b": ParamSpec(lead + (conv_dim,), la + ("inner",), "zeros", dtype=cfg.dtype),
        "A_log": ParamSpec(lead + (nh,), la + (None,), "zeros", dtype=f32),
        "dt_bias": ParamSpec(lead + (nh,), la + (None,), "zeros", dtype=f32),
        "D": ParamSpec(lead + (nh,), la + (None,), "ones", dtype=f32),
        "gate_norm": ParamSpec(lead + (din,), la + ("inner",), "zeros", dtype=cfg.dtype),
        "out_proj": ParamSpec(lead + (din, d), la + ("inner", "embed"), "fan_in",
                              dtype=cfg.dtype),
    }


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA [..., Q] -> L [..., Q, Q], L[i,j] = sum_{j<k<=i} dA[k] for i>=j else -inf."""
    q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=dA.device).tril()
    return diff.masked_fill(~mask, -torch.inf)


def _heads(t: torch.Tensor, rep: int, acc: torch.dtype) -> torch.Tensor:
    """B or C [B, S, G, N] broadcast to the heads [B, S, G * rep, N] in ``acc``."""
    return t.to(acc).repeat_interleave(rep, dim=2)


def ssd(x, dt, A, B, C, D, h0, chunk: int):
    """SSD chunked scan.

    x [B,S,H,P]; dt [B,S,H]; A [H] (negative); B,C [B,S,G,N] (G groups broadcast
    to heads); D [H]; h0 [B,H,N,P] f32. Returns (y [B,S,H,P] in x's dtype, h_final).
    """
    b, s, nh, pdim = x.shape
    rep = nh // B.shape[2]
    q = min(chunk, s)
    if s % q:  # pad with dt=0 steps (decay 1, zero input): state unchanged
        pad = q - s % q
        y, h = ssd(*(_pad_seq(t, pad) for t in (x, dt)), A,
                   *(_pad_seq(t, pad) for t in (B, C)), D, h0, chunk)
        return y[:, :s], h
    dA = dt.float() * A                                                    # [B,S,H]
    xr = x.float() * dt.float()[..., None]                                 # [B,S,H,P]
    Br, Cr = _heads(B, rep, torch.float32), _heads(C, rep, torch.float32)  # [B,S,H,N]
    h = h0
    ys = []
    for c0 in range(0, s, q):
        dA_c, x_c = dA[:, c0:c0 + q], xr[:, c0:c0 + q]
        B_c, C_c = Br[:, c0:c0 + q], Cr[:, c0:c0 + q]
        cum = torch.cumsum(dA_c, dim=1)                                    # [B,Q,H]
        L = torch.exp(_segsum(dA_c.transpose(1, 2)))                       # [B,H,Q,Q]
        scores = torch.einsum("bqhn,bkhn->bhqk", C_c, B_c) * L
        y_intra = torch.einsum("bhqk,bkhp->bqhp", scores, x_c)
        decay0 = torch.exp(cum)                                            # [B,Q,H]
        y_state = torch.einsum("bqhn,bhnp->bqhp", C_c * decay0[..., None], h)
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)                     # [B,Q,H]
        h = torch.exp(cum[:, -1])[..., None, None] * h + torch.einsum(
            "bqhn,bqhp->bhnp", B_c * decay_to_end[..., None], x_c)
        ys.append(y_intra + y_state)
    y = torch.cat(ys, dim=1) + x.float() * D[None, None, :, None]
    return y.to(x.dtype), h


def ssd_ref(x, dt, A, B, C, D, h0):
    """Naive sequential oracle for SSD, in the dtype of ``h0`` (f32 as the
    reference; f64 for a yardstick)."""
    s = x.shape[1]
    acc = h0.dtype
    rep = x.shape[2] // B.shape[2]
    Br, Cr = _heads(B, rep, acc), _heads(C, rep, acc)
    A, D = A.to(acc), D.to(acc)
    h = h0
    ys = []
    for t in range(s):
        a = torch.exp(dt[:, t].to(acc) * A[None])                          # [B,H]
        xt = x[:, t].to(acc) * dt[:, t].to(acc)[..., None]
        h = a[..., None, None] * h + torch.einsum("bhn,bhp->bhnp", Br[:, t], xt)
        ys.append(torch.einsum("bhn,bhnp->bhp", Cr[:, t], h))
    y = torch.stack(ys, 1) + x.to(acc) * D[None, None, :, None]
    return y.to(x.dtype) if acc == torch.float32 else y, h


def _gated_rmsnorm(y: torch.Tensor, gain: torch.Tensor, eps: float, group, whole: int
                   ) -> torch.Tensor:
    """`layers.rmsnorm` over ``whole`` channels of which y holds this rank's:
    the sum of squares summed over the model group."""
    if group is None:
        return rmsnorm(y, gain, eps)
    yf = y.float()
    var = collectives.sum_both_ways((yf * yf).sum(-1, keepdim=True), group) / whole
    return (yf * torch.rsqrt(var + eps) * (1.0 + gain.float())).to(y.dtype)


def _mamba2_split(cfg: ModelConfig, tp) -> dict:
    """A rank's share of a Mamba-2 layer over the model ranks of ``tp``: its
    channels (c0, dl), heads (h0, hl) and their B/C groups (gl of them, gw
    channels), and the spans of in_proj's columns and the conv's channels
    it reads."""
    s_cfg = cfg.ssm
    din = s_cfg.expand * cfg.d_model
    nh = din // s_cfg.head_dim
    gn = s_cfg.n_groups * s_cfg.d_state
    group, rank, c0, dl = _model_split(tp, din, s_cfg.head_dim)
    h0, hl = c0 // s_cfg.head_dim, dl // s_cfg.head_dim
    hpg = nh // s_cfg.n_groups
    if hl % hpg and hpg % hl:
        raise ValueError(f"{hl} heads a rank do not sit in whole groups of {hpg}")
    g0, gl = h0 // hpg, max(1, hl // hpg)
    gs, gw = g0 * s_cfg.d_state, gl * s_cfg.d_state
    return dict(din=din, nh=nh, gn=gn, group=group, rank=rank, c0=c0, dl=dl, h0=h0, hl=hl,
                hpg=hpg, gl=gl, gw=gw,
                w_in=[(c0, dl), (din + c0, dl), (2 * din + gs, gw), (2 * din + gn + gs, gw),
                      (2 * din + 2 * gn + h0, hl)],
                conv=[(c0, dl), (din + gs, gw), (din + gn + gs, gw)])


def mamba2_block(p: dict, cfg: ModelConfig, x: torch.Tensor, state=None, tp=None):
    """Full-sequence mamba-2 block; returns (x + out, (conv_state, ssm_state)).
    ``tp`` runs the rank's heads (training; see the module's note)."""
    s_cfg = cfg.ssm
    b, s, _ = x.shape
    sp = _mamba2_split(cfg, tp)
    group, rank, din, nh, dl, hl, gl, gw = (sp[k] for k in ("group", "rank", "din", "nh",
                                                             "dl", "hl", "gl", "gw"))
    h = collectives.copy_to_group(rmsnorm(x, p["norm"], cfg.norm_eps), group)
    w_in = _spans(p["in_proj"], -1, 2 * din + 2 * sp["gn"] + nh, group, sp["w_in"], rank)
    z, xbc_pre, dt_raw = dense(h, w_in).split([dl, dl + 2 * gw, hl], dim=-1)
    cdim = din + 2 * sp["gn"]
    xbc = causal_conv1d(xbc_pre, _spans(p["conv_w"], 0, cdim, group, sp["conv"], rank),
                        _spans(p["conv_b"], 0, cdim, group, sp["conv"], rank))
    xbc = F.silu(xbc.float()).to(x.dtype)
    xin, Bm, Cm = xbc.split([dl, gw, gw], dim=-1)
    xh = xin.reshape(b, s, hl, s_cfg.head_dim)
    Bh = Bm.reshape(b, s, gl, s_cfg.d_state)
    Ch = Cm.reshape(b, s, gl, s_cfg.d_state)

    def heads(name):
        return _spans(p[name], 0, nh, group, [(sp["h0"], hl)], rank)

    dt = F.softplus(dt_raw.float() + heads("dt_bias"))
    A = -torch.exp(heads("A_log"))
    h0 = (torch.zeros((b, hl, s_cfg.d_state, s_cfg.head_dim), dtype=torch.float32,
                      device=x.device) if state is None else state)
    y, h_fin = ssd(xh, dt, A, Bh, Ch, heads("D"), h0, s_cfg.chunk)
    y = y.reshape(b, s, dl)
    y = _gated_rmsnorm((y.float() * F.silu(z.float())).to(x.dtype),
                       _spans(p["gate_norm"], 0, din, group, [(sp["c0"], dl)], rank),
                       cfg.norm_eps, group, din)
    out = collectives.reduce_from_group(
        dense(y, _spans(p["out_proj"], 0, din, group, [(sp["c0"], dl)], rank)), group)
    return x + out, (_last_inputs(xbc_pre, s_cfg.d_conv), h_fin)


def xbc_whole(t: torch.Tensor, cfg: ModelConfig, tp) -> torch.Tensor:
    """A rank's conv channels (x of its heads | B | C of their groups) on the
    last axis of ``t`` -> every channel (x | B | C), gathered over the model
    group: x in rank order, each B/C group from the first rank holding it."""
    sp = _mamba2_split(cfg, tp)
    if sp["group"] is None:
        return t
    parts = collectives.all_gather(t, sp["group"])                 # [S, ..., dl + 2 gw]
    dl, gw = sp["dl"], sp["gw"]
    keep = [r for r in range(parts.shape[0]) if (r * sp["hl"]) % sp["hpg"] == 0]
    xs = torch.cat(parts[..., :dl].unbind(0), -1)
    bs = torch.cat([parts[r, ..., dl:dl + gw] for r in keep], -1)
    cs = torch.cat([parts[r, ..., dl + gw:] for r in keep], -1)
    return torch.cat([xs, bs, cs], -1)


def mamba2_cache_states(cfg: ModelConfig, conv: torch.Tensor, ssm: torch.Tensor, tp,
                        conv_cut: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """A prefill's final states on the rank's share ([..., K-1, dl + 2 gw],
    [..., hl, N, P]) as the cache places them: the conv channels gathered
    whole and, where the cache cuts them over ``model`` (``conv_cut``), the
    rank's contiguous block; the SSM state gathered over every head (the
    cache holds it whole)."""
    sp = _mamba2_split(cfg, tp)
    if sp["group"] is None:
        return conv, ssm
    conv = xbc_whole(conv, cfg, tp)
    if conv_cut:
        n = conv.shape[-1] // collectives.ranks(sp["group"])
        conv = conv.narrow(-1, sp["rank"] * n, n).contiguous()
    return conv, collectives.all_gather_dim(ssm, ssm.dim() - 3, sp["group"])


def mamba2_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, conv_state: torch.Tensor,
                  ssm_state: torch.Tensor, tp=None):
    """x [B,1,d]; conv_state [B,K-1,conv_dim]; ssm_state [B,H,N,P] f32.
    Returns (x + out, new conv_state, new ssm_state). ``tp`` runs the
    rank's heads, as `mamba2_block` does, on the cache's placement: the
    conv state whole or the rank's contiguous block of conv_dim (gathered
    whole for the step, the new column gathered from every rank's
    channels), the SSM state whole (the rank updates its heads, gathered
    back over every head)."""
    s_cfg = cfg.ssm
    b = x.shape[0]
    sp = _mamba2_split(cfg, tp)
    group, rank, dl, hl = sp["group"], sp["rank"], sp["dl"], sp["hl"]
    cdim = sp["din"] + 2 * sp["gn"]
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    w_in = _spans(p["in_proj"], -1, 2 * sp["din"] + 2 * sp["gn"] + sp["nh"], group,
                  sp["w_in"], rank)
    z, xbc, dt_raw = dense(h, w_in)[:, 0].split([dl, dl + 2 * sp["gw"], hl], dim=-1)
    whole = (collectives.all_gather_dim(conv_state, -1, group)
             if conv_state.shape[-1] < cdim else conv_state)
    own = torch.cat([whole.narrow(-1, a, k) for a, k in sp["conv"]], -1)
    _, xbc_c = conv_step(own, xbc, _spans(p["conv_w"], 0, cdim, group, sp["conv"], rank),
                         _spans(p["conv_b"], 0, cdim, group, sp["conv"], rank))
    col = xbc_whole(xbc, cfg, tp)
    if conv_state.shape[-1] < cdim:
        col = col.narrow(-1, rank * conv_state.shape[-1], conv_state.shape[-1])
    conv_state = torch.cat([conv_state[:, 1:], col[:, None]], dim=1)
    xbc_c = F.silu(xbc_c.float()).to(x.dtype)
    xin, Bm, Cm = xbc_c.split([dl, sp["gw"], sp["gw"]], dim=-1)
    xh = xin.reshape(b, hl, s_cfg.head_dim).float()
    rep = hl // sp["gl"]
    Bh = Bm.reshape(b, sp["gl"], s_cfg.d_state).float().repeat_interleave(rep, dim=1)
    Ch = Cm.reshape(b, sp["gl"], s_cfg.d_state).float().repeat_interleave(rep, dim=1)

    def heads(name):
        return _spans(p[name], 0, sp["nh"], group, [(sp["h0"], hl)], rank)

    dt = F.softplus(dt_raw.float() + heads("dt_bias"))                  # [B,H]
    A = -torch.exp(heads("A_log"))
    a = torch.exp(dt * A[None])
    xdt = xh * dt[..., None]
    mine = ssm_state.narrow(1, sp["h0"], hl) if ssm_state.shape[1] > hl else ssm_state
    mine = a[..., None, None] * mine + torch.einsum("bhn,bhp->bhnp", Bh, xdt)
    y = torch.einsum("bhn,bhnp->bhp", Ch, mine) + xh * heads("D")[None, :, None]
    y = y.reshape(b, dl)
    y = _gated_rmsnorm((y * F.silu(z.float())).to(x.dtype),
                       _spans(p["gate_norm"], 0, sp["din"], group, [(sp["c0"], dl)], rank),
                       cfg.norm_eps, group, sp["din"])
    out = collectives.reduce_from_group(
        dense(y, _spans(p["out_proj"], 0, sp["din"], group, [(sp["c0"], dl)], rank)), group)
    if ssm_state.shape[1] > hl:
        mine = collectives.all_gather_dim(mine, 1, group)
    return x + out[:, None], conv_state, mine
