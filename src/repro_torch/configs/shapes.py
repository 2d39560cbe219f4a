"""The dry run's input-shape cells and the inputs of each (counterpart of
`repro/configs/shapes.py`).

Four cells per architecture:
  train_4k     seq 4,096   global_batch 256   -> loss_fn       (train step)
  prefill_32k  seq 32,768  global_batch 32    -> prefill_fn    (inference prefill)
  decode_32k   seq 32,768  global_batch 128   -> decode_fn     (one token, KV cache)
  long_500k    seq 524,288 global_batch 1     -> decode_fn     (sub-quadratic only)

`long_500k` runs only for architectures with a sub-quadratic / bounded-KV
decode path (``cfg.subquadratic``), as in the reference.

`input_specs` returns (kind, {name: meta tensor}, {name: logical axes}):
the reference's names, shapes, dtypes and axes, allocating nothing (meta
tensors, or fake ones when called under a FakeTensorMode with ``device``).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    seq: int
    batch: int
    kind: str  # train | prefill | decode


CELLS = {
    "train_4k": Cell("train_4k", 4096, 256, "train"),
    "prefill_32k": Cell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Cell("decode_32k", 32768, 128, "decode"),
    "long_500k": Cell("long_500k", 524288, 1, "decode"),
}

# VLM cells: vision-prefix length (stub patch embeddings), grid h*w = s_vis
VLM_VISION = {"train_4k": (256, (16, 16)), "prefill_32k": (1024, (32, 32)),
              "decode_32k": (1024, (32, 32)), "long_500k": (1024, (32, 32))}


def cell_applicable(cfg, cell: Cell) -> tuple[bool, str]:
    if cell.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full attention — no sub-quadratic path (see DESIGN.md)"
    return True, ""


def input_specs(cfg, cell: Cell, device="meta"):
    """Returns (kind, batch tensors, their logical axes), the tensors empty
    on ``device`` (meta by default)."""
    b, s = cell.batch, cell.seq

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    tok_axes = ("batch", "seq")
    if cell.kind in ("train", "prefill"):
        if cfg.kind == "vlm":
            s_vis, _grid = VLM_VISION[cell.name]
            shapes = {
                "tokens": empty((b, s - s_vis), torch.int32),
                "patch_embeds": empty((b, s_vis, cfg.d_model), cfg.dtype),
                "positions": empty((b, s, 3), torch.int32),
            }
            axes = {
                "tokens": tok_axes,
                "patch_embeds": ("batch", "seq", "embed"),
                "positions": ("batch", "seq", None),
            }
        elif cfg.kind == "encdec":
            shapes = {
                "frames": empty((b, cfg.enc_seq, cfg.d_model), cfg.dtype),
                "tokens": empty((b, s), torch.int32),
            }
            axes = {"frames": ("batch", "seq", "embed"), "tokens": tok_axes}
        else:
            shapes = {"tokens": empty((b, s), torch.int32)}
            axes = {"tokens": tok_axes}
        if cell.kind == "train":
            shapes["targets"] = empty(tuple(shapes["tokens"].shape), torch.int32)
            axes["targets"] = tok_axes
        return cell.kind, shapes, axes

    # decode: token [B], pos scalar, cache of length seq
    shapes = {"token": empty((b,), torch.int32), "pos": empty((), torch.int32)}
    axes = {"token": ("batch",), "pos": ()}
    return "decode", shapes, axes
