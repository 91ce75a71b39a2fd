"""The assigned input shapes and concrete batches for them.

  train_4k     seq 4,096   global_batch 256   (training)
  prefill_32k  seq 32,768  global_batch 32    (inference → prefill_step)
  decode_32k   seq 32,768  global_batch 128   (decode → decode_step,
                                               1 token, 32k KV cache)
  long_500k    seq 524,288 global_batch 1     (long-context decode; only for
                                               sub-quadratic archs)

``make_batch`` draws from numpy's ``default_rng(seed)`` in the order
``repro.configs.shapes.make_batch`` does, so its tokens are bit-identical
to the reference's for one seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.lm.config import LMConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Per-(arch, shape) microbatch counts of the reference (sized so train_4k
# activations fit its 16 GB chips under scan + remat).
MICROBATCHES: dict[tuple[str, str], int] = {
    ("qwen3-32b", "train_4k"): 16,
    ("deepseek-v2-236b", "train_4k"): 16,
    ("internlm2-20b", "train_4k"): 8,
    ("llama-3.2-vision-11b", "train_4k"): 4,
    ("recurrentgemma-9b", "train_4k"): 4,
    ("qwen3-1.7b", "train_4k"): 2,
    ("qwen2-0.5b", "train_4k"): 2,
    ("deepseek-v2-lite-16b", "train_4k"): 4,
    ("musicgen-medium", "train_4k"): 2,
    ("xlstm-125m", "train_4k"): 2,
}


def microbatches(arch: str, shape: str) -> int:
    return MICROBATCHES.get((arch, shape), 1)


def make_batch(cfg: LMConfig, shape: str, batch: int, seq: int,
               seed: int = 0, device: str | torch.device = "cpu") -> dict:
    """A concrete batch of ``batch`` rows of ``seq`` positions on
    ``device``: int32 ``tokens`` (and ``targets`` for training), or
    ``embeds`` in the config's dtype for embedding-input archs."""
    rng = np.random.default_rng(seed)
    sp = SHAPES[shape]
    dt = getattr(torch, cfg.dtype)

    def ints(shape_):
        return torch.from_numpy(
            rng.integers(0, cfg.vocab, shape_).astype(np.int32)).to(device)

    def normal(shape_):
        return torch.from_numpy(rng.standard_normal(shape_)).to(device, dt)

    out: dict = {}
    if sp.kind in ("train", "prefill"):
        if cfg.embeds_input:
            out["embeds"] = normal((batch, seq, cfg.d_model))
        else:
            out["tokens"] = ints((batch, seq))
        if cfg.cross_seq:
            out["cross_states"] = normal((batch, cfg.cross_seq, cfg.d_model))
        if sp.kind == "train":
            out["targets"] = ints((batch, seq))
    else:
        out["tokens"] = ints((batch, 1))
    return out


def shape_applicable(cfg: LMConfig, shape: str) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs (the reference's skip
    rule)."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 524k-token decode has no "
                       "sub-quadratic mechanism — skipped per assignment")
    return True, ""


def input_specs(cfg: LMConfig, shape: str,
                batch_override: int | None = None) -> dict:
    """Every model input of this cell as a ``meta`` tensor (its shape and
    dtype, nothing allocated): the reference's ``ShapeDtypeStruct``s."""
    sp = SHAPES[shape]
    b = batch_override if batch_override is not None else sp.global_batch
    t = sp.seq_len
    dt = getattr(torch, cfg.dtype)

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if sp.kind in ("train", "prefill"):
        specs = {"targets": spec((b, t), torch.int32)} \
            if sp.kind == "train" else {}
        if cfg.embeds_input:
            specs["embeds"] = spec((b, t, cfg.d_model), dt)
        else:
            specs["tokens"] = spec((b, t), torch.int32)
        if cfg.cross_seq:
            specs["cross_states"] = spec((b, cfg.cross_seq, cfg.d_model), dt)
        return specs
    # decode: one new token against a cache of length seq_len (musicgen
    # decodes its own EnCodec token ids through its embed table)
    return {"tokens": spec((b, 1), torch.int32)}
