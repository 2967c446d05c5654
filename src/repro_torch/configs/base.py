"""Config registry: architectures x input shapes.

Each architecture registers a FULL config (the published widths), a SMOKE
config (same family, reduced widths, runs on the CPU), the assigned
shapes it runs and a note for each it skips.

Shapes (the assigned set): ``train_4k`` is a training step,
``prefill_32k`` a prefill, ``decode_*`` one token against a ``seq_len``
cache. ``long_500k`` applies only to the sub-quadratic architectures (SSM
and hybrid); the others record why they skip it. The port's copy of
``repro/configs/base.py``; :func:`input_specs` gives ``meta`` tensors
where the reference gives ``jax.ShapeDtypeStruct``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.transformer import ModelConfig

__all__ = ["Shape", "SHAPES", "STANDARD_SHAPES", "ALL_SHAPES",
           "FULL_ATTN_SKIP", "ArchEntry", "ARCH_REGISTRY", "register",
           "get_arch", "list_archs", "input_specs"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    full: ModelConfig
    smoke: ModelConfig
    shapes: Tuple[str, ...]
    skip_notes: Dict[str, str]
    source: str


ARCH_REGISTRY: Dict[str, ArchEntry] = {}


def register(name: str, full: ModelConfig, smoke: ModelConfig,
             shapes: Tuple[str, ...], source: str = "",
             skip_notes: Optional[Dict[str, str]] = None) -> None:
    ARCH_REGISTRY[name] = ArchEntry(full=full, smoke=smoke, shapes=shapes,
                                    skip_notes=skip_notes or {},
                                    source=source)


def get_arch(name: str) -> ArchEntry:
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]


def list_archs():
    return sorted(ARCH_REGISTRY)


STANDARD_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
ALL_SHAPES = STANDARD_SHAPES + ("long_500k",)
FULL_ATTN_SKIP = {"long_500k": "pure full-attention arch: 512k dense decode "
                               "is outside the operating envelope (quadratic "
                               "attention); skipped per assignment spec"}


def _spec(*shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: Shape) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins (shape and dtype, no storage) for every model
    input of a shape, as the reference's: a train batch's ``tokens`` and
    ``labels``, a prefill's ``tokens`` (an encoder-decoder's source
    ``src_embeds`` and at most 4096 target tokens; a VLM's
    ``frontend_embeds`` and the rest of ``seq_len`` as tokens), a decode
    step's one new token per row (the caches come from ``init_caches``)."""
    b, s = shape.global_batch, shape.seq_len
    bf16 = torch.bfloat16
    if shape.kind == "train":
        specs = {"tokens": _spec(b, s), "labels": _spec(b, s)}
        if cfg.family in ("encdec", "audio"):
            specs["src_embeds"] = _spec(b, s, cfg.frontend_dim or cfg.d_model,
                                        dtype=bf16)
        if cfg.family == "vlm":
            specs["frontend_embeds"] = _spec(b, cfg.frontend_len,
                                             cfg.frontend_dim, dtype=bf16)
            specs["tokens"] = _spec(b, s - cfg.frontend_len)
            specs["labels"] = _spec(b, s - cfg.frontend_len)
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": _spec(b, s)}
        if cfg.family in ("encdec", "audio"):
            specs["src_embeds"] = _spec(b, s, cfg.frontend_dim or cfg.d_model,
                                        dtype=bf16)
            specs["tokens"] = _spec(b, min(s, 4096))
        if cfg.family == "vlm":
            specs["frontend_embeds"] = _spec(b, cfg.frontend_len,
                                             cfg.frontend_dim, dtype=bf16)
            specs["tokens"] = _spec(b, s - cfg.frontend_len)
        return specs
    return {"tokens": _spec(b, 1)}
