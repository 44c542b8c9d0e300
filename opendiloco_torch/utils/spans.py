"""Named spans that tie the card's kernels to the model op that issued them.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
profiler records, and a shared no-op context otherwise, so an untraced
step pays one flag read a span. :data:`SPANS` lists every name the
training path opens; ``profile_inner_step`` adds up the device time of
the kernels launched inside each (and, through the autograd sequence
link, of the backward kernels of the ops inside each).
"""
from __future__ import annotations

import contextlib

import torch

# the training path's spans: model ops (models/llama.py), the losses, the
# trainer's casts, accumulation, clip and AdamW (trainer.py), and the outer
# step's phases (diloco/optimizer.py)
MODEL_SPANS = (
    "llama.cast_params", "llama.embed", "llama.layer_params", "llama.attn_norm", "llama.qkv", "llama.rope",
    "llama.attention", "llama.o_proj", "llama.attn_residual", "llama.ffn_norm", "llama.gate_up", "llama.swiglu",
    "llama.down", "llama.ffn_residual", "llama.final_norm", "llama.lm_head", "loss.causal_lm", "loss.fused",
)
TRAINER_SPANS = ("trainer.backward", "trainer.grad_accum", "trainer.grad_norm", "adamw.clip", "adamw.update")
OUTER_SPANS = ("outer.d2h", "outer.pseudo_grad", "outer.all_reduce", "outer.nesterov", "outer.h2d")
SPANS = MODEL_SPANS + TRAINER_SPANS + OUTER_SPANS

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records,
    else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
