"""Serving engine: bucketed prefill and batched incremental decode over a
slot-paged ring KV cache, on the card.

The PyTorch counterpart of ``opendiloco_tpu/serve/engine.py``
``ServeEngine`` for the cold path: ``admit`` prefills a prompt into a
free slot, ``decode_step`` takes one greedy token for every slot. Both
are called from one scheduler thread; the engine is not thread-safe,
which lets it update the cache in place (where the JAX engine donates
the cache buffers to its jits).

``weight_format="w4"`` keeps the stacked decoder matmul weights packed
blockwise-4-bit at rest (:mod:`opendiloco_torch.quant`); every matmul on
them goes through the fused dequant-matmul kernel. Decode attention goes
through the paged-decode-attention kernel. On the CPU both take their
plain versions.

Speculative decode, prefix reuse, the KV tier and weight hot swap are
later slices of the port: their arguments raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from opendiloco_torch.config import WEIGHT_FORMATS
from opendiloco_torch.device import DeviceLike, resolve_device
from opendiloco_torch.models.llama import (
    LlamaConfig,
    PackedW4,
    cache_insert,
    decode_forward,
    init_kv_cache,
    prefill_forward,
)
from opendiloco_torch.quant import pack_blockwise4_stacked
from opendiloco_torch.serve.kvcache import pick_bucket


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A: {item})"
    )


class ServeEngine:
    def __init__(
        self,
        cfg: LlamaConfig,
        params: dict,
        *,
        num_slots: int = 8,
        max_context: int = 512,
        prefill_buckets: Sequence[int] = (32, 128, 512),
        compute_dtype: Optional[torch.dtype] = None,
        epoch: int = 0,
        weight_format: str = "fp32",
        device: DeviceLike = None,
        spec_k: int = 0,
        draft_layers: int = 0,
        snapshot_fn=None,
        epoch_fn=None,
        max_stale_rounds: int = 0,
    ):
        """``device`` defaults to the card (and raises without one);
        ``compute_dtype`` defaults to bf16 on the card, f32 on the CPU."""
        if spec_k or draft_layers:
            raise not_ported("speculative decode", "speculative decode and prefix reuse")
        if snapshot_fn is not None or epoch_fn is not None or max_stale_rounds:
            raise not_ported("weight hot swap", "hot swap and install_wire")
        if weight_format not in WEIGHT_FORMATS:
            raise ValueError(f"unknown weight_format {weight_format!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        if compute_dtype is None:  # bf16 on the card; f32 on the CPU, where bf16 matmuls are slow
            compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.compute_dtype = compute_dtype
        self.num_slots = int(num_slots)
        self.max_context = int(max_context)
        self.prefill_buckets = sorted(min(int(b), self.max_context) for b in prefill_buckets)
        self.weight_format = weight_format
        self.params = self._assemble(params)
        self.weights_epoch = int(epoch)
        self.swap_count = 0
        # wall seconds per stage, each ending in a device sync
        self.stage_seconds = {"prefill": 0.0, "decode": 0.0}
        cache = init_kv_cache(
            cfg, self.num_slots, self.max_context, self.compute_dtype, self.device
        )
        self.cache_k, self.cache_v = cache["k"], cache["v"]

    # -- weight residency ---------------------------------------------------

    def _assemble(self, params: dict) -> dict:
        """The engine's own copy of ``params`` on its device. Dense leaves
        are held in the compute dtype: the JAX engine keeps f32 masters
        and casts them at every forward, which gives the same weights,
        while the card holds one copy. Under ``w4`` the stacked decoder
        matmuls ([L, in, out] leaves under "layers") are packed instead;
        norms, embeddings and the lm head stay dense."""

        def walk(tree, path):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            x = torch.as_tensor(tree)
            if self.weight_format == "w4" and path[0] == "layers" and x.dim() == 3:
                q, s = pack_blockwise4_stacked(x.to(self.device, torch.float32))
                return PackedW4(q, s, tuple(x.shape[1:]))
            return x.to(device=self.device, dtype=self.compute_dtype, copy=True)

        return walk(params, ())

    def install_params(self, epoch: int, params: dict) -> None:
        """Direct rebind of uncompressed weights (static-weight serving)."""
        self.params = self._assemble(params)
        self.weights_epoch = int(epoch)
        self.swap_count += 1

    def install_wire(self, epoch: int, blobs, codec_name: str) -> None:
        raise not_ported("install_wire", "hot swap and install_wire")

    def kernel_probe(self, iters: int = 3) -> dict:
        raise not_ported("kernel_probe", "hot swap and install_wire")

    # -- admission ---------------------------------------------------------

    def prompt_fits(self, n: int) -> bool:
        return pick_bucket(n, self.prefill_buckets) is not None

    def admit(
        self,
        slot: int,
        prompt: Sequence[int],
        *,
        prefix_src: Optional[int] = None,
        prefix_len: int = 0,
        host_prefix: Optional[tuple] = None,
    ) -> tuple[int, np.ndarray]:
        """Prefill ``prompt`` into ``slot`` (cold: the whole prompt, padded
        to its bucket) and return (first greedy token, last-position
        logits [V] f32 on the host)."""
        if prefix_src is not None or prefix_len or host_prefix is not None:
            raise not_ported("prefix reuse", "speculative decode and prefix reuse")
        n = len(prompt)
        bucket = pick_bucket(n, self.prefill_buckets)
        if bucket is None:
            raise ValueError(
                f"prompt length {n} exceeds max bucket {self.prefill_buckets[-1]}"
            )
        t0 = time.perf_counter()
        ids = torch.zeros((1, bucket), dtype=torch.int64)
        ids[0, :n] = torch.as_tensor(np.asarray(prompt, np.int64))
        logits, ks, vs = prefill_forward(
            self.params, ids.to(self.device), n, self.cfg,
            compute_dtype=self.compute_dtype,
        )
        cache_insert(self.cache_k, self.cache_v, ks, vs, slot)
        row = logits[0].cpu().numpy()  # waits for the device
        self.stage_seconds["prefill"] += time.perf_counter() - t0
        return int(row.argmax()), row

    # -- decode ------------------------------------------------------------

    def decode_step(
        self, tokens: np.ndarray, lens: np.ndarray
    ) -> tuple[np.ndarray, torch.Tensor]:
        """One greedy token per slot. ``tokens``/``lens`` are dense [S] host
        arrays (inactive slots pass 0s; their ring writes land in masked
        rows that the slot's next tenant overwrites). Returns (next tokens
        [S] int32 on the host, logits [S, V] on the device)."""
        t0 = time.perf_counter()
        tok = torch.as_tensor(np.asarray(tokens, np.int64)).to(self.device)
        ln = torch.as_tensor(np.asarray(lens, np.int32)).to(self.device)
        logits, _, _ = decode_forward(
            self.params, tok, ln, self.cache_k, self.cache_v, self.cfg,
            compute_dtype=self.compute_dtype,
        )
        nxt = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()  # waits
        self.stage_seconds["decode"] += time.perf_counter() - t0
        return nxt, logits
