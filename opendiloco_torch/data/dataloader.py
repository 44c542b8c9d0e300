"""Host-side data pipeline: fake token streams, batched on a thread.

The port's copy of the fake-data part of
``opendiloco_tpu/data/dataloader.py``: ``FakeTokenizedDataset`` (numpy
only, so the port yields the same batches as the JAX package),
``DataLoader`` and the fake branch of ``get_dataloader``. Process rank
and count come from ``torch.distributed`` when it is initialized, else 0
and 1. The HF streaming and indexed branches raise (ROADMAP.md A9).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

IGNORE_INDEX = -100


def process_index_and_count() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class _ProducerError:
    """Sentinel carrying a prefetch-thread failure to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class FakeTokenizedDataset:
    """Deterministic infinite stream of synthetic token sequences.

    Counter-based: sample ``i`` of a seed is a pure function of ``(seed,
    i)``; process ``p`` of ``n`` yields samples ``p, p + n, ...``.
    ``mode="random"`` yields uniform tokens (loss sits at ln(vocab));
    ``mode="ramp"`` yields consecutive-token ramps from a random start,
    which a model can learn, so loss-descent checks are meaningful."""

    def __init__(self, seq_length: int, vocab_size: int, seed: int = 0, start: int = 0,
                 stride: int = 1, mode: str = "random"):
        if vocab_size <= 3:
            raise ValueError("vocab_size must be greater than 3")
        if mode not in ("random", "ramp"):
            raise ValueError(f"unknown fake-data mode {mode!r}")
        self.seq_length = seq_length
        self.vocab_size = vocab_size
        self.seed = seed
        self.start = start
        self.stride = stride
        self.mode = mode
        self.samples_seen = 0  # local count; global index = start + i * stride

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            idx = self.start + self.samples_seen * self.stride
            rng = np.random.default_rng((self.seed, idx))
            if self.mode == "ramp":
                first = rng.integers(0, self.vocab_size)
                ids = ((first + np.arange(self.seq_length)) % self.vocab_size).astype(np.int32)
            else:
                ids = rng.integers(3, self.vocab_size, self.seq_length).astype(np.int32)
            self.samples_seen += 1
            yield {"input_ids": ids, "labels": ids.copy()}

    def state_dict(self) -> dict:
        return {"samples_seen": self.samples_seen, "seed": self.seed}

    def load_state_dict(self, sd: dict) -> None:
        self.samples_seen = sd["samples_seen"]
        self.seed = sd["seed"]


class DataLoader:
    """Batches samples and prefetches them on a background thread.
    ``state_dict()`` is exact for the last batch the consumer received.
    The port's only dataset is infinite, so the JAX loader's wrap into a
    next data epoch is not carried over: a dataset that ends, or fails,
    raises in the consumer."""

    def __init__(self, dataset, batch_size: int, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.prefetch = prefetch
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._delivered_state = None

    def _producer(self) -> None:
        try:
            it = iter(self.dataset)
            while not self._stop.is_set():
                batch = [next(it) for _ in range(self.batch_size)]
                out = {k: np.stack([b[k] for b in batch]) for k in batch[0].keys()}
                # dataset state as of after this batch, whatever the queue holds
                snap = self.dataset.state_dict()
                while not self._stop.is_set():
                    try:
                        self._queue.put((out, snap), timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced to the consumer, never lost
            self._queue.put(_ProducerError(RuntimeError(f"data producer failed: {e!r}")))

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        self._stop.clear()
        self._queue = queue.Queue(maxsize=self.prefetch)
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        while True:
            item = self._queue.get()
            if isinstance(item, _ProducerError):
                raise item.error
            out, self._delivered_state = item
            yield out

    def stop(self) -> None:
        self._stop.set()

    def state_dict(self) -> dict:
        if self._delivered_state is None:
            return {"dataset": self.dataset.state_dict()}
        return {"dataset": self._delivered_state}

    def load_state_dict(self, sd: dict) -> None:
        self.dataset.load_state_dict(sd["dataset"])


def get_dataloader(
    *,
    fake_data: bool,
    fake_data_mode: str = "random",
    dataset_name_or_paths: str,
    tokenizer_name: str,
    seq_length: int,
    batch_size: int,
    vocab_size: int,
    world_rank: int = 0,
    galaxy_size: int = 1,
    seed: int = 42,
    split: str = "train",
    streaming: bool = True,
) -> DataLoader:
    """The JAX package's factory; only ``fake_data=True`` is ported."""
    if not fake_data:
        raise NotImplementedError(
            f"loading {dataset_name_or_paths!r} (HF streaming or indexed data) is not "
            "ported yet (ROADMAP.md A9); use fake_data"
        )
    index, count = process_index_and_count()
    # a different seed stream acts as the held-out split
    offset = 0 if split == "train" else 10_000_019
    ds = FakeTokenizedDataset(
        seq_length, vocab_size, seed=seed + world_rank + offset, start=index, stride=count,
        mode=fake_data_mode,
    )
    return DataLoader(ds, batch_size)
