"""OpenDiLoCo in PyTorch on an NVIDIA H100: the port of ``opendiloco_tpu``.

The JAX package beside this one is the reference. This package imports
neither it nor JAX: where it needs host code from there, it keeps its own
copy. Module, function and array layouts at public functions mirror the
JAX package so each piece can be held against its counterpart.

Layout:
    device     -- resolve the target device (the card unless told otherwise)
    config     -- the ``Config``/``DilocoConfig``/``ServeConfig`` fields the port reads
    quant      -- blockwise-4-bit packer for ``weight_format="w4"``
    models/    -- functional Llama (training forward and loss, prefill /
                  paged decode), configs, weight IO
    ops/       -- plain attention, the hand-written CUDA kernels (flash
                  attention, paged decode attention, W4 matmul), their
                  build and their launch counter
    trainer    -- ``InnerTrainer``: one worker's train step (AdamW, clip,
                  accumulation, fp16 loss scaling)
    diloco/    -- outer loop: loopback backend, outer SGD, ``DiLoCoOptimizer``
    data/      -- fake token streams and the batching loader
    train      -- ``train()``: one DiLoCo worker's training loop
    serve/     -- serving engine, continuous batcher, ``build_serving``
    utils/     -- loggers and parameter fingerprints

Entry points run on the card by default and raise when it is absent;
tests pass ``device="cpu"``, where every kernel wrapper takes its plain
PyTorch version.
"""

__version__ = "0.1.0"
