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
                  paged decode), configs, HF weight directories
    ops/       -- plain attention, the hand-written CUDA kernels (flash
                  attention, paged decode attention, W4 matmul), their
                  build and their launch counter
    trainer    -- ``InnerTrainer``: one worker's train step (AdamW, clip,
                  accumulation, fp16 loss scaling), on one device or cut
                  over a process group
    parallel/  -- the sharding strategies over ``torch.distributed``: mesh,
                  specs and blocks, collectives, the world messenger
    diloco/    -- outer loop: loopback backend, outer SGD, ``DiLoCoOptimizer``,
                  state-tree packing
    data/      -- fake token streams and the batching loader
    ckpt       -- checkpoint and resume (``device_state.safetensors`` and
                  the JAX package's sidecar files)
    train      -- ``train()``: one DiLoCo worker's training loop, and the
                  command line (``python -m opendiloco_torch.train``)
    serve/     -- serving engine, continuous batcher, ``build_serving``
    obs/       -- the obs plane: tracer, exporters, Prometheus, request
                  traces, flight recorder, watchdogs, MFU (off unless
                  ``ODTP_OBS`` is set)
    utils/     -- loggers, the safetensors reader and writer, parameter
                  fingerprints

Entry points run on the card by default and raise when it is absent;
tests pass ``device="cpu"``, where every kernel wrapper takes its plain
PyTorch version.
"""

__version__ = "0.1.0"
