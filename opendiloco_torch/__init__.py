"""OpenDiLoCo in PyTorch on an NVIDIA H100: the port of ``opendiloco_tpu``.

The JAX package beside this one is the reference. This package imports
neither it nor JAX: where it needs host code from there, it keeps its own
copy. Module, function and array layouts at public functions mirror the
JAX package so each piece can be held against its counterpart.

Layout:
    device     -- resolve the target device (the card unless told otherwise)
    config     -- the ``ServeConfig`` fields the serving plane reads
    quant      -- blockwise-4-bit packer for ``weight_format="w4"``
    models/    -- functional Llama (prefill / paged decode), configs, weight IO
    ops/       -- plain attention, the hand-written CUDA kernels and their build
    serve/     -- serving engine, continuous batcher, ``build_serving``

Entry points run on the card by default and raise when it is absent;
tests pass ``device="cpu"``, where every kernel wrapper takes its plain
PyTorch version.
"""

__version__ = "0.1.0"
