"""Write fresh Llama weights from a size config as a model directory.

The port's counterpart of ``opendiloco_tpu/models/init_weights.py``, with
its flags::

    python -m opendiloco_torch.models.init_weights \\
        --config 2m --output models/llama-2m-fresh [--seed 42]

Writes an HF llama directory (``model.safetensors`` and ``config.json``)
that this package, the JAX package and ``transformers`` load. The weights
are drawn on the CPU with ``torch.Generator().manual_seed(seed)``, so one
seed writes the same bytes on any machine (the JAX CLI's ``jax.random``
draws differ; the layout, names and dtypes are the same). An MoE config
raises, as the JAX CLI's ``save_params`` does: HF llama has no routed
experts.
"""
from __future__ import annotations

import argparse

import torch

from opendiloco_torch.models import hf_io
from opendiloco_torch.models.llama import init_params, num_params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True, help="size name (2m..1b) or config path")
    ap.add_argument("--output", required=True, help="output model directory")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    cfg = hf_io.load_config(args.config)
    params = init_params(torch.Generator().manual_seed(args.seed), cfg)
    hf_io.save_params(params, cfg, args.output)
    print(f"wrote {num_params(cfg):,}-param llama ({args.config}) to {args.output}")


if __name__ == "__main__":
    main()
