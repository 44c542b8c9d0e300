"""One turn of a training-phase comparison between two checkouts.

    python /path/to/checkout/phase_turns.py ROOT 150m|1b

runs ``chip_smoke.py``'s phase 8 (``150m``) or phase 10 (``1b``) from the
checkout at ``ROOT``, with that checkout's package, on the card, and
prints one line ``TURN {json}``: the inner-step ms of each variant by
turn, the card's ms by step, the outer-step seconds and their phases, the
run's wall seconds, the losses and the checkpoint save seconds (where the
checkout's phase 8 checkpoints). Run it by file path, once a process, in
turns over the two roots (parent, change, change, parent), in one call on
one card: the phase's own a b b a turns compare its variants within a
process, this compares the two checkouts.
"""
import json
import os
import shutil
import sys


def main() -> None:
    root, model = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from opendiloco_torch.ops import build
    from opendiloco_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build(["flash_attention", "flash_attention_fwd_sm90", "flash_attention_bwd_sm90", "flash_attention_delta",
                 "fused_xent", "fused_xent_sm90"])
    dev, card = torch.device("cuda"), cs.card_line()
    if model == "150m":
        r = cs.phase_train(torch, tfa, dev, card, "150m", cs.TRAIN_150M,
                           {"kernels": dict(attn_impl="pallas"), "plain": dict(attn_impl="xla")})
    else:
        r = cs.phase_train(torch, tfa, dev, card, "1b", cs.TRAIN_1B, {"fused": {}, "unfused": dict(fused_loss=False)})
    if r.get("ckpt_path"):
        shutil.rmtree(os.path.dirname(r["ckpt_path"]), ignore_errors=True)
    keep = ("inner_step_ms_one_worker_by_variant", "inner_step_ms_one_worker_runs_in_turns", "outer_step_s",
            "outer_wait_s", "outer_d2h_s", "outer_allreduce_s", "outer_nesterov_s", "train_wall_s", "losses",
            "ckpt_save_s")
    out = {"root": root, "model": model, "card": card, **{k: r.get(k) for k in keep},
           "card_ms_per_step": [t["card_ms_per_step"] for t in r["inner_step_turns"]],
           "turn_variants": [t["variant"] for t in r["inner_step_turns"]]}
    print("TURN " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
