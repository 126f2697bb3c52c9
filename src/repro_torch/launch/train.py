"""Training launcher of the port.

    python -m repro_torch.launch.train --arch qwen3_8b --smoke --steps 50
    python -m repro_torch.launch.train --arch granite_3_8b --smoke --steps 100 \\
        --checkpoint-dir ckpt              # stop it and rerun → resumes

The reference's command line (``repro.launch.train``) plus ``--device``
(default ``cuda``; the launcher raises where there is no CUDA device, and
``--device cpu`` runs the kernels' plain versions). ``--arch`` offers the
archs whose ``loss`` the port has: the ``TransformerLM`` families (dense,
MoE, VLM backbone). RecurrentGemma, xLSTM and Whisper are refused with the
ROADMAP item that brings them. Checkpoints are in the reference's format, so
a run the reference started resumes here and the reverse.
"""
from __future__ import annotations

import argparse

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..models.transformer import TransformerLM
from ..train.optimizer import AdamWConfig
from ..train.train_loop import TrainConfig, train

TRAIN_ARCHS = tuple(a for a in ARCH_IDS if get_smoke_config(a).family in TransformerLM.FAMILIES)

# the reference's training archs that the port cannot train yet, by the
# ROADMAP.md item that brings each
NOT_YET = {
    "recurrentgemma_9b": "ROADMAP.md queue 1 item 11 (RecurrentGemma's loss, with a backward of kernel 4)",
    "xlstm_350m": "ROADMAP.md queue 1 item 9 (models/xlstm.py)",
    "whisper_small": "ROADMAP.md queue 1 item 9 (models/whisper.py)",
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=TRAIN_ARCHS + tuple(NOT_YET), required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.arch in NOT_YET:
        ap.error(f"--arch {args.arch}: the port cannot train it yet; {NOT_YET[args.arch]}")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tc = TrainConfig(
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        microbatches=args.microbatches,
        checkpoint_dir=args.checkpoint_dir,
    )
    out = train(cfg, tc, AdamWConfig(lr=args.lr, warmup_steps=10), device=args.device)
    print(
        f"done: arch={cfg.name} device={args.device} steps={out['steps_run']} "
        f"(resumed at {out['start_step']}) loss {out['first_loss']:.4f} -> "
        f"{out['last_loss']:.4f} in {out['wall_s']:.1f}s"
    )
    return out


if __name__ == "__main__":
    main()
