"""Convergence driver: train a ResNet on the procedural classes to a held-out
accuracy, with a mid-run resume and a final int8 evaluation.

The counterpart of the JAX package's ``tools/convergence_run.py``, with its
flags, defaults and recipe (``make_config``): SGD with momentum 0.9, linear
warmup then step decay, weight decay 1e-4 with the ``no_bn`` mask, label
smoothing 0.1, bf16 compute at ``matmul_precision='default'``, the
standard topology, async checkpoints. It trains on ``data/procedural.py``'s
classes (train and eval are disjoint instance streams), evaluates the
running-statistics forward every ``--eval-every`` steps, stops at
``--resume-at`` (0: halfway), builds a fresh ``Trainer`` from the latest
dump with the stream skipped to the restored step, trains to ``--steps``,
and ends with the W8A8 post-training-quantized model (``quantize``),
calibrated on a real training batch, evaluated on the same held-out batches.

    python -m resnet_tpu_torch.tools.convergence --out conv.json \
        [--device cuda|cpu] [--kernels pallas --conv-kernels pallas] ...

CPU rehearsal (a few seconds):

    python -m resnet_tpu_torch.tools.convergence --device cpu --model tiny \
        --steps 6 --batch 8 --dim 16 --classes 8 --eval-every 3 \
        --eval-batches 1 --warmup 2 --out /tmp/conv.json

``--device`` takes the place of JAX_PLATFORMS; ``--kernels`` and
``--conv-kernels`` set those ``ExecutionConfig`` fields (default 'xla', as
JAX's). The JSON written to ``--out`` has the JAX tool's schema (config,
resume, curve, final, wall_seconds); the config also names the platform
('gpu' or 'cpu'), the engines and, on the card, its name and power limit as
``nvidia-smi`` prints them, and each curve point the training loss of the
last step before it. Checkpoints go to ``--dir`` (default: a temporary
directory, removed at the end).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import tempfile
import time
from typing import Any, Dict, List

import torch

from ..config import (
    RESUME_LATEST,
    DataConfig,
    ExecutionConfig,
    OptimizerConfig,
    TrainConfig,
    model_config,
    tiny_model_config,
)
from ..data.procedural import ProceduralDataset, ProceduralIterator

ENGINES = ["xla", "pallas", "fused", "hybrid", "fusedxla", "blockfused"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--model", default="resnet18")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--classes", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--warmup", type=int, default=600)
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--eval-batches", type=int, default=20)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches a step (the benchmark headline runs 2)")
    ap.add_argument("--resume-at", type=int, default=0,
                    help="0 = halfway: stop, rebuild the Trainer from the latest dump,"
                         " continue")
    ap.add_argument("--dir", default="",
                    help="checkpoint directory (default: a temporary one, removed)")
    ap.add_argument("--out", required=True, help="where to write the JSON record")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--kernels", default="xla", choices=ENGINES)
    ap.add_argument("--conv-kernels", default="xla", choices=["xla", "pallas"])
    return ap


def make_config(args, resume_from: int = -1) -> TrainConfig:
    """The recipe (``tools/convergence_run.py``'s ``make_cfg``, field for
    field) with the engines ``--kernels`` and ``--conv-kernels`` name."""
    mcfg = (tiny_model_config(input_dim=args.dim, num_classes=args.classes)
            if args.model == "tiny" else
            model_config(args.model, input_dim=args.dim, num_classes=args.classes,
                         stride_projection_kernel=1))
    return TrainConfig(
        model=mcfg,
        execution=ExecutionConfig(
            compute_dtype="bfloat16", matmul_precision="default",
            grad_accum=args.grad_accum, kernels=args.kernels,
            conv_kernels=args.conv_kernels,
        ),
        optimizer=OptimizerConfig(
            name="sgd", momentum=0.9,
            learning_rate=args.lr, weight_decay=1e-4, wd_mask="no_bn",
            label_smoothing=0.1,
            schedule="step", warmup_steps=args.warmup,
            total_steps=args.steps,
        ),
        data=DataConfig(batch_size=args.batch, synthetic=True, transfer_dtype="bfloat16"),
        checkpoint_dir=args.dir,
        checkpoint_every=1000,
        async_checkpoint=True,
        log_every=100,
        resume_from=resume_from,
    )


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def run(args) -> Dict[str, Any]:
    """Train, resume, evaluate; the record ``main`` writes."""
    from ..train import Trainer

    resume_at = args.resume_at or args.steps // 2
    ds = ProceduralDataset(num_classes=args.classes, image_dim=args.dim)

    def train_iter(start_batch=0):
        # the stream is index-keyed: a resumed leg continues on fresh
        # instances after the restored step
        return ProceduralIterator(ds, args.batch, seed=1, start_batch=start_batch)

    def eval_iter():
        return ProceduralIterator(ds, args.batch, seed=1, evaluation=True)

    curve: List[Dict[str, Any]] = []

    def evaluate(trainer, tag, train_loss):
        m = trainer.evaluate(eval_iter(), args.eval_batches)
        rec = {"step": int(trainer.state.step), "eval_loss": round(m["loss"], 4),
               "top1": round(m["accuracy"], 4), "top5": round(m.get("top5", 0.0), 4),
               "train_loss": train_loss, "phase": tag}
        curve.append(rec)
        print("eval:", json.dumps(rec), flush=True)
        return rec

    t0 = time.time()
    trainer = Trainer(make_config(args), data_source=train_iter(), device=args.device)
    done, loss = 0, None
    while done < resume_at:
        n = min(args.eval_every, resume_at - done)
        loss = trainer.run(n).get("loss")
        done += n
        evaluate(trainer, "pre-resume", loss)
    trainer.finalize()
    del trainer

    # a fresh Trainer restores the state, the optimizer and the schedule's
    # position from the latest dump, the stream skipped to the restored step
    resume_stream = train_iter()
    trainer = Trainer(make_config(args, resume_from=RESUME_LATEST), data_source=resume_stream,
                      device=args.device)
    resumed_step = int(trainer.state.step)
    resume_stream.skip(resumed_step)
    while done < args.steps:
        n = min(args.eval_every, args.steps - done)
        loss = trainer.run(n).get("loss")
        done += n
        evaluate(trainer, "post-resume", loss)
    final_fp = evaluate(trainer, "final", loss)

    # int8 PTQ of the learned state, calibrated on a real training batch
    calib = next(train_iter())["images"][: min(64, args.batch)]
    qm = trainer.evaluate_quantized(eval_iter(), args.eval_batches, calib_images=calib)
    trainer.finalize()
    wall = time.time() - t0

    on_card = args.device == "cuda"
    return {
        "config": {
            "model": args.model, "dim": args.dim, "classes": args.classes,
            "batch": args.batch, "dtype": "bfloat16", "grad_accum": args.grad_accum,
            "recipe": "sgd momentum=0.9, lr={} linear-warmup {} steps, "
                      "step decay, wd 1e-4 no_bn mask, smoothing 0.1, "
                      "zero-gamma init, flip+translate augmentation, BN "
                      "running stats for eval".format(args.lr, args.warmup),
            "dataset": "procedural {}-class texture+shape, held-out instance stream "
                       "for eval".format(args.classes),
            "steps": args.steps,
            "kernels": args.kernels, "conv_kernels": args.conv_kernels,
            "platform": "gpu" if on_card else "cpu",
            "device": card_line() if on_card else "cpu",
            "torch": torch.__version__,
        },
        "resume": {"at_step": resume_at, "restored_step": resumed_step,
                   "exact": resumed_step == resume_at},
        "curve": curve,
        "final": {
            "fp_top1": final_fp["top1"],
            "fp_top5": final_fp["top5"],
            "int8_top1": round(qm["accuracy"], 4),
            "int8_top5": round(qm.get("top5", 0.0), 4),
            "int8_minus_fp_top1": round(qm["accuracy"] - final_fp["top1"], 4),
        },
        "wall_seconds": round(wall, 1),
    }


def main(argv=None) -> Dict[str, Any]:
    args = parser().parse_args(argv)
    scratch = not args.dir
    if scratch:
        args.dir = tempfile.mkdtemp(prefix="convergence-")
    try:
        out = run(args)
    finally:
        if scratch:
            shutil.rmtree(args.dir, ignore_errors=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({
        "convergence": "done", "final_top1": out["final"]["fp_top1"],
        "int8_top1": out["final"]["int8_top1"], "resume_exact": out["resume"]["exact"],
        "wall_s": out["wall_seconds"]}), flush=True)
    return out


if __name__ == "__main__":
    main()
