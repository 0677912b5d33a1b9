"""Output hashes of one training step of each engine on the card, without a
process group: the check that a change leaves every existing path's bits
and launches as they were.

For each engine ('pallas' and 'blockfused' with conv_kernels='pallas',
'fused', 'hybrid', 'fusedxla') in fp32 and bf16 compute, on the "resnet"
variant (ResNet-50 at 224^2, batch 32, fused Adam) from the seeded state and
one seeded synthetic batch: a SHA-256 of the bits of the training forward
(logits and batch statistics), then one step and a SHA-256 of the new
parameters, Adam moments, running statistics, loss and grad_norm, with the
step's launch counters' moves. One JSON line a run. cuDNN runs its
deterministic algorithms: the fp32 engines' gradient convs are cuDNN's,
whose default backward algorithms add in no fixed order, so without it two
runs of one tree already differ.

    python resnet_tpu_torch/tools/step_hashes.py --root CHECKOUT

runs the ``resnet_tpu_torch`` package of CHECKOUT (this script's own by
default), so two trees (a change and its parent) are compared by running
each in turn in one session on one card and comparing their lines.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
from pathlib import Path

import torch

ENGINES = (("pallas", "pallas"), ("fused", "xla"), ("hybrid", "xla"), ("fusedxla", "xla"),
           ("blockfused", "pallas"))
SEED = 1234


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose resnet_tpu_torch runs")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    from resnet_tpu_torch.bridge import leaves
    from resnet_tpu_torch.config import variant_config
    from resnet_tpu_torch.data import SyntheticDataset
    from resnet_tpu_torch.kernels import checks
    from resnet_tpu_torch.models import forward
    from resnet_tpu_torch.train import init_train_state, make_train_step

    if not torch.cuda.is_available():
        raise SystemExit("step_hashes: needs a CUDA device")
    checks.fp32_strict()
    torch.backends.cudnn.deterministic = True
    base = variant_config("resnet")
    data = next(SyntheticDataset(base.data.batch_size, image_dim=base.model.input_dim,
                                 num_classes=base.model.num_classes, seed=SEED))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    where = {name: (mod, attr) for name, (mod, attr, *_) in checks.KERNELS.items()}
    for kernels, conv in ENGINES:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(
                base, execution=dataclasses.replace(base.execution, kernels=kernels,
                                                    conv_kernels=conv, compute_dtype=dtype),
                optimizer=dataclasses.replace(base.optimizer, fused=True))
            state = init_train_state(cfg, torch.Generator().manual_seed(SEED), device="cuda")
            with torch.no_grad():
                logits, aux = forward(state.params, batch["images"], cfg.model, cfg.execution,
                                      bn_state=state.bn_state)
            forward_digest = _digest([logits, *leaves(aux["bn_stats"])])
            del logits, aux
            torch.cuda.synchronize()
            before = {k: getattr(m, a) for k, (m, a) in where.items()}
            state, metrics = make_train_step(cfg)(state, batch)
            torch.cuda.synchronize()
            counts = {k: getattr(m, a) - before[k] for k, (m, a) in where.items()
                      if getattr(m, a) != before[k]}
            digest = _digest(leaves([state.params, state.opt_state.means, state.bn_state])
                             + [metrics["loss"], metrics["grad_norm"]])
            print(json.dumps({"root": args.root, "kernels": kernels, "conv_kernels": conv,
                              "dtype": dtype, "forward_hash": forward_digest,
                              "hash": digest, "counts": counts,
                              "loss": metrics["loss"].item()}), flush=True)
            del state, metrics


if __name__ == "__main__":
    main()
