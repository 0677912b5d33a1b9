"""Training metrics logging: a copy of resnet_tpu.utils.logging (pure
Python; a metric may be a float or a 0-d tensor, read with ``float``).

The reference prints per-iter loss/accuracy and appends the batch-average
loss to avg_loss_log.txt with an immediate flush (resnet.cu:3386-3389), and
keeps per-epoch aggregates in trainer arrays (resnet.cu:3410-3412). Same
behavior here, plus structured JSONL for tooling.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, print_every: int = 1,
                 batch_size: int = 0):
        self.log_dir = log_dir
        self.print_every = print_every
        self.batch_size = batch_size
        self._last_ts: Optional[float] = None
        self.loss_history = []
        self.acc_history = []
        self._loss_f = self._jsonl_f = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            # avg_loss_log.txt: one loss per line, flushed per step
            self._loss_f = open(os.path.join(log_dir, "avg_loss_log.txt"), "a")
            self._jsonl_f = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log_step(self, step: int, metrics: Dict[str, float], epoch: int = 0):
        loss = float(metrics.get("loss", float("nan")))
        acc = float(metrics.get("accuracy", float("nan")))
        self.loss_history.append(loss)
        self.acc_history.append(acc)
        if self._loss_f:
            self._loss_f.write(f"{loss}\n")
            self._loss_f.flush()  # resnet.cu:3389
        now = time.time()
        if self._last_ts is not None and self.batch_size:
            dt = now - self._last_ts
            if dt > 0:
                metrics = dict(metrics)
                metrics["images_per_sec"] = self.batch_size / dt
        self._last_ts = now
        if self._jsonl_f:
            rec = {"step": step, "epoch": epoch, "ts": now}
            rec.update({k: float(v) for k, v in metrics.items()})
            self._jsonl_f.write(json.dumps(rec) + "\n")
            self._jsonl_f.flush()
        if self.print_every and step % self.print_every == 0:
            extras = " ".join(
                f"{k}={float(v):.4g}"
                for k, v in metrics.items()
                if k not in ("loss", "accuracy")
            )
            print(f"step {step} (epoch {epoch}): loss={loss:.5f} acc={acc:.4f} {extras}")

    def epoch_summary(self, epoch: int, steps: int):
        if not self.loss_history:
            return {}
        recent_l = self.loss_history[-steps:]
        recent_a = self.acc_history[-steps:]
        summary = {
            "epoch": epoch,
            "avg_loss": sum(recent_l) / len(recent_l),
            "avg_accuracy": sum(recent_a) / len(recent_a),
        }
        print(
            f"epoch {epoch}: avg_loss={summary['avg_loss']:.5f} "
            f"avg_acc={summary['avg_accuracy']:.4f}"
        )
        return summary

    def close(self):
        for f in (self._loss_f, self._jsonl_f):
            if f:
                f.close()
