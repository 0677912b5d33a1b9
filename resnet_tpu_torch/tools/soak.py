"""Soak: train through the CLI, kill it with SIGKILL between checkpoints,
resume it, and audit the run.

The counterpart of the JAX package's ``tools/soak.py``:

1. launches ``python -m resnet_tpu_torch.train.cli`` with JAX's flags
   (``--model``, the standard topology, synthetic data staged on the device
   (``--device-batches``), the s2d stem, ``--batch-size``, bf16,
   ``--steps``, async checkpoints every ``--checkpoint-every`` steps), on
   ``--device`` with the engines ``--kernels`` and ``--conv-kernels``;
2. samples the trainer's RSS from ``/proc/<pid>/status`` every
   ``--sample-every`` seconds;
3. sends it SIGKILL, with no warning: ``--kill-at`` seconds into the run,
   or, with ``--kill-after-dump ID``, as soon as a complete dump with an id
   of at least ID is published (polled, not waited for);
4. relaunches it with ``--resume-from latest`` for the remaining steps;
5. audits the directory (``soak_audit.audit``): throughput drift, RSS
   growth, every dump complete, the staging directories left, and the
   continuation, read from run 2's own records and from the dump it
   resumed from.

Each run's stdout goes to ``run<k>.log`` in ``--dir``; ``soak_runs.jsonl``
records each run (its pid, start time, where its records begin in
``metrics.jsonl``, for run 2 the newest dump when it started) and the RSS
samples, so ``soak_audit`` can repeat the verdict from the directory alone.

    python -m resnet_tpu_torch.tools.soak --dir D --out soak.json \
        [--device cuda|cpu] [--kernels pallas --conv-kernels pallas] ...

CPU rehearsal: ``--device cpu --model tiny --steps 12 --batch 8
--device-batches 2 --checkpoint-every 4 --kill-after-dump 4``. Exits 0
when the audit's checks hold, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List

from ..train.checkpoint import discover_latest_dump
from .soak_audit import RUNS, audit


def rss_mb(pid: int):
    """The process's resident set in MiB, or None once it is gone."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        return None
    return None


def cli_args(args, resume: bool, steps: int) -> List[str]:
    """The CLI's arguments for one run."""
    cmd = [sys.executable, "-m", "resnet_tpu_torch.train.cli",
           "--model", args.model, "--projections", "standard", "--synthetic"]
    if args.model != "tiny":
        cmd.append("--space-to-depth")
    cmd += ["--device-batches", str(args.device_batches),
            "--batch-size", str(args.batch), "--dtype", "bfloat16",
            "--steps", str(steps), "--checkpoint-dir", args.dir,
            "--checkpoint-every", str(args.checkpoint_every),
            "--async-checkpoint", "--log-every", str(args.log_every),
            "--device", args.device, "--kernels", args.kernels,
            "--conv-kernels", args.conv_kernels]
    return cmd + (["--resume-from", "latest"] if resume else [])


class Run:
    """One CLI run: its process, its record in ``soak_runs.jsonl``."""

    def __init__(self, args, k: int, resume: bool, steps: int):
        self.args, self.k = args, k
        metrics = os.path.join(args.dir, "metrics.jsonl")
        self.record: Dict[str, Any] = {
            "run": k, "log": f"run{k}.log", "started": time.time(),
            "metrics_offset": os.path.getsize(metrics) if os.path.exists(metrics) else 0}
        if resume:
            self.record["latest_dump"] = discover_latest_dump(args.dir)
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        with open(os.path.join(args.dir, self.record["log"]), "w") as log:
            self.proc = subprocess.Popen(cli_args(args, resume, steps), cwd=root,
                                         stdout=log, stderr=subprocess.STDOUT)
        self.record["pid"] = self.proc.pid
        self.rss: List[float] = []

    def _sample(self) -> None:
        mb = rss_mb(self.proc.pid)
        if mb is not None:
            self.rss.append(mb)
            _append(self.args.dir, {"run": self.k, "t": time.time(), "rss": mb})

    def watch(self, until=lambda: False) -> bool:
        """Sample RSS until the process exits (False) or ``until()`` holds
        (True, the process still running)."""
        while self.proc.poll() is None:
            if until():
                return True
            self._sample()
            time.sleep(self.args.sample_every)
        return False

    def finish(self, killed: bool) -> None:
        if killed:
            os.kill(self.proc.pid, signal.SIGKILL)
        self.proc.wait()
        self.record.update(returncode=self.proc.returncode, killed=killed, ended=time.time())
        _append(self.args.dir, self.record)


def _append(directory: str, rec: Dict[str, Any]) -> None:
    with open(os.path.join(directory, RUNS), "a") as f:
        f.write(json.dumps(rec) + "\n")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=25000)
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--kill-at", type=float, default=1080.0,
                    help="seconds into run 1 to send it SIGKILL")
    ap.add_argument("--kill-after-dump", type=int, default=-1,
                    help="send SIGKILL as soon as a complete dump with at least this id"
                         " exists, instead of at --kill-at")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device-batches", type=int, default=8)
    ap.add_argument("--checkpoint-every", type=int, default=1000)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--sample-every", type=float, default=5.0,
                    help="seconds between RSS samples")
    ap.add_argument("--dir", required=True, help="the run's checkpoint directory (new)")
    ap.add_argument("--out", required=True, help="where to write the JSON record")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--kernels", default="xla", choices=["xla", "pallas", "fused"])
    ap.add_argument("--conv-kernels", default="xla", choices=["xla", "pallas"])
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    args.dir = os.path.abspath(args.dir)  # the CLI runs from the checkout's root
    os.makedirs(args.dir, exist_ok=False)
    t0 = time.time()

    run1 = Run(args, 1, resume=False, steps=args.steps)
    if args.kill_after_dump >= 0:
        def due():
            latest = discover_latest_dump(args.dir)
            return latest is not None and latest >= args.kill_after_dump
    else:
        deadline = t0 + args.kill_at

        def due():
            return time.time() >= deadline
    run1.finish(killed=run1.watch(due))
    latest = discover_latest_dump(args.dir)
    if latest is None:
        raise SystemExit("soak: no complete dump after run 1")

    run2 = Run(args, 2, resume=True, steps=max(args.steps - latest, 1))
    run2.watch()
    run2.finish(killed=False)

    out = {"config": {"model": args.model, "topology": "standard", "batch": args.batch,
                      "dtype": "bfloat16", "space_to_depth": args.model != "tiny",
                      "device": args.device, "kernels": args.kernels,
                      "conv_kernels": args.conv_kernels,
                      "input": f"synthetic, {args.device_batches} batches staged on the device",
                      "checkpoint_every": args.checkpoint_every, "async_checkpoint": True,
                      "steps_requested": args.steps,
                      "kill": (f"after dump {args.kill_after_dump}"
                               if args.kill_after_dump >= 0 else f"at {args.kill_at} s")},
           "wall_seconds": time.time() - t0,
           "run1": {"killed": run1.record["killed"], "returncode": run1.record["returncode"],
                    "seconds": run1.record["ended"] - run1.record["started"]},
           "run2": {"resumed_from_latest": latest, "steps_remaining": max(args.steps - latest, 1),
                    "returncode": run2.record["returncode"]},
           **audit(args.dir)}
    if args.device == "cuda":
        from .convergence import card_line

        out["config"]["card"] = card_line()
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"soak": "done", "ok": out["ok"], "checks": out["checks"],
                      "final_step": out["final_step"], "wall_s": out["wall_seconds"],
                      "throughput_drift": out["throughput_drift"]}), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
