"""Audit of a soak's checkpoint directory, from the directory alone.

The counterpart of the JAX package's ``tools/soak_audit.py``; ``soak``
runs the same audit at its end. What it reads, all written into the
directory by the soak and the CLI it ran:

* ``soak_runs.jsonl``: one line per CLI run (``run``, ``pid``, ``started``,
  ``metrics_offset``: the size of ``metrics.jsonl`` when the run started,
  so the records after it are that run's own, ``log``: its stdout file,
  and for a resumed run ``latest_dump``, the newest complete dump when it
  started), and the RSS samples (``rss``);
* ``metrics.jsonl``: one record per step (``step``, ``ts``,
  ``images_per_sec``), appended by both runs;
* each run's stdout (``run<k>.log``); the resumed run prints ``resumed
  from dump <id> at step <step>``;
* the dumps (``<id:08d>/trainer_checkpoint.txt``, whose ``cur_dump_id`` is
  the step the dump holds).

The verdict: throughput over the steps (the first and last deciles, the
drift between their medians), RSS per run from its first logged step on
(the growth from that sample to its last), the staging directories a SIGKILL left (``<id>.tmp-<pid>``), and
three checks: every published dump complete, the last run finished (exit
code 0, steps logged), and the continuation. The continuation is exact
when run 2's first step in its own records (after its ``metrics_offset``)
equals the step read from the dump it says it resumed from, and that dump
is the one that was newest when run 2 started. (JAX's audit takes the
dump as the newest at or below run 2's first step, so it cannot fail.)

    python -m resnet_tpu_torch.tools.soak_audit --dir D --out audit.json

exits 0 when every check holds, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from ..train.checkpoint import dump_id_dir, parse_trainer_checkpoint

RUNS = "soak_runs.jsonl"
RESUMED = re.compile(r"resumed from dump (\d+) at step (\d+)")


def series(vals) -> Optional[Dict[str, float]]:
    """Mean, median, extremes, first- and last-decile means and medians of a
    sequence. A step's images/s is one step's wall time, which a step that
    waits for the device (or a dump's snapshot) stretches and the next
    shortens, so the medians are the steady figures."""
    if not vals:
        return None
    a = np.asarray(vals, float)
    k = max(1, len(a) // 10)
    return {"mean": float(a.mean()), "median": float(np.median(a)), "min": float(a.min()),
            "max": float(a.max()), "first_decile_mean": float(a[:k].mean()),
            "last_decile_mean": float(a[-k:].mean()),
            "first_decile_median": float(np.median(a[:k])),
            "last_decile_median": float(np.median(a[-k:])), "n": int(len(a))}


def _records(path: str, start: int, end: Optional[int] = None) -> List[Dict[str, Any]]:
    """The JSON lines of ``path`` between two byte offsets."""
    with open(path, "rb") as f:
        f.seek(start)
        data = f.read() if end is None else f.read(end - start)
    return [json.loads(line) for line in data.decode().splitlines() if line.strip()]


def _dump_step(directory: str, dump_id: int) -> Optional[int]:
    path = os.path.join(dump_id_dir(directory, dump_id), "trainer_checkpoint.txt")
    try:
        return int(parse_trainer_checkpoint(path)["cur_dump_id"])
    except (OSError, KeyError, ValueError):
        return None


def audit(directory: str) -> Dict[str, Any]:
    """The verdict on a soak directory (see the module's docstring)."""
    runs, rss = [], {}
    with open(os.path.join(directory, RUNS)) as f:
        for line in f:
            rec = json.loads(line)
            if "rss" in rec:
                rss.setdefault(rec["run"], []).append((rec["t"], rec["rss"]))
            else:
                runs.append(rec)
    runs.sort(key=lambda r: r["run"])
    metrics = os.path.join(directory, "metrics.jsonl")
    offsets = [r["metrics_offset"] for r in runs] + [None]
    per_run = [_records(metrics, offsets[i], offsets[i + 1]) for i in range(len(runs))]
    steps = [r["step"] for recs in per_run for r in recs]
    ips = [r["images_per_sec"] for recs in per_run for r in recs if r.get("images_per_sec")]

    dumps = sorted(int(d) for d in os.listdir(directory) if re.fullmatch(r"\d{8}", d))
    complete = {d: _dump_step(directory, d) is not None for d in dumps}
    partials = sorted(d for d in os.listdir(directory) if ".tmp" in d or d.startswith("."))

    resume: Dict[str, Any] = {"exact_continuation": False}
    if len(runs) > 1:
        with open(os.path.join(directory, runs[1]["log"])) as f:
            said = RESUMED.search(f.read())
        resumed_from = int(said.group(1)) if said else None
        first = per_run[1][0]["step"] if per_run[1] else None
        dump_step = None if resumed_from is None else _dump_step(directory, resumed_from)
        latest = runs[1].get("latest_dump")
        resume = {"resumed_from_dump": resumed_from, "dump_step": dump_step,
                  "run2_first_logged_step": first, "latest_before_run2": latest,
                  "exact_continuation": (first is not None and first == dump_step
                                         and resumed_from == latest)}
    thr = series(ips)
    # a run's RSS from its first logged step on (before it, the process is
    # still importing and staging its batches)
    trained = {run["run"]: [mb for t, mb in rss.get(run["run"], [])
                            if recs and t >= recs[0]["ts"]]
               for run, recs in zip(runs, per_run)}
    growth = {str(k): float(v[-1] - v[0]) for k, v in sorted(trained.items()) if v}
    checks = {"all_dumps_complete": all(complete.values()),
              "exact_continuation": resume["exact_continuation"],
              "last_run_finished": runs[-1].get("returncode", 0) == 0 and bool(per_run[-1])}
    return {
        "source_dir": directory,
        "runs": [{k: r[k] for k in ("run", "pid", "returncode", "killed") if k in r}
                 for r in runs],
        "wall_seconds": (per_run[-1][-1]["ts"] - per_run[0][0]["ts"]
                         if per_run and per_run[0] and per_run[-1] else None),
        "steps_logged": len(steps),
        "final_step": steps[-1] if steps else None,
        "throughput_img_s": thr,
        "throughput_drift": (thr["last_decile_median"] / thr["first_decile_median"] - 1.0
                             if thr and thr["first_decile_median"] else None),
        "rss_mb": {str(k): series(v) for k, v in sorted(trained.items())},
        "rss_growth_mb": growth,
        "checkpoints": {"ids": dumps, "all_complete": checks["all_dumps_complete"],
                        "incomplete": [d for d, ok in complete.items() if not ok],
                        "partial_artifacts_left": partials},
        "resume": resume,
        "checks": checks,
        "ok": all(checks.values()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = audit(args.dir)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"soak_audit": "done", "ok": out["ok"], "checks": out["checks"],
                      "final_step": out["final_step"]}), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
