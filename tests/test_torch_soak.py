"""The soak driver (resnet_tpu_torch.tools.soak) on the CPU: the tiny CLI
killed by SIGKILL once its first periodic dump after step 0 is published,
resumed, and audited (resnet_tpu_torch.tools.soak_audit); and the audit
failing on directories doctored so that run 2 does not continue from the
dump it resumed from, which JAX's audit (tools/soak_audit.py:109-111)
cannot see."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from resnet_tpu_torch.tools import soak_audit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180  # seconds for the whole soak (both CLI runs); ~15 s here


@pytest.fixture(scope="module")
def soaked(tmp_path_factory):
    base = tmp_path_factory.mktemp("soak")
    d, out = base / "run", base / "soak.json"
    done = subprocess.run(
        [sys.executable, "-m", "resnet_tpu_torch.tools.soak", "--device", "cpu", "--model",
         "tiny", "--steps", "160", "--batch", "8", "--device-batches", "2",
         "--checkpoint-every", "8", "--kill-after-dump", "8", "--sample-every", "0.05",
         "--log-every", "40", "--dir", str(d), "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT)
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-3000:]
    return d, json.loads(out.read_text())


def test_soak_kills_resumes_and_audits(soaked):
    d, rec = soaked
    assert rec["ok"] and all(rec["checks"].values())
    assert rec["run1"]["killed"] and rec["run1"]["returncode"] == -9
    res = rec["resume"]
    assert res["resumed_from_dump"] == res["latest_before_run2"] >= 8
    assert res["run2_first_logged_step"] == res["dump_step"] == res["resumed_from_dump"]
    assert rec["final_step"] == 159 and rec["checkpoints"]["all_complete"]
    assert set(rec["rss_mb"]) == {"1", "2"} and rec["rss_mb"]["1"]["n"] >= 1
    assert rec["throughput_img_s"]["n"] > 100
    # the audit from the directory alone gives the same verdict
    assert soak_audit.audit(str(d))["checks"] == rec["checks"]


def _doctor(src, dst, how):
    shutil.copytree(src, dst)
    runs = [json.loads(line) for line in open(dst / soak_audit.RUNS)]
    run2 = next(r for r in runs if r.get("run") == 2 and "rss" not in r)
    path = dst / "metrics.jsonl"
    data = path.read_bytes()
    head, tail = data[:run2["metrics_offset"]], data[run2["metrics_offset"]:].splitlines(True)
    if how == "first_step_dropped":  # run 2 starts one step after its dump
        path.write_bytes(head + b"".join(tail[1:]))
    elif how == "first_step_moved":  # run 2's first record names another step
        first = json.loads(tail[0])
        first["step"] += 1
        path.write_bytes(head + (json.dumps(first) + "\n").encode() + b"".join(tail[1:]))
    else:  # run 2 says it resumed from an older dump
        log = dst / run2["log"]
        text = log.read_text()
        said = soak_audit.RESUMED.search(text)
        log.write_text(text.replace(said.group(0),
                                    f"resumed from dump 0 at step {said.group(2)}"))


@pytest.mark.parametrize("how", ["first_step_dropped", "first_step_moved", "older_dump"])
def test_audit_fails_on_a_wrong_continuation(soaked, tmp_path, how):
    d, _ = soaked
    bad = tmp_path / "bad"
    _doctor(d, bad, how)
    out = tmp_path / "audit.json"
    rc = soak_audit.main(["--dir", str(bad), "--out", str(out)])
    verdict = json.loads(out.read_text())
    assert rc == 1 and not verdict["ok"]
    assert not verdict["checks"]["exact_continuation"]
    assert verdict["checks"]["all_dumps_complete"]


def test_audit_fails_on_an_incomplete_dump(soaked, tmp_path):
    d, _ = soaked
    bad = tmp_path / "bad"
    shutil.copytree(d, bad)
    os.remove(bad / "00000000" / "trainer_checkpoint.txt")
    verdict = soak_audit.audit(str(bad))
    assert not verdict["ok"] and verdict["checkpoints"]["incomplete"] == [0]
