"""The convergence driver (resnet_tpu_torch.tools.convergence): its recipe
against the JAX tool's (tools/convergence_run.py), and a CPU rehearsal of
a few steps with a resume halfway."""

import dataclasses
import json

import pytest

from resnet_tpu import config as jcfg
from resnet_tpu_torch.tools import convergence

# the ExecutionConfig fields JAX has for the TPU alone
TPU_ONLY = {"pallas_interpret", "scoped_vmem_limit_kib", "grad_accum_unroll"}


def _jax_make_cfg(steps=12000, model="resnet18", batch=256, dim=64, classes=100, lr=0.1,
                  warmup=600, grad_accum=1, directory="/tmp/c", resume_from=-1):
    """tools/convergence_run.py's make_cfg (:82-106), its values written out."""
    return jcfg.TrainConfig(
        model=jcfg.model_config(model, input_dim=dim, num_classes=classes,
                                stride_projection_kernel=1),
        execution=jcfg.ExecutionConfig(compute_dtype="bfloat16", matmul_precision="default",
                                       grad_accum=grad_accum),
        optimizer=jcfg.OptimizerConfig(name="sgd", momentum=0.9, learning_rate=lr,
                                       weight_decay=1e-4, wd_mask="no_bn", label_smoothing=0.1,
                                       schedule="step", warmup_steps=warmup, total_steps=steps),
        data=jcfg.DataConfig(batch_size=batch, synthetic=True, transfer_dtype="bfloat16"),
        checkpoint_dir=directory, checkpoint_every=1000, async_checkpoint=True, log_every=100,
        resume_from=resume_from)


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["execution"] = {k: v for k, v in out["execution"].items() if k not in TPU_ONLY}
    return json.loads(json.dumps(out))


@pytest.mark.parametrize("argv,jax_kw", [
    ([], {}),
    (["--steps", "8000", "--lr", "0.03", "--warmup", "400", "--grad-accum", "2"],
     dict(steps=8000, lr=0.03, warmup=400, grad_accum=2)),
    (["--model", "resnet50", "--batch", "32", "--dim", "32", "--classes", "10"],
     dict(model="resnet50", batch=32, dim=32, classes=10)),
], ids=["defaults", "r5", "resnet50"])
@pytest.mark.parametrize("resume_from", [-1, jcfg.RESUME_LATEST])
def test_make_config_is_the_jax_recipe_field_for_field(argv, jax_kw, resume_from):
    """make_config equals the JAX tool's TrainConfig in every field but
    JAX's TPU-only ones, with the flags' defaults; the engines default to
    JAX's 'xla'."""
    args = convergence.parser().parse_args(argv + ["--dir", "/tmp/c", "--out", "x.json"])
    got = _fields(convergence.make_config(args, resume_from))
    want = _fields(_jax_make_cfg(directory="/tmp/c", resume_from=resume_from, **jax_kw))
    assert got == want
    assert (args.kernels, args.conv_kernels) == ("xla", "xla")


def test_engine_flags_set_the_execution_config():
    args = convergence.parser().parse_args(["--kernels", "pallas", "--conv-kernels", "pallas",
                                            "--out", "x.json"])
    ecfg = convergence.make_config(args).execution
    assert (ecfg.kernels, ecfg.conv_kernels) == ("pallas", "pallas")


@pytest.mark.parametrize("kernels", ["xla", "pallas"])
def test_rehearsal_resumes_exactly_and_writes_the_schema(tmp_path, kernels):
    """A few steps of the tiny model on the CPU with the resume halfway:
    the JAX tool's record (config, resume, curve, final, wall_seconds),
    platform 'cpu', the resume exact, every curve point finite, and the
    checkpoint directory it made for itself removed."""
    out = tmp_path / "conv.json"
    rec = convergence.main(["--device", "cpu", "--model", "tiny", "--steps", "6", "--batch", "8",
                            "--dim", "16", "--classes", "8", "--eval-every", "3",
                            "--eval-batches", "1", "--warmup", "2", "--kernels", kernels,
                            "--conv-kernels", kernels, "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    assert set(rec) == {"config", "resume", "curve", "final", "wall_seconds"}
    assert rec["config"]["platform"] == "cpu" and rec["config"]["kernels"] == kernels
    assert rec["resume"] == {"at_step": 3, "restored_step": 3, "exact": True}
    assert [(c["step"], c["phase"]) for c in rec["curve"]] == [
        (3, "pre-resume"), (6, "post-resume"), (6, "final")]
    for c in rec["curve"]:
        assert 0 <= c["top1"] <= c["top5"] <= 1 and c["eval_loss"] > 0 and c["train_loss"] > 0
    assert set(rec["final"]) == {"fp_top1", "fp_top5", "int8_top1", "int8_top5",
                                 "int8_minus_fp_top1"}
    assert not list(tmp_path.glob("convergence-*"))


def test_rehearsal_keeps_a_directory_it_is_given(tmp_path):
    d = tmp_path / "dumps"
    convergence.main(["--device", "cpu", "--model", "tiny", "--steps", "4", "--batch", "8",
                      "--dim", "16", "--classes", "8", "--eval-every", "2", "--eval-batches",
                      "1", "--warmup", "1", "--dir", str(d), "--out", str(tmp_path / "c.json")])
    assert (d / "77777777").is_dir() and (d / "metrics.jsonl").is_file()
