"""The port's command line against resnet_tpu.train.cli on the CPU.

``build_config`` gives the JAX CLI's configs field for field (the port's
``ExecutionConfig`` drops the TPU-only fields) and the same parsed
arguments, plus ``--device``, for a list of command lines, ``--variant``
included (all six presets, bf16 and NCHW among them, the fused engines
across ranks and under spatial partitioning, the s2d stem there too); the
spatial 'shard_map' command line is refused at the Trainer with JAX's
message, as JAX's Trainer refuses it. Then ``main`` with ``--device cpu`` trains the fused engine in bf16
for a step and dumps it, and trains, evaluates, resumes the latest dump
with async checkpoints and exports, as tests/test_cli.py drives the JAX
CLI.
"""

import dataclasses
import os

import numpy as np
import pytest

from resnet_tpu.train.cli import build_config as j_build_config
from resnet_tpu_torch.data import write_shard
from resnet_tpu_torch.export import load_inference
from resnet_tpu_torch.train.cli import build_config, main


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("shards"))
    for s in range(3):
        write_shard(d, s, np.zeros((2, 3, 4, 4), np.float32), np.zeros(2, np.int32))
    return d


ARGVS = [
    [],
    ["--model", "tiny", "--synthetic", "--steps", "3", "--batch-size", "8"],
    ["--shard-dir", "{shards}", "--batch-size", "64", "--epochs", "2"],
    ["--shard-dir", "{shards}", "--num-shards", "5", "--shard-images", "640",
     "--total-steps", "77", "--steps", "9"],
    ["--optimizer", "sgd", "--schedule", "step", "--steps", "100", "--weight-decay", "1e-4",
     "--wd-mask", "no_bn", "--label-smoothing", "0.1", "--warmup-steps", "5", "--lr", "0.1"],
    ["--remat", "block", "--grad-accum", "2", "--kernels", "fused", "--conv-kernels",
     "pallas", "--model", "resnet101"],
    ["--resume-from", "latest", "--async-checkpoint", "--check-errors",
     "--no-record-metrics", "--transfer-dtype", "bfloat16", "--device-batches", "4",
     "--random-flip", "--projections", "standard", "--shard-layout", "NHWC",
     "--checkpoint-every", "7", "--log-every", "3", "--seed", "5", "--no-mesh"],
    ["--evaluate", "--eval-batches", "3", "--resume-from", "12", "--export", "m.pt",
     "--export-dtype", "float32", "--jpeg-dir", "imgs"],
    # under --variant, --num-shards and --shard-images do not reach the data
    # config (a quirk of the JAX CLI, kept)
    ["--variant", "resnet", "--shard-dir", "{shards}", "--num-shards", "7",
     "--shard-images", "64"],
    ["--variant", "clean", "--synthetic", "--checkpoint-every", "4"],
    ["--variant", "lowmem", "--model", "resnet101", "--steps", "5"],
    ["--variant", "cudnn", "--model", "tiny", "--jpeg-dir", "imgs"],
    ["--variant", "fast", "--synthetic"],
    ["--variant", "nchw", "--model", "tiny", "--shard-dir", "{shards}"],
    ["--dtype", "bfloat16", "--layout", "NCHW", "--kernels", "pallas", "--conv-kernels",
     "pallas", "--shard-layout", "NHWC"],
    ["--dtype", "bfloat16", "--kernels", "fused"],
    # JAX's headline configuration: s2d, bf16, grad_accum 2, standard projections
    ["--space-to-depth", "--dtype", "bfloat16", "--grad-accum", "2", "--batch-size", "256",
     "--projections", "standard", "--model", "resnext50_32x4d", "--conv-kernels", "pallas"],
    ["--export", "m.pt", "--export-dtype", "bfloat16", "--resume-from", "latest"],
    # the data-parallel layouts that run
    ["--num-devices", "2", "--kernels", "pallas", "--conv-kernels", "pallas"],
    ["--parallel-mode", "shard_map", "--kernels", "fused"],
    ["--zero-sharding", "--no-mesh"],
    # the fused engines under 'auto' across ranks, their statistics summed
    ["--num-devices", "2", "--kernels", "fused"],
    ["--zero-sharding", "--num-devices", "2", "--kernels", "fused"],
    # spatial partitioning with a fused engine and with the s2d stem (the
    # second refused at the Trainer for 'shard_map', as JAX's)
    ["--spatial-devices", "2", "--kernels", "fused"],
    ["--parallel-mode", "shard_map", "--spatial-devices", "2", "--space-to-depth"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "defaults")
def test_build_config_matches_jax(argv, shard_dir):
    argv = [a.replace("{shards}", shard_dir) for a in argv]
    cfg, args = build_config(argv + ["--device", "cpu"])
    jcfg, jargs = j_build_config(argv)
    port_args = vars(args)
    assert port_args.pop("device") == "cpu"
    assert port_args.pop("dist_backend") == ""
    assert port_args == vars(jargs)
    for field in ("model", "optimizer", "data", "parallel"):
        assert dataclasses.asdict(getattr(cfg, field)) == dataclasses.asdict(
            getattr(jcfg, field)), field
    jex = dataclasses.asdict(jcfg.execution)
    assert dataclasses.asdict(cfg.execution) == {
        k: jex[k] for k in dataclasses.asdict(cfg.execution)}
    for f in dataclasses.fields(cfg):
        if f.name not in ("model", "execution", "optimizer", "data", "parallel"):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


def test_shard_map_spatial_s2d_flags_raise_jax_message_at_the_trainer():
    """``--parallel-mode shard_map --spatial-devices 2 --space-to-depth``
    builds JAX's config; both packages' Trainers then refuse it with JAX's
    'shard_map' message, before any group or device mesh."""
    from resnet_tpu.train.trainer import Trainer as JTrainer
    from resnet_tpu_torch.train import Trainer

    argv = ["--parallel-mode", "shard_map", "--spatial-devices", "2", "--space-to-depth",
            "--model", "tiny", "--synthetic", "--batch-size", "8", "--checkpoint-dir", ""]
    cfg, _ = build_config(argv + ["--device", "cpu"])
    jcfg, _ = j_build_config(argv)
    match = r"spatial_devices > 1 requires parallel.mode='auto'"
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, device="cpu", use_mesh=True)
    with pytest.raises(ValueError, match=match):
        JTrainer(jcfg, use_mesh=True)


def test_bf16_fused_engine_trains_a_step_and_dumps_it(tmp_path):
    """One step of ``--kernels fused --dtype bfloat16`` (the fused engine in
    bf16; on the CPU its kernels' plain versions): the final dump holds every
    parameter leaf, finite, and the run's one loss line is finite."""
    dumps = tmp_path / "dumps"
    main(["--model", "tiny", "--synthetic", "--batch-size", "8", "--steps", "1",
          "--kernels", "fused", "--dtype", "bfloat16", "--checkpoint-dir", str(dumps),
          "--log-every", "0", "--device", "cpu"])
    params = dumps / "77777777" / "model_params"
    files = sorted(os.listdir(params))
    assert files
    for name in files:
        assert np.isfinite(np.fromfile(params / name, np.float32)).all(), name
    with open(dumps / "avg_loss_log.txt") as f:
        lines = f.read().splitlines()
    assert len(lines) == 1 and np.isfinite(float(lines[0].split()[-1])), lines


def test_bad_flag_values_exit():
    for argv in (["--kernels", "blockfused"], ["--resume-from", "not-a-dump-id"],
                 ["--device", "tpu"], ["--int8", "--export-dtype", "float32"]):
        with pytest.raises(SystemExit):
            build_config(argv)


def test_cli_trains_evaluates_resumes_and_exports(tmp_path, capsys):
    ckpt = str(tmp_path / "dumps")
    common = ["--model", "tiny", "--synthetic", "--batch-size", "8", "--checkpoint-dir",
              ckpt, "--log-every", "0", "--device", "cpu"]
    main(common + ["--steps", "3", "--checkpoint-every", "2"])
    assert os.path.isdir(tmp_path / "dumps" / "00000002")
    assert os.path.isdir(tmp_path / "dumps" / "77777777")
    with open(tmp_path / "dumps" / "avg_loss_log.txt") as f:
        assert len(f.read().splitlines()) == 3

    main(common + ["--evaluate", "--eval-batches", "2"])
    assert "eval over 2 batches" in capsys.readouterr().out

    # --resume-from latest + --async-checkpoint: continue from the final dump
    main(common + ["--steps", "2", "--checkpoint-every", "1", "--resume-from", "latest",
                   "--async-checkpoint"])
    out = capsys.readouterr().out
    assert "resumed from dump 77777777 at step 3" in out
    assert "input: synthetic loader" in out
    assert os.path.isdir(tmp_path / "dumps" / "00000004")

    art = str(tmp_path / "model.pt")
    main(common + ["--resume-from", "latest", "--export", art])
    assert "exported serving artifact" in capsys.readouterr().out
    served = load_inference(art, device="cpu")
    assert served.kind == "fp" and served.meta["execution_config"]["kernels"] == "xla"
    logits = served.call(np.zeros((2, 16, 16, 3), np.float32))
    assert tuple(logits.shape) == (2, 8)
    assert np.all(np.isfinite(logits.numpy()))
