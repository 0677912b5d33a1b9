"""``ExecutionConfig.matmul_precision`` governs cuDNN's and cuBLAS's TF32 flags.

The JAX package passes the precision to every plain conv and to the FC
(resnet_tpu/models/resnet.py:57, :61, :291, :313, :387), its VJP included.
On the card the port's plain convs follow the process-wide
``torch.backends.cudnn.allow_tf32`` (True out of the box) and its plain
products ``torch.backends.cuda.matmul.allow_tf32``; ``ops.precision``
sets both from the config inside each entry point. These tests record both
flags at every plain conv of a tiny model: at its call (``F.conv2d``), when
autograd passes back through it, and at each gradient conv of the fused
engine (``fused_conv._conv_vjp``). Under 'highest' both must be off, under
'high' and 'default' on, and the caller's values (set here to the other
state) must be back after the call. The flags are plain Python state on the
CPU too, so the CPU shows the scoping; the card's test is
``test_default_config_runs_plain_convs_in_fp32`` in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from resnet_tpu_torch import config as tcfg
from resnet_tpu_torch.data import SyntheticDataset
from resnet_tpu_torch.export import export_inference
from resnet_tpu_torch.kernels import fused_conv
from resnet_tpu_torch.models import forward
from resnet_tpu_torch.ops.precision import allows_tf32, precision_scope
from resnet_tpu_torch.train import eval_step, init_train_state, make_train_step

# matmul_precision -> whether TF32 is allowed inside an entry point
PRECISIONS = {"highest": False, "high": True, "default": True}


def _flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


class _BackwardProbe(torch.autograd.Function):
    """Identity whose backward records the flags as autograd passes."""

    @staticmethod
    def forward(ctx, y, seen):
        ctx.seen = seen
        return y.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.seen.append(("conv backward", _flags()))
        return g, None


@pytest.fixture
def seen(monkeypatch):
    """The flags at each plain conv call, conv backward and fused-engine
    gradient conv, in order."""
    log = []
    conv2d, conv_vjp = F.conv2d, fused_conv._conv_vjp

    def recording_conv2d(*args, **kwargs):
        log.append(("conv", _flags()))
        y = conv2d(*args, **kwargs)
        return _BackwardProbe.apply(y, log) if y.requires_grad else y

    def recording_vjp(*args, **kwargs):
        log.append(("gradient conv", _flags()))
        return conv_vjp(*args, **kwargs)

    monkeypatch.setattr(F, "conv2d", recording_conv2d)
    monkeypatch.setattr(fused_conv, "_conv_vjp", recording_vjp)
    return log


@pytest.fixture
def caller_flags(monkeypatch, request):
    """The caller's flags set to the opposite of what the precision asks,
    restored after the test."""
    other = not PRECISIONS[request.node.callspec.params["precision"]]
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", other)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", other)
    return (other, other)


def _train_config(precision, **execution):
    return tcfg.TrainConfig(model=tcfg.tiny_model_config(),
                            execution=tcfg.ExecutionConfig(matmul_precision=precision,
                                                           **execution),
                            optimizer=tcfg.OptimizerConfig())


def _batch(cfg):
    data = next(SyntheticDataset(4, image_dim=cfg.model.input_dim,
                                 num_classes=cfg.model.num_classes, seed=0))
    return {k: torch.from_numpy(v) for k, v in data.items()}


def _state(cfg):
    return init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")


def _assert_scoped(seen, precision, caller, *kinds):
    allow = PRECISIONS[precision]
    assert {kind for kind, _ in seen} >= set(kinds), seen
    assert all(flags == (allow, allow) for _, flags in seen), seen
    assert _flags() == caller


@pytest.mark.parametrize("precision", sorted(PRECISIONS))
def test_precision_scope_sets_and_restores_both_flags(caller_flags, precision):
    ecfg = tcfg.ExecutionConfig(matmul_precision=precision)
    assert allows_tf32(ecfg) == PRECISIONS[precision]
    with pytest.raises(RuntimeError):
        with precision_scope(ecfg):
            assert _flags() == (PRECISIONS[precision],) * 2
            raise RuntimeError("the flags come back on an error too")
    assert _flags() == caller_flags


@pytest.mark.parametrize("precision", sorted(PRECISIONS))
def test_forward_runs_plain_convs_at_the_configured_precision(seen, caller_flags, precision):
    cfg = _train_config(precision)
    state = _state(cfg)
    forward(state.params, _batch(cfg)["images"], cfg.model, cfg.execution, train=True)
    _assert_scoped(seen, precision, caller_flags, "conv")


@pytest.mark.parametrize("precision", sorted(PRECISIONS))
def test_train_step_scopes_forward_and_backward(seen, caller_flags, precision):
    """The standard path's train step: every conv and every conv backward
    (autograd's, inside ``loss_and_grads``) at the configured precision."""
    cfg = _train_config(precision)
    make_train_step(cfg)(_state(cfg), _batch(cfg))
    _assert_scoped(seen, precision, caller_flags, "conv", "conv backward")


@pytest.mark.parametrize("precision", sorted(PRECISIONS))
def test_fused_engine_step_scopes_its_gradient_convs(seen, caller_flags, precision):
    """The fused engine's step: K8's plain version on the CPU calls the plain
    conv, and its backward's gradient convs (``_conv_vjp``, cuDNN's
    ``convolution_backward`` on the card) run inside the scope."""
    cfg = _train_config(precision, kernels="fused")
    make_train_step(cfg)(_state(cfg), _batch(cfg))
    _assert_scoped(seen, precision, caller_flags, "conv", "gradient conv")


@pytest.mark.parametrize("precision", sorted(PRECISIONS))
def test_eval_step_runs_at_the_configured_precision(seen, caller_flags, precision):
    cfg = _train_config(precision)
    eval_step(_state(cfg), _batch(cfg), cfg)
    _assert_scoped(seen, precision, caller_flags, "conv")


@pytest.mark.parametrize("precision", sorted(PRECISIONS))
def test_served_forward_runs_at_the_configured_precision(seen, caller_flags, precision):
    cfg = _train_config(precision)
    state = _state(cfg)
    model = export_inference(state.params, cfg.model, bn_state=state.bn_state,
                             ecfg=cfg.execution)
    images = np.asarray(_batch(cfg)["images"])
    logits = model.call(images)
    assert logits.shape == (4, cfg.model.num_classes)
    _assert_scoped(seen, precision, caller_flags, "conv")
