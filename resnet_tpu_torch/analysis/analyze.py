"""Dump analysis — the pytest/CLI replacement for the reference's
analyze_trainer_dump.ipynb. A copy of resnet_tpu.analysis.analyze (numpy
only), reading the port's dumps (``analysis.dump``).

Covers the notebook's three jobs (SURVEY.md section 2.6):
  * per-tensor range listing over params/grads/Adam state (cells 5-7)
    -> tensor_ranges / activation_ranges
  * numpy re-implementation cross-checks of FC matmul, softmax, global
    avg-pool forward + their gradients against dumped device values
    (cells 32-53, the de-facto output-fidelity gate) -> crosscheck_dump
  * blow-up forensics: scan activation ranges across consecutive dumps to
    localize divergence (cells 57-60) -> scan_divergence
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .dump import load_activation_dump


def tensor_ranges(tree: Dict[str, np.ndarray]) -> List[Tuple[str, float, float, float]]:
    """(name, min, max, absmax) per tensor — notebook cells 5-7."""
    rows = []
    for name in sorted(tree):
        arr = np.asarray(tree[name], dtype=np.float64)
        rows.append((name, float(arr.min()), float(arr.max()),
                     float(np.abs(arr).max())))
    return rows


def activation_ranges(dump_dir: str) -> List[Tuple[str, float, float, float]]:
    return tensor_ranges(load_activation_dump(dump_dir))


def _softmax_np(z):
    e = np.exp(z - z.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def crosscheck_dump(
    dump_dir: str,
    fc_weight: np.ndarray,
    labels: Optional[np.ndarray] = None,
    *,
    fc_grad: Optional[np.ndarray] = None,
    pool_grad: Optional[np.ndarray] = None,
    atol: float = 1e-4,
    rtol: float = 1e-4,
) -> Dict[str, float]:
    """Numpy re-computation of the output head against dumped tensors.

    Recomputes (notebook cells 32-53):
      final_avg_pool @ fc_w  == linear_output
      softmax(linear_output) == pred
      global mean of last block output == final_avg_pool
      [if labels] d(loss)/d(logits) = softmax - onehot (summed CE,
        resnet.cu:1800-1811), then dW_fc = pool^T @ dlogits and dpool =
        dlogits @ W^T (resnet.cu:1823-1830) compared BY VALUE against
        the dumped gradients when fc_grad / pool_grad are provided (the
        notebook's cells 51-53 value comparison).
    Returns max abs errors per check; raises AssertionError on violation.
    """
    d = load_activation_dump(dump_dir)
    errs: Dict[str, float] = {}

    pool = d["final_avg_pool"].astype(np.float64)
    logits = d["linear_output"].astype(np.float64)
    w = np.asarray(fc_weight, dtype=np.float64)

    fc_err = np.abs(pool @ w - logits).max()
    errs["fc_forward"] = float(fc_err)

    if "pred" in d:
        sm_err = np.abs(_softmax_np(logits) - d["pred"].astype(np.float64)).max()
        errs["softmax"] = float(sm_err)

    # last block output -> global avg pool
    block_keys = sorted(k for k in d if k.endswith("output_activated"))
    if block_keys:
        last = d[block_keys[-1]].astype(np.float64)
        # NHWC (N,H,W,C) or NCHW (N,C,H,W): pool is (N,C)
        if last.shape[-1] == pool.shape[-1]:
            recomputed = last.mean(axis=(1, 2))
        else:
            recomputed = last.mean(axis=(2, 3))
        errs["global_avg_pool"] = float(np.abs(recomputed - pool).max())

    if labels is not None:
        n, k = logits.shape
        dlogits = _softmax_np(logits)
        dlogits[np.arange(n), labels] -= 1.0  # summed CE grad
        dw = pool.T @ dlogits
        dpool = dlogits @ w.T
        # value comparison is the ONLY gradient check; an absent dumped
        # gradient is reported as skipped, never as ok (a shape check
        # passing on its own recomputed arrays proves nothing)
        if fc_grad is not None:
            errs["fc_grad"] = float(
                np.abs(dw - np.asarray(fc_grad, np.float64)).max()
            )
        else:
            errs["fc_grad_skipped"] = 1.0
        if pool_grad is not None:
            errs["avgpool_grad"] = float(
                np.abs(dpool - np.asarray(pool_grad, np.float64)).max()
            )
        else:
            errs["avgpool_grad_skipped"] = 1.0

    for name, err in errs.items():
        if name.endswith("_skipped"):
            continue
        assert err < atol + rtol * 10, f"{name}: max abs err {err}"
    return errs


def scan_divergence(
    dump_dirs: List[str], *, threshold: float = 1e3
) -> List[Tuple[str, str, float]]:
    """Scan dumps (in step order) for the first tensor whose absmax blows
    past threshold — notebook cells 57-60 forensics. Returns
    (dump_dir, tensor, absmax) hits."""
    hits = []
    for dd in dump_dirs:
        for name, _, _, absmax in activation_ranges(dd):
            if absmax > threshold or not np.isfinite(absmax):
                hits.append((dd, name, absmax))
    return hits


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="analyze activation dumps")
    ap.add_argument("dump_dirs", nargs="+")
    ap.add_argument("--threshold", type=float, default=1e3)
    args = ap.parse_args(argv)
    for dd in args.dump_dirs:
        print(f"== {dd}")
        for name, lo, hi, am in activation_ranges(dd):
            print(f"  {name:50s} [{lo:+.4e}, {hi:+.4e}] absmax {am:.4e}")
    hits = scan_divergence(args.dump_dirs, threshold=args.threshold)
    if hits:
        print("DIVERGENCE:")
        for dd, name, am in hits:
            print(f"  {dd}: {name} absmax {am:.4e}")


if __name__ == "__main__":
    main()
