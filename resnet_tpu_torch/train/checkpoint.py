"""Checkpoint / resume with the reference's dump schema: the port of
resnet_tpu.train.checkpoint, writing the same files byte for byte.

dump_trainer (resnet.cu:2250-2772) writes, under <dump_dir>/<%08d dump_id>/:
  model_params/%03d.buffer   raw float32 per tensor in flat-registry order
  means/%03d.buffer          Adam first moments
  vars/%03d.buffer           Adam second moments
  gradients/%03d.buffer      (reference dumps these too; optional here)
  trainer_checkpoint.txt     shard cursor, Adam decay products, counters
  trainer_metadata.txt       hyperparams + loss/accuracy history

The SGD momentum goes to momentum/, the BN running statistics to bn_state/.
Sentinel ids: 77777777 final dump (resnet.cu:3424), 99999999 NaN crash dump
(check_errors, resnet.cu:2903). The flat registry is JAX's pytree order
(dict keys sorted, lists by index: ``bridge.flatten``), written alongside as
registry.txt, so a dump of either package restores in the other. A dump
without registry.txt is an actual reference dump: buffers in the
reference's init order with OIHW conv weights.

Every write starts from an owned host copy of the state (``_host``), taken
on the calling thread: the fused Adam step updates parameters and moments
in place, and on the CPU ``tensor.numpy()`` is a view, so a dump that read
the live tensors later would see a later step. Writes are atomic: a temp
sibling directory renamed over the final path last.

Across ranks (``mesh``, with a ZeRO ``plan`` where the state is sharded)
every rank joins the gather of the whole state (``parallel.multihost.
fetch_global``), rank 0 alone writes, so a ZeRO dump equals a replicated
one file for file, and a barrier after the rename keeps every rank from
running past a dump that is not yet published (checkpoint.py:205-238 in
the JAX package). A restore reads whole tensors; the Trainer cuts them to
its shards.

A compact single-file .npz format ("save_npz") is also provided, with the
JAX package's keys.
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import os
import re
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..bridge import flatten, unflatten
from ..data.shards import ShardCursor
from ..optim import GuardedAdamState
from ..optim.sgd import SGDState
from ..utils.debug import _paths
from .state import TrainState

FINAL_DUMP_ID = 77777777  # resnet.cu:3424
NAN_DUMP_ID = 99999999  # resnet.cu:2903


def _map_paths(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """fn(path, leaf) over a tree of NamedTuples, dicts and lists, keeping
    its types; paths are named as ``utils.debug._paths`` names them (the JAX
    package's: a NamedTuple field as ``.name``)."""
    def join(key):
        return f"{prefix}/{key}" if prefix else key

    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_paths(fn, getattr(tree, f), join(f".{f}"))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, join(str(k))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_paths(fn, v, join(str(i))) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _host_leaf(_, leaf):
    if isinstance(leaf, torch.Tensor):
        # an owned copy; from the card it is also synchronized. numpy has no
        # bf16: such a leaf goes to the host as fp32 (exact), the dtype
        # every leaf is written in; a restore casts it back to the leaf's
        # dtype, as JAX's checkpoint.py:71-83 does
        dtype = torch.float32 if leaf.dtype is torch.bfloat16 else leaf.dtype
        return leaf.detach().to("cpu", dtype=dtype, copy=True).numpy()
    return np.asarray(leaf)


def _host(tree):
    """An owned host (numpy) copy of a tree of tensors, types kept."""
    return _map_paths(_host_leaf, tree)


def _like(arr: np.ndarray, leaf: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``leaf``'s shape, dtype and device."""
    arr = np.array(np.reshape(arr, tuple(leaf.shape)), order="C")  # owned, 0-d kept
    return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)


def flat_registry(params) -> List[Tuple[str, Any]]:
    """Deterministic (name, leaf) registry over the param tree — the
    analogue of Params.locations/sizes (resnet.h:83-87), in JAX's order."""
    return flatten(params)


def _write_buffers(directory: str, registry: List[Tuple[str, Any]]):
    os.makedirs(directory, exist_ok=True)
    for i, (_, leaf) in enumerate(registry):
        np.asarray(leaf, dtype=np.float32).tofile(
            os.path.join(directory, f"{i:03d}.buffer")
        )


def _read_buffers(directory: str, template) -> Any:
    out = []
    for i, (path, leaf) in enumerate(flatten(template)):
        buf = np.fromfile(os.path.join(directory, f"{i:03d}.buffer"), dtype=np.float32)
        out.append((path, _like(buf, leaf)))
    return unflatten(out)


def dump_id_dir(dump_dir: str, dump_id: int) -> str:
    return os.path.join(dump_dir, f"{dump_id:08d}")


# The reference's trainer_checkpoint.txt is bare positional values in this
# exact order (dump_trainer_checkpoint, resnet.cu:2743-2751). Ours adds
# 'key: value' labels; both forms are parsed below.
_REFERENCE_CKPT_FIELDS = (
    "cur_shard",
    "cur_batch_in_shard",
    "cur_mean_decay",
    "cur_var_decay",
    "cur_dump_id",
    "cur_epoch",
)


def parse_trainer_checkpoint(path: str) -> Dict[str, str]:
    """Parse trainer_checkpoint.txt — labeled (this repo) or positional
    (actual reference dumps, resnet.cu:2733-2753)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if any(":" in ln for ln in lines):
        out: Dict[str, str] = {}
        for ln in lines:
            k, _, v = ln.partition(":")
            out[k.strip()] = v.strip()
        return out
    return dict(zip(_REFERENCE_CKPT_FIELDS, lines))


def reference_registry_order(params) -> List[str]:
    """Our param names in the reference's flat-registry order
    (init_model_parameters, resnet.cu:805-949): init conv W, init BN
    gamma/beta; per block reduce/spatial/expand each W, gamma, beta, then
    projection W/gamma/beta when present; finally FC W. 160 entries for
    ResNet-50 (n_locations = 16 + 9*n_blocks, resnet.cu:819)."""
    order = ["init_conv/w", "init_bn/gamma", "init_bn/beta"]
    for i, block in enumerate(params["blocks"]):
        for conv, bn in (
            ("reduce", "bn_reduce"),
            ("spatial", "bn_spatial"),
            ("expand", "bn_expand"),
        ):
            order += [
                f"blocks/{i}/{conv}/w",
                f"blocks/{i}/{bn}/gamma",
                f"blocks/{i}/{bn}/beta",
            ]
        if "proj" in block:
            order += [
                f"blocks/{i}/proj/w",
                f"blocks/{i}/bn_proj/gamma",
                f"blocks/{i}/bn_proj/beta",
            ]
    order.append("fc/w")
    return order


def load_reference_buffers(directory: str, params_template) -> Any:
    """Read a reference-ordered buffer directory (model_params/, means/,
    vars/ of an actual resnet.cu dump) into our params tree, on the
    template's device.

    Reference conv weights are OIHW (doConvolution indexing,
    resnet.cu:131-152: weights[o*k*k*in + in*k*k + kh*k + kw]); ours are
    HWIO, so 4-D buffers are transposed (2,3,1,0). BN vectors and the FC
    matrix (row-major in_features x classes, matMul resnet.cu:70-88) map
    directly."""
    by_name = dict(flat_registry(params_template))
    out = {}
    for i, name in enumerate(reference_registry_order(params_template)):
        leaf = by_name[name]
        buf = np.fromfile(os.path.join(directory, f"{i:03d}.buffer"), dtype=np.float32)
        shape = tuple(leaf.shape)
        if len(shape) == 4:  # HWIO <- OIHW
            h, w, ci, co = shape
            buf = buf.reshape(co, ci, h, w).transpose(2, 3, 1, 0)
        out[name] = _like(buf, leaf)
    return unflatten((name, out[name]) for name, _ in flatten(params_template))


def discover_latest_dump(dump_dir: str) -> Optional[int]:
    """Largest resumable dump id under dump_dir, or None.

    Only complete dumps are visible (writes are atomic, see
    save_checkpoint). The non-finite forensic sentinel (99999999,
    resnet.cu:2903) is never resumable state and is excluded; the final
    sentinel (77777777, resnet.cu:3424) IS included — a completed run's
    last state wins over its periodic dumps.
    """
    if not os.path.isdir(dump_dir):
        return None
    ids = [
        int(name)
        for name in os.listdir(dump_dir)
        if re.fullmatch(r"\d{8}", name) and int(name) != NAN_DUMP_ID
        and os.path.exists(os.path.join(dump_dir, name, "trainer_checkpoint.txt"))
    ]
    return max(ids) if ids else None


def save_checkpoint(
    dump_dir: str,
    dump_id: int,
    state: TrainState,
    cursor: ShardCursor,
    *,
    metadata: Optional[Dict[str, Any]] = None,
    include_grads=None,
    mesh=None,
    plan=None,
) -> str:
    """Buffer-tree checkpoint in the reference schema; returns its path.

    Atomic: everything is written into a temp sibling directory that is
    renamed over the final path last, so a crash mid-dump never leaves a
    partial dump where restore/discover_latest_dump would find it. (The
    reference writes buffers in place, resnet.cu:2279-2317 — a crash
    inside dump_trainer corrupts that dump id silently.) With a mesh every
    rank must call it: the sharded leaves are gathered, rank 0 writes, and
    all meet after the rename.
    """
    from ..parallel.multihost import barrier, fetch_global

    final_root = dump_id_dir(dump_dir, dump_id)
    state = fetch_global(state, plan, mesh)
    if mesh is not None and mesh.rank != 0:
        barrier(f"ckpt-{dump_id}")
        return final_root
    state, include_grads = _host(state), _host(include_grads)
    root = f"{final_root}.tmp-{os.getpid()}"
    if os.path.exists(root):
        shutil.rmtree(root)
    os.makedirs(root)
    try:
        _write_dump(root, final_root, state, cursor, metadata, include_grads)
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    if mesh is not None:
        barrier(f"ckpt-{dump_id}")
    return final_root


def _write_dump(root, final_root, state, cursor, metadata, include_grads):
    reg = flat_registry(state.params)
    _write_buffers(os.path.join(root, "model_params"), reg)
    with open(os.path.join(root, "registry.txt"), "w") as f:
        for i, (name, leaf) in enumerate(reg):
            f.write(f"{i:03d} {name} {'x'.join(map(str, np.shape(leaf)))}\n")

    is_adam = isinstance(state.opt_state, GuardedAdamState)
    if is_adam:
        _write_buffers(os.path.join(root, "means"), flat_registry(state.opt_state.means))
        _write_buffers(os.path.join(root, "vars"), flat_registry(state.opt_state.vars))
    elif isinstance(state.opt_state, SGDState):
        _write_buffers(
            os.path.join(root, "momentum"), flat_registry(state.opt_state.momentum_buf)
        )
    if include_grads is not None:
        _write_buffers(os.path.join(root, "gradients"), flat_registry(include_grads))
    if state.bn_state is not None:
        _write_buffers(os.path.join(root, "bn_state"), flat_registry(state.bn_state))

    # trainer_checkpoint.txt: the six resume fields (resnet.cu:2733-2753);
    # the decay products print as JAX prints them: float() of the fp32 value
    ckpt = {
        "cur_shard": cursor.shard,
        "cur_batch_in_shard": cursor.batch_in_shard,
        "cur_epoch": cursor.epoch,
        "cur_dump_id": int(state.step),
        "opt_step": int(state.opt_state.step),
    }
    if is_adam:
        ckpt["cur_mean_decay"] = float(state.opt_state.mean_decay_prod)
        ckpt["cur_var_decay"] = float(state.opt_state.var_decay_prod)
    with open(os.path.join(root, "trainer_checkpoint.txt"), "w") as f:
        for k, v in ckpt.items():
            f.write(f"{k}: {v}\n")

    with open(os.path.join(root, "trainer_metadata.txt"), "w") as f:
        f.write(json.dumps(metadata or {}, indent=2, default=float))

    # publish atomically: remove any previous dump of this id, then rename
    if os.path.exists(final_root):
        shutil.rmtree(final_root)
    os.replace(root, final_root)


class AsyncCheckpointer:
    """Non-blocking checkpoint writer.

    The reference dumps synchronously inside update_parameters
    (resnet.cu:2947-2950), stalling the training loop for the whole file
    write. Here save() copies the state to owned host memory on the calling
    thread — synchronized before save() returns, since the next step (fused
    Adam) updates the tensors in place — and hands the slower file I/O to
    a single worker thread. A second save() first waits for the previous
    write, bounding memory to one in-flight host snapshot; write errors
    surface on the next save()/wait() rather than being swallowed.
    """

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer"
        )
        self._pending: Optional[concurrent.futures.Future] = None

    def save(self, dump_dir, dump_id, state, cursor, *, include_grads=None,
             mesh=None, plan=None, **kwargs) -> str:
        self.wait()
        # the gather of sharded leaves is a collective: it runs here, on the
        # training thread of every rank in step, never on the writer thread;
        # rank 0 alone then writes, with no barrier (the next save's or
        # close's wait orders the publish)
        from ..parallel.multihost import fetch_global

        state = fetch_global(state, plan, mesh)
        if mesh is not None and mesh.rank != 0:
            return dump_id_dir(dump_dir, dump_id)
        host_state, host_grads = _host(state), _host(include_grads)
        self._pending = self._pool.submit(
            save_checkpoint, dump_dir, dump_id, host_state, copy.copy(cursor),
            include_grads=host_grads, **kwargs
        )
        return dump_id_dir(dump_dir, dump_id)

    def wait(self):
        """Block until the in-flight write (if any) lands; re-raise its errors."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self):
        self.wait()
        self._pool.shutdown()


def restore_checkpoint(
    dump_dir: str, dump_id: int, state_template: TrainState
) -> Tuple[TrainState, ShardCursor]:
    """(state, cursor) of a dump, the state on the template's device."""
    root = dump_id_dir(dump_dir, dump_id)
    ckpt = parse_trainer_checkpoint(os.path.join(root, "trainer_checkpoint.txt"))
    # a dump without registry.txt is an actual reference dump: buffers in
    # init-registry order with OIHW conv weights (resnet.cu:805-949)
    is_reference_dump = not os.path.exists(os.path.join(root, "registry.txt"))
    read = load_reference_buffers if is_reference_dump else _read_buffers
    params = read(os.path.join(root, "model_params"), state_template.params)
    # reference checkpoints carry no optimizer step; cur_dump_id is the
    # global step and the optimizer has run once per step
    opt_step = int(ckpt.get("opt_step", ckpt["cur_dump_id"]))

    opt = state_template.opt_state
    # catch optimizer mismatch early with an actionable message (a dump
    # written by one optimizer cannot hydrate the other's state)
    if isinstance(opt, GuardedAdamState) and not os.path.isdir(
        os.path.join(root, "means")
    ) and os.path.isdir(os.path.join(root, "momentum")):
        raise ValueError(
            f"dump {root} was written by an SGD run (momentum/ present, "
            "means/ absent) but the configured optimizer is adam; rerun "
            "with --optimizer sgd"
        )
    if isinstance(opt, SGDState) and not os.path.isdir(
        os.path.join(root, "momentum")
    ) and os.path.isdir(os.path.join(root, "means")):
        raise ValueError(
            f"dump {root} was written by an Adam run (means/ present, "
            "momentum/ absent) but the configured optimizer is sgd; rerun "
            "with --optimizer adam"
        )
    if isinstance(opt, GuardedAdamState):
        opt = GuardedAdamState(
            means=read(os.path.join(root, "means"), opt.means),
            vars=read(os.path.join(root, "vars"), opt.vars),
            mean_decay_prod=_like(np.float32(ckpt["cur_mean_decay"]), opt.mean_decay_prod),
            var_decay_prod=_like(np.float32(ckpt["cur_var_decay"]), opt.var_decay_prod),
            step=_like(opt_step, opt.step),
        )
    elif isinstance(opt, SGDState):
        opt = SGDState(
            momentum_buf=_read_buffers(os.path.join(root, "momentum"), opt.momentum_buf),
            step=_like(opt_step, opt.step),
        )

    bn_state = state_template.bn_state
    if bn_state is not None and os.path.isdir(os.path.join(root, "bn_state")):
        bn_state = _read_buffers(os.path.join(root, "bn_state"), bn_state)

    state = TrainState(
        params=params,
        opt_state=opt,
        bn_state=bn_state,
        step=_like(int(ckpt["cur_dump_id"]), state_template.step),
    )
    cursor = ShardCursor(
        shard=int(ckpt["cur_shard"]),
        batch_in_shard=int(ckpt["cur_batch_in_shard"]),
        epoch=int(ckpt["cur_epoch"]),
    )
    return state, cursor


def save_npz(path: str, state: TrainState, cursor: ShardCursor, metadata=None):
    """Compact single-file checkpoint (routine training use), with the JAX
    package's keys ('params/blocks/0/proj/w', 'opt_state/.means/...')."""
    arrays = dict(_paths(_host(state)._asdict()))
    arrays["__cursor__"] = np.asarray([cursor.shard, cursor.batch_in_shard, cursor.epoch])
    if metadata:
        arrays["__metadata__"] = np.frombuffer(
            json.dumps(metadata, default=float).encode(), dtype=np.uint8
        )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


def restore_npz(path: str, state_template: TrainState) -> Tuple[TrainState, ShardCursor]:
    """(state, cursor) of a save_npz file, the state on the template's device."""
    with np.load(path) as data:
        d = _map_paths(lambda p, leaf: _like(data[p], leaf), state_template._asdict())
        cur = data["__cursor__"]
    return TrainState(**d), ShardCursor(shard=int(cur[0]), batch_in_shard=int(cur[1]),
                                        epoch=int(cur[2]))
