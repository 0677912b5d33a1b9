"""The port's input data against resnet_tpu.data on the CPU.

The readers are copies of the JAX package's, so every comparison here is
exact: the same images bit for bit, the same labels and the same cursors
from the same files and seeds. ``ShardIterator`` in both layouts, with the
seeded flip, across the epoch wrap and on resume; ``NativeShardIterator``
(skipped where the native loader cannot be built, as tests/test_native.py
skips), each loader resumed from the other's cursor; the procedural
streams; ``JpegDataset`` on the PIL path and, where libjpeg's library is
built, the native path; the class metadata; ``write_shard``'s files.
The CPU prefetcher: order, cursors, ``stop()``, a worker's error raised on
the consumer, and the bf16 transfer cast bit-equal to JAX's host cast.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu.data import JpegDataset as JJpegDataset
from resnet_tpu.data import ShardCursor as JShardCursor
from resnet_tpu.data import ShardDataset as JShardDataset
from resnet_tpu.data import ShardIterator as JShardIterator
from resnet_tpu.data import load_class_metadata as j_load_class_metadata
from resnet_tpu.data import write_shard as j_write_shard
from resnet_tpu.data.procedural import ProceduralDataset as JProceduralDataset
from resnet_tpu.data.procedural import ProceduralIterator as JProceduralIterator
from resnet_tpu_torch.data import (
    DevicePrefetcher,
    JpegDataset,
    ShardCursor,
    ShardDataset,
    ShardIterator,
    load_class_metadata,
    prefetch_to_device,
    write_shard,
)
from resnet_tpu_torch.data import native
from resnet_tpu_torch.data.procedural import ProceduralDataset, ProceduralIterator

SHARDS, PER_SHARD, BATCH, DIM = 3, 8, 4, 4


def _cursor(c):
    return (c.shard, c.batch_in_shard, c.epoch)


@pytest.fixture
def shard_dir(tmp_path):
    """Three shards of 8 images (4x4x3), NCHW on disk; labels number the
    images so each batch is identifiable."""
    rng = np.random.default_rng(7)
    d = str(tmp_path / "shards")
    for s in range(SHARDS):
        imgs = rng.normal(0, 50, (PER_SHARD, 3, DIM, DIM)).astype(np.float32)
        write_shard(d, s, imgs, (np.arange(PER_SHARD) + PER_SHARD * s).astype(np.int32))
    return d


def _datasets(shard_dir):
    kw = dict(num_shards=SHARDS, shard_images=PER_SHARD, image_dim=DIM, disk_layout="NCHW")
    return ShardDataset(shard_dir, **kw), JShardDataset(shard_dir, **kw)


@pytest.fixture
def native_loaders():
    """The port's and JAX's NativeShardIterator, where the library builds."""
    if not native.native_available():
        pytest.skip(f"native loader not built ({native.native_status()})")
    from resnet_tpu.data.native import NativeShardIterator as JNative

    return native.NativeShardIterator, JNative


def _same_stream(a, b, n):
    for i in range(n):
        x, y = next(a), next(b)
        np.testing.assert_array_equal(x["images"], y["images"], err_msg=f"batch {i}")
        np.testing.assert_array_equal(x["labels"], y["labels"], err_msg=f"batch {i}")
        assert x["images"].dtype == y["images"].dtype == np.float32
        assert _cursor(x["cursor"]) == _cursor(y["cursor"]), f"batch {i}"


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("flip", [False, True])
def test_shard_iterator_matches_jax(shard_dir, layout, flip):
    """Both layouts, with and without the seeded flip: 14 batches cross two
    epoch wraps; then each resumes from the cursor (2, 1, 1)."""
    ds, jds = _datasets(shard_dir)
    kw = dict(layout=layout, random_flip=flip, seed=5)
    a, b = ShardIterator(ds, BATCH, **kw), JShardIterator(jds, BATCH, **kw)
    _same_stream(a, b, 14)
    assert _cursor(a.cursor) == (0, 2, 2)  # 6 batches per epoch: the third epoch's second
    a = ShardIterator(ds, BATCH, cursor=ShardCursor(2, 1, 1), **kw)
    b = JShardIterator(jds, BATCH, cursor=JShardCursor(2, 1, 1), **kw)
    _same_stream(a, b, 4)


def test_native_iterator_matches_jax(shard_dir, native_loaders):
    """The port's binding and JAX's read the same library: the same bytes
    and cursors, in both layouts, across the epoch wrap and on resume."""
    port, jax_native = native_loaders
    ds, jds = _datasets(shard_dir)
    for layout in ("NHWC", "NCHW"):
        a, b = port(ds, BATCH, layout=layout), jax_native(jds, BATCH, layout=layout)
        _same_stream(a, b, 14)
        a.close(), b.close()
    a = port(ds, BATCH, cursor=ShardCursor(2, 1, 1))
    b = jax_native(jds, BATCH, cursor=JShardCursor(2, 1, 1))
    _same_stream(a, b, 4)
    a.close(), b.close()


def test_loaders_resume_from_each_others_cursor(shard_dir, native_loaders):
    """After 24 batches (4 epochs of 6) the native loader reports the
    cursor already wrapped, (0, 0, 4), and ShardIterator the one before the
    wrap, (2, 2, 3). Either loader resumed from either cursor yields the
    same next batch: batch 0 of shard 0."""
    port, _ = native_loaders
    ds, _ = _datasets(shard_dir)
    nat, py = port(ds, BATCH), ShardIterator(ds, BATCH)
    for _ in range(24):
        nb, pb = next(nat), next(py)
        np.testing.assert_array_equal(nb["images"], pb["images"])
    nat.close()
    assert _cursor(nb["cursor"]) == (0, 0, 4)
    assert _cursor(pb["cursor"]) == (2, 2, 3)
    want = next(ShardIterator(ds, BATCH))
    for cur in (nb["cursor"], pb["cursor"]):
        for make in (port, ShardIterator):
            it = make(ds, BATCH, cursor=ShardCursor(*_cursor(cur)))
            got = next(it)
            np.testing.assert_array_equal(got["images"], want["images"])
            np.testing.assert_array_equal(got["labels"], np.arange(BATCH, dtype=np.int32))
            if make is port:
                it.close()


@pytest.mark.parametrize("evaluation", [False, True])
def test_procedural_streams_match_jax(evaluation):
    ds = ProceduralDataset(num_classes=10, image_dim=12, seed=3)
    jds = JProceduralDataset(num_classes=10, image_dim=12, seed=3)
    np.testing.assert_array_equal(ds.protos, jds.protos)
    a = ProceduralIterator(ds, 5, seed=9, evaluation=evaluation)
    b = JProceduralIterator(jds, 5, seed=9, evaluation=evaluation)
    a.skip(3), b.skip(3)
    for _ in range(3):
        x, y = next(a), next(b)
        np.testing.assert_array_equal(x["images"], y["images"])
        np.testing.assert_array_equal(x["labels"], y["labels"])
    # positional: start_batch=k equals k batches skipped
    c = ProceduralIterator(ds, 5, seed=9, evaluation=evaluation, start_batch=6)
    np.testing.assert_array_equal(next(c)["images"], next(a)["images"])


@pytest.fixture
def image_folder(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(11)
    root = tmp_path / "imgs"
    for cls in ("n01", "n02"):
        (root / cls).mkdir(parents=True)
        for i in range(3):
            arr = rng.integers(0, 256, (40, 48, 3)).astype(np.uint8)
            Image.fromarray(arr).save(root / cls / f"{i}.JPEG")
    return str(root)


@pytest.mark.parametrize("path", ["pil", "native"])
@pytest.mark.parametrize("train", [True, False])
def test_jpeg_dataset_matches_jax(image_folder, monkeypatch, path, train):
    if path == "pil":
        monkeypatch.setenv("RESNET_TPU_JPEG_PIL", "1")
    else:
        from resnet_tpu.data import native_jpeg as j_native_jpeg
        from resnet_tpu_torch.data import native_jpeg

        if not (native_jpeg.available() and j_native_jpeg.available()):
            pytest.skip("libresnet_jpeg.so not built")
    kw = dict(batch_size=4, out_dim=16, train=train, seed=3, use_processes=False,
              num_workers=2)
    a, b = JpegDataset(image_folder, **kw), JJpegDataset(image_folder, **kw)
    try:
        assert a.paths == b.paths and a.classes == b.classes
        for _ in range(3):  # crosses the epoch end (6 images, batch 4)
            x, y = next(a), next(b)
            np.testing.assert_array_equal(x["images"], y["images"])
            np.testing.assert_array_equal(x["labels"], y["labels"])
    finally:
        a.close(), b.close()


def test_class_metadata_matches_jax(tmp_path):
    for name, lines in (("id_to_label_mapping.txt", ["tench", "goldfish"]),
                        ("id_to_synset_mapping.txt", ["n01440764", "n01443537"]),
                        ("id_to_img_count_mapping.txt", ["1300", "1280"])):
        (tmp_path / name).write_text("\n".join(lines) + "\n\n")
    m, jm = load_class_metadata(str(tmp_path)), j_load_class_metadata(str(tmp_path))
    assert (m.labels, m.synsets, m.counts) == (jm.labels, jm.synsets, jm.counts)
    assert (m.num_classes, m.total_images) == (2, 2580)


def test_write_shard_files_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    imgs = rng.normal(0, 50, (5, 3, 4, 4)).astype(np.float64)  # cast on write
    labels = np.arange(5, dtype=np.int64)
    write_shard(str(tmp_path / "port"), 4, imgs, labels)
    j_write_shard(str(tmp_path / "jax"), 4, imgs, labels)
    for name in ("004.images", "004.labels"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_prefetcher_order_and_cursors(shard_dir):
    ds, _ = _datasets(shard_dir)
    want = ShardIterator(ds, BATCH)
    pre = prefetch_to_device(ShardIterator(ds, BATCH), depth=2, device="cpu")
    try:
        for _ in range(8):
            got, ref = next(pre), next(want)
            assert isinstance(got["images"], torch.Tensor)
            np.testing.assert_array_equal(got["images"].numpy(), ref["images"])
            np.testing.assert_array_equal(got["labels"].numpy(), ref["labels"])
            assert got["labels"].dtype == torch.int32
            assert _cursor(got["cursor"]) == _cursor(ref["cursor"])
        assert 0 <= pre.qsize() <= 2
    finally:
        pre.stop()


def test_prefetcher_stop_mid_stream(shard_dir):
    """stop() joins the worker even while it is blocked on a full queue,
    and leaves the queue empty."""
    ds, _ = _datasets(shard_dir)
    pre = DevicePrefetcher(ShardIterator(ds, BATCH), depth=2, device="cpu")
    next(pre)
    pre.stop()
    assert not pre._thread.is_alive()
    assert pre.qsize() == 0


def test_prefetcher_raises_worker_error_on_consumer():
    def source():
        yield {"images": np.zeros((2, 4, 4, 3), np.float32),
               "labels": np.zeros(2, np.int32)}
        raise OSError("shard read failed")

    pre = DevicePrefetcher(source(), depth=2, device="cpu")
    next(pre)
    consumer = threading.current_thread()
    with pytest.raises(OSError, match="shard read failed"):
        next(pre)
    assert threading.current_thread() is consumer
    pre._thread.join(timeout=5)
    assert not pre._thread.is_alive()


def test_bf16_transfer_bits_match_jax_host_cast():
    """transfer_dtype='bfloat16' rounds on the host to nearest even, as
    JAX's numpy cast to jnp.bfloat16 does: the bits agree, ties and the
    extremes included."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 80, (3, 5, 5, 3)).astype(np.float32)
    # exact ties between two bf16 values, both parities, and large values
    ties = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 3.0e38, -3.0e38,
                     1e-40, 0.0, -0.0, 65504.0], np.float32)
    x.reshape(-1)[: ties.size] = ties
    want = x.astype(jnp.bfloat16).view(np.uint16)
    pre = prefetch_to_device(iter([{"images": x, "labels": np.zeros(3, np.int32)}]),
                             device="cpu", transfer_dtype="bfloat16")
    got = next(pre)
    pre.stop()
    assert got["images"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["images"].view(torch.int16).numpy().view(np.uint16),
                                  want)
    assert got["labels"].dtype == torch.int32


def test_prefetcher_copies_read_only_shard_views(shard_dir):
    """A ShardIterator whose layout matches the disk hands out read-only
    memmap views; the prefetched batch owns its memory all the same."""
    ds, _ = _datasets(shard_dir)
    view = next(ShardIterator(ds, BATCH, layout="NCHW"))["images"]
    assert not view.flags.writeable
    before = np.array(view)
    pre = prefetch_to_device(ShardIterator(ds, BATCH, layout="NCHW"), device="cpu")
    got = next(pre)
    pre.stop()
    np.testing.assert_array_equal(got["images"].numpy(), before)
    got["images"].add_(1.0)  # writable, and the shard is untouched
    np.testing.assert_array_equal(np.asarray(ds.open_shard(0)[0][:BATCH]), before)
