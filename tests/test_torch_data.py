"""The port's data pipeline against the JAX package's, on the CPU: the same arrays, moved to NTCHW.

Each numpy module gives the JAX module's arrays bit for bit (windows, the
native packer and its numpy fallback, crops, synthetic host batches,
``NimrodStream`` / ``DGMRDataModule`` on local parquet, numpy-backed
``MRMSSequences`` with per-process chunks and phase rotation, ``mrms_tiles``);
``blob_fields`` agrees with JAX's on the same blob parameters (f32 exp and
sums, 1e-5 of the field's scale); ``prefetch_to_device`` on the CPU keeps the
order, forwards errors and casts with ``transfer_dtype``. No JAX program is
compiled beyond ``blob_fields``' few eager ops.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from skillful_nowcasting_tpu import data as jdata
from skillful_nowcasting_tpu.data import native as jnative
from skillful_nowcasting_tpu_torch import data
from skillful_nowcasting_tpu_torch.data import _process, native

torch.set_num_threads(1)


def tchw(a):
    """A JAX (..., H, W, C) array in the port's (..., C, H, W) layout."""
    return np.moveaxis(np.asarray(a), -1, -3)


def test_windows_match_jax():
    frames = np.random.default_rng(0).random((30, 8, 8, 2), np.float32)
    want = jdata.extract_input_and_target_frames(frames)
    got = data.extract_input_and_target_frames(tchw(frames))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, tchw(w))
    with pytest.raises(ValueError):
        data.extract_input_and_target_frames(np.zeros((10, 1, 4, 4), np.float32))


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_pack_windows_and_space_to_depth_match_jax(path, monkeypatch):
    if path == "numpy":
        monkeypatch.setattr(native, "_load", lambda: None)
    rng = np.random.default_rng(1)
    for channels in (1, 2):
        pool = rng.random((12, 20, 24, channels), np.float32)
        pool[3, 4, 5, 0] = np.nan
        idx = [np.array(v, np.int64) for v in ([0, 5, 2], [1, 0, 4], [3, 8, 0])]
        kw = dict(n_in=2, n_tgt=3, crop_h=16, crop_w=16, scale=0.5, offset=0.25, nan_fill=-1.0)
        want = jnative.pack_windows(pool, *idx, **kw)
        got = native.pack_windows(tchw(pool), *idx, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, tchw(w))
        x = rng.random((2, 3, 8, 12, channels), np.float32)
        s2d = native.space_to_depth_host(tchw(x), 2)
        np.testing.assert_array_equal(s2d, tchw(jnative.space_to_depth_host(x, 2)))
        np.testing.assert_array_equal(s2d, F.pixel_unshuffle(torch.from_numpy(tchw(x)), 2).numpy())
    with pytest.raises(ValueError):
        native.pack_windows(tchw(pool), *[np.array([20])] * 3, **kw)


def test_crops_and_synthetic_host_batches_match_jax():
    pool = np.random.default_rng(2).random((30, 64, 96, 1), np.float32)
    kw = dict(batch_size=3, crop=32, num_target_frames=6, seed=1)
    want = jdata.random_crop_batches(pool, **kw)
    got = data.random_crop_batches(tchw(pool), **kw)
    for _ in range(2):
        for g, w in zip(next(got), next(want)):
            np.testing.assert_array_equal(g, tchw(w))
    with pytest.raises(ValueError):
        next(data.random_crop_batches(tchw(pool), 1, crop=128))

    for name, kw in (("synthetic_batches", dict(batch_size=2, size=16, channels=2, seed=7)),
                     ("synthetic_radar_batches", dict(batch_size=2, input_frames=2,
                                                      target_frames=3, size=32, seed=7,
                                                      n_blobs=4, channels=2))):
        want, got = getattr(jdata, name)(**kw), getattr(data, name)(**kw)
        for _ in range(2):
            for g, w in zip(next(got), next(want)):
                assert g.dtype == np.float32
                np.testing.assert_array_equal(g, tchw(w))


def test_blob_fields_match_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    b, k, t, s = 2, 3, 4, 16
    params = (rng.uniform(0, s, (b, k, 2)), rng.uniform(-3, 3, (b, k, 2)),
              rng.uniform(s / 32, s / 8, (b, k)), rng.uniform(2, 12, (b, k)))
    want = np.asarray(jdata.blob_fields(*(jnp.asarray(p, jnp.float32) for p in params), t, s))
    got = data.blob_fields(*(torch.tensor(p, dtype=torch.float32) for p in params), t, s)
    assert got.shape == (b, t, 1, s, s) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), tchw(want), rtol=0, atol=1e-5 * np.abs(want).max())


def test_synthetic_radar_batches_device_on_the_cpu():
    kw = dict(batch_size=2, input_frames=2, target_frames=3, size=16, seed=11, device="cpu")
    images, future = next(data.synthetic_radar_batches_device(**kw))
    assert images.shape == (2, 2, 1, 16, 16) and future.shape == (2, 3, 1, 16, 16)
    assert images.device.type == "cpu" and float(future.max()) > 1.0
    again, _ = next(data.synthetic_radar_batches_device(**kw))
    assert torch.equal(images, again)
    with pytest.raises(ValueError):
        next(data.synthetic_radar_batches_device(channels=2, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            next(data.synthetic_radar_batches_device())


@pytest.fixture(scope="module")
def nimrod_parquet(tmp_path_factory):
    """4 parquet files x 2 rows of THWC frames, each row's frames filled with its row id."""
    datasets = pytest.importorskip("datasets")
    root = tmp_path_factory.mktemp("nimrod_parquet")
    files = []
    for f in range(4):
        rows = [np.full((24, 8, 8, 1), float(f * 2 + r), np.float32).tolist() for r in range(2)]
        path = str(root / f"part-{f}.parquet")
        datasets.Dataset.from_dict({"radar_frames": rows}).to_parquet(path)
        files.append(path)
    return files


def test_nimrod_stream_matches_jax(nimrod_parquet):
    """Two processes' streams (each opening costs seconds, so the epoch logic is left to
    ``tests/test_data.py``): JAX's windows in TCHW, disjoint shards covering the data."""
    from skillful_nowcasting_tpu.data.nimrod import NimrodStream as JaxStream

    shards = []
    for idx in (0, 1):
        kw = dict(split="train", seed=3, process_index=idx, process_count=2,
                  dataset_name="parquet", config_name=None,
                  load_kwargs={"data_files": {"train": nimrod_parquet}})
        want, got = JaxStream(**kw), data.NimrodStream(**kw)
        ids = []
        for _ in range(4):
            (gi, gt), (wi, wt) = next(got), next(want)
            np.testing.assert_array_equal(gi, tchw(wi))
            np.testing.assert_array_equal(gt, tchw(wt))
            assert gi.shape == (4, 1, 8, 8) and gt.shape == (18, 1, 8, 8)
            ids.append(int(gi[0, 0, 0, 0]))
        shards.append(set(ids))
    assert not shards[0] & shards[1] and shards[0] | shards[1] == set(range(8))

    dm = data.DGMRDataModule(batch_size=2, seed=5, process_index=0, process_count=1,
                             dataset_name="parquet", config_name=None,
                             load_kwargs={"data_files": {"train": nimrod_parquet}})
    images, future = next(dm.train_dataloader())
    assert images.shape == (2, 4, 1, 8, 8) and future.shape == (2, 18, 1, 8, 8)


def test_process_index_from_torch_distributed(monkeypatch):
    import torch.distributed as dist

    assert _process.process_index_and_count(None, None) == (0, 1)
    assert _process.process_index_and_count(3, 4) == (3, 4)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    assert _process.process_index_and_count(None, None) == (1, 2)
    assert data.MRMSSequences(np.zeros((8, 4, 4))).process_index == 1


def test_mrms_matches_jax():
    array = np.random.default_rng(3).random((64, 96, 128)).astype(np.float32)  # THW
    array[0, 0, 0] = np.nan
    kw = dict(batch_size=2, crop=64, num_target_frames=6, frames_per_chunk=32,
              batches_per_chunk=2, seed=5, nan_fill=0.25)
    for idx, count in ((0, 1), (1, 2)):
        want = iter(jdata.MRMSSequences(array, process_index=idx, process_count=count, **kw))
        got = iter(data.MRMSSequences(array, process_index=idx, process_count=count, **kw))
        for _ in range(5):  # across chunk boundaries
            for g, w in zip(next(got), next(want)):
                np.testing.assert_array_equal(g, tchw(w))

    # Disjoint per-process chunk slots, the same starts as JAX's, under every phase.
    long = np.zeros((512, 8, 8), np.float32)
    for phase in (0, 7, 31):
        starts = []
        for idx in range(4):
            mine = data.MRMSSequences(long, frames_per_chunk=32, seed=9, process_index=idx,
                                      process_count=4)
            theirs = jdata.MRMSSequences(long, frames_per_chunk=32, seed=9, process_index=idx,
                                         process_count=4)
            r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
            got = [mine._next_chunk_start(r1, 512, phase) for _ in range(50)]
            assert got == [theirs._next_chunk_start(r2, 512, phase) for _ in range(50)]
            starts.append(set(got))
        for i in range(4):
            for j in range(i + 1, 4):
                assert all(abs(a - b) >= 32 for a in starts[i] for b in starts[j])

    want = jdata.mrms_tiles(array, t_index=7, scale=2.0, nan_fill=0.5)
    got = data.mrms_tiles(array, t_index=7, scale=2.0, nan_fill=0.5)
    assert got.shape == (4, 1, 96, 128)
    np.testing.assert_array_equal(got, tchw(want))
    with pytest.raises(ValueError):
        data.mrms_tiles(array, t_index=2)
    with pytest.raises(ImportError, match="zarr"):
        data.open_zarr("missing.zarr")


def test_prefetch_to_device_on_the_cpu():
    items = [(np.full((2, 3), i, np.float32), np.arange(i + 1)) for i in range(5)]
    out = list(data.prefetch_to_device(iter(items), size=2, device="cpu"))
    assert len(out) == 5
    for i, (a, b) in enumerate(out):
        assert isinstance(a, torch.Tensor) and a.dtype == torch.float32 and float(a[0, 0]) == i
        assert torch.equal(b, torch.arange(i + 1))

    def broken():
        yield items[0]
        raise ValueError("bad shard")

    it = data.prefetch_to_device(broken(), device="cpu")
    next(it)
    with pytest.raises(ValueError, match="bad shard"):
        next(it)

    a, b = next(data.prefetch_to_device(iter(items[1:]), device="cpu",
                                        transfer_dtype=torch.bfloat16))
    assert a.dtype == torch.bfloat16 and b.dtype == torch.int64  # floating leaves only
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            data.prefetch_to_device(iter(items))
