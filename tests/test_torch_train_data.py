"""``flux2_tpu_torch/training/data.py`` against the JAX package's original,
to the bit: the buckets, caption parsing, the dataset scan (``.txt``
sidecars, ``manifest.jsonl``, control pairing), Pillow's LANCZOS resize and
center crop, the ``LatentCache`` key, file names and round trip (a cache
written by one package is read by the other), and ``batches``' order. The
datasets are written from seeds by ``utils.synthetic.write_dataset``.
"""

import dataclasses
import os

import numpy as np
import pytest

from flux2_tpu.training import data as jdata
from flux2_tpu_torch.training import data as tdata
from flux2_tpu_torch.utils import synthetic

SIZES = [(64, 64), (48, 80), (96, 64), (64, 64), (40, 120)]


def test_standard_buckets_equal_jax():
    assert tdata.STANDARD_BUCKETS == jdata.STANDARD_BUCKETS


@pytest.mark.parametrize("resolution", [32, 64, 256, 512, 768, 1024, 1536])
def test_scaled_buckets_equal_jax(resolution):
    assert tdata.scaled_buckets(resolution) == jdata.scaled_buckets(resolution)


@pytest.mark.parametrize("resolutions", [[1024], [512], [512, 768, 1024], [64]], ids=["1024", "512", "multi", "64"])
@pytest.mark.parametrize("wh", [(512, 512), (300, 700), (1000, 400), (64, 96), (2000, 2000), (31, 33), (1536, 640)])
def test_assign_bucket_equals_jax(wh, resolutions):
    buckets = []
    for r in resolutions:
        buckets += [b for b in jdata.scaled_buckets(r) if b not in buckets]
    assert tdata.assign_bucket(*wh, buckets) == jdata.assign_bucket(*wh, buckets)


@pytest.mark.parametrize("raw,trigger", [("a photo of [trigger]", "sks"), ("a photo of [trigger] here", None),
                                         ("[trigger]  cat ", ""), ("no placeholder", "sks"), ("", None)])
def test_parse_caption_equals_jax(raw, trigger):
    assert tdata.parse_caption(raw, trigger) == jdata.parse_caption(raw, trigger)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return {manifest: synthetic.write_dataset(str(root / ("manifest" if manifest else "sidecars")), 3, SIZES,
                                               control=(0, 2), manifest=manifest)
            for manifest in (False, True)}


@pytest.mark.parametrize("control", [False, True], ids=["plain", "control"])
@pytest.mark.parametrize("manifest", [False, True], ids=["sidecars", "manifest"])
@pytest.mark.parametrize("resolution", [64, 1024])
def test_load_dataset_equals_jax(datasets, manifest, control, resolution):
    d = datasets[manifest]
    kw = dict(trigger="sks", control_dir=d["control"] if control else None, buckets=jdata.scaled_buckets(resolution))
    ours = [dataclasses.asdict(it) for it in tdata.load_dataset(d["dataset"], **kw)]
    assert ours == [dataclasses.asdict(it) for it in jdata.load_dataset(d["dataset"], **kw)]
    assert len(ours) == len(SIZES) and len({tuple(it["bucket"]) for it in ours}) >= 2
    if control or manifest:
        assert [it["control_path"] is not None for it in ours] == [i in (0, 2) for i in range(len(SIZES))]


@pytest.mark.parametrize("bucket", [(64, 64), (64, 96), (96, 64), (32, 96)])
def test_load_image_pixels_equal_jax(datasets, bucket):
    path = os.path.join(datasets[False]["dataset"], "image_01.png")
    ours, ref = tdata.load_image(path, *bucket), jdata.load_image(path, *bucket)
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == (bucket[1], bucket[0], 3)
    assert np.array_equal(ours, ref)


def test_latent_cache_key_file_and_round_trip_across_packages(datasets, tmp_path):
    item = tdata.load_dataset(datasets[False]["dataset"], buckets=tdata.scaled_buckets(64))[1]
    jitem = jdata.DatasetItem(**dataclasses.asdict(item))
    ours, ref = tdata.LatentCache(str(tmp_path), "flux2-vae32-v1"), jdata.LatentCache(str(tmp_path), "flux2-vae32-v1")
    assert ours._key(item) == ref._key(jitem)
    assert ours._key(item) != tdata.LatentCache(str(tmp_path), "other")._key(item)
    lat = np.random.RandomState(0).randn(1, 24, 128).astype(np.float32)
    ref.put(jitem, lat)
    assert os.listdir(tmp_path) == [ref._key(jitem) + ".npy"]
    assert np.array_equal(ours.get(item), lat)
    calls = []
    got = ours.get_or_encode(item, lambda img: calls.append(img.shape) or lat + 1)
    assert not calls and np.array_equal(got, lat)  # the JAX-written entry is a hit
    other = tdata.DatasetItem(item.image_path, item.caption, (96, 64))
    got = ours.get_or_encode(other, lambda img: calls.append(img.shape) or lat + 1)
    assert calls == [(64, 96, 3)] and np.array_equal(got, lat + 1)
    assert np.array_equal(ref.get(jdata.DatasetItem(**dataclasses.asdict(other))), lat + 1)


@pytest.mark.parametrize("batch_size,drop_last", [(1, False), (2, False), (2, True), (3, True)])
@pytest.mark.parametrize("seed", [0, 7])
def test_batches_order_equals_jax(datasets, seed, batch_size, drop_last):
    items = tdata.load_dataset(datasets[False]["dataset"], buckets=tdata.scaled_buckets(64))
    jitems = [jdata.DatasetItem(**dataclasses.asdict(it)) for it in items]
    ours = [[it.image_path for it in b] for b in tdata.batches(items, batch_size, seed, drop_last)]
    assert ours == [[it.image_path for it in b] for b in jdata.batches(jitems, batch_size, seed, drop_last)]
