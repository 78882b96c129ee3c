"""Training dataset: images + captions, aspect-ratio buckets, latent cache.

The port's own copy of ``flux2_tpu/training/data.py`` (pure host code: the
same buckets, caption parsing, dataset scan, Pillow LANCZOS resize and
center crop, and ``LatentCache`` key, so a cache directory is shared between
the packages; held against the original in ``tests/test_torch_train_data.py``).

Capability parity with ``Sources/Flux2Core/Training/Data/``:
  - image+caption pairs from a directory (``.txt`` caption sidecars or a
    ``.jsonl`` manifest), ``[trigger]`` placeholder substitution
    (CaptionParser).
  - aspect-ratio bucketing over the standard ratio set so every batch has
    one static shape (AspectRatioBucket.swift:33-45).
  - disk VAE-latent cache keyed by an encoder-version tag for invalidation
    (LatentCache.swift:75-80).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# Standard bucket ratios (w/h) at ~1MP, all dims multiples of 32.
STANDARD_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (1024, 1024),
    (896, 1152),
    (1152, 896),
    (832, 1216),
    (1216, 832),
    (768, 1344),
    (1344, 768),
    (640, 1536),
    (1536, 640),
)


def scaled_buckets(
    resolution: int, base: Sequence[Tuple[int, int]] = STANDARD_BUCKETS
) -> Tuple[Tuple[int, int], ...]:
    """Scale the standard ~1MP ratio set to a target resolution (the
    reference buckets at the configured training resolution). Dims stay
    multiples of 32 with a 32px floor; duplicates collapse."""
    factor = resolution / 1024.0
    out = []
    for w, h in base:
        sw = max(32, int(round(w * factor / 32)) * 32)
        sh = max(32, int(round(h * factor / 32)) * 32)
        if (sw, sh) not in out:
            out.append((sw, sh))
    return tuple(out)


@dataclasses.dataclass
class DatasetItem:
    image_path: str
    caption: str
    bucket: Tuple[int, int]  # (width, height)
    control_path: Optional[str] = None  # I2I training control image


def parse_caption(raw: str, trigger: Optional[str]) -> str:
    """Substitute the ``[trigger]`` placeholder (CaptionParser semantics)."""
    if trigger:
        return raw.replace("[trigger]", trigger).strip()
    return raw.replace("[trigger]", "").replace("  ", " ").strip()


def assign_bucket(width: int, height: int, buckets: Sequence[Tuple[int, int]] = STANDARD_BUCKETS) -> Tuple[int, int]:
    """Pick the bucket with the closest aspect ratio; ties (the same ratio
    set scaled to several resolutions — ``bucket_resolutions``) break toward
    the closest area so multi-resolution lists actually spread images by
    size instead of funneling everything into the first resolution, and a
    bucket never upscales past ~2x the source pixels."""
    ratio = width / height
    area = width * height

    def key(b):
        ratio_err = abs(b[0] / b[1] - ratio)
        barea = b[0] * b[1]
        # forbid heavy upscaling: a bucket >2x the image's pixels ranks last
        upscale_penalty = 1 if barea > 2 * area else 0
        return (round(ratio_err, 3), upscale_penalty, abs(barea - area))

    return min(buckets, key=key)


def load_dataset(
    dataset_dir: str,
    trigger: Optional[str] = None,
    control_dir: Optional[str] = None,
    buckets: Sequence[Tuple[int, int]] = STANDARD_BUCKETS,
) -> List[DatasetItem]:
    """Scan a directory of images with .txt caption sidecars or a manifest.jsonl."""
    items: List[DatasetItem] = []
    manifest = os.path.join(dataset_dir, "manifest.jsonl")
    if os.path.exists(manifest):
        with open(manifest) as f:
            for line in f:
                rec = json.loads(line)
                img_path = os.path.join(dataset_dir, rec["image"])
                w, h = _image_size(img_path)
                items.append(
                    DatasetItem(
                        image_path=img_path,
                        caption=parse_caption(rec.get("caption", ""), trigger),
                        bucket=assign_bucket(w, h, buckets),
                        control_path=os.path.join(dataset_dir, rec["control"]) if rec.get("control") else None,
                    )
                )
        return items

    exts = (".png", ".jpg", ".jpeg", ".webp")
    for name in sorted(os.listdir(dataset_dir)):
        if not name.lower().endswith(exts):
            continue
        img_path = os.path.join(dataset_dir, name)
        stem = os.path.splitext(name)[0]
        cap_path = os.path.join(dataset_dir, stem + ".txt")
        caption = ""
        if os.path.exists(cap_path):
            with open(cap_path) as f:
                caption = f.read()
        control_path = None
        if control_dir:
            for ext in exts:
                c = os.path.join(control_dir, stem + ext)
                if os.path.exists(c):
                    control_path = c
                    break
        w, h = _image_size(img_path)
        items.append(
            DatasetItem(
                image_path=img_path,
                caption=parse_caption(caption, trigger),
                bucket=assign_bucket(w, h, buckets),
                control_path=control_path,
            )
        )
    return items


def group_by_bucket(items: Sequence[DatasetItem]) -> Dict[Tuple[int, int], List[DatasetItem]]:
    out: Dict[Tuple[int, int], List[DatasetItem]] = {}
    for item in items:
        out.setdefault(item.bucket, []).append(item)
    return out


def _image_size(path: str) -> Tuple[int, int]:
    from PIL import Image

    with Image.open(path) as im:
        return im.size  # (w, h)


def load_image(path: str, width: int, height: int) -> np.ndarray:
    """Load + center-crop-resize to the bucket dims; [H, W, 3] float in [0,1]."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        # scale so the image covers the bucket, then center-crop
        scale = max(width / im.width, height / im.height)
        nw, nh = round(im.width * scale), round(im.height * scale)
        im = im.resize((nw, nh), Image.LANCZOS)
        x0 = (nw - width) // 2
        y0 = (nh - height) // 2
        im = im.crop((x0, y0, x0 + width, y0 + height))
        return np.asarray(im, np.float32) / 255.0


class LatentCache:
    """Disk cache of VAE-encoded latents, invalidated by encoder version.

    Cache key = sha1(image path + mtime + bucket + encoder_version)
    (LatentCache.swift:75-80 uses the same encoder-version tag idea).
    """

    def __init__(self, cache_dir: str, encoder_version: str):
        self.cache_dir = cache_dir
        self.encoder_version = encoder_version
        os.makedirs(cache_dir, exist_ok=True)

    def _key(self, item: DatasetItem) -> str:
        st = os.stat(item.image_path)
        blob = f"{item.image_path}:{int(st.st_mtime)}:{item.bucket}:{self.encoder_version}"
        return hashlib.sha1(blob.encode()).hexdigest()

    def get(self, item: DatasetItem) -> Optional[np.ndarray]:
        path = os.path.join(self.cache_dir, self._key(item) + ".npy")
        if os.path.exists(path):
            return np.load(path)
        return None

    def put(self, item: DatasetItem, latents: np.ndarray) -> None:
        path = os.path.join(self.cache_dir, self._key(item) + ".npy")
        tmp = path + ".tmp"
        np.save(tmp, latents)  # np.save always appends .npy to a bare name
        os.replace(tmp + ".npy", path)

    def get_or_encode(self, item: DatasetItem, encode_fn) -> np.ndarray:
        cached = self.get(item)
        if cached is not None:
            return cached
        w, h = item.bucket
        latents = np.asarray(encode_fn(load_image(item.image_path, w, h)))
        self.put(item, latents)
        return latents


def batches(
    items: Sequence[DatasetItem],
    batch_size: int,
    seed: int = 0,
    drop_last: bool = False,
) -> Iterator[List[DatasetItem]]:
    """Bucket-homogeneous batches in shuffled order (static shapes per batch)."""
    rng = np.random.RandomState(seed)
    grouped = group_by_bucket(items)
    all_batches: List[List[DatasetItem]] = []
    for bucket_items in grouped.values():
        idx = rng.permutation(len(bucket_items))
        for i in range(0, len(idx), batch_size):
            chunk = [bucket_items[j] for j in idx[i : i + batch_size]]
            if len(chunk) == batch_size or not drop_last:
                all_batches.append(chunk)
    order = rng.permutation(len(all_batches))
    for i in order:
        yield all_batches[i]
