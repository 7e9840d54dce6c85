"""Image-pair data pipeline (the "multi-modal" metric-learning input).

Reference: PairImageDataLayer (src/caffe/layers/pair_image_data_layer.cpp:
26-178; proto caffe.proto:434-463): a list file of

    img1_path img2_path angle1 angle2 label

rows, both images loaded per row, optionally resized / scaled /
mean-subtracted / mirrored (the DataTransformer subset the layer uses),
shuffled per epoch with rand_skip.  The reference stacks the pair along the
channel axis; this pipeline keeps them as two NHWC tensors (the siamese
model shares weights anyway, and separate tensors let the encoder batch
img1 ⧺ img2 in one pass -- larger matrix products than doubling channels).

Image IO: PIL when available; ``.npy`` arrays always (tests and synthetic
pools use npy -- no image codec dependency on the accelerator host).
"""

from __future__ import annotations

import os

import numpy as np


def parse_pair_list(path_or_text: str):
    """Returns list of (img1, img2, angle1, angle2, label).  Accepts a
    file path or the list TEXT itself (which contains a newline or
    whitespace-separated columns); a missing path raises instead of
    silently parsing the path string as an empty list."""
    if os.path.exists(path_or_text):
        with open(path_or_text) as f:
            lines = f.read().splitlines()
    elif "\n" in path_or_text or len(path_or_text.split()) >= 5:
        lines = path_or_text.splitlines()
    else:
        raise FileNotFoundError(path_or_text)
    rows = []
    for line in lines:
        parts = line.split()
        if len(parts) < 5:
            continue
        rows.append((parts[0], parts[1], float(parts[2]), float(parts[3]),
                     int(parts[4])))
    return rows


def load_image(path: str, *, new_height: int = 0, new_width: int = 0,
               is_color: bool = True) -> np.ndarray:
    """-> float32 HWC in [0, 255] (the reference's cv::Mat convention)."""
    if path.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
    else:
        from PIL import Image  # gated: only needed for real image files

        img = Image.open(path)
        img = img.convert("RGB" if is_color else "L")
        if new_height and new_width:
            img = img.resize((new_width, new_height))
        arr = np.asarray(img, np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr
    if new_height and new_width and arr.shape[:2] != (new_height, new_width):
        raise ValueError("npy images must already be target-sized")
    return arr


def transform(arr, *, scale: float = 1.0, mean=None, crop_size: int = 0,
              mirror: bool = False, rng=None, train: bool = True):
    """DataTransformer subset (src/caffe/data_transformer.cpp): mean
    subtract -> crop (random at train, center at test) -> mirror -> scale."""
    if mean is not None:
        arr = arr - mean
    if crop_size:
        h, w = arr.shape[:2]
        if train and rng is not None:
            y = int(rng.integers(0, h - crop_size + 1))
            x = int(rng.integers(0, w - crop_size + 1))
        else:
            y, x = (h - crop_size) // 2, (w - crop_size) // 2
        arr = arr[y: y + crop_size, x: x + crop_size]
    if mirror and rng is not None and rng.random() < 0.5:
        arr = arr[:, ::-1]
    return arr * scale


class PairImageDataset:
    """Batch iterator over an image-pair list file.

    Matches the reference layer's epoch behavior: shuffle per epoch
    (pair_image_data_layer.cpp:93-100), rand_skip at start (:83-90),
    wrap-around at the end of the list (:150-157).
    """

    def __init__(self, list_file: str, batch_size: int, *, root: str = "",
                 seed: int = 0, shuffle: bool = True, rand_skip: int = 0,
                 new_height: int = 0, new_width: int = 0,
                 scale: float = 1.0, mean=None, crop_size: int = 0,
                 mirror: bool = False, train: bool = True):
        self.rows = parse_pair_list(list_file)
        if not self.rows:
            raise ValueError("empty pair list")
        self.root = root
        self.bs = batch_size
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle
        self.kw = dict(new_height=new_height, new_width=new_width)
        self.tf = dict(scale=scale, mean=mean, crop_size=crop_size,
                       mirror=mirror, train=train)
        self.order = np.arange(len(self.rows))
        if shuffle:
            self.rng.shuffle(self.order)
        if rand_skip:
            # caffe_rng_rand() % rand_skip -> [0, rand_skip-1], with
            # CHECK_GT(lines_.size(), skip)
            # (image_data_layer.cpp:60-66 / pair_image_data_layer.cpp)
            if rand_skip >= len(self.rows):
                raise ValueError(
                    f"rand_skip {rand_skip} must be < list size "
                    f"{len(self.rows)} (the layer CHECKs the same)")
            self.cursor = int(self.rng.integers(0, rand_skip))
        else:
            self.cursor = 0

    def __iter__(self):
        return self

    def __next__(self):
        img1s, img2s, angles, labels = [], [], [], []
        for _ in range(self.bs):
            if self.cursor >= len(self.order):
                self.cursor = 0
                if self.shuffle:
                    self.rng.shuffle(self.order)
            row = self.rows[self.order[self.cursor]]
            self.cursor += 1
            a = load_image(os.path.join(self.root, row[0]), **self.kw)
            b = load_image(os.path.join(self.root, row[1]), **self.kw)
            img1s.append(transform(a, rng=self.rng, **self.tf))
            img2s.append(transform(b, rng=self.rng, **self.tf))
            angles.append((row[2], row[3]))
            labels.append(row[4])
        return {
            "img1": np.stack(img1s).astype(np.float32),
            "img2": np.stack(img2s).astype(np.float32),
            "angles": np.asarray(angles, np.float32),
            "label": np.asarray(labels, np.float32),
        }


class ImageListDataset:
    """Batch iterator over the stock ImageData list format — one
    ``path label`` row per line (image_data_layer.cpp:37-52) — with the
    same epoch shuffle / rand_skip / wrap mechanics as the pair layer.
    Yields {"data": (N,H,W,C) f32, "label": (N,) f32}."""

    def __init__(self, list_file: str, batch_size: int, *, root: str = "",
                 seed: int = 0, shuffle: bool = False, rand_skip: int = 0,
                 new_height: int = 0, new_width: int = 0,
                 is_color: bool = True,
                 scale: float = 1.0, mean=None, crop_size: int = 0,
                 mirror: bool = False, train: bool = True):
        with open(list_file) as f:
            self.rows = [(ln.rsplit(None, 1)[0], float(ln.rsplit(None, 1)[1]))
                         for ln in (s.strip() for s in f) if ln]
        if not self.rows:
            raise ValueError(f"empty image list {list_file}")
        self.root = root
        self.bs = batch_size
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle
        self.kw = dict(new_height=new_height, new_width=new_width,
                       is_color=is_color)
        self.tf = dict(scale=scale, mean=mean, crop_size=crop_size,
                       mirror=mirror, train=train)
        self.order = np.arange(len(self.rows))
        if shuffle:
            self.rng.shuffle(self.order)
        if rand_skip:
            # caffe_rng_rand() % rand_skip -> [0, rand_skip-1], with
            # CHECK_GT(lines_.size(), skip)
            # (image_data_layer.cpp:60-66 / pair_image_data_layer.cpp)
            if rand_skip >= len(self.rows):
                raise ValueError(
                    f"rand_skip {rand_skip} must be < list size "
                    f"{len(self.rows)} (the layer CHECKs the same)")
            self.cursor = int(self.rng.integers(0, rand_skip))
        else:
            self.cursor = 0

    def __iter__(self):
        return self

    def __next__(self):
        imgs, labels = [], []
        for _ in range(self.bs):
            if self.cursor >= len(self.order):
                self.cursor = 0
                if self.shuffle:
                    self.rng.shuffle(self.order)
            path, label = self.rows[self.order[self.cursor]]
            self.cursor += 1
            a = load_image(os.path.join(self.root, path), **self.kw)
            imgs.append(transform(a, rng=self.rng, **self.tf))
            labels.append(label)
        return {"data": np.stack(imgs).astype(np.float32),
                "label": np.asarray(labels, np.float32)}


def synthetic_image_corpus(directory, n_images=32, hw=16, channels=1,
                           n_classes=3, seed=0):
    """Write .npy images + an ImageData list file with a plantable
    signal: class k images are noise around a fixed class template."""
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    templates = rng.normal(size=(n_classes, hw, hw, channels)) * 2.0
    lines = []
    for i in range(n_images):
        k = int(rng.integers(0, n_classes))
        a = (templates[k]
             + 0.3 * rng.normal(size=templates[k].shape)).astype(np.float32)
        p = f"im{i}.npy"
        np.save(os.path.join(directory, p), a)
        lines.append(f"{p} {k}")
    list_file = os.path.join(directory, "images.txt")
    with open(list_file, "w") as f:
        f.write("\n".join(lines))
    return list_file


def synthetic_pair_corpus(directory, n_pairs=32, hw=16, channels=1, seed=0):
    """Write .npy images + list file with a plantable signal: label-1 pairs
    are near-duplicates, label-0 pairs are independent noise."""
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    lines = []
    for i in range(n_pairs):
        label = int(rng.random() < 0.5)
        a = rng.normal(size=(hw, hw, channels)).astype(np.float32)
        b = a + 0.05 * rng.normal(size=a.shape).astype(np.float32) \
            if label else rng.normal(size=a.shape).astype(np.float32)
        pa, pb = f"a{i}.npy", f"b{i}.npy"
        np.save(os.path.join(directory, pa), a)
        np.save(os.path.join(directory, pb), b)
        lines.append(f"{pa} {pb} 0.0 0.0 {label}")
    list_file = os.path.join(directory, "pairs.txt")
    with open(list_file, "w") as f:
        f.write("\n".join(lines))
    return list_file


def compute_image_mean(list_file: str, *, root: str = "", new_height=0,
                       new_width=0):
    """Mean image (HWC float32) over every image referenced by a list --
    the `compute_image_mean` tool (tools/compute_image_mean.cpp), for the
    DataTransformer's mean subtraction.  Accepts BOTH list formats: the
    pair layer's 5-column rows (both image columns contribute) and the
    stock ImageData `path label` rows."""
    paths = []
    for row in parse_pair_list(list_file):
        paths.extend((row[0], row[1]))
    if not paths:
        with open(list_file) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        paths = [ln.rsplit(None, 1)[0] if len(ln.split()) > 1 else ln
                 for ln in lines]
    if not paths:
        raise ValueError(f"empty image list {list_file}")
    total = None
    for path in paths:
        arr = load_image(os.path.join(root, path),
                         new_height=new_height, new_width=new_width)
        total = arr if total is None else total + arr
    return total / len(paths)


def load_mean_hwc(path: str) -> np.ndarray:
    """Read a `mean_file` BlobProto ((1,)C,H,W — the tool's layout) and
    return it HWC to match this module's image convention."""
    from ..utils.caffemodel import load_blob_binaryproto

    arr = load_blob_binaryproto(path)
    while arr.ndim > 3 and arr.shape[0] == 1:
        arr = arr[0]
    if arr.ndim != 3:
        raise ValueError(f"mean file {path} has shape {arr.shape}, "
                         f"expected (1, C, H, W)")
    return np.ascontiguousarray(arr.transpose(1, 2, 0))
