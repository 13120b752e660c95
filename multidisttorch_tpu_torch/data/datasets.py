"""MNIST from local IDX files and CIFAR-10 from its python pickles, each
with a deterministic synthetic fallback, and token corpora for the LM.

A copy of ``Dataset``, ``_read_idx``, ``synthetic_mnist``, ``load_mnist``,
``synthetic_cifar10``, ``load_cifar10``, ``TokenCorpus``, ``byte_corpus``
and ``synthetic_corpus`` from ``multidisttorch_tpu/data/datasets.py``
(numpy only, so the port imports none of the JAX package). One
difference: the port never downloads. ``load_mnist`` and ``load_cifar10``
read files under ``data_dir`` or, failing that, return the labelled
synthetic stand-in (``Dataset.synthetic`` is True), so every result says
which data it came from. Image rows are flattened HWC (NHWC batches).
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import warnings
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Dataset:
    """Host-resident split: images in [0,1] float32, labels int32."""

    images: np.ndarray  # (N, H*W*C) flattened
    labels: np.ndarray  # (N,)
    name: str
    synthetic: bool = False

    def __len__(self) -> int:
        return self.images.shape[0]


_MNIST_FILES = {
    True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _read_idx(path: str) -> np.ndarray:
    """Parse an IDX-format file (optionally gzipped)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"{path}: not an IDX file")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                  0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}
        data = np.frombuffer(f.read(), dtype=dtypes[dtype_code])
        return data.reshape(dims)


def _find_idx_file(data_dir: str, basename: str) -> str | None:
    for sub in ("", "MNIST/raw", "mnist"):
        for ext in ("", ".gz"):
            p = os.path.join(data_dir, sub, basename + ext)
            if os.path.exists(p):
                return p
    return None


def synthetic_mnist(n: int, seed: int = 0, image_hw: int = 28) -> Dataset:
    """Deterministic MNIST-shaped stand-in: 10 classes of oriented
    Gaussian strokes. The same rows as the JAX package's for the same
    ``(n, seed)``."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:image_hw, 0:image_hw].astype(np.float32)
    imgs = np.zeros((n, image_hw, image_hw), np.float32)
    for cls in range(10):
        idx = np.where(labels == cls)[0]
        if idx.size == 0:
            continue
        angle = cls * np.pi / 10.0
        cy = 14 + 6 * np.sin(angle) + rng.normal(0, 1.2, idx.size)
        cx = 14 + 6 * np.cos(angle) + rng.normal(0, 1.2, idx.size)
        sy = 2.0 + 1.5 * (cls % 3)
        sx = 2.0 + 1.5 * ((cls + 1) % 3)
        d = np.exp(
            -((yy[None] - cy[:, None, None]) ** 2 / (2 * sy**2)
              + (xx[None] - cx[:, None, None]) ** 2 / (2 * sx**2))
        )
        imgs[idx] = d
    imgs += rng.normal(0, 0.02, imgs.shape).astype(np.float32)
    imgs = np.clip(imgs, 0.0, 1.0)
    return Dataset(
        images=imgs.reshape(n, -1), labels=labels,
        name="synthetic-mnist", synthetic=True,
    )


def load_mnist(
    train: bool = True,
    data_dir: str = "data",
    *,
    allow_synthetic: bool = True,
    synthetic_size: int | None = None,
) -> Dataset:
    """Load MNIST from IDX files under ``data_dir``; else the synthetic
    stand-in (MNIST-sized unless ``synthetic_size``), or raise when
    ``allow_synthetic=False``. Never downloads."""
    img_base, lbl_base = _MNIST_FILES[train]
    img_path = _find_idx_file(data_dir, img_base)
    lbl_path = _find_idx_file(data_dir, lbl_base)
    if img_path and lbl_path:
        imgs = _read_idx(img_path).astype(np.float32) / 255.0
        labels = _read_idx(lbl_path).astype(np.int32)
        return Dataset(imgs.reshape(len(imgs), -1), labels, "mnist")

    if not allow_synthetic:
        raise FileNotFoundError(
            f"MNIST not found under {data_dir!r}; pass allow_synthetic=True "
            "for the deterministic stand-in"
        )
    n = synthetic_size if synthetic_size is not None else (60000 if train else 10000)
    warnings.warn("Using synthetic MNIST stand-in (no local data)")
    return synthetic_mnist(n, seed=0 if train else 1)


def synthetic_cifar10(n: int, seed: int = 0) -> Dataset:
    """Deterministic CIFAR-shaped stand-in: 32x32x3 class-coloured
    gradients plus texture noise. The same rows as the JAX package's for
    the same ``(n, seed)``."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
    base = np.zeros((n, 32, 32, 3), np.float32)
    for cls in range(10):
        idx = np.where(labels == cls)[0]
        if idx.size == 0:
            continue
        hue = np.array(
            [np.sin(cls * 0.7), np.sin(cls * 0.7 + 2.1), np.sin(cls * 0.7 + 4.2)],
            np.float32,
        ) * 0.3 + 0.5
        grad = (yy * np.cos(cls) + xx * np.sin(cls)) / 64.0 + 0.5
        base[idx] = grad[None, :, :, None] * hue[None, None, None, :]
    base += rng.normal(0, 0.05, base.shape).astype(np.float32)
    base = np.clip(base, 0.0, 1.0)
    return Dataset(base.reshape(n, -1), labels, "synthetic-cifar10", synthetic=True)


def load_cifar10(
    train: bool = True,
    data_dir: str = "data",
    *,
    allow_synthetic: bool = True,
    synthetic_size: int | None = None,
) -> Dataset:
    """CIFAR-10 from the ``cifar-10-batches-py`` pickles under ``data_dir``
    (``data_batch_1``..``5`` or ``test_batch``): NCHW bytes as flattened
    NHWC rows over 255. Else the synthetic stand-in (CIFAR-sized unless
    ``synthetic_size``), or raise when ``allow_synthetic=False``. Never
    downloads."""
    batch_dir = os.path.join(data_dir, "cifar-10-batches-py")
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    if all(os.path.exists(os.path.join(batch_dir, b)) for b in names):
        xs, ys = [], []
        for b in names:
            with open(os.path.join(batch_dir, b), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        imgs = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0
        return Dataset(imgs.reshape(len(imgs), -1), np.asarray(ys, np.int32), "cifar10")

    if not allow_synthetic:
        raise FileNotFoundError(f"CIFAR-10 not found under {data_dir!r}")
    n = synthetic_size if synthetic_size is not None else (50000 if train else 10000)
    warnings.warn("Using synthetic CIFAR-10 stand-in (no local data)")
    return synthetic_cifar10(n, seed=0 if train else 1)


@dataclass(frozen=True)
class TokenCorpus:
    """Host-resident token stream for LM training: a local file read as
    bytes (vocab 256) or a synthetic periodic stream. ``batch(rng, b, t)``
    samples ``b`` random ``t``-token windows; the same ``np.random.Generator``
    state gives the same windows as the JAX package's."""

    tokens: np.ndarray  # (N,) int32
    vocab_size: int
    name: str
    synthetic: bool = False

    def __len__(self) -> int:
        return self.tokens.shape[0]

    def batch(self, rng: np.random.Generator, b: int, t: int) -> np.ndarray:
        n = self.tokens.shape[0]
        if n < t:
            raise ValueError(f"corpus of {n} tokens cannot fill windows of {t}")
        # inclusive upper start: the final token must be reachable
        starts = rng.integers(0, n - t + 1, size=b)
        return np.stack([self.tokens[s : s + t] for s in starts]).astype(np.int32)


def byte_corpus(path: str, *, name: str | None = None) -> TokenCorpus:
    """Byte-level tokens from any local file (vocab 256)."""
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(), dtype=np.uint8)
    return TokenCorpus(tokens=raw.astype(np.int32), vocab_size=256, name=name or os.path.basename(path))


def synthetic_corpus(
    n: int = 65536, *, vocab_size: int = 32, period: int = 16, seed: int = 0
) -> TokenCorpus:
    """Perfectly learnable periodic stream: block ``i`` is
    ``(arange(period) + seed + 5*i) % vocab_size``, so every token is a
    deterministic function of its predecessors and the loss floor is zero."""
    stride = 5  # coprime with common periods; any fixed value works
    blocks = n // period + 2
    phases = (seed + stride * np.arange(blocks)) % vocab_size
    rows = [(np.arange(period) + p) % vocab_size for p in phases]
    tokens = np.concatenate(rows)[:n].astype(np.int32)
    return TokenCorpus(tokens=tokens, vocab_size=vocab_size, name="synthetic-periodic", synthetic=True)
