"""MNIST (paper §4) — IDX loader with a procedural fallback.  The port's
own copy of ``repro/data/mnist.py`` (numpy only): the same numpy Generator
calls in the same order, so ``procedural_digits`` gives the reference's
bytes.

If real MNIST IDX files exist under $REPRO_MNIST_DIR (train-images-idx3-ubyte
etc., optionally .gz), they are used.  The repository ships no datasets, so
the default is **procedural digits**: 28×28 renderings of a 5×7 digit font
with random shift / scale / shear / pixel noise — same shapes, same
protocol, a genuinely learnable 10-class problem.  The paper's *validated*
claim (noise-robustness ordering clean > off-chip > on-chip, Fig. 5) is
dataset-independent; absolute MNIST numbers are reported when IDX files are
supplied (README §Data).
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

# 5x7 bitmap font for digits 0-9
_FONT = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11110", "00001", "00001", "01110", "00001", "00001", "11110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _glyphs() -> np.ndarray:
    g = np.zeros((10, 7, 5), np.float32)
    for d, rows in _FONT.items():
        for i, row in enumerate(rows):
            for j, c in enumerate(row):
                g[d, i, j] = float(c == "1")
    return g


def procedural_digits(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(images (n, 784) float32 in [0,1], labels (n,) int32)."""
    rng = np.random.default_rng(seed)
    glyphs = _glyphs()
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    imgs = np.zeros((n, 28, 28), np.float32)
    scales = rng.uniform(2.4, 3.4, size=n)
    dx = rng.integers(-3, 4, size=n)
    dy = rng.integers(-3, 4, size=n)
    shear = rng.uniform(-0.25, 0.25, size=n)
    for i in range(n):
        g = glyphs[labels[i]]
        s = scales[i]
        h, w = int(round(7 * s)), int(round(5 * s))
        ys = np.clip((np.arange(h) / s).astype(int), 0, 6)
        xs = np.clip((np.arange(w) / s).astype(int), 0, 4)
        big = g[np.ix_(ys, xs)]
        # shear: shift each row proportionally
        sh = shear[i]
        for r in range(h):
            big[r] = np.roll(big[r], int(round(sh * (r - h / 2))))
        y0 = max(0, (28 - h) // 2 + dy[i])
        x0 = max(0, (28 - w) // 2 + dx[i])
        y1, x1 = min(28, y0 + h), min(28, x0 + w)
        imgs[i, y0:y1, x0:x1] = big[: y1 - y0, : x1 - x0]
    imgs += rng.normal(0, 0.08, size=imgs.shape).astype(np.float32)
    imgs = np.clip(imgs, 0.0, 1.0)
    return imgs.reshape(n, 784), labels


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find(directory: str, stem: str) -> str | None:
    for suffix in ("", ".gz"):
        p = os.path.join(directory, stem + suffix)
        if os.path.exists(p):
            return p
    return None


def load(split_sizes=(60000, 10000), seed: int = 0):
    """Returns dict(train=(x, y), test=(x, y)). Real MNIST if available."""
    d = os.environ.get("REPRO_MNIST_DIR", "")
    if d:
        ti = _find(d, "train-images-idx3-ubyte")
        tl = _find(d, "train-labels-idx1-ubyte")
        vi = _find(d, "t10k-images-idx3-ubyte")
        vl = _find(d, "t10k-labels-idx1-ubyte")
        if all([ti, tl, vi, vl]):
            xtr = _read_idx(ti).reshape(-1, 784).astype(np.float32) / 255.0
            ytr = _read_idx(tl).astype(np.int32)
            xte = _read_idx(vi).reshape(-1, 784).astype(np.float32) / 255.0
            yte = _read_idx(vl).astype(np.int32)
            return {"train": (xtr, ytr), "test": (xte, yte), "source": "mnist-idx"}
    ntr, nte = split_sizes
    xtr, ytr = procedural_digits(ntr, seed=seed)
    xte, yte = procedural_digits(nte, seed=seed + 10_000)
    return {"train": (xtr, ytr), "test": (xte, yte), "source": "procedural"}
