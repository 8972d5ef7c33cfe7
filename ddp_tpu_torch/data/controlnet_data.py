"""ControlNet training data: fill50k pairs and the toy prompt tokenizer (port
of ``ddp_tpu/data/controlnet_data.py``; reference: controlnet/
tutorial_dataset.py).

fill50k: the hint is a circle's outline, the target the circle filled with
one colour on a background of another, the prompt "<fill> circle with <bg>
background". ``SyntheticFill50k`` renders pair ``idx`` from its own numpy
seed (bitwise JAX's); ``Fill50kDataset`` reads the real PNG pairs
(``prompt.json``) through ``data/image_io.py: read_image``;
``device_fill50k_batch`` renders a batch on the card from a
``torch.Generator`` (the same family as JAX's ``device_fill50k_batch``, not its
random stream). Images follow SD's convention: target in [-1, 1], hint in
[0, 1], NHWC; ids [77] int32 under the toy word-level ``VOCAB``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from .image_io import read_image

# colour name -> RGB, the prompts' content words
COLORS: List[Tuple[str, Tuple[int, int, int]]] = [
    ("red", (220, 40, 40)), ("green", (40, 200, 60)), ("blue", (50, 80, 230)),
    ("yellow", (230, 220, 50)), ("cyan", (60, 220, 220)),
    ("magenta", (220, 60, 220)), ("white", (240, 240, 240)),
    ("orange", (240, 150, 40)), ("purple", (140, 60, 200)),
    ("teal", (40, 140, 140)),
]

# CLIP-like special tokens, then a fixed vocabulary
_WORDS = (["<start>", "<end>", "<pad>", "circle", "with", "background"]
          + [name for name, _ in COLORS])
VOCAB: Dict[str, int] = {w: i for i, w in enumerate(_WORDS)}
MAX_LEN = 77


def tokenize(prompt: str, max_len: int = MAX_LEN) -> np.ndarray:
    """<start> words <end> <pad>*, an unknown word as <pad>."""
    ids = [VOCAB["<start>"]]
    for w in prompt.lower().split():
        ids.append(VOCAB.get(w, VOCAB["<pad>"]))
    ids.append(VOCAB["<end>"])
    ids = ids[:max_len]
    ids += [VOCAB["<pad>"]] * (max_len - len(ids))
    return np.asarray(ids, np.int32)


class SyntheticFill50k:
    """Procedural fill50k: pair ``idx`` drawn from ``np.random.default_rng(idx)``."""

    def __init__(self, size: int = 64, length: int = 1000, max_len: int = MAX_LEN):
        self.size = size
        self.length = length
        self.max_len = max_len

    def __len__(self):
        return self.length

    @staticmethod
    def params(idx: int, size: int):
        """(fill colour index, background colour index, centre (x, y), radius)
        of pair ``idx``, as ``load`` draws them."""
        rng = np.random.default_rng(idx)
        fill_i, bg_i = rng.choice(len(COLORS), 2, replace=False)
        cx, cy = rng.uniform(0.3, 0.7, 2) * size
        rad = rng.uniform(0.15, 0.35) * size
        return int(fill_i), int(bg_i), (cx, cy), rad

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        s = self.size
        fill_i, bg_i, (cx, cy), rad = self.params(idx, s)
        fill_name, fill_rgb = COLORS[fill_i]
        bg_name, bg_rgb = COLORS[bg_i]
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        dist = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        inside = dist < rad
        ring = np.abs(dist - rad) < max(1.0, s / 64.0)
        target = np.empty((s, s, 3), np.float32)
        target[:] = np.asarray(bg_rgb, np.float32)
        target[inside] = np.asarray(fill_rgb, np.float32)
        hint = np.zeros((s, s, 3), np.float32)
        hint[ring] = 255.0
        return {"image": (target / 127.5 - 1.0).astype(np.float32),
                "hint": (hint / 255.0).astype(np.float32),
                "ids": tokenize(f"{fill_name} circle with {bg_name} background", self.max_len)}


class Fill50kDataset:
    """Real fill50k pairs: ``data_root/prompt.json`` lines of {"source",
    "target", "prompt"}; the source is the [0, 1] hint, the target the
    [-1, 1] image, each bilinearly resized to ``size`` where it differs
    (through Pillow, as JAX's: without Pillow a resize raises ImportError)."""

    def __init__(self, data_root: str, size: int = 64, max_len: int = MAX_LEN):
        self.data_root = data_root
        self.size = size
        self.max_len = max_len
        self.items: List[dict] = []
        path = os.path.join(data_root, "prompt.json")
        if os.path.exists(path):
            with open(path) as f:
                self.items = [json.loads(line) for line in f if line.strip()]

    def __len__(self):
        return len(self.items)

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        item = self.items[idx]
        target, source = (read_rgb(os.path.join(self.data_root, item[k]), self.size)
                          for k in ("target", "source"))
        return {"image": (target / 127.5 - 1.0).astype(np.float32),
                "hint": (source / 255.0).astype(np.float32),
                "ids": tokenize(item["prompt"], self.max_len)}


def read_rgb(path: str, size: int) -> np.ndarray:
    """An image file as [size, size, 3] float32 RGB values in [0, 255],
    bilinearly resized through Pillow where its size differs (without
    Pillow a resize raises ImportError)."""
    arr = read_image(path, rgb=True)
    if arr.shape[:2] != (size, size):
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(f"{path}: resizing {arr.shape[1]}x{arr.shape[0]} to "
                              f"{size}x{size} needs Pillow, which is not installed") from e
        arr = np.asarray(Image.fromarray(arr).resize((size, size), Image.BILINEAR))
    return arr.astype(np.float32)


def render_fill50k(fill_i: torch.Tensor, bg_i: torch.Tensor, cxy: torch.Tensor,
                   rad: torch.Tensor, size: int, dtype=torch.float32):
    """(image [B, s, s, 3] in [-1, 1], hint [B, s, s, 3] in {0, 1}, ids [B, 77]
    int32) of circles with these colour indices, centres [B, 2] (x, y) and
    radii [B], their geometry computed in ``dtype`` (float32 on the card, as
    JAX's; float64 gives ``SyntheticFill50k``'s pixels)."""
    device = fill_i.device
    palette = torch.tensor([rgb for _, rgb in COLORS], dtype=torch.float32, device=device)
    grid = torch.arange(size, device=device).to(torch.float32).to(dtype)
    cxy, rad = cxy.to(dtype), rad.to(dtype)
    dist = torch.sqrt((grid[None, None, :] - cxy[:, 0, None, None]) ** 2
                      + (grid[None, :, None] - cxy[:, 1, None, None]) ** 2)
    inside = dist < rad[:, None, None]
    ring = torch.abs(dist - rad[:, None, None]) < max(1.0, size / 64.0)
    image = torch.where(inside[..., None], palette[fill_i][:, None, None, :],
                        palette[bg_i][:, None, None, :]) / 127.5 - 1.0
    hint = ring[..., None].expand(image.shape).to(torch.float32)
    c0 = VOCAB[COLORS[0][0]]
    base = torch.full((MAX_LEN,), VOCAB["<pad>"], dtype=torch.int32, device=device)
    base[:7] = torch.tensor([VOCAB["<start>"], 0, VOCAB["circle"], VOCAB["with"], 0,
                             VOCAB["background"], VOCAB["<end>"]], dtype=torch.int32)
    ids = base.repeat(fill_i.shape[0], 1)
    ids[:, 1] = (c0 + fill_i).to(torch.int32)
    ids[:, 4] = (c0 + bg_i).to(torch.int32)
    return image, hint, ids


def device_fill50k_batch(generator: torch.Generator, batch: int, size: int):
    """A procedural fill50k batch drawn and rendered on the generator's device
    (JAX's ``device_fill50k_batch`` family: two distinct palette colours,
    centre U(0.3, 0.7)·s, radius U(0.15, 0.35)·s): (image, hint, ids) as
    ``render_fill50k`` gives them."""
    device = generator.device
    n = len(COLORS)
    fill_i = torch.randint(0, n, (batch,), generator=generator, device=device)
    bg_i = (fill_i + torch.randint(1, n, (batch,), generator=generator, device=device)) % n
    cxy = (torch.rand((batch, 2), generator=generator, device=device) * 0.4 + 0.3) * size
    rad = (torch.rand((batch,), generator=generator, device=device) * 0.2 + 0.15) * size
    return render_fill50k(fill_i, bg_i, cxy, rad, size)


def controlnet_batch_iterator(ds, batch_size: int, seed: int = 0, rank: int = 0,
                              world: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite (image, hint, ids) batches of the GLOBAL ``batch_size``, an
    epoch's order ``default_rng(seed + epoch).permutation``; with world > 1
    each process yields its rank's slice."""
    assert batch_size % world == 0
    local = batch_size // world
    epoch, cursor = 0, 0
    while True:
        order = np.random.default_rng(seed + epoch).permutation(len(ds))
        batch = {"image": [], "hint": [], "ids": []}
        for i in range(rank * local, (rank + 1) * local):
            sample = ds.load(int(order[(cursor + i) % len(ds)]))
            for k in batch:
                batch[k].append(sample[k])
        yield {k: np.stack(v) for k, v in batch.items()}
        cursor += batch_size
        if cursor >= len(ds):
            cursor, epoch = 0, epoch + 1
