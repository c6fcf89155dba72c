"""Hermetic VQ image tokenizer for the img_gen task (host numpy).

Counterpart of ``unimp_tpu/tools/vqgan.py``. The reference generates
VQGAN codebook tokens and decodes them offline with a downloaded
taming-transformers VQGAN; this gives a self-contained stand-in so the
img_gen task runs end to end without downloads:

  * a 1024-entry patch codebook (the ``img_{0..1023}`` token budget)
    learned by k-means over PCA-projected image patches
  * ``encode``: image -> grid of codebook tokens; ``decode``: tokens ->
    image (codebook patch reconstruction)
  * ``tokenize_item_images`` writes ``img_id2semantic.json`` (item ->
    token list), which the img_gen prompts read

Item images are read through the port's decoders (``data/transforms.py``)
and resized as PIL's bilinear resize does, as in the JAX package;
``from_torch_vqgan`` loads a real taming VQGAN (``tools/vqgan_decoder.py``).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from unimp_tpu_torch.data.png import encode_png
from unimp_tpu_torch.data.transforms import load_image_rgb, resize_bilinear_pil

CODEBOOK_SIZE = 1024  # the img_{i} token budget


class PatchVQTokenizer:
    def __init__(self, patch: int = 16, pca_dim: int = 64, codebook_size: int = CODEBOOK_SIZE):
        self.patch = patch
        self.pca_dim = pca_dim
        self.codebook_size = codebook_size
        self.mean: Optional[np.ndarray] = None
        self.basis: Optional[np.ndarray] = None  # [P*P*3, pca_dim]
        self.codebook: Optional[np.ndarray] = None  # [K, pca_dim]

    def _patches(self, images: np.ndarray) -> np.ndarray:
        n, h, w, c = images.shape
        p = self.patch
        gh, gw = h // p, w // p
        x = images[:, : gh * p, : gw * p].reshape(n, gh, p, gw, p, c)
        x = x.transpose(0, 1, 3, 2, 4, 5).reshape(n * gh * gw, p * p * c)
        return x.astype(np.float32) / 255.0

    def fit(self, images: np.ndarray, seed: int = 0, kmeans_iters: int = 20):
        """images: uint8 [N, H, W, 3] (all the item images)."""
        x = self._patches(images)
        self.mean = x.mean(0)
        xc = x - self.mean
        # PCA by SVD on a subsample
        rng = np.random.default_rng(seed)
        sub = xc[rng.choice(len(xc), min(len(xc), 20_000), replace=False)]
        _, _, vt = np.linalg.svd(sub, full_matrices=False)
        self.basis = vt[: self.pca_dim].T  # [D, pca]
        z = xc @ self.basis
        k = min(self.codebook_size, len(z))
        centers = z[rng.choice(len(z), k, replace=False)].copy()
        for _ in range(kmeans_iters):
            assign = self._assign(z, centers)
            for j in range(k):
                pts = z[assign == j]
                if len(pts):
                    centers[j] = pts.mean(0)
        if k < self.codebook_size:
            centers = np.concatenate(
                [centers, np.zeros((self.codebook_size - k, self.pca_dim), centers.dtype)])
        self.codebook = centers
        return self

    @staticmethod
    def _assign(z: np.ndarray, centers: np.ndarray) -> np.ndarray:
        out = np.empty(len(z), np.int64)
        step = 8192
        c2 = (centers ** 2).sum(1)
        for i in range(0, len(z), step):
            chunk = z[i : i + step]
            d = c2[None, :] - 2 * chunk @ centers.T
            out[i : i + step] = d.argmin(1)
        return out

    def encode(self, images: np.ndarray) -> np.ndarray:
        """uint8 [N, H, W, 3] -> int tokens [N, gh*gw]."""
        n, h, w, _ = images.shape
        gh, gw = h // self.patch, w // self.patch
        z = (self._patches(images) - self.mean) @ self.basis
        return self._assign(z, self.codebook).reshape(n, gh * gw)

    def decode(self, tokens: np.ndarray, grid: Optional[int] = None) -> np.ndarray:
        """int tokens [N, G] -> uint8 images [N, g*p, g*p, 3]."""
        n, g = tokens.shape
        gh = grid or int(round(g ** 0.5))
        gw = g // gh
        p = self.patch
        patches = self.codebook[tokens.reshape(-1)] @ self.basis.T + self.mean
        x = patches.reshape(n, gh, gw, p, p, 3).transpose(0, 1, 3, 2, 4, 5)
        x = x.reshape(n, gh * p, gw * p, 3)
        return np.clip(x * 255.0, 0, 255).astype(np.uint8)

    def save(self, path: str):
        np.savez(path, patch=self.patch, pca_dim=self.pca_dim,
                 codebook_size=self.codebook_size, mean=self.mean,
                 basis=self.basis, codebook=self.codebook)

    @classmethod
    def load(cls, path: str) -> "PatchVQTokenizer":
        z = np.load(path)
        obj = cls(int(z["patch"]), int(z["pca_dim"]), int(z["codebook_size"]))
        obj.mean, obj.basis, obj.codebook = z["mean"], z["basis"], z["codebook"]
        return obj

    @classmethod
    def from_torch_vqgan(cls, checkpoint_path: str):
        """A real taming-transformers VQGAN checkpoint as a
        ``VQGANDecoder`` (``decode``-compatible with this class)."""
        from unimp_tpu_torch.tools.vqgan_decoder import VQGANDecoder

        return VQGANDecoder.from_torch_checkpoint(checkpoint_path)


def _item_image(data_dir: str, subset: str, item: int, size: int) -> np.ndarray:
    img = load_image_rgb(os.path.join(data_dir, subset, f"{item}.jpg"))
    if img.shape[0] != size or img.shape[1] != size:
        img = resize_bilinear_pil(img, size)
    return img


def tokenize_item_images(data_dir: str, subset: str, item_ids: List[int], *,
                         image_size: int = 224, n_tokens: int = 4, seed: int = 0) -> dict:
    """Fit a codebook on the item images and write ``img_id2semantic.json``
    (item -> its first ``n_tokens`` codebook tokens; the full grids go to
    ``img_tokens_full.json``, the codebook to ``vq_codebook.npz``)."""
    imgs = np.stack([_item_image(data_dir, subset, i, image_size) for i in item_ids])
    vq = PatchVQTokenizer().fit(imgs, seed=seed)
    tokens = vq.encode(imgs)
    mapping = {str(i): [int(t) for t in row[:n_tokens]] for i, row in zip(item_ids, tokens)}
    with open(os.path.join(data_dir, "img_id2semantic.json"), "w") as f:
        json.dump(mapping, f)
    with open(os.path.join(data_dir, "img_tokens_full.json"), "w") as f:
        json.dump({str(i): [int(t) for t in row] for i, row in zip(item_ids, tokens)}, f)
    vq.save(os.path.join(data_dir, "vq_codebook.npz"))
    return mapping


def parse_img_tokens(text: str) -> List[int]:
    """'img_789,img_591, ...' (or 'img_789 img_591') -> [789, 591, ...];
    malformed pieces skipped."""
    out = []
    for piece in text.replace(",", " ").split():
        if piece.startswith("img_"):
            tail = piece[4:]
            if tail.isdigit():
                tok = int(tail)
                if 0 <= tok < CODEBOOK_SIZE:
                    out.append(tok)
    return out


def decode_generation_dump(dump_path: str, codebook_path: str, out_dir: str,
                           grid: int = 14) -> List[str]:
    """Decode an img_gen eval dump (generated token strings) to PNGs with
    the patch codebook; each sequence padded or cut to grid*grid tokens."""
    vq = PatchVQTokenizer.load(codebook_path)
    with open(dump_path) as f:
        records = json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, rec in enumerate(records):
        toks = (parse_img_tokens(rec["generated"]) + [0] * grid * grid)[: grid * grid]
        img = vq.decode(np.asarray([toks]), grid=grid)[0]
        p = os.path.join(out_dir, f"gen_{i}.png")
        with open(p, "wb") as f:
            f.write(encode_png(img))
        paths.append(p)
    return paths
