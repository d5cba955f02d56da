"""Datasets: the port's numpy-only copy of cspn_tpu/data/datasets.py's
Bernoulli sparse sampler, procedural `SyntheticDepthDataset` and
`SyntheticStereoDataset`.

Samples are channels-last, as in the JAX package:
    {'rgbd': [H, W, 4] float32, 'depth': [H, W] float32[, 'raw_rgb']}
    {'left': [H, W, 3], 'right': [H, W, 3], 'disp': [H, W]} (stereo)
and equal to the JAX package's for the same seed and index.  The NYU/KITTI
file datasets are not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from cspn_tpu_torch.data import transforms as T


def create_sparse_depth(
    depth: np.ndarray, n_sample: int, rng: np.random.Generator, denom: str = "total"
) -> np.ndarray:
    """Bernoulli sparse sampling of a depth map.

    denom='total': p = n_sample / n_pixels (NYU, nyu_dataset_loader.py:141)
    denom='valid': p = n_sample / #(depth > 1e-4) (KITTI, kitti_dataset_loader.py:138)
    """
    if denom == "total":
        p = n_sample / depth.size
    elif denom == "valid":
        n_valid = int((depth > 1e-4).sum())
        p = n_sample / max(n_valid, 1)
    else:
        raise ValueError(denom)
    mask = (rng.random(depth.shape) < min(p, 1.0)).astype(np.float32)
    return depth * mask


class SyntheticDepthDataset:
    """Procedural RGBD fixture dataset (no files needed): smooth random depth
    surfaces + shading-derived RGB.  Deterministic per (seed, idx).  Used by
    tests and benchmarks; mirrors the real datasets' sample dict."""

    def __init__(
        self,
        length: int = 64,
        hw: tuple[int, int] = (228, 304),
        n_sample: int = 500,
        seed: int = 0,
        split: str = "train",
        return_raw_rgb: bool = False,
        style: str = "smooth",
    ):
        self.length = length
        self.hw = hw
        self.n_sample = n_sample
        self.seed = seed
        self.split = split
        self.return_raw_rgb = return_raw_rgb
        # 'smooth': Gaussian-bump depth with depth-encoding RGB (default,
        # golden-pinned by tests).  'edges': sharp-edged foreground
        # rectangles at constant depths whose RGB shows the *borders*
        # (albedo step + shading line) but whose interiors are textureless
        # and whose albedo is UNCORRELATED with depth -- absolute depth is
        # only recoverable from the sparse channel, so dense completion
        # must spread the sparse anchors within edge-bounded regions: the
        # scenario CSPN's edge-aware propagation exists for (TPAMI Fig. 4
        # analog of the stereo 'edges' fixture above).
        # 'edges_mono': same sharp-edged geometry but albedo affine in
        # depth (0.1 + 0.08*d), so depth IS recoverable from RGB alone --
        # the monocular setting (n_sample=0, BASELINE config 4).  The
        # network's coarse-to-fine decoder blurs the discontinuities; the
        # question the mono ablation asks is whether CSPN's edge-aware
        # propagation restores them (the paper's mono refinement claim).
        if style not in ("smooth", "edges", "edges_mono"):
            # a typo silently falling back to 'smooth' (whose RGB encodes
            # depth) would quietly invalidate the completion ablation
            raise ValueError(f"style must be smooth|edges|edges_mono: {style!r}")
        self.style = style

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        h, w = self.hw
        rng = np.random.default_rng((self.seed, idx))
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        depth = np.full((h, w), 2.0, np.float32)
        for _ in range(6):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            sy, sx = rng.uniform(h / 8, h / 2), rng.uniform(w / 8, w / 2)
            amp = rng.uniform(-1.0, 1.0)
            depth += amp * np.exp(
                -(((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2)
            ).astype(np.float32)
        depth = np.clip(depth, 0.5, 10.0)
        if self.style == "edges_mono":
            for _ in range(4):
                y0 = int(rng.uniform(0, h * 0.7))
                x0 = int(rng.uniform(0, w * 0.7))
                y1 = y0 + int(rng.uniform(h * 0.15, h * 0.4))
                x1 = x0 + int(rng.uniform(w * 0.15, w * 0.4))
                depth[y0:y1, x0:x1] = rng.uniform(0.7, 9.5)
            alb = (0.1 + 0.08 * depth).astype(np.float32)
            gy, gx = np.gradient(depth)
            shade = 1.0 / (1.0 + np.abs(gy) + np.abs(gx))
            raw_rgb = np.stack(
                [alb * shade, alb, shade.astype(np.float32)], axis=-1
            ).astype(np.float32)
        elif self.style == "edges":
            # low-frequency background albedo (independent of depth)
            alb = np.full((h, w), 0.5, np.float32)
            for _ in range(4):
                cy, cx = rng.uniform(0, h), rng.uniform(0, w)
                sy, sx = rng.uniform(h / 6, h / 2), rng.uniform(w / 6, w / 2)
                alb += rng.uniform(-0.25, 0.25) * np.exp(
                    -(((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2)
                ).astype(np.float32)
            # sharp-edged objects: constant depth, flat albedo, both drawn
            # independently -- the RGB edge marks WHERE depth jumps but
            # says nothing about the jump's value
            for _ in range(4):
                y0 = int(rng.uniform(0, h * 0.7))
                x0 = int(rng.uniform(0, w * 0.7))
                y1 = y0 + int(rng.uniform(h * 0.15, h * 0.4))
                x1 = x0 + int(rng.uniform(w * 0.15, w * 0.4))
                depth[y0:y1, x0:x1] = rng.uniform(0.7, 9.5)
                alb[y0:y1, x0:x1] = rng.uniform(0.15, 0.9)
            alb = np.clip(alb, 0.05, 1.0)
            gy, gx = np.gradient(depth)
            shade = 1.0 / (1.0 + np.abs(gy) + np.abs(gx))
            raw_rgb = np.stack(
                [alb * shade, alb, shade.astype(np.float32)], axis=-1
            ).astype(np.float32)
        else:
            gy, gx = np.gradient(depth)
            shade = 1.0 / (1.0 + np.abs(gy) + np.abs(gx))
            raw_rgb = np.stack(
                [shade, depth / 10.0, 1.0 - depth / 10.0], axis=-1
            ).astype(np.float32)
        rgb = T.Normalize()(raw_rgb)
        sparse = create_sparse_depth(depth, self.n_sample, rng, "total")
        rgbd = np.concatenate([rgb, sparse[..., None]], axis=-1).astype(np.float32)
        sample = {"rgbd": rgbd, "depth": depth}
        if self.return_raw_rgb:
            sample["raw_rgb"] = raw_rgb
        return sample


def batches(dataset, batch_size: int, max_batches: int | None = None) -> Iterator[dict]:
    """In-order batches of `dataset` as stacked arrays (the last one may be
    short), at most `max_batches` of them."""
    n_batches = -(-len(dataset) // batch_size)
    if max_batches is not None:
        n_batches = min(n_batches, max_batches)
    for b in range(n_batches):
        items = [dataset[i] for i in range(b * batch_size, min((b + 1) * batch_size, len(dataset)))]
        yield {k: np.stack([it[k] for it in items]) for k in items[0]}


class SyntheticStereoDataset:
    """Procedural stereo fixture: left/right views of a random smooth
    disparity field (right = left warped by disparity along W), used by the
    stereo trainer's tests and smoke runs.  Samples:
        {'left': [H,W,3], 'right': [H,W,3], 'disp': [H,W]}
    style 'smooth': Gaussian-bump disparity; 'edges': adds sharp-edged,
    nearly textureless constant-disparity rectangles (the structure CSPN's
    edge-aware refinement exploits).
    """

    def __init__(
        self,
        length: int = 32,
        hw: tuple[int, int] = (64, 96),
        max_disp: int = 16,
        seed: int = 0,
        style: str = "smooth",
    ):
        if style not in ("smooth", "edges"):
            raise ValueError(f"style must be smooth|edges: {style!r}")
        self.length = length
        self.hw = hw
        self.max_disp = max_disp
        self.seed = seed
        self.style = style

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        h, w = self.hw
        rng = np.random.default_rng((self.seed, idx))
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        disp = np.full((h, w), self.max_disp / 4.0, np.float32)
        for _ in range(4):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            sy, sx = rng.uniform(h / 6, h / 2), rng.uniform(w / 6, w / 2)
            amp = rng.uniform(0, self.max_disp / 3.0)
            disp += amp * np.exp(-(((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2)).astype(np.float32)
        disp = np.clip(disp, 1.0, self.max_disp - 1.0)
        left = rng.random((h, w, 3)).astype(np.float32)
        if self.style == "edges":
            for _ in range(3):
                y0 = int(rng.uniform(0, h * 0.7))
                x0 = int(rng.uniform(0, w * 0.7))
                y1 = y0 + int(rng.uniform(h * 0.15, h * 0.4))
                x1 = x0 + int(rng.uniform(w * 0.15, w * 0.4))
                d_obj = rng.uniform(self.max_disp * 0.5, self.max_disp - 1.0)
                disp[y0:y1, x0:x1] = d_obj
                flat = rng.uniform(0.2, 0.8)
                left[y0:y1, x0:x1] = flat + 0.08 * (left[y0:y1, x0:x1] - left[y0:y1, x0:x1].mean())
            disp = np.clip(disp, 1.0, self.max_disp - 1.0)
            left = np.clip(left, 0.0, 1.0)
        # smooth the texture a bit so matching is learnable
        left = 0.25 * (left + np.roll(left, 1, 0) + np.roll(left, 1, 1) + np.roll(left, -1, 1))
        # left pixel x appears at x - d in the right view
        src = np.clip(xx + disp, 0, w - 1).astype(np.int64)
        right = left[np.arange(h)[:, None], src]
        return {
            "left": left.astype(np.float32),
            "right": right.astype(np.float32),
            "disp": disp,
        }
