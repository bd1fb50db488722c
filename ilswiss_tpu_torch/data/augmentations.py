"""Image augmentations for RAD / CURL on NHWC batches (counterpart:
ilswiss_tpu/data/augmentations.py; `random_crop`, `center_crop`,
`random_translate`, `random_cutout`, `grayscale`, `color_jitter`,
`no_aug`, `AUG_REGISTRY`).

Every random choice comes in as a tensor, the values the JAX function
draws from its key:
  - crop / translate: `offsets` int [B, 2], (x, y) per image, each in
    [0, H - out] (crop) or [0, out - H] (translate);
  - cutout: `boxes` int [B, 3], (size in [min_cut, max_cut), x in
    [0, W - max_cut), y in [0, H - max_cut));
  - grayscale: `u` [B] uniforms, the image turns gray where u < p;
  - color jitter: `u` [6, B] uniforms, rows (order, take, brightness,
    contrast, saturation, hue); the order coin is row 0's first entry.
`AUG_DRAWS[name](noise, imgs, out_size)` makes those draws from the
loop's `Noise` (`augment_index`, `augment_uniform`), and
`AUG_REGISTRY[name](imgs, *draws, ...)` applies them, so data/aug_replay.py
draws and applies one augmentation after the other.  The pixel ops index
with gathers, so a batch is one launch per op on the GPU.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def _window(imgs: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
            ) -> torch.Tensor:
    """imgs[b, ys[b, i], xs[b, j]] for every b, i, j: [B, len(ys), len(xs),
    C]."""
    b = torch.arange(imgs.shape[0], device=imgs.device)[:, None, None]
    return imgs[b, ys[:, :, None], xs[:, None, :]]


def random_crop(imgs: torch.Tensor, out_size: int, offsets: torch.Tensor
                ) -> torch.Tensor:
    """[B, H, W, C] -> [B, out, out, C], the window at (x, y) = offsets[b]
    (JAX `random_crop`, :18; reference data_augmentation.py:43)."""
    r = torch.arange(out_size, device=imgs.device)
    offsets = offsets.to(torch.int64)
    return _window(imgs, offsets[:, 1:2] + r, offsets[:, 0:1] + r)


def center_crop(imgs: torch.Tensor, out_size: int) -> torch.Tensor:
    """The deterministic evaluation crop (JAX `center_crop`, :36); an
    `out_size` above the source pastes the image centered on a zero
    canvas (RAD's center translate)."""
    b, h, w, c = imgs.shape
    if out_size <= h:
        off = (h - out_size) // 2
        return imgs[:, off:off + out_size, off:off + out_size, :]
    off = (out_size - h) // 2
    canvas = torch.zeros((b, out_size, out_size, c), dtype=imgs.dtype,
                         device=imgs.device)
    canvas[:, off:off + h, off:off + w, :] = imgs
    return canvas


def random_translate(imgs: torch.Tensor, out_size: int,
                     offsets: torch.Tensor) -> torch.Tensor:
    """Each [H, W] image placed at (x, y) = offsets[b] on a zero [out, out]
    canvas (JAX `random_translate`, :53)."""
    b, h, w, c = imgs.shape
    r = torch.arange(out_size, device=imgs.device)
    offsets = offsets.to(torch.int64)
    ys = r - offsets[:, 1:2]                       # source row of each row
    xs = r - offsets[:, 0:1]
    inside = (((ys >= 0) & (ys < h))[:, :, None]
              & ((xs >= 0) & (xs < w))[:, None, :])
    out = _window(imgs, ys.clamp(0, h - 1), xs.clamp(0, w - 1))
    return torch.where(inside[..., None], out, torch.zeros_like(out))


def random_cutout(imgs: torch.Tensor, boxes: torch.Tensor,
                  min_cut: int = 10, max_cut: int = 30) -> torch.Tensor:
    """A square of side boxes[b, 0] at (x, y) = boxes[b, 1:] zeroed in each
    image (JAX `random_cutout`, :71)."""
    b, h, w, c = imgs.shape
    size, ox, oy = (boxes[:, i, None, None] for i in range(3))
    yy = torch.arange(h, device=imgs.device)[None, :, None]
    xx = torch.arange(w, device=imgs.device)[None, None, :]
    mask = (yy >= oy) & (yy < oy + size) & (xx >= ox) & (xx < ox + size)
    return torch.where(mask[..., None], torch.zeros_like(imgs), imgs)


def grayscale(imgs: torch.Tensor, u: torch.Tensor, p: float = 0.3
              ) -> torch.Tensor:
    """The channel mean in every channel of the images where u < p (JAX
    `grayscale`, :91)."""
    gray = torch.mean(imgs.to(torch.float32), dim=-1, keepdim=True)
    gray = gray.expand(imgs.shape).to(imgs.dtype)
    return torch.where((u < p)[:, None, None, None], gray, imgs)


def no_aug(imgs: torch.Tensor) -> torch.Tensor:
    return imgs


# --- color jitter (JAX :114-190; the reference ColorJitterLayer) ----------
def _rgb2hsv(rgb: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """[..., 3] RGB in [0, 1] -> HSV in [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    cmax = torch.amax(rgb, -1)
    cmin = torch.amin(rgb, -1)
    delta = cmax - cmin
    hr = ((g - b) / (delta + eps)) % 6.0
    hg = (b - r) / (delta + eps) + 2.0
    hb = (r - g) / (delta + eps) + 4.0
    hue = torch.where(cmax == r, hr, torch.where(cmax == g, hg, hb))
    zero = torch.zeros_like(hue)
    hue = torch.where(cmax == 0.0, zero, hue) / 6.0
    sat = torch.where(cmax == 0.0, zero, delta / (cmax + eps))
    return torch.stack([hue, sat, cmax], -1)


def _hsv2rgb(hsv: torch.Tensor) -> torch.Tensor:
    """[..., 3] HSV in [0, 1] -> RGB in [0, 1]."""
    hsv = torch.clamp(hsv, 0.0, 1.0)
    h = hsv[..., 0] * 6.0
    c = hsv[..., 2] * hsv[..., 1]
    x = c * (1.0 - torch.abs(h % 2.0 - 1.0))
    m = hsv[..., 2] - c
    i = torch.clamp(torch.floor(h).to(torch.int32), 0, 5)
    z = torch.zeros_like(c)

    def sel(vals):
        # jnp.select: the first sector that matches
        out = z
        for k in reversed(range(6)):
            out = torch.where(i == k, vals[k], out)
        return out

    r = sel([c, x, z, z, x, c])
    g = sel([x, c, c, x, z, z])
    b = sel([z, z, x, c, c, x])
    return torch.clamp(torch.stack([r + m, g + m, b + m], -1), 0.0, 1.0)


def color_jitter(imgs: torch.Tensor, u: torch.Tensor,
                 brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, hue: float = 0.5,
                 p: float = 1.0) -> torch.Tensor:
    """RAD color jitter on stacked frames [B, H, W, 3k] in [0, 1] (JAX
    `color_jitter`, :145): one factor per image shared by its k frames,
    drawn as lo + u * (hi - lo) from the rows of `u` [6, B]; the HSV chain
    and the contrast op in the order row 0's first coin picks; an image
    jittered where its `take` uniform is below p.  uint8 frames (the DMC
    ring's) are jittered as x / 255 and come back as uint8, rounded; the
    JAX function takes their 0..255 values for [0, 1] ones (its HSV
    chain wraps uint8 differences and clips the value channel to 1), a
    reference fault that the port does not copy (ROADMAP.md section 3)."""
    if imgs.dtype == torch.uint8:
        out = color_jitter(imgs.to(torch.float32) / 255.0, u, brightness,
                           contrast, saturation, hue, p)
        return torch.round(out * 255.0).to(torch.uint8)
    b, h, w, C = imgs.shape
    k = C // 3
    x = imgs.reshape(b, h, w, k, 3)

    def factor(row, lo, hi):
        return (u[row] * (hi - lo) + lo)[:, None, None, None]

    f_b = factor(2, max(0.0, 1 - brightness), 1 + brightness)
    f_c = factor(3, max(0.0, 1 - contrast), 1 + contrast)
    f_s = factor(4, max(0.0, 1 - saturation), 1 + saturation)
    f_h = factor(5, -hue, hue)

    def hsv_chain(x):
        hsv = _rgb2hsv(x)
        v = torch.clamp(hsv[..., 2] * f_b, 0.0, 1.0)
        hch = (hsv[..., 0] + f_h * 255.0 / 360.0) % 1.0
        s = torch.clamp(hsv[..., 1] * f_s, 0.0, 1.0)
        return _hsv2rgb(torch.stack([hch, s, v], -1))

    def contrast_op(x):
        means = torch.mean(x, dim=(1, 2), keepdim=True)
        return torch.clamp((x - means) * f_c[..., None] + means, 0.0, 1.0)

    a = contrast_op(hsv_chain(x))
    bpath = hsv_chain(contrast_op(x))
    out = torch.where(u[0, 0] >= 0.5, bpath, a)
    take = (u[1] < p)[:, None, None, None, None]
    return torch.where(take, out, x).reshape(b, h, w, C)


AUG_REGISTRY: Dict[str, Callable] = {
    "crop": random_crop,
    "translate": random_translate,
    "cutout": random_cutout,
    "grayscale": grayscale,
    "color_jitter": color_jitter,
    "no_aug": no_aug,
}


def _offsets(noise, n: int, high: int) -> torch.Tensor:
    return noise.augment_index((n, 2), 0, high + 1)


def _boxes(noise, n: int, h: int, w: int, min_cut: int = 10,
           max_cut: int = 30) -> torch.Tensor:
    return torch.stack([noise.augment_index((n,), min_cut, max_cut),
                        noise.augment_index((n,), 0, w - max_cut),
                        noise.augment_index((n,), 0, h - max_cut)], dim=1)


# name -> draws(noise, imgs, out_size): the tensors the augmentation takes
AUG_DRAWS: Dict[str, Callable] = {
    "crop": lambda noise, imgs, out: (
        _offsets(noise, imgs.shape[0], imgs.shape[1] - out),),
    "translate": lambda noise, imgs, out: (
        _offsets(noise, imgs.shape[0], out - imgs.shape[1]),),
    "cutout": lambda noise, imgs, out: (
        _boxes(noise, imgs.shape[0], imgs.shape[1], imgs.shape[2]),),
    "grayscale": lambda noise, imgs, out: (
        noise.augment_uniform((imgs.shape[0],)),),
    "color_jitter": lambda noise, imgs, out: (
        noise.augment_uniform((6, imgs.shape[0])),),
    "no_aug": lambda noise, imgs, out: (),
}
