"""Teacher-generated synthetic image classification, the paper's CNN path
(port of ``repro/data/images.py``).

Class-conditioned images around smooth class prototypes, with Gaussian
noise and a +-1-pixel roll: labels are a real function of the pixels, so a
student CNN can learn them and quantizing it degrades and recovers accuracy,
the property the SigmaQuant controller experiments need.

The JAX package draws from ``jax.random``, which has no PyTorch twin: the
port draws the same distribution from CPU ``torch.Generator``s keyed by
``(seed, step)`` and moves a batch to ``device`` afterwards, so a batch is
the same on the card and on the CPU.  Only the distribution is shared with
the JAX package, not the draws.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .pipeline import _generator


def upsample_linear(coarse: torch.Tensor, size: int) -> torch.Tensor:
    """(N, h, w, C) -> (N, size, size, C), the twin of ``jax.image.resize(...,
    method="linear")`` when upsampling: half-pixel centres, edges clamped."""
    x = F.interpolate(coarse.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=False)
    return x.permute(0, 2, 3, 1).contiguous()


@dataclasses.dataclass(frozen=True)
class ImageTask:
    n_classes: int = 20
    img_size: int = 16
    channels: int = 3
    seed: int = 0
    noise: float = 0.35

    def _prototypes(self) -> torch.Tensor:
        """Spatially smooth class prototypes (low-resolution noise, upsampled),
        so the +-1-pixel jitter keeps images correlated with their class."""
        lo = self.img_size // 4
        coarse = torch.randn((self.n_classes, lo, lo, self.channels),
                             generator=_generator(self.seed ^ 0x1A6E))
        return 2.0 * upsample_linear(coarse, self.img_size)

    def batch(self, generator: torch.Generator, batch: int, *, device=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (images (B, H, W, C) float32, labels (B,) int64)."""
        protos = self._prototypes()
        labels = torch.randint(0, self.n_classes, (batch,), generator=generator)
        base = protos[labels]
        noise = torch.randn(base.shape, generator=generator) * self.noise
        # mild spatial jitter: roll each image by -1, 0 or +1 pixels on each axis
        shifts = torch.randint(-1, 2, (batch, 2), generator=generator)
        h = torch.arange(self.img_size)
        rows = (h[None, :] - shifts[:, :1]) % self.img_size
        cols = (h[None, :] - shifts[:, 1:]) % self.img_size
        imgs = (base + noise)[torch.arange(batch)[:, None, None], rows[:, :, None],
                              cols[:, None, :]]
        return imgs.to(device=device, dtype=torch.float32), labels.to(device)

    def batch_at(self, step: int, batch: int, *, device=None):
        return self.batch(_generator(self.seed, step), batch, device=device)

    def eval_set(self, n: int = 512, *, device=None):
        """Fixed held-out evaluation set (the step 2**31 - 1 namespace)."""
        return self.batch(_generator(self.seed, 2**31 - 1), n, device=device)
