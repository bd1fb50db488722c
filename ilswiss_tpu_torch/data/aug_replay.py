"""Augmented batch sampling for RAD / CURL (counterpart:
ilswiss_tpu/data/aug_replay.py; `augmented_sample`).

The reference's `AugmentCPCImageEnvReplayBuffer`
(rlkit/data_management/aug_replay_buffer.py): a uniform batch of the ring,
the augmentation pipeline applied to obs and to next_obs independently
(RAD), and with `cpc` two more independent views of the raw obs,
`observations_anchor` and `observations_pos`, for CURL's contrastive loss
(aug_replay_buffer.py:61-67).

Draws, from the loop's `noise` in this order: `replay(batch_size)` for
the rows, then the draws of each augmentation in turn
(data/augmentations.py `AUG_DRAWS`) for obs, for next_obs, and with `cpc`
for the anchor and the positive view.  The JAX function derives the same
values from the five keys it splits (aug_replay.py:22-45).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ilswiss_tpu_torch.data.augmentations import AUG_DRAWS, AUG_REGISTRY
from ilswiss_tpu_torch.data.replay import ReplayState, replay_sample


def apply_augs(imgs: torch.Tensor, noise, augs: Sequence[str],
               out_size: int | None) -> torch.Tensor:
    """The augmentations `augs`, in order, each with its draws from
    `noise`; crop and translate take `out_size`."""
    for name in augs:
        draws = AUG_DRAWS[name](noise, imgs, out_size)
        fn = AUG_REGISTRY[name]
        if name in ("crop", "translate"):
            imgs = fn(imgs, out_size, *draws)
        else:
            imgs = fn(imgs, *draws)
    return imgs


def augmented_sample(state: ReplayState, noise, batch_size: int,
                     augs: Sequence[str] = ("crop",),
                     out_size: int | None = None,
                     cpc: bool = False) -> Dict[str, torch.Tensor]:
    batch = replay_sample(state, noise.replay(batch_size))
    raw_obs = batch["obs"]
    batch["obs"] = apply_augs(raw_obs, noise, augs, out_size)
    batch["next_obs"] = apply_augs(batch["next_obs"], noise, augs, out_size)
    if cpc:
        batch["observations_anchor"] = apply_augs(raw_obs, noise, augs,
                                                  out_size)
        batch["observations_pos"] = apply_augs(raw_obs, noise, augs,
                                               out_size)
    return batch
