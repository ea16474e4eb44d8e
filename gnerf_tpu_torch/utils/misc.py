"""Training helpers: EMA tracking, gradient scrubbing, the infinite sampler.

Port of `gnerf_tpu/utils/misc.py` (`ema_update`, `nan_to_num`,
`InfiniteSampler`). The JAX versions map over parameter trees; these take
dicts or sequences of tensors and update them in place.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Mapping

import numpy as np
import torch


@torch.no_grad()
def nan_to_num(tensors: Iterable[torch.Tensor], nan=0.0, posinf=1e5, neginf=-1e5) -> None:
    """Replace NaN / +inf / -inf in place (gradient scrubbing)."""
    for x in tensors:
        if x is not None:
            torch.nan_to_num_(x, nan=nan, posinf=posinf, neginf=neginf)


@torch.no_grad()
def ema_update(ema: Mapping[str, torch.Tensor], new: Mapping[str, torch.Tensor],
               beta: float) -> None:
    """ema = ema * beta + new * (1 - beta), leafwise and in place (G_ema
    tracking over a module's `state_dict()`: parameters and buffers, every
    leaf of the JAX parameter tree)."""
    if ema.keys() != new.keys():
        raise KeyError("EMA and source trees differ: "
                       f"{sorted(set(ema) ^ set(new))[:8]}")
    for k, e in ema.items():
        e.copy_(e * beta + new[k].to(e.dtype) * (1 - beta))


class InfiniteSampler:
    """Endless shuffled index stream, sharded across hosts: every
    num_replicas-th index of an endlessly reshuffled order, with a
    window-swap perturbation (numpy only, the JAX package's sampler)."""

    def __init__(self, dataset_size: int, rank: int = 0, num_replicas: int = 1,
                 shuffle: bool = True, seed: int = 0, window_size: float = 0.5):
        assert dataset_size > 0
        self.dataset_size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.dataset_size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))
        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield int(order[i])
            if window >= 2:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1
