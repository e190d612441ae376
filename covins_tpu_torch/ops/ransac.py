"""Minimal-set sampling for the fixed-iteration RANSAC harnesses.

Counterpart of `covins_tpu/ops/ransac.py`.  All minimal sets are drawn at
once, without replacement within each set, by the Gumbel top-k trick: one
(n_sets, N) Gumbel draw, invalid entries set to -inf, the top k of each
row.  The reference draws the noise with `jax.random` inside its jitted
program; the port draws the same distribution on the host from an
explicit CPU `torch.Generator` (:func:`gumbel_noise`), so a run on the card
and a run on the CPU draw the same sets, and applies the mask and the
top-k on the tensor's device (:func:`sample_minimal_sets`), with no host
sync on the device-side mask.
"""

from __future__ import annotations

import torch

_TINY = torch.finfo(torch.float64).tiny


def gumbel_noise(generator: torch.Generator, n_sets: int, n: int,
                 device=None) -> torch.Tensor:
    """(n_sets, n) float64 standard Gumbel noise from a CPU generator, as
    `jax.random.gumbel` makes it: -log(-log(U)), U uniform in [tiny, 1)."""
    g = torch.rand((n_sets, n), generator=generator, dtype=torch.float64)
    g.clamp_(min=_TINY).log_().neg_().log_().neg_()  # in place: no temporaries
    return g.to(device) if device is not None else g


def sample_minimal_sets(noise: torch.Tensor, mask: torch.Tensor,
                        set_size: int) -> torch.Tensor:
    """(..., n_sets, set_size) int64 index sets of distinct valid indices:
    the top ``set_size`` of each (..., n_sets, N) noise row after masking
    with the (..., N) ``mask`` (largest first, ties to the lowest index, as
    `jax.lax.top_k`; a stable sort, where ``torch.topk`` leaves the order
    of ties open)."""
    g = torch.where(mask[..., None, :], noise, -torch.inf)
    return torch.sort(g, dim=-1, descending=True, stable=True).indices[..., :set_size]


def best_hypothesis(counts: torch.Tensor, valid=None) -> torch.Tensor:
    """Index of the highest-count valid hypothesis (the first on ties)."""
    if valid is not None:
        counts = torch.where(valid, counts, -1)
    return torch.argmax(counts)
