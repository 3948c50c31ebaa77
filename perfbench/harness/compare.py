"""The numbers that decide `correct`, each a gap between what the program
produced and what the reference worked out again."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable

import torch

# A leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone (a bias under a softmax, for one) and is left out.
STILL_LEAF = 1e-3


def rel_gap(program: float, reference: float) -> float:
    """|program - reference| / |reference| (inf where they differ and the
    reference is 0; a non-finite program value is inf)."""
    if not math.isfinite(program):
        return math.inf
    if reference == 0.0:
        return 0.0 if program == 0.0 else math.inf
    return abs(program - reference) / abs(reference)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def moving_leaves(ref_grad_norms: Dict[str, float]) -> set:
    """The leaves whose reference gradient is at least STILL_LEAF of the
    median leaf's."""
    median = statistics.median(ref_grad_norms.values())
    return {k for k, v in ref_grad_norms.items() if v >= STILL_LEAF * median}


def worst_leaf_gap(program: Dict[str, float], reference: Dict[str, float], leaves: Iterable[str]) -> float:
    """The largest |program norm - reference norm| / max(reference norm,
    median reference norm) over `leaves`."""
    leaves = list(leaves)
    median = statistics.median(reference[k] for k in leaves)
    return max(math.inf if not math.isfinite(program[k]) else abs(program[k] - reference[k]) / max(reference[k], median)
               for k in leaves)


def training_gaps(program, reference, first_update: bool = False) -> Dict[str, float]:
    """The gaps of two records of a training cell's first iterations
    (reference/ppo_ref.Record): each iteration's mean loss (the largest
    relative gap), Adam's first moment of every leaf after iteration 1
    ("grad_gap") or, with `first_update`, after the first update
    ("first_grad_gap"), and every leaf's change over the iterations (by the
    worst leaf, over the leaves the reference moves)."""
    loss_gap = max(rel_gap(p, r) for p, r in zip(program.losses, reference.losses))
    name, program_mu, ref_mu = (("first_grad_gap", program.mu_first, reference.mu_first) if first_update
                                else ("grad_gap", program.mu1, reference.mu1))
    ref_mu = leaf_norms(ref_mu)
    keep = moving_leaves(ref_mu)
    grad_gap = worst_leaf_gap(leaf_norms(program_mu), ref_mu, keep)
    change = leaf_norms({k: program.params_end[k] - program.params0[k] for k in program.params0})
    ref_change = leaf_norms({k: reference.params_end[k] - reference.params0[k] for k in reference.params0})
    return {"loss_gap": loss_gap, name: grad_gap, "change_gap": worst_leaf_gap(change, ref_change, keep)}


def clipped_normal_second_moment(mean: torch.Tensor, std: torch.Tensor,
                                 low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """E[(clip(mean + std * n, low, high) - mean)^2] for a standard normal n,
    elementwise."""
    a = (low - mean) / std
    b = (high - mean) / std
    cdf_a, cdf_b = torch.special.ndtr(a), torch.special.ndtr(b)
    pdf_a = torch.exp(-0.5 * a * a) / math.sqrt(2 * math.pi)
    pdf_b = torch.exp(-0.5 * b * b) / math.sqrt(2 * math.pi)
    inner = (cdf_b - cdf_a) + a * pdf_a - b * pdf_b
    return std * std * (a * a * cdf_a + b * b * (1.0 - cdf_b) + inner)


class SampleMoment:
    """The spread of sampled actions about the reference's mean, against the
    spread a clipped Gaussian of the reference's std gives: sum of squared
    residuals over its expectation. 1 for a sound sampler."""

    def __init__(self) -> None:
        self.seen = 0.0
        self.expected = 0.0

    def add(self, actions, mean, std, low, high) -> None:
        a, m = actions.double(), mean.double()
        s = std.double().expand_as(m)
        self.seen += float(((a - m) ** 2).sum())
        self.expected += float(clipped_normal_second_moment(m, s, low.double(), high.double()).sum())

    def gap(self) -> float:
        return abs(self.seen / self.expected - 1.0) if self.expected > 0 else math.inf
