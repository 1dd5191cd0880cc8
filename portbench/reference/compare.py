"""The numbers that decide `correct`, worked out from the reference's logits.

A served token is judged by the gap by which its reference logit lies below
the reference's best logit at that position: 0 where the program picked the
reference's greedy token, small where it picked another at a near-tie, large
where it picked a token the reference would not. The control is judged the
same way through the token it puts first.
"""
from __future__ import annotations

import torch


def served_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """ref_logits [n, vocab] f32, tokens [n]: the gap of each served token."""
    t = tokens.to(ref_logits.device, torch.long).reshape(-1, 1)
    return ref_logits.amax(dim=-1) - ref_logits.gather(1, t)[:, 0]


def control_gaps(ref_logits: torch.Tensor, ctl_logits: torch.Tensor) -> torch.Tensor:
    """The gap of the token the control puts first at each position."""
    return served_gaps(ref_logits, ctl_logits.argmax(dim=-1))
