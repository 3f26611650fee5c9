"""Log-depth inclusive scan over an associative combine, in plain torch.

The counterpart of jax.lax.associative_scan that models/iir.py (the
carries between blocks of an IIR filter) and models/_lti_impl.py (the
state recurrence of lsim/dlsim) run on.  The odd/even recursion: pair
neighbours, scan the pairs, then fill the even positions from the odd
ones.  A scan of B elements is 2 log2(B) batched combines over halving
lengths, O(B) work in all; no pass is a loop over elements.

The combines of both callers are small batched matmuls; the callers run
the scan under fft.four_step._tf32_off() so that they stay float32 on
the card (ROADMAP fault class a).
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["associative_scan"]

Elems = tuple[torch.Tensor, ...]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = even.new_empty((even.shape[0] + odd.shape[0],) + tuple(even.shape[1:]))
    out[0::2] = even
    out[1::2] = odd
    return out


def associative_scan(combine: Callable[[Elems, Elems], Elems], elems: Elems) -> Elems:
    """Inclusive scan of `elems` (tensors sharing the leading length B):
    out[i] = e[0] o e[1] o ... o e[i], where combine(earlier, later)
    composes two batches of elements position by position."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    pairs = combine(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = associative_scan(combine, pairs)  # prefixes ending at 1, 3, 5, ...
    rest = tuple(e[2::2] for e in elems)
    head = odd if n % 2 else tuple(o[:-1] for o in odd)
    even = combine(head, rest)  # prefixes ending at 2, 4, ...
    even = tuple(torch.cat([e[:1], v]) for e, v in zip(elems, even))
    return tuple(_interleave(ev, od) for ev, od in zip(even, odd))
