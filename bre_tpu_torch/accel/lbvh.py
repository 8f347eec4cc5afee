"""Morton codes (counterpart of ``bre_tpu/accel/lbvh.py:50-68``).

Only ``morton3`` is ported: the packed beam sort key.  The LBVH itself
(beam-LBVH gather, tri-BVH) is ROADMAP Queue 1 "breadth".  Codes are uint32
values held in int64; each multiply is masked to 32 bits, so the results are
bit-equal to the reference's uint32 arithmetic.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd position."""
    v = (v * 0x00010001 & _M32) & 0xFF0000FF
    v = (v * 0x00000101 & _M32) & 0x0F00F00F
    v = (v * 0x00000011 & _M32) & 0xC30C30C3
    v = (v * 0x00000005 & _M32) & 0x49249249
    return v


def morton3(p01: torch.Tensor) -> torch.Tensor:
    """(N,3) float in [0,1] -> 30-bit Morton codes (int64)."""
    q = torch.clamp(p01 * 1024.0, 0.0, 1023.0).to(torch.int64)
    return ((_expand_bits(q[..., 2]) << 2) | (_expand_bits(q[..., 1]) << 1)
            | _expand_bits(q[..., 0]))
