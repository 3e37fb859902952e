"""The PGD sign step in its plain form: ``x + gamma * sign(g)``, then the
L-inf projection with ``clip``, in ``x``'s dtype (``gamma`` and ``eps``
rounded to it first, as the port's update and its JAX original do)."""
from __future__ import annotations

from .project import linfball_proj, weak_scalar


def pgd_update(x, g, center=None, *, gamma, eps=None, clip=False):
    out = x + weak_scalar(gamma, x.dtype) * g.sign()
    if clip:
        out = linfball_proj(center, eps, out)
    return out
