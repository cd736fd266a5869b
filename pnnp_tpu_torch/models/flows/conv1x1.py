"""Glow invertible 1x1 convolution, LU-parameterized (counterpart of
``pnnp_tpu/models/flows/conv1x1.py``; reference
archs/flow_layers/conv2d1x1.py:19-92).

``W = P @ L @ U`` with a fixed permutation ``P`` and signs ``sign_s``,
learned strictly-lower ``l``, strictly-upper ``u`` and ``log|s|``. The
log-det is ``sum(log|s|) * H * W``, read off the parameterization; the
inverse recomposes ``W`` and inverts it in float32. The parameters keep the
JAX names (``lu.{p, sign_s, l, log_s, u}``), so checkpoints move across;
``p`` and ``sign_s`` take no gradient (``stop_gradient`` in JAX).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pnnp_tpu_torch.models.flows.base import Bijector


class InvertibleConv1x1(Bijector):
    def __init__(self, num_channels: int = 4, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = self.num_channels = num_channels
        # the JAX init law: QR of a normal draw, then LU (the draws differ)
        w = torch.linalg.qr(torch.randn((c, c), generator=generator))[0]
        p, l, u = torch.linalg.lu(w)
        s = torch.diagonal(u)
        self.lu = nn.ParameterDict({
            "p": p, "sign_s": torch.sign(s), "l": torch.tril(l, -1),
            "log_s": torch.log(torch.abs(s)), "u": torch.triu(u, 1)})

    def weight(self) -> torch.Tensor:
        """The recomposed ``[c_out, c_in]`` matrix ``P @ L @ U``."""
        lu, c = self.lu, self.num_channels
        eye = torch.eye(c, device=lu["l"].device)
        l_mask = torch.tril(torch.ones_like(eye), -1)
        l = lu["l"] * l_mask + eye
        u = lu["u"] * l_mask.T + torch.diag(lu["sign_s"].detach() * torch.exp(lu["log_s"]))
        return lu["p"].detach() @ l @ u

    def forward_ldj(self, x, clean=None, iso=None, train: bool = False):
        z = F.conv2d(x, self.weight()[:, :, None, None])
        ldj = torch.sum(self.lu["log_s"]) * x.shape[-2] * x.shape[-1]
        return z, torch.broadcast_to(ldj, (x.shape[0],))

    def inverse(self, z, clean=None, iso=None):
        return F.conv2d(z, torch.linalg.inv(self.weight())[:, :, None, None])
