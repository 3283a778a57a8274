"""Adam (Kingma and Ba), plain: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2)
g^2, p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps), with the
published b1 0.9, b2 0.999, eps 1e-8, in the parameters' precision."""

from __future__ import annotations

import torch


class Adam:
    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params, lr):
        self.params, self.lr, self.t = params, lr, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            mhat = m / (1.0 - self.b1 ** self.t)
            vhat = v / (1.0 - self.b2 ** self.t)
            p.sub_(self.lr * mhat / (vhat.sqrt() + self.eps))
