"""Faults planted under the timed path, for the readings that bound the
limits from above and for the test that a broken path reads as not correct.

Each fault wraps a kind's ``Program`` class; ``FAULTS[kind][name]`` gives
the wrapper. None of them is used by a benchmark run.
"""

from __future__ import annotations

import torch


def half_batch_serve(base):
    class HalfBatch(base):
        """The forward runs the first half of the frames; the second half's
        maps are left as zeros."""

        def forward(self, frames):
            half = super().forward(frames[: len(frames) // 2])
            return tuple(torch.cat([m, torch.zeros_like(m)]) for m in half)

    return HalfBatch


def altered_answer_serve(base):
    class Altered(base):
        """One decoded keypoint of the first frame moved by a pixel where the
        decode produces it."""

        def decode(self, maps):
            out = list(super().decode(maps))
            kp = out[3].clone()
            kp[0, 0, 0, 0, 0] += 1.0
            out[3] = kp
            return tuple(out)

    return Altered


def half_batch_train(base):
    class HalfBatch(base):
        """Each step sees the first half of the batch, the loss the mean over it."""

        def step(self, batch):
            n = len(batch["images"]) // 2
            return super().step({k: v[:n] for k, v in batch.items()})

    return HalfBatch


def unchanged_state_train(base):
    class Unchanged(base):
        """Each step returns the state unchanged: the parameters and the
        optimizer's moments are put back after the step."""

        def step(self, batch):
            params = [p.detach().clone() for p in self.params()]
            loss = super().step(batch)
            with torch.no_grad():
                for p, saved in zip(self.params(), params):
                    p.copy_(saved)
            moments = getattr(getattr(self, "state", None), "opt_state", None)
            if moments is not None:
                for t in moments.mu + (moments.nu or []):
                    t.zero_()
                moments.count = 0
            return loss

    return Unchanged


FAULTS = {
    "keypoint_serve": {"half_batch": half_batch_serve, "altered_answer": altered_answer_serve},
    "detector_train": {"half_batch": half_batch_train, "unchanged_state": unchanged_state_train},
}
