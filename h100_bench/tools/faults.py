"""Faults planted in the program's timed path, to show that the output
check catches them: each is a context manager that patches one function of
the program while it is active.

- ``half_batch``: half of each batch left out, the mean taken over the
  rest (evaluation: a scorer call scores the first half of its rows and
  gives the rest their mean; training: the step's cross-entropy over the
  first half of its rows);
- ``answer_altered``: one answer altered where it is produced (the first
  middle score of each scorer call raised by 0.25);
- ``state_unchanged``: a train step that returns its state unchanged (the
  gradients taken, no update applied).
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch


@contextlib.contextmanager
def half_batch(entry: str):
    if entry == "ltn_train":
        from lstc_vad_tpu_torch.train import steps

        orig = steps.soft_cross_entropy_on_probs

        def half(probs, soft):
            n = max(probs.shape[0] // 2, 1)
            return orig(probs[:n], soft[:n])

        with mock.patch.object(steps, "soft_cross_entropy_on_probs", half):
            yield
        return
    from lstc_vad_tpu_torch.evaluation.scoring import VideoScorer

    orig = VideoScorer._forward

    def forward(self, x):
        n = x.shape[0]
        s = orig(self, x[:max(n // 2, 1)])
        return torch.cat([s, s.mean().expand(n - s.shape[0])])

    with mock.patch.object(VideoScorer, "_forward", forward):
        yield


@contextlib.contextmanager
def answer_altered(entry: str):
    from lstc_vad_tpu_torch.evaluation.scoring import VideoScorer

    orig = VideoScorer._forward

    def forward(self, x):
        s = orig(self, x).clone()
        s[s.shape[0] // 2] += 0.25
        return s

    with mock.patch.object(VideoScorer, "_forward", forward):
        yield


@contextlib.contextmanager
def state_unchanged(entry: str):
    from lstc_vad_tpu_torch.train.steps import TrainStep

    def step(self, state, *batch):
        metrics = self.grads(state, *batch)
        state.step += 1
        return state, metrics

    with mock.patch.object(TrainStep, "__call__", step):
        yield


# the faults each entry can have
FAULTS = {"ltn_eval": (half_batch, answer_altered),
          "ltn_train": (half_batch, state_unchanged)}
