"""What every program entry gives the harness, and the program's side of it.

An entry module (``h100_bench/entries/<entry>.py``) defines ``Cell``, a
subclass of ``Cell`` here:

- ``inputs()``: the benchmark's inputs from the seed (data and weights);
- ``build()``: the program under test, fed those inputs and warmed on every
  shape the window uses (set-up), setting ``warm_from`` (perf_counter) where
  the warm-up begins;
- ``unit()``: one unit of the window's work (a pass, an epoch), returning
  its counts: the work its end-to-end rate counts, and ``model_flops``;
- ``outputs()`` / ``release()``: what the program produced, and freeing
  the program's state;
- ``reference(mm)``: the plain reference's outputs on the same inputs,
  its products through ``mm`` (the f32 reference, or the TF32 control);
- ``compare(got, want)``: the numbers compared, {name: value};
- ``failed(got)``: how many units produced a malformed answer;
- ``min_units``: the fewest units a window runs, past its deadline if need
  be (the training check reads the state after its first units).
"""

from __future__ import annotations

import math
from typing import Dict

import torch


class Cell:
    min_units = 1

    def __init__(self, spec: dict, seed: int, device):
        self.spec = spec
        self.p = dict(spec["config"]["program"])
        self.traffic = spec["traffic"]
        self.seed = seed
        self.device = torch.device(device)

    def inputs(self) -> None:
        raise NotImplementedError

    def build(self) -> None:
        raise NotImplementedError

    def unit(self) -> Dict[str, float]:
        raise NotImplementedError

    def outputs(self):
        raise NotImplementedError

    def release(self) -> None:
        raise NotImplementedError

    def reference(self, mm):
        raise NotImplementedError

    def compare(self, got, want) -> Dict[str, float]:
        raise NotImplementedError

    def failed(self, got) -> int:
        return 0


def program_config(config: dict):
    """The program's configuration of a config file: its preset with its
    ``overrides``; every number of ``program`` is then held equal to the
    program's value, so the file states the configuration as it is run."""
    from lstc_vad_tpu_torch.config import preset

    cfg = preset(config["preset"])
    if config.get("overrides"):
        from lstc_vad_tpu_torch.config import replace

        cfg = replace(cfg, **config["overrides"])
    wrong = {}
    for key, want in config["program"].items():
        got = cfg
        for part in key.split("."):
            got = getattr(got, part)
        if got != want:
            wrong[key] = (got, want)
    if wrong:
        raise ValueError(f"the program's configuration differs from "
                         f"{config['preset']}'s file: {wrong}")
    return cfg


def load_weights(encoder, head, weights) -> None:
    """The benchmark's weights into the program's modules; only buffers
    the program derives itself (the relative position index) may be left
    out."""
    for module, part in ((encoder, "encoder"), (head, "head")):
        missing, unexpected = module.load_state_dict(weights[part],
                                                     strict=False)
        bad = [k for k in missing if not k.endswith("relative_position_index")]
        if bad or unexpected:
            raise KeyError(f"{part}: weights missing {bad}, unexpected "
                           f"{unexpected}")


def worst(values) -> float:
    """The largest value, inf for none or for a NaN."""
    values = list(values)
    if not values or any(math.isnan(v) for v in values):
        return math.inf
    return max(values)
