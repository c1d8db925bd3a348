"""AOT inference export: ``torch.export`` programs of the eval scorer —
PyTorch counterpart of lstc_vad_tpu/export.py.

The reference deploys by shipping Python model code + torch checkpoints and
re-building modules at load time (Test/evaluation_shanghaitech_ubnormal.py:
35-62).  Here the eval-path scorer — encoder + head, the exact math of
``evaluation/scoring.py::VideoScorer`` — is exported once per token length
and saved beside its weights as one directory artifact:

    artifact/
      program_L{n}.pt2   torch.export program, one per token length
      params.pt          the weights, once (a state_dict of CPU tensors)
      meta.json          token_len/token_lens/d_model/kind/l2_normalize
                         (+ n_patch/part_len from export-aot)

Each program takes the weights as inputs (``torch.func.functional_call``),
so it holds none of them: at ``sht_ltn`` the weights are ~400 MB and an
artifact with tails bakes three lengths.  The batch axis is a symbolic
``Dim``, so one program serves every batch size (eager programs compile
nothing per batch, so no batch is padded); several token lengths are
distinct programs (the relative-position bias is sliced by the sequence
length, models/MultiHeadAttention.py:108 — how LTN tail parts are scored).
The attention kernel is the registered operator ``lstc_vad::attention``, and
each f32 Linear of the encoder the operator ``lstc_vad::linear``, each one
opaque node of the programs, so a loaded program launches the kernels on
the card.

Loading needs only torch and this package's ``ops`` modules, which register
the operators: no model code, no config.  The JAX artifact lowers for
("tpu", "cpu"); this one is device-portable instead: ``load_scorer(path,
device=)`` moves the programs to ``device`` whichever device exported them
(``torch.export.passes.move_to_device_pass`` rewrites the device that ops
such as the input's dtype cast bake into the graph).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Sequence

import numpy as np
import torch

from .device import resolve_device
from .ops import cuda_attention  # noqa: F401  (registers lstc_vad::attention)
from .ops import cuda_linear  # noqa: F401  (registers lstc_vad::linear)

_META = "meta.json"
_PARAMS = "params.pt"
MAX_BATCH = 1 << 20  # the symbolic batch's upper bound


def _program_file(token_len: int) -> str:
    return f"program_L{token_len}.pt2"


class _Scorer(torch.nn.Module):
    """encoder + head -> one score per sequence (scoring._scorer_apply)."""

    def __init__(self, encoder, head, kind: str, l2_normalize: bool):
        super().__init__()
        self.encoder = encoder
        self.head = head
        self.kind = kind
        self.l2_normalize = l2_normalize

    def forward(self, x):
        from .evaluation.scoring import _scorer_apply

        return _scorer_apply(self.encoder, self.head, self.kind,
                             self.l2_normalize, x)


class _Functional(torch.nn.Module):
    """``forward(params, x)``: the scorer with ``params`` in place of its
    own weights.  It holds the scorer outside its registered submodules, so
    the exported program has no parameters of its own."""

    def __init__(self, scorer: _Scorer):
        super().__init__()
        self._scorer = (scorer,)

    def forward(self, params: Dict[str, torch.Tensor], x: torch.Tensor):
        return torch.func.functional_call(self._scorer[0], params, (x,))


def export_scorer(encoder, head, kind: str, token_len: int, d_model: int,
                  l2_normalize: bool = False):
    """``(ExportedProgram, params)``: the scorer of input [b, token_len,
    d_model] with a symbolic batch b, on the modules' device, and the
    weights it takes."""
    scorer = _Scorer(encoder, head, kind, l2_normalize).eval()
    params = dict(scorer.state_dict())
    device = next(iter(params.values())).device
    x = torch.zeros(2, token_len, d_model, device=device)
    batch = torch.export.Dim("batch", min=1, max=MAX_BATCH)
    with torch.no_grad():
        program = torch.export.export(
            _Functional(scorer), (params, x),
            dynamic_shapes=({k: None for k in params}, {0: batch}))
    # a saved program would otherwise carry its example inputs: the weights
    program.example_inputs = None
    return program, params


def save_scorer_artifact(path: str, encoder, head, kind: str, token_len: int,
                         d_model: int, l2_normalize: bool = False,
                         extra_token_lens: Sequence[int] = (),
                         extra_meta: dict | None = None) -> dict:
    """``extra_token_lens``: additional sequence lengths to bake in (LTN
    tail parts l*n_patch for l < part_len).  ``extra_meta``: merged into
    meta.json (n_patch/part_len, so serving.StreamingScorer.from_artifact
    can rebuild the clip layout).  Returns the host seconds spent exporting
    and saving: {"export_s": ..., "save_s": ...}."""
    token_lens = sorted({token_len, *extra_token_lens})
    os.makedirs(path, exist_ok=True)
    params = None
    seconds = {"export_s": 0.0, "save_s": 0.0}
    for length in token_lens:
        t0 = time.perf_counter()
        program, params = export_scorer(encoder, head, kind, length, d_model,
                                        l2_normalize)
        t1 = time.perf_counter()
        torch.export.save(program, os.path.join(path, _program_file(length)))
        seconds["export_s"] += t1 - t0
        seconds["save_s"] += time.perf_counter() - t1
    t0 = time.perf_counter()
    torch.save({k: v.detach().cpu() for k, v in params.items()},
               os.path.join(path, _PARAMS))
    with open(os.path.join(path, _META), "w") as f:
        json.dump({"token_len": token_len, "token_lens": token_lens,
                   "d_model": d_model, "kind": kind,
                   "l2_normalize": l2_normalize,
                   **(extra_meta or {})}, f, indent=1)
    seconds["save_s"] += time.perf_counter() - t0
    return seconds


class LoadedScorer:
    """A loaded scorer artifact on ``device``.  ``score(tokens[B, L, d]) ->
    [B]`` (host numpy) and ``forward(x)`` (a tensor on ``device``) for any
    baked-in token length L; ``n_calls`` counts the program calls."""

    def __init__(self, programs: dict, params: Dict[str, torch.Tensor],
                 meta: dict, device: torch.device):
        self.meta = meta
        self.device = device
        self._programs = programs
        self._params = params
        self.n_calls = 0

    @property
    def token_lens(self):
        return sorted(self._programs)

    def _program(self, length: int, d: int):
        program = self._programs.get(length)
        if program is None or d != self.meta["d_model"]:
            raise ValueError(
                f"tokens [{length}, {d}] do not match the exported programs "
                f"(token_lens={self.token_lens}, d_model="
                f"{self.meta['d_model']})")
        return program

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        program = self._program(x.shape[1], x.shape[2])
        self.n_calls += 1
        with torch.inference_mode():
            return program(self._params, x)

    def score(self, tokens: np.ndarray) -> np.ndarray:
        n, length, d = tokens.shape
        self._program(length, d)
        if n == 0:
            return np.empty(0, np.float32)
        x = torch.from_numpy(np.ascontiguousarray(tokens, dtype=np.float32))
        return self.forward(x.to(self.device)).cpu().numpy()


def load_scorer(path: str, device="cuda") -> LoadedScorer:
    """The artifact at ``path`` on ``device`` (the card unless told the
    CPU), whichever device exported it."""
    from torch.export.passes import move_to_device_pass

    dev = resolve_device(device)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    params = torch.load(os.path.join(path, _PARAMS), map_location=dev,
                        weights_only=True)
    programs = {}
    for length in meta.get("token_lens", [meta["token_len"]]):
        program = torch.export.load(os.path.join(path,
                                                 _program_file(length)))
        programs[length] = move_to_device_pass(program, dev).module()
    return LoadedScorer(programs, params, meta, dev)
