"""The port's STN train step (``make_stn_train_step`` on a ``Trainer``-built
state) against the benchmark's plain reference (``h100_bench/reference/
stn.py``), on the CPU, at a small STN-shaped configuration: the ``sht_stn``
config file's numbers with the widths cut, d_inner 31 (off the 16-byte grid,
as 3027 is), 16 patches + CLS = 17-token sequences, 16 parts of 7 clips,
the Regressor and the STN MIL loss.  Scores, loss, every leaf's gradient
and one Adagrad step are compared with dropout off and with the dropout
stream followed (the masks drawn from the step's seed in the program's
order); the weights are the benchmark's, from ``data.make_weights``.

Tolerances.  Both sides compute in f32 on the CPU with the same operations
in the same order, and read bit-equal scores, loss and gradients on these
seeds; the updated weights differ by up to 1.5e-8 (torch's Adagrad divides
with one ``addcdiv``, the reference in separate operations).  The limits
leave room for a BLAS that sums the port's ``F.linear`` (addmm) and the
reference's ``matmul(x, w.t())`` in another order, a few f32 roundings
(~6e-8 relative) a product carried through 3 layers and the LayerNorms:
SCORE_ATOL 1e-6 on sigmoid scores of order 0.5, LOSS_RTOL 1e-6; GRAD_RTOL
1e-5 of each leaf's norm, for sums over 672 sequences whose terms partly
cancel; STEP_ATOL 1e-6 on the updated weights, Adagrad's first step moving
an element by lr · g / |g| (the head's lr 1e-2 times 1e-4 of slack for an
element whose gradient is zero to rounding).  A dropout mask drawn out of
the program's order moves the scores by far more than SCORE_ATOL.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench.harness import data  # noqa: E402
from h100_bench.harness.cell import load_weights, program_config  # noqa: E402
from h100_bench.reference.model import (adagrad, matmul,  # noqa: E402
                                        step_seed)
from h100_bench.reference.stn import STN, stn_loss  # noqa: E402

CONFIG = ROOT / "h100_bench" / "configs" / "sht_stn.json"
# widths cut; n_patch, part_num, part_len, the layers and d_inner's
# misalignment kept
SMALL = {"encoder.d_model": 16, "encoder.n_head": 2, "encoder.d_k": 8,
         "encoder.d_v": 8, "encoder.d_inner": 31, "head.d_model": 16,
         "head.hidden_dim": 8, "data.d_model": 16, "data.batch_size": 3}
NO_DROPOUT = {"encoder.attn_dropout": 0.0, "encoder.fc_dropout": 0.0,
              "encoder.ffn_dropout": 0.0, "head.dropout": 0.0}
SCORE_ATOL, LOSS_RTOL, GRAD_RTOL, STEP_ATOL = 1e-6, 1e-6, 1e-5, 1e-6


def _config(extra=None):
    config = json.loads(CONFIG.read_text())
    cut = dict(SMALL, **(extra or {}))
    config["overrides"] = dict(cut)
    config["program"].update(cut)
    return config


def _trainer(tmp_path, config, seed):
    from lstc_vad_tpu_torch.config import replace
    from lstc_vad_tpu_torch.data.annotations import TrainRecord
    from lstc_vad_tpu_torch.data.synthetic import (SyntheticStore,
                                                   write_train_files)
    from lstc_vad_tpu_torch.train.driver import Trainer

    p = config["program"]
    rng = np.random.default_rng(seed)
    feats, records = {}, []
    for i in range(2 * p["data.batch_size"]):
        key = f"v{i:02d}"
        feats[key] = rng.standard_normal(
            (int(rng.integers(7, 30)), p["data.n_patch"], 16),
            dtype=np.float32)
        records.append(TrainRecord(key, i >= p["data.batch_size"]))
    train_txt, mask_dir = write_train_files(str(tmp_path), records, {})
    cfg = replace(program_config(config), **{
        "data.train_txt": train_txt, "data.test_mask_dir": mask_dir,
        "seed": seed})
    return Trainer(cfg, store=SyntheticStore(feats), test_videos=[],
                   device="cpu")


def _batch(p, seed):
    """Normal and abnormal features [B, pn·pl, n_patch, d] and labels."""
    g = torch.Generator().manual_seed(seed)
    b, clips = p["data.batch_size"], p["data.part_num"] * p["data.part_len"]
    shape = (b, clips, p["data.n_patch"], p["encoder.d_model"])
    nf, af = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    return nf, torch.zeros(b, clips), af, torch.zeros(b, clips)


def _port_step(trainer, batch):
    """The program's scores (the step's forward, its masks drawn again from
    the step's seed), loss, gradients and weights after one update."""
    from lstc_vad_tpu_torch.train.steps import step_rng

    state, step = trainer.state, trainer.step_fn
    nf, _, af, _ = batch
    x = torch.cat([nf, af]).reshape(-1, *nf.shape[2:])
    state.encoder.train()
    state.head.train()
    with torch.no_grad(), step_rng(state.seed, state.step, state.device):
        scores = state.head(state.encoder(x)[:, 0, :])[:, 0]
    metrics = step.grads(state, *batch)
    named = {**{f"encoder.{k}": v for k, v in
                state.encoder.named_parameters()},
             **{f"head.{k}": v for k, v in state.head.named_parameters()}}
    grads = {k: None if v.grad is None else v.grad.clone()
             for k, v in named.items()}
    state.optimizer.step()
    after = {k: v.detach().clone() for k, v in named.items()}
    return scores, float(metrics["loss"]), grads, after


def _reference_step(p, weights, batch, run_seed):
    nf, _, af, _ = batch
    x = torch.cat([nf, af]).reshape(-1, *nf.shape[2:])
    model = STN(p, "cpu")
    W = {k: v.clone() for k, v in data.flat(weights).items()}
    unused = set(data.unused(p))
    names = [k for k in W if k not in unused]
    leaves = {k: (v.detach().requires_grad_() if k in names else v)
              for k, v in W.items()}
    torch.manual_seed(step_seed(run_seed, 0))
    scores = model.forward(leaves, x, matmul, True)
    loss = stn_loss(scores, nf.shape[0], p["data.part_num"],
                    p["data.part_len"], p)
    grads = dict.fromkeys(W)
    grads.update(zip(names, torch.autograd.grad(
        loss, [leaves[k] for k in names])))
    acc = {k: torch.zeros_like(v) for k, v in W.items()}
    with torch.no_grad():
        adagrad(W, grads, acc, p)
    return scores.detach(), float(loss.detach()), grads, W


def test_config_file_is_the_preset():
    """Every number of the file is the ``sht_stn`` preset's (program_config
    raises on one that differs), nothing is cut, and the STN's shapes are
    the published ones."""
    config = json.loads(CONFIG.read_text())
    program_config(config)
    assert config["reduced"] == [] and not config["overrides"]
    assert config["dtype"] == "float32" and config["preset"] == "sht_stn"
    p = config["program"]
    assert (p["encoder.d_model"], p["encoder.n_head"], p["encoder.d_k"],
            p["encoder.d_inner"], p["encoder.n_layers"]) == (2048, 8, 256,
                                                             3027, 3)
    assert p["encoder.d_inner"] % 4  # K off the 16-byte grid
    assert (p["data.n_patch"], p["data.part_num"], p["data.part_len"],
            p["data.batch_size"]) == (16, 16, 7, 40)
    assert p["head.kind"] == "regressor" and p["model"] == "stn"
    STN(p, "cpu")  # the reference implements every setting of the file


def test_port_loads_the_full_width_weight_layout_on_the_meta_device():
    """The benchmark's weight layout at full width is the port's modules'
    state_dict, key for key and shape for shape: w_1 2048 -> 3027, w_2
    3027 -> 2048, the Regressor 2048 -> 512 -> 32 -> 1, no bias table."""
    from lstc_vad_tpu_torch.models import build

    config = json.loads(CONFIG.read_text())
    layout = data.weight_layout(config["program"])
    with torch.device("meta"):
        encoder, head = build(program_config(config), "cpu", seed=0)
    for module, part in ((encoder, "encoder"), (head, "head")):
        assert {k: tuple(v.shape) for k, v in module.state_dict().items()} \
            == {k: tuple(s) for k, s, _, _ in layout[part]}
    f = "layer_stack.0.pos_ffn."
    assert dict((k, s) for k, s, _, _ in layout["encoder"])[
        f + "w_1.weight"] == (3027, 2048)
    assert dict((k, s) for k, s, _, _ in layout["head"])[
        "regressor.5.weight"] == (1, 32)


@pytest.mark.parametrize("dropout", ["off", "stream"])
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_train_step_matches_the_reference(tmp_path, seed, dropout):
    config = _config(NO_DROPOUT if dropout == "off" else None)
    p = config["program"]
    weights = data.make_weights(p, seed, "cpu")
    trainer = _trainer(tmp_path, config, seed)
    load_weights(trainer.state.encoder, trainer.state.head, weights)
    batch = _batch(p, seed % 2 ** 32)
    got_scores, got_loss, got_grads, got_after = _port_step(trainer, batch)
    trainer.close()
    w_scores, w_loss, w_grads, w_after = _reference_step(p, weights, batch,
                                                         seed)

    assert got_scores.shape == w_scores.shape == (
        2 * p["data.batch_size"] * p["data.part_num"] * p["data.part_len"],)
    torch.testing.assert_close(got_scores, w_scores, rtol=0, atol=SCORE_ATOL)
    assert abs(got_loss - w_loss) <= LOSS_RTOL * abs(w_loss)
    assert set(got_grads) == set(w_grads)
    for k, want in w_grads.items():
        got = got_grads[k]
        if want is None:  # the unused LayerNorms: no gradient either side
            assert got is None, k
            continue
        scale = float(want.norm())
        assert scale > 0, k
        assert float((got - want).norm()) <= GRAD_RTOL * scale, k
    for k, want in w_after.items():
        torch.testing.assert_close(got_after[k], want, rtol=0,
                                   atol=STEP_ATOL, msg=k)
