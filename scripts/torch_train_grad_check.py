"""How far the gradients of one dropout-free LTN train step move when only
the attention's forward changes (PyTorch package, one CUDA card).

    python3 scripts/torch_train_grad_check.py [--seed 0] [--top 12]
                                              [--after-epochs 3]

chip_smoke.py's train set-up (``set_up_train``: ``sht_ltn`` at full width,
seed-0 weights, the synthetic SHT train split, TF32 off) with every dropout
at 0, and the batch of 40 pairs that chip_smoke.py's dropout-free step takes
(the first one after ``--after-epochs`` epochs of the paired dataset).
Four gradients of the same step:

- ``kernel``: attention forward by the Hopper kernel (its backward is
  autograd through ``plain_sdpa``), the path ``chip_smoke.py`` checks;
- ``plain``: ``plain_sdpa`` in f32;
- ``f64attn``: an f32 model whose attention is computed in float64 and
  rounded to f32, a third f32 forward, closer to exact than either;
- ``exact``: the whole step in float64.

Prints one JSON line per parameter among the ``--top`` worst by kernel vs
plain, each with ``|g_a - g_b| / |g_b|`` (Frobenius norms) for every pair,
then one summary line: per pair the worst parameter and its error, and per
pair how many ReLU inputs (each FFN's ``w_1`` output and the head's first
Linear output) and per-video arg-max parts of the MIL loss differ in sign or
place between the two forwards: a sign flip of one ReLU input moves every
gradient upstream of it at once.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def sdpa64(q, k, v, temperature, bias=None, **_):
    """Attention in float64, returned in the inputs' dtype."""
    import torch

    attn = torch.matmul(q.double() / temperature, k.double().transpose(-1,
                                                                       -2))
    if bias is not None:
        attn = attn + bias.double()
    return torch.matmul(torch.softmax(attn, -1), v.double()).to(q.dtype)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--after-epochs", type=int, default=3)
    args = p.parse_args(argv)

    import torch

    import chip_smoke
    from lstc_vad_tpu_torch.config import replace
    from lstc_vad_tpu_torch.data import BatchIterator
    from lstc_vad_tpu_torch.ops import attention as attn_mod
    from lstc_vad_tpu_torch.train import create_train_state, make_train_step
    from lstc_vad_tpu_torch.train.driver import Trainer

    card = chip_smoke.card_line()
    with tempfile.TemporaryDirectory() as root:
        cfg, store = chip_smoke.set_up_train(root, args.seed)
        cfg0 = chip_smoke.no_dropout(cfg)
        trainer = Trainer(cfg0, store=store, test_videos=[])
        batches = BatchIterator(trainer.dataset, cfg0.data.batch_size)
        for _ in range(args.after_epochs):  # as Trainer.train_epoch draws
            list(batches)
            trainer.dataset.shuffle_keys()
        batch = next(iter(batches))
        kernel_state = trainer.state
        del trainer
    plain_cfg = replace(cfg0, **{"encoder.attn_impl": "plain"})
    step = make_train_step(cfg0)
    feats = [torch.as_tensor(x, device=kernel_state.device) for x in batch]

    def grads(state, dtype=torch.float32, attention=None):
        """{name: grad} of one forward/backward, the head's first-Linear
        outputs and the per-video arg-max parts."""
        seen = {}
        relus = {f"ffn{i}": layer.pos_ffn.w_1
                 for i, layer in enumerate(state.encoder.layer_stack)}
        relus["head"] = state.head.classifier[0]
        hooks = [m.register_forward_hook(
            lambda m, i, o, name=name: seen.__setitem__(name, o.detach() > 0))
            for name, m in relus.items()]
        hooks.append(state.head.register_forward_hook(
            lambda m, i, o: seen.__setitem__("probs", o.detach())))
        orig = attn_mod.plain_sdpa
        if attention is not None:
            attn_mod.plain_sdpa = attention
        try:
            state.encoder.train()
            state.head.train()
            state.optimizer.zero_grad(set_to_none=True)
            loss, _ = step.loss_fn(state, *(f.to(dtype) for f in feats))
            loss.backward()
        finally:
            attn_mod.plain_sdpa = orig
            for h in hooks:
                h.remove()
        g = {**{f"encoder.{n}": q.grad.double()
                for n, q in state.encoder.named_parameters()
                if q.grad is not None},
             **{f"head.{n}": q.grad.double()
                for n, q in state.head.named_parameters()}}
        pn = cfg0.data.part_num
        argmax = seen["probs"][:, 1].reshape(-1, pn).argmax(-1)
        signs = {k: v for k, v in seen.items() if k != "probs"}
        return loss.item(), g, signs, argmax

    def clone_of(state, cfg):
        other = create_train_state(cfg, device=state.device, seed=args.seed)
        other.encoder.load_state_dict(state.encoder.state_dict())
        other.head.load_state_dict(state.head.state_dict())
        return other

    runs = {}
    runs["kernel"] = grads(kernel_state)
    plain_state = clone_of(kernel_state, plain_cfg)
    runs["plain"] = grads(plain_state)
    runs["f64attn"] = grads(plain_state, attention=sdpa64)
    exact_state = copy.deepcopy(plain_state)
    exact_state.encoder.double()
    exact_state.head.double()
    runs["exact"] = grads(exact_state, torch.float64, attention=sdpa64)

    def rel(a, b, name):
        ga, gb = runs[a][1][name], runs[b][1][name]
        return ((ga - gb).norm() / gb.norm()).item()

    pairs = (("kernel", "plain"), ("kernel", "exact"), ("plain", "exact"),
             ("f64attn", "plain"), ("f64attn", "exact"))
    names = list(runs["plain"][1])
    table = {n: {f"{a}_vs_{b}": rel(a, b, n) for a, b in pairs}
             for n in names}
    for n in sorted(names, key=lambda n: -table[n]["kernel_vs_plain"])[
            :args.top]:
        print(json.dumps({"param": n, "norm": runs["exact"][1][n].norm()
                          .item(), **table[n]}))
    worst = {}
    for a, b in pairs:
        key = f"{a}_vs_{b}"
        n = max(names, key=lambda n: table[n][key])
        worst[key] = {"param": n, "rel_err": table[n][key]}
    flips = {f"{a}_vs_{b}": {
        **{k: int((runs[a][2][k] != runs[b][2][k]).sum())
           for k in runs[a][2]},
        "argmax_parts": int((runs[a][3] != runs[b][3]).sum())}
        for a, b in pairs}
    print(json.dumps({
        "losses": {k: v[0] for k, v in runs.items()},
        "worst": worst, "sign_flips": flips,
        "relu_inputs": {k: v.numel() for k, v in runs["plain"][2].items()},
        "videos": runs["kernel"][3].numel(), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
