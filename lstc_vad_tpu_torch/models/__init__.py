from typing import Tuple

import torch

from ..config import TrainConfig
from ..device import resolve_device
from .encoder import Encoder, EncoderLayer, FeedForward, MultiHeadAttention
from .heads import Classifier, Regressor, make_head

__all__ = ["Encoder", "EncoderLayer", "FeedForward", "MultiHeadAttention",
           "Classifier", "Regressor", "make_head", "build"]


def build(cfg: TrainConfig, device="cuda", seed: int = 0
          ) -> Tuple[Encoder, torch.nn.Module]:
    """The encoder and head of ``cfg`` on ``device``, in eval mode, with
    weights drawn from a ``torch.Generator`` on that device seeded with
    ``seed``.  Raises when ``device`` is CUDA and there is no card."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    encoder = Encoder(cfg.encoder, device=dev).reset_parameters(gen)
    h = cfg.head
    head = make_head(h.kind, h.d_model, h.hidden_dim, h.dropout,
                     h.weight_init, device=dev).reset_parameters(gen)
    return encoder.eval(), head.eval()
