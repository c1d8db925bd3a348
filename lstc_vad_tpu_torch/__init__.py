"""lstc_vad_tpu_torch — the PyTorch + CUDA port of ``lstc_vad_tpu``.

A second package beside the JAX one, which stays the reference every part of
this package is held against (tests/test_torch_*.py).  It imports torch and
numpy, and nothing of JAX or of ``lstc_vad_tpu``.

What is ported so far: the evaluation forward, training, pseudo labels and
co-teaching, for SHT, UBnormal and UCF (tenCrop stores included), serving
and AOT export:

- ``models``      — encoder (STN/LTN) and Regressor/Classifier heads as
                    ``nn.Module``s, with the reference's state_dict key layout.
- ``ops``         — attention: the plain PyTorch version and a CUDA kernel
                    written for Hopper (``csrc/attention.cu``), built with
                    ``nvcc`` at first use.
- ``ckpt``        — JAX param trees and the reference's ``.ckpt`` files into
                    this package's state_dicts; checkpoints of the train
                    state, synchronous or in the background.
- ``evaluation``  — part chunking, the batched scorers (UCF's included), the
                    eval drivers and the metric zoo.
- ``data``        — annotation parsers, the HDF5 feature store, the paired
                    train dataset and its prefetcher, the test split, and
                    synthetic splits.
- ``objectives``, ``train`` — the losses, Adagrad, the train steps and the
                    Trainer.
- ``pseudo``      — the pseudo-label generators and the co-teaching driver.
- ``serving``, ``serving_mp`` — the streaming scorer and its JSONL server;
                    torch-free workers behind one batching backend.
- ``export``      — ``torch.export`` artifacts of the eval scorer.
- ``cli``         — ``python -m lstc_vad_tpu_torch train | gen-pseudo |
                    evaluate | coteach | export-aot | serve |
                    serve-backend``.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
Importing the package imports nothing else: a serving worker (serving_mp.py)
loads neither torch nor the model code, and an artifact loader
(export.py) only torch and ``ops``.
"""

__version__ = "0.1.0"
