"""lstc_vad_tpu_torch — the PyTorch + CUDA port of ``lstc_vad_tpu``.

A second package beside the JAX one, which stays the reference every part of
this package is held against (tests/test_torch_*.py).  It imports torch and
numpy, and nothing of JAX or of ``lstc_vad_tpu``.

What is ported: the evaluation forward, training, pseudo labels and
co-teaching, for SHT, UBnormal and UCF (tenCrop stores included), serving,
AOT export, the ``.lstcpack`` data layer, the benchmark, every CLI
subcommand, and the train-time knobs (bf16 compute, stochastic rounding,
remat, bf16 wires for training and evaluation batches; f32 by default, and
evaluation is f32 whatever they say), and multi-device runs (a data x model
mesh of processes, one per device):

- ``models``      — encoder (STN/LTN) and Regressor/Classifier heads as
                    ``nn.Module``s, with the reference's state_dict key layout.
- ``ops``         — attention: the plain PyTorch version and CUDA kernels
                    written for Hopper, one per type (``csrc/attention.cu``
                    f32, ``csrc/attention_bf16.cu`` bf16), built with
                    ``nvcc`` at first use; ``ops/_build.py`` also builds the
                    host C++ pack reader (``csrc/packstore.cpp``) with g++;
                    the stochastic-rounding cast (``ops/sr.py``).
- ``ckpt``        — JAX param trees and the reference's ``.ckpt`` files into
                    this package's state_dicts and back out to the
                    reference's files; checkpoints of the train state,
                    synchronous or in the background.
- ``evaluation``  — part chunking, the batched scorers (UCF's included), the
                    eval drivers and the metric zoo.
- ``data``        — annotation parsers, the HDF5 and ``.lstcpack`` feature
                    stores (the pack's native batch gather), the paired
                    train dataset and its prefetcher, the test split,
                    dataset validation and synthetic splits.
- ``objectives``, ``train`` — the losses, Adagrad, the train steps and the
                    Trainer.
- ``pseudo``      — the pseudo-label generators and the co-teaching driver.
- ``serving``, ``serving_mp`` — the streaming scorer and its JSONL server;
                    torch-free workers behind one batching backend.
- ``export``      — ``torch.export`` artifacts of the eval scorer.
- ``parallel``    — multi-device runs over ``torch.distributed``: the
                    (data, model) DeviceMesh, the tensor-parallel rules and
                    collectives, process-group set-up (``--multihost``,
                    torchrun) and the gloo rehearsal (``dryrun``).
- ``utils``       — logging, profiling, seeding, the wire-type lookup.
- ``benchmark``   — single-card throughput over the preset matrix at full
                    width, one JSON line of the JAX benchmark's keys.
- ``cli``         — ``python -m lstc_vad_tpu_torch train | gen-pseudo |
                    evaluate | coteach | export-aot | serve |
                    serve-backend | pack | validate-data | export-torch |
                    info | profile | sweep | benchmark``.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
Importing the package imports nothing else: a serving worker (serving_mp.py)
loads neither torch nor the model code, and an artifact loader
(export.py) only torch and ``ops``.
"""

__version__ = "0.1.0"
