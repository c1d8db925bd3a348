"""The PyTorch package imports nothing of JAX and nothing of the JAX package.

A fresh interpreter imports every module of ``lstc_vad_tpu_torch`` and
lists what got loaded.  The package name shares the prefix
``lstc_vad_tpu``, so the check matches the JAX package by exact name or
``lstc_vad_tpu.`` prefix.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, json, pkgutil, sys
import lstc_vad_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""

FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax")


def test_package_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    for mod in ("lstc_vad_tpu_torch.ops.cuda_attention",
                "lstc_vad_tpu_torch.evaluation.scoring",
                "lstc_vad_tpu_torch.cli",
                "lstc_vad_tpu_torch.objectives.losses",
                "lstc_vad_tpu_torch.train.optim",
                "lstc_vad_tpu_torch.train.state",
                "lstc_vad_tpu_torch.train.steps",
                "lstc_vad_tpu_torch.train.driver",
                "lstc_vad_tpu_torch.data.sampler",
                "lstc_vad_tpu_torch.data.pipeline",
                "lstc_vad_tpu_torch.data.synthetic",
                "lstc_vad_tpu_torch.ckpt.io",
                "lstc_vad_tpu_torch.pseudo.generator",
                "lstc_vad_tpu_torch.pseudo.coteach",
                "lstc_vad_tpu_torch.evaluation.drivers",
                "lstc_vad_tpu_torch.serving",
                "lstc_vad_tpu_torch.serving_mp",
                "lstc_vad_tpu_torch.export",
                "lstc_vad_tpu_torch.data.packed",
                "lstc_vad_tpu_torch.data.validate",
                "lstc_vad_tpu_torch.ckpt.torch_export",
                "lstc_vad_tpu_torch.parallel.mesh",
                "lstc_vad_tpu_torch.utils.logging",
                "lstc_vad_tpu_torch.utils.profiling",
                "lstc_vad_tpu_torch.utils.seeding",
                "lstc_vad_tpu_torch.utils.misc",
                "lstc_vad_tpu_torch.ops.sr"):
        assert mod in report["imported"]
    bad = [m for m in report["loaded"]
           if m.split(".")[0] in FORBIDDEN_ROOTS
           or m == "lstc_vad_tpu" or m.startswith("lstc_vad_tpu.")]
    assert not bad, bad
    # h5py loads only when a store opens: a machine without it can still
    # import the package and feed features from memory
    assert "h5py" not in report["loaded"]


NO_H5PY_PROBE = """
import os, sys, tempfile
sys.modules["h5py"] = None  # any import of h5py now raises ImportError
import numpy as np
from lstc_vad_tpu_torch import cli
from lstc_vad_tpu_torch.config import preset
from lstc_vad_tpu_torch.data.packed import PackedStore, write_pack
from lstc_vad_tpu_torch.data.validate import validate_data
from lstc_vad_tpu_torch.train.driver import Trainer

root = tempfile.mkdtemp()
rng = np.random.default_rng(0)
keys = ["01_000", "01_001", "02_002"]
pack = os.path.join(root, "f.lstcpack")
write_pack(pack, [(k, rng.standard_normal((12, 4, 8)).astype(np.float32))
                  for k in keys])
train_txt = os.path.join(root, "train.txt")
with open(train_txt, "w") as f:
    f.write("01_000,0\\n01_001,0\\n02_002,1\\n")
cfg = preset("sht_ltn", **{"data.pack_path": pack,
                           "data.train_txt": train_txt, "data.n_patch": 4,
                           "data.d_model": 8})
problems, stats = validate_data(cfg)
assert problems == [] and stats["train_videos"] == 3, (problems, stats)
store = Trainer(cfg, eval_only=True, device="cpu").store
assert isinstance(store, PackedStore) and store.native
print("ok")
"""


def test_the_pack_path_needs_no_h5py():
    """With h5py made unimportable, the CLI module imports, a pack is
    written and validated, and a Trainer reads it: the card's machine,
    which has no h5py, can run the package from a pack."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", NO_H5PY_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
