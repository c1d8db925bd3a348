"""``validate-data`` in the PyTorch package (lstc_vad_tpu_torch/data/
validate.py) against the JAX package's ``validate_data``: the cases of
tests/test_validate.py, each run over the HDF5 file and over a pack made
from it (``data.pack_path``), must give the same problems, in the same
order, and the same stats as the JAX function over the same store; the
CLI's exit codes and lines follow.
"""

import os
from dataclasses import replace

import h5py
import numpy as np
import pytest

from fixtures import make_sht_like, make_ubnormal_like, make_ucf_like
from lstc_vad_tpu.config import preset as jax_preset
from lstc_vad_tpu.data.validate import validate_data as jax_validate_data
from lstc_vad_tpu_torch import cli
from lstc_vad_tpu_torch.data.datasets import load_test_videos
from lstc_vad_tpu_torch.data.feature_store import FeatureStore
from lstc_vad_tpu_torch.data.packed import PackedStore, pack_h5
from lstc_vad_tpu_torch.data.sampler import maybe_double_short
from lstc_vad_tpu_torch.data.validate import validate_data

from test_torch_train_step import port_config

STORES = ["h5", "pack"]


def _validate(jcfg, store):
    """(problems, stats) of the port over ``store`` ("h5", or a pack made
    from the h5 now), held equal to the JAX function's over the same."""
    if store == "pack":
        pack = jcfg.data.h5_path + ".lstcpack"
        pack_h5(jcfg.data.h5_path, pack)
        jcfg = replace(jcfg, data=replace(jcfg.data, pack_path=pack))
    want = jax_validate_data(jcfg)
    got = validate_data(port_config(jcfg))
    assert got == want
    return got


def _sht_cfg(fixture, **data_kw):
    h5, train_txt, test_txt, mask_dir = fixture
    cfg = jax_preset("sht_stn")
    data = replace(cfg.data, h5_path=h5, train_txt=train_txt,
                   test_txt=test_txt, test_mask_dir=mask_dir + "/",
                   n_patch=4, d_model=16, part_len=3, **data_kw)
    return replace(cfg, data=data)


def _ucf_cfg(h5, train_txt, test_txt, gt_h5, **data_kw):
    cfg = jax_preset("ucf_ltn")
    data = replace(cfg.data, h5_path=h5, train_txt=train_txt,
                   test_txt=test_txt, test_mask_h5=gt_h5, n_patch=3,
                   d_model=16, **data_kw)
    return replace(cfg, data=data)


@pytest.mark.parametrize("store", STORES)
def test_clean_sht_fixture_validates(tmp_path, store):
    cfg = _sht_cfg(make_sht_like(str(tmp_path), n_patch=4, d_model=16))
    problems, stats = _validate(cfg, store)
    assert problems == []
    assert stats["train_videos"] == 7 and stats["test_videos"] == 7
    assert stats["train_normal"] == 4 and stats["train_abnormal"] == 3


@pytest.mark.parametrize("store", STORES)
def test_missing_key_and_mask_and_shape(tmp_path, store):
    fixture = make_sht_like(str(tmp_path), n_patch=4, d_model=16)
    h5, train_txt, _, mask_dir = fixture
    with open(train_txt, "a") as f:
        f.write("01_ghost,0\n")
    with h5py.File(h5, "a") as f:
        del f["01_000.npy"]
        f["01_000.npy"] = np.zeros((5, 4, 8), np.float32)
    os.remove(os.path.join(mask_dir, "02_004.npy"))
    problems, _ = _validate(_sht_cfg(fixture), store)
    text = "\n".join(problems)
    assert "'01_ghost' not in the feature store" in text
    assert "d_model 8 != data.d_model=16" in text
    assert "missing frame mask" in text and "02_004" in text


@pytest.mark.parametrize("store", STORES)
def test_short_video_and_single_class(tmp_path, store):
    fixture = make_sht_like(str(tmp_path), n_patch=4, d_model=16)
    h5, train_txt, _, _ = fixture
    with h5py.File(h5, "a") as f:
        del f["01_001.npy"]
        f["01_001.npy"] = np.zeros((2, 4, 16), np.float32)  # < part_len=3
    problems, _ = _validate(_sht_cfg(fixture), store)
    assert any("2 clips < part_len=3" in p for p in problems)
    with open(train_txt, "w") as f:
        f.write("01_000,0\n01_001,0\n")
    problems, _ = _validate(_sht_cfg(fixture), store)
    assert any("balanced pairing" in p for p in problems)


@pytest.mark.parametrize("store", STORES)
def test_pseudo_label_gaps(tmp_path, store):
    fixture = make_sht_like(str(tmp_path), n_patch=4, d_model=16)
    with h5py.File(fixture[0], "r") as f:
        n0 = f["01_000.npy"].shape[0]
    path = str(tmp_path / "pseudo.npy")
    np.save(path, {"01_000.npy": np.zeros(n0 + 5, np.float32)})
    problems, _ = _validate(_sht_cfg(fixture, pseudo_labels_path=path),
                            store)
    text = "\n".join(problems)
    assert f"has {n0 + 5} entries, expected {n0}" in text
    assert "no entry for train video" in text


@pytest.mark.parametrize("store", STORES)
def test_ucf_gt_h5_checks(tmp_path, store):
    h5, train_txt, test_txt, gt_h5 = make_ucf_like(str(tmp_path))
    cfg = _ucf_cfg(h5, train_txt, test_txt, gt_h5)
    problems, _ = _validate(cfg, store)
    assert problems == []
    with h5py.File(gt_h5, "a") as f:
        del f[list(f.keys())[0]]
    problems, _ = _validate(cfg, store)
    assert any("no frame mask for abnormal" in p for p in problems)
    problems, _ = _validate(_ucf_cfg(h5, train_txt, test_txt, ""), store)
    assert any("no data.test_mask_h5" in p for p in problems)


@pytest.mark.parametrize("store", STORES)
def test_zero_clip_video_reported_not_hung(tmp_path, store):
    h5, train_txt, test_txt, gt_h5 = make_ucf_like(str(tmp_path))
    with h5py.File(h5, "a") as f:
        victim = list(f.keys())[0]
        del f[victim]
        f[victim] = np.zeros((0, 3, 16), np.float32)
    pseudo_path = str(tmp_path / "pseudo.npy")
    with h5py.File(h5, "r") as f:
        np.save(pseudo_path, {k: np.zeros(max(f[k].shape[0], 1), np.float32)
                              for k in f.keys()})
    problems, _ = _validate(_ucf_cfg(h5, train_txt, test_txt, gt_h5,
                                     pseudo_labels_path=pseudo_path), store)
    assert any("0 stored clips" in p for p in problems)


@pytest.mark.parametrize("store", STORES)
def test_suffixless_dataset(tmp_path, store):
    """Stored without the '.npy' suffix: a problem line over the h5; the
    pack names its keys without the suffix, so over a pack made from it the
    video is simply there."""
    fixture = make_sht_like(str(tmp_path), n_patch=4, d_model=16)
    with h5py.File(fixture[0], "a") as f:
        arr = f["01_000.npy"][:]
        del f["01_000.npy"]
        f["01_000"] = arr
    problems, _ = _validate(_sht_cfg(fixture), store)
    suffixless = [p for p in problems
                  if "without the '.npy' dataset suffix" in p]
    assert len(suffixless) == (2 if store == "h5" else 0)  # train + test


@pytest.mark.parametrize("store", STORES)
def test_pseudo_doubling_at_exactly_part_len(tmp_path, store):
    h5, train_txt, test_txt, gt_h5 = make_ucf_like(str(tmp_path))
    part_len = jax_preset("ucf_ltn").data.part_len
    with h5py.File(h5, "a") as f:
        victim = list(f.keys())[0]
        del f[victim]
        f[victim] = np.zeros((part_len, 3, 16), np.float32)
    pseudo_path = str(tmp_path / "pseudo.npy")
    with h5py.File(h5, "r") as f:
        np.save(pseudo_path,
                {k: np.zeros(maybe_double_short(f[k][:], part_len).shape[0],
                             np.float32) for k in f.keys()})
    problems, _ = _validate(_ucf_cfg(h5, train_txt, test_txt, gt_h5,
                                     pseudo_labels_path=pseudo_path), store)
    assert problems == []


@pytest.mark.parametrize("store", STORES)
def test_pickled_mask_rejected_like_runtime(tmp_path, store):
    fixture = make_sht_like(str(tmp_path), n_patch=4, d_model=16)
    victim = os.path.join(fixture[3], "02_004.npy")
    frames = np.load(victim).tolist()
    np.save(victim, np.array([frames], dtype=object), allow_pickle=True)
    problems, _ = _validate(_sht_cfg(fixture), store)
    assert any("allow_pickle=False" in p and "02_004" in p for p in problems)


@pytest.mark.parametrize("store", STORES)
def test_ubnormal_missing_frame_count_caught(tmp_path, store):
    h5, train_txt, test_txt, mask_dir = make_ubnormal_like(str(tmp_path))
    with open(test_txt) as f:
        lines = f.read().splitlines()
    lines[0] = lines[0].split(",")[0]  # a normal video, frame count dropped
    with open(test_txt, "w") as f:
        f.write("\n".join(lines) + "\n")
    cfg = jax_preset("ubnormal_ltn")
    data = replace(cfg.data, h5_path=h5, train_txt=train_txt,
                   test_txt=test_txt, test_mask_dir=mask_dir + "/",
                   n_patch=4, d_model=8)
    problems, _ = _validate(replace(cfg, data=data), store)
    assert any("no frame count" in p for p in problems)
    feats = (FeatureStore(h5, n_patch=4, d_model=8) if store == "h5"
             else PackedStore(h5 + ".lstcpack"))
    with pytest.raises(ValueError, match="no frame count"):
        load_test_videos("UBnormal", test_txt, feats,
                         mask_dir=mask_dir + "/")
    feats.close()


@pytest.mark.parametrize("store", STORES)
def test_cli_validate_data(tmp_path, capsys, store):
    h5, train_txt, test_txt, mask_dir = make_sht_like(
        str(tmp_path), n_patch=4, d_model=16)
    source = ["--h5", h5]
    if store == "pack":
        pack = str(tmp_path / "feats.lstcpack")
        assert cli.main(["pack", "--h5", h5, "--out", pack]) == 0
        source = ["--set", f"data.pack_path={pack}"]
    args = ["validate-data", "--preset", "sht_stn", *source,
            "--train-txt", train_txt, "--test-txt", test_txt,
            "--mask-dir", mask_dir + "/", "--set", "data.n_patch=4",
            "--set", "data.d_model=16", "--set", "data.part_len=3",
            "--log-dir", str(tmp_path / "logs")]
    capsys.readouterr()
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "ok: all referenced" in out and "train_videos=7" in out
    with open(train_txt, "a") as f:
        f.write("01_ghost,0\n")
    assert cli.main(args) == 1
    out = capsys.readouterr().out
    assert "PROBLEM: train: key '01_ghost' not in the feature store" in out
    assert "1 problem(s) found" in out
