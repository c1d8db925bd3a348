"""The PyTorch package's ``.lstcpack`` store (lstc_vad_tpu_torch/data/
packed.py and its own native reader, csrc/packstore.cpp built with g++)
against the JAX package's (lstc_vad_tpu/data/packed.py).

The cases of tests/test_packed.py, each run over the native reader and the
numpy reader: round trip, gather and batch gather, bad key and index,
truncation and random-corruption fuzz, corrupt fields, overflowing extents,
empty and tiny files, duplicate keys, heterogeneous d_model, the
``PS_ERR_IO`` degrade and tenCrop clip counts.  Then what holds the two
packages together: packs written by either are byte-identical and each
reads the other's, ``pack_h5`` and the ``pack`` subcommand write the JAX
``cmd_pack``'s file, and batches from a pack — per item through
``store.gather`` and per batch through ``get_batch`` — are bit-equal to the
JAX ``PairedTrainDataset`` over the JAX ``PackedStore``.  Exact equality
throughout: the data is copied, never computed.
"""

import ctypes
import filecmp
import struct

import numpy as np
import pytest

from fixtures import make_sht_like
from lstc_vad_tpu.cli.main import main as jax_main
from lstc_vad_tpu.data import BatchIterator as JaxBatchIterator
from lstc_vad_tpu.data import PairedTrainDataset as JaxPairedTrainDataset
from lstc_vad_tpu.data.packed import PackedStore as JaxPackedStore
from lstc_vad_tpu.data.packed import pack_h5 as jax_pack_h5
from lstc_vad_tpu.data.packed import write_pack as jax_write_pack
from lstc_vad_tpu_torch import cli
from lstc_vad_tpu_torch.data import (BatchIterator, PairedTrainDataset,
                                     load_train_records)
from lstc_vad_tpu_torch.data import packed as pk
from lstc_vad_tpu_torch.data.packed import (PackedStore, PackFormatError,
                                            pack_h5, write_pack)
from lstc_vad_tpu_torch.ops import _build

READERS = ["native", "numpy"]


def _store(path, reader, **kw):
    store = PackedStore(path, use_native=reader == "native", **kw)
    assert store.native == (reader == "native")
    return store


def _sample_videos(rng, n=5):
    return [(f"vid_{i:02d}",
             rng.standard_normal((int(rng.integers(5, 20)), 4, 8))
             .astype(np.float32))
            for i in range(n)]


def _write_sample_pack(tmp_path, rng, name="c.lstcpack"):
    path = str(tmp_path / name)
    write_pack(path, _sample_videos(rng, n=3))
    return path


@pytest.mark.parametrize("reader", READERS)
def test_pack_roundtrip(tmp_path, rng, reader):
    videos = _sample_videos(rng)
    path = str(tmp_path / "feats.lstcpack")
    write_pack(path, videos)
    store = _store(path, reader)
    assert store.keys() == [k for k, _ in videos]
    for key, feat in videos:
        np.testing.assert_array_equal(store.get(key), feat)
        assert store.n_clips(key) == feat.shape[0]
        assert store.shape(key) == feat.shape
    store.close()


@pytest.mark.parametrize("reader", READERS)
def test_gather_matches_the_features(tmp_path, rng, reader):
    videos = _sample_videos(rng)
    path = str(tmp_path / "feats.lstcpack")
    write_pack(path, videos)
    store = _store(path, reader)
    for key, feat in videos:
        idx = rng.integers(0, feat.shape[0], size=7)
        np.testing.assert_array_equal(store.gather(key, idx, n_patch_out=3),
                                      feat[idx, :3, :])
    store.close()


@pytest.mark.parametrize("reader", READERS)
def test_gather_batch(tmp_path, rng, reader):
    videos = _sample_videos(rng, n=6)
    path = str(tmp_path / "feats.lstcpack")
    write_pack(path, videos)
    store = _store(path, reader)
    keys = [k for k, _ in videos]
    idx = np.stack([rng.integers(0, min(f.shape[0] for _, f in videos),
                                 size=4) for _ in keys])
    out = store.gather_batch(keys, idx, n_patch_out=4, d_model=8)
    assert out.shape == (6, 4, 4, 8)
    for i, (key, feat) in enumerate(videos):
        np.testing.assert_array_equal(out[i], feat[idx[i]])
    store.close()


@pytest.mark.parametrize("reader,bad_index_error",
                         [("native", KeyError), ("numpy", IndexError)])
def test_gather_bad_key_and_index(tmp_path, rng, reader, bad_index_error):
    videos = _sample_videos(rng, n=2)
    path = str(tmp_path / "feats.lstcpack")
    write_pack(path, videos)
    store = _store(path, reader)
    with pytest.raises(KeyError):
        store.gather("nope", np.array([0]), 2)
    with pytest.raises(bad_index_error):
        store.gather(videos[0][0], np.array([10**6]), 2)
    store.close()


def test_pack_h5_and_the_pack_subcommand_write_the_jax_file(tmp_path):
    h5_path, _, _, _ = make_sht_like(str(tmp_path), n_patch=4, d_model=8)
    ours, cmd, theirs, theirs_fn = (str(tmp_path / f"{n}.lstcpack") for n in
                                    ("ours", "cmd", "theirs", "theirs_fn"))
    pack_h5(h5_path, ours)
    assert cli.main(["pack", "--h5", h5_path, "--out", cmd]) == 0
    assert jax_main(["pack", "--h5", h5_path, "--out", theirs]) == 0
    jax_pack_h5(h5_path, theirs_fn)
    for path in (cmd, theirs, theirs_fn):
        assert filecmp.cmp(ours, path, shallow=False), path
    import h5py

    store = PackedStore(ours, use_native=False)
    with h5py.File(h5_path, "r") as h5:
        for name in h5.keys():
            np.testing.assert_array_equal(store.get(name[:-4]), h5[name][:])


@pytest.mark.parametrize("reader", READERS)
def test_packs_are_byte_identical_and_cross_readable(tmp_path, rng, reader):
    videos = _sample_videos(rng, n=4) + [
        ("empty", np.zeros((0, 4, 8), np.float32)),
        ("wide", rng.standard_normal((3, 2, 16)).astype(np.float32))]
    ours, theirs = (str(tmp_path / f"{n}.lstcpack") for n in ("ours", "j"))
    write_pack(ours, videos)
    jax_write_pack(theirs, videos)
    assert filecmp.cmp(ours, theirs, shallow=False)
    port_reads_jax = _store(theirs, reader)
    jax_reads_port = JaxPackedStore(ours, use_native=reader == "native")
    for key, feat in videos:
        np.testing.assert_array_equal(port_reads_jax.get(key), feat)
        np.testing.assert_array_equal(jax_reads_port.get(key), feat)
    port_reads_jax.close()
    jax_reads_port.close()


@pytest.mark.parametrize("reader", READERS)
def test_packed_store_in_dataset(tmp_path, reader):
    h5_path, train_txt, _, _ = make_sht_like(str(tmp_path), n_patch=4,
                                             d_model=16, n_clips=(14, 30))
    pack_path = str(tmp_path / "ds.lstcpack")
    pack_h5(h5_path, pack_path)
    records = load_train_records("SHT", train_txt)
    ds = PairedTrainDataset(records, _store(pack_path, reader), part_num=4,
                            part_len=3, n_patch=4, sample="uniform")
    nf, nl, af, al = ds[0]
    assert nf.shape == af.shape == (12, 4, 16)
    assert nf.dtype == np.float32 and nl.shape == (12,)


def _stack(items):
    return tuple(np.stack([it[j] for it in items]) for j in range(4))


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("sample", ["uniform", "random"])
def test_batches_from_a_pack_equal_jax(tmp_path, reader, sample):
    """get_batch, the per-item gather path and BatchIterator over a pack are
    bit-equal to the JAX dataset over the JAX PackedStore, over three
    epochs (reshuffled in between), with pseudo labels."""
    h5_path, train_txt, _, _ = make_sht_like(str(tmp_path), n_patch=6,
                                             d_model=16, n_clips=(14, 30))
    pack_path = str(tmp_path / "fp.lstcpack")
    pack_h5(h5_path, pack_path)
    records = load_train_records("SHT", train_txt)
    rng = np.random.default_rng(3)
    pseudo = {r.key + ".npy": rng.random(_store(pack_path, "numpy")
                                         .n_clips(r.key)).astype(np.float32)
              for r in records}
    kw = dict(part_num=4, part_len=3, n_patch=4, sample=sample, seed=7,
              pseudo_labels=pseudo)
    import lstc_vad_tpu.data.datasets as jax_datasets

    jax_records = jax_datasets.load_train_records("SHT", train_txt)
    jax_ds = JaxPairedTrainDataset(jax_records, JaxPackedStore(pack_path),
                                   **kw)
    fast = PairedTrainDataset(records, _store(pack_path, reader), **kw)
    per_item = PairedTrainDataset(records, _store(pack_path, reader), **kw)
    through_iter = PairedTrainDataset(records, _store(pack_path, reader),
                                      **kw)
    calls = []
    get_batch = through_iter.get_batch
    through_iter.get_batch = lambda a, b: calls.append((a, b)) or \
        get_batch(a, b)
    for _ in range(3):
        want = jax_ds.get_batch(0, 2)
        got_fast = fast.get_batch(0, 2)
        got_items = _stack([per_item[i] for i in range(2)])
        (got_iter,) = list(BatchIterator(through_iter, 2))
        for got in (got_fast, got_items, got_iter):
            assert len(got) == 4
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        for ds in (jax_ds, fast, per_item, through_iter):
            ds.shuffle_keys()
    assert calls == [(0, 2)] * 3  # BatchIterator took the fast path
    # JAX's own per-item path over its pack agrees too
    assert len(list(JaxBatchIterator(jax_ds, 2))) == 1


# ------------------------------------------------------------ corruption
# A corrupt pack must be a clean Python exception at PackedStore
# construction — never a native segfault or out-of-bounds read.


def _expect_format_error(path, reader):
    with pytest.raises(PackFormatError):
        PackedStore(path, use_native=reader == "native")


@pytest.mark.parametrize("reader", READERS)
def test_truncation_fuzz(tmp_path, rng, reader):
    path = _write_sample_pack(tmp_path, rng)
    data = open(path, "rb").read()
    index_offset, = struct.unpack_from("<Q", data, 12)
    cuts = sorted({0, 1, 7, 8, 12, 19, 20, len(data) - 1,
                   index_offset - 1, index_offset,
                   *range(index_offset + 1, min(index_offset + 30,
                                                len(data))),
                   *np.linspace(21, len(data) - 2, 15).astype(int).tolist()})
    for cut in cuts:
        trunc = str(tmp_path / "trunc.lstcpack")
        with open(trunc, "wb") as f:
            f.write(data[:cut])
        _expect_format_error(trunc, reader)


@pytest.mark.parametrize("reader", READERS)
def test_corrupt_fields_rejected(tmp_path, rng, reader):
    path = _write_sample_pack(tmp_path, rng)
    data = bytearray(open(path, "rb").read())
    index_offset, = struct.unpack_from("<Q", data, 12)
    key_len = struct.unpack_from("<I", data, index_offset)[0]
    mutations = [
        lambda b: b.__setitem__(slice(0, 8), b"XXXXXXXX"),        # magic
        lambda b: struct.pack_into("<Q", b, 12, len(data) + 50),  # index ptr
        lambda b: struct.pack_into("<I", b, index_offset, 2**31),  # key_len
        lambda b: struct.pack_into("<I", b, index_offset + 4 + key_len + 8,
                                   2**32 - 1),                    # huge clips
        lambda b: struct.pack_into("<Q", b, index_offset + 4 + key_len,
                                   len(data) * 2),                # bad offset
    ]
    for mutate in mutations:
        buf = bytearray(data)
        mutate(buf)
        bad = str(tmp_path / "mut.lstcpack")
        with open(bad, "wb") as f:
            f.write(buf)
        _expect_format_error(bad, reader)


@pytest.mark.parametrize("reader", READERS)
def test_overflowing_extent_rejected(tmp_path, reader):
    """n_clips = n_patch = d_model = 2^32-1: the byte count overflows 64
    bits and must not wrap around the extent check."""
    key = b"evil"
    header = b"LSTCPK01" + struct.pack("<I", 1) + struct.pack("<Q", 20)
    entry = (struct.pack("<I", len(key)) + key +
             struct.pack("<QIII", 20, 2**32 - 1, 2**32 - 1, 2**32 - 1))
    path = str(tmp_path / "evil.lstcpack")
    with open(path, "wb") as f:
        f.write(header + entry)
    _expect_format_error(path, reader)


@pytest.mark.parametrize("reader", READERS)
def test_empty_and_tiny_files_rejected(tmp_path, reader):
    for content in (b"", b"LST", b"LSTCPK01"):
        path = str(tmp_path / f"tiny{len(content)}.lstcpack")
        with open(path, "wb") as f:
            f.write(content)
        _expect_format_error(path, reader)


@pytest.mark.parametrize("reader", READERS)
def test_random_corruption_fuzz(tmp_path, rng, reader):
    """200 random corruptions of 1-8 bytes: the store opens and serves
    every key at its shape, or raises PackFormatError / KeyError."""
    path = _write_sample_pack(tmp_path, rng)
    data = open(path, "rb").read()
    for _ in range(200):
        buf = bytearray(data)
        pos = int(rng.integers(0, len(buf)))
        for off in range(int(rng.integers(1, 9))):
            if pos + off < len(buf):
                buf[pos + off] ^= int(rng.integers(1, 256))
        bad = str(tmp_path / "fuzz.lstcpack")
        with open(bad, "wb") as f:
            f.write(buf)
        try:
            store = PackedStore(bad, use_native=reader == "native")
        except PackFormatError:
            continue
        try:
            for key in store.keys():
                assert store.get(key).shape == store.shape(key)
        except (PackFormatError, KeyError):
            pass  # a flipped key byte renames an entry
        finally:
            store.close()


@pytest.mark.parametrize("reader,error,match", [
    ("native", RuntimeError, "rc=-4"), ("numpy", ValueError, "broadcast")])
def test_gather_batch_rejects_heterogeneous_d_model(tmp_path, rng, reader,
                                                    error, match):
    videos = [("a", rng.standard_normal((5, 4, 8)).astype(np.float32)),
              ("b", rng.standard_normal((5, 4, 16)).astype(np.float32))]
    path = str(tmp_path / "het.lstcpack")
    write_pack(path, videos)
    store = _store(path, reader)
    with pytest.raises(error, match=match):
        store.gather_batch(["a", "b"], np.zeros((2, 3), np.int64),
                           n_patch_out=4, d_model=8)
    store.close()


def test_ps_err_io_degrades_to_numpy(tmp_path, rng, monkeypatch):
    """PS_ERR_IO (fd limit, mmap exhaustion) on a pack the numpy reader has
    validated degrades to numpy; a format code raises."""
    path = _write_sample_pack(tmp_path, rng)

    class _IOFailLib:
        def ps_open_checked(self, _path, err_ref):
            err_ref._obj.value = 1  # PS_ERR_IO
            return None

    monkeypatch.setattr(pk, "_load_lib", lambda: _IOFailLib())
    store = pk.PackedStore(path)
    assert store.native is False
    assert store.get("vid_00").shape == store._np.view("vid_00").shape

    class _FormatFailLib:
        def ps_open_checked(self, _path, err_ref):
            err_ref._obj.value = 3  # PS_ERR_INDEX: a real disagreement
            return None

    monkeypatch.setattr(pk, "_load_lib", lambda: _FormatFailLib())
    with pytest.raises(PackFormatError, match="code 3"):
        pk.PackedStore(path)


@pytest.mark.parametrize("reader", READERS)
def test_tencrop_n_clips_total_size_based(tmp_path, reader):
    n, p, d = 6, 4, 8
    stacked = np.arange(10 * n * p * d, dtype=np.float32).reshape(
        10 * n, p, d)
    folded = np.arange(n * 10 * p * d, dtype=np.float32).reshape(
        n, 10 * p, d)
    path = str(tmp_path / "tc.lstcpack")
    write_pack(path, [("stacked", stacked), ("folded", folded)])
    store = _store(path, reader, ten_crop=True, n_patch=p, d_model=d)
    for key in ("stacked", "folded"):
        assert store.n_clips(key) == n
        assert store.get(key).shape == (n, 10, p, d)
        np.testing.assert_array_equal(
            store.get(key, crop=3),
            store.get(key).reshape(n, 10, p, d)[:, 3])
    store.close()


@pytest.mark.parametrize("reader", READERS)
def test_duplicate_key_pack_rejected(tmp_path, rng, reader):
    feat_a = rng.standard_normal((9, 4, 8)).astype(np.float32)
    feat_b = rng.standard_normal((2, 4, 8)).astype(np.float32)
    path = str(tmp_path / "dup.lstcpack")
    with pytest.raises(ValueError, match="duplicate key"):
        write_pack(path, [("v", feat_a), ("v", feat_b)])
    # forge one: two keys of equal length, the second renamed in the index
    write_pack(path, [("va", feat_a), ("vb", feat_b)])
    raw = bytearray(open(path, "rb").read())
    index_offset, = struct.unpack_from("<Q", bytes(raw[:20]), 12)
    at = raw.index(b"vb", index_offset)
    raw[at:at + 2] = b"va"
    open(path, "wb").write(bytes(raw))
    with pytest.raises(PackFormatError, match="duplicate key"):
        PackedStore(path, use_native=reader == "native")
    if reader == "native":
        # the native validator rejects it too, the numpy layer bypassed
        lib = pk._load_lib()
        err = ctypes.c_int32(0)
        assert not lib.ps_open_checked(path.encode(), ctypes.byref(err))
        assert err.value == 5  # PS_ERR_DUPKEY


# ------------------------------------------------------------ the build


def test_native_build_failure_raises_with_the_compiler_output(
        tmp_path, rng, monkeypatch):
    """No quiet fallback: with use_native=True a reader that does not build
    raises, naming the compiler's complaint."""
    path = _write_sample_pack(tmp_path, rng)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "CXX_FLAGS",
                        (*_build.CXX_FLAGS, "-fno-such-option-anywhere"))
    with pytest.raises(RuntimeError, match="no-such-option"):
        PackedStore(path)
    assert PackedStore(path, use_native=False).native is False


def test_reader_library_has_its_own_digest(tmp_path, monkeypatch):
    """The reader's library is named by a hash of its own source and flags:
    editing it rebuilds it, and leaves the attention library's name (a
    hash of the .cu sources) as it was."""
    before = {n: _build.library_path(n).name for n in _build.SOURCES}
    assert before["packstore"].startswith("libpackstore-")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC_DIR.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    with open(csrc / "packstore.cpp", "a") as f:
        f.write("\n// edited\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    after = {n: _build.library_path(n).name for n in _build.SOURCES}
    assert after["attention"] == before["attention"]
    assert after["packstore"] != before["packstore"]
