"""The port's data path (gdkvm_tpu_torch.data) against the JAX package's,
on the CPU: the on-disk loaders and the batch iterator bitwise on files the
tests write, the prefetcher's contract, and the device cache's semantics
(its draws are torch's, so the tests hold what a batch is, not its bits).
"""

import dataclasses
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from gdkvm_tpu.data import camus as jcamus
from gdkvm_tpu.data import camus_raw as jraw
from gdkvm_tpu.data import echonet as jechonet
from gdkvm_tpu.data import packed as jpacked
from gdkvm_tpu.data import pipeline as jpipeline
from gdkvm_tpu.eval import parity as jparity
from gdkvm_tpu_torch.config.schema import DataConfig, ts8_256
from gdkvm_tpu_torch.data import camus, camus_raw, echonet, packed, pipeline
from gdkvm_tpu_torch.data import device_cache as dc
from gdkvm_tpu_torch.data.synthetic import SyntheticDataset
from gdkvm_tpu_torch.eval import parity

torch.set_num_threads(1)


def _same_items(ds, ds_j):
    assert len(ds) == len(ds_j) > 0
    for i in range(len(ds)):
        for a, b in zip(ds[i], ds_j[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _same_batches(it, it_j, n):
    for _ in range(n):
        b, b_j = next(it), next(it_j)
        for name in ("frames", "masks", "valid"):
            np.testing.assert_array_equal(getattr(b, name), getattr(b_j, name))


@pytest.fixture(scope="module")
def camus_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("camus"))
    camus.materialize_synthetic_camus(root, num_train=5, num_val=3, image_size=32,
                                      clip_len=4, difficulty=0.5, seed=2)
    return root


@pytest.fixture(scope="module")
def pck_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pck"))
    ds = SyntheticDataset(num_clips=7, clip_len=3, image_size=32, num_classes=4, seed=5)
    packed.write_pck(os.path.join(root, "train.pck"), ds)
    jpacked.write_pck(os.path.join(root, "train_j.pck"), ds)
    return root


# ---------------------------------------------------------------- loaders


def test_camus_materializer_and_loader_match_jax(camus_root, tmp_path):
    """The port's materializer writes the files the JAX package's writes,
    and the two loaders read them to identical arrays, resized or not."""
    jcamus.materialize_synthetic_camus(str(tmp_path), num_train=5, num_val=3,
                                       image_size=32, clip_len=4, difficulty=0.5, seed=2)
    for split in ("train", "val"):
        for size in (32, 24):
            kw = dict(split=split, image_size=size, clip_len=4, num_classes=4)
            ds = camus.CamusDataset(camus_root, **kw)
            _same_items(ds, jcamus.CamusDataset(camus_root, **kw))
            _same_items(ds, jcamus.CamusDataset(str(tmp_path), **kw))
            assert ds.spacing(0) == jcamus.CamusDataset(camus_root, **kw).spacing(0)
    f, m, v = camus.CamusDataset(camus_root, image_size=32, clip_len=4)[0]
    assert f.shape == (4, 32, 32, 1) and m.shape == (4, 32, 32) and v.tolist() == [1.0] * 4
    with pytest.raises(FileNotFoundError, match="CAMUS split directory"):
        camus.CamusDataset(camus_root, split="test")


def test_camus_missing_masks_are_invalid(camus_root, tmp_path):
    """Frames without a mask file get valid 0 and a zero mask, as in JAX."""
    import shutil
    root = str(tmp_path / "c")
    shutil.copytree(camus_root, root)
    clip = sorted(os.listdir(os.path.join(root, "train")))[0]
    os.remove(os.path.join(root, "train", clip, "mask_02.png"))
    ds = camus.CamusDataset(root, image_size=32, clip_len=4)
    _same_items(ds, jcamus.CamusDataset(root, image_size=32, clip_len=4))
    assert ds[0][2].tolist() == [1.0, 1.0, 0.0, 1.0] and not ds[0][1][2].any()


def test_packed_matches_jax(pck_root):
    """write_pck writes the JAX package's bytes; items and gathers (with
    flips) are equal; the dataset says which gather it took."""
    a, b = (open(os.path.join(pck_root, n), "rb").read() for n in ("train.pck", "train_j.pck"))
    assert a == b
    ds = packed.PackedDataset(os.path.join(pck_root, "train.pck"), num_workers=2)
    ds_j = jpacked.PackedDataset(os.path.join(pck_root, "train.pck"), num_workers=2)
    assert ds.native_gather == (ds_j._native is not None)
    _same_items(ds, ds_j)
    idx, flips = np.array([6, 0, 3, 3]), np.array([1, 0, 1, 0], np.uint8)
    for got, want in zip(ds.gather(idx, flips), ds_j.gather(idx, flips)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(IndexError):
        ds.gather(np.array([7]))
    with pytest.raises(FileNotFoundError, match="write_pck"):
        packed.PackedDataset(os.path.join(pck_root, "none.pck"))


def test_packed_numpy_gather_equals_native(pck_root, monkeypatch):
    """Without the shared library the mmap gather returns the same bytes."""
    path = os.path.join(pck_root, "train.pck")
    native = packed.PackedDataset(path)
    monkeypatch.setattr(packed, "_lib", None)
    monkeypatch.setattr(packed, "_lib_tried", True)
    plain = packed.PackedDataset(path)
    assert plain.native_gather is False
    idx, flips = np.array([1, 5, 2]), np.array([0, 1, 1], np.uint8)
    for got, want in zip(plain.gather(idx, flips), native.gather(idx, flips)):
        np.testing.assert_array_equal(got, want)
    assert (len(plain), plain.clip_len, plain.height, plain.width) == (7, 3, 32, 32)


def _write_raw(root, writer):
    rng = np.random.default_rng(0)
    for pat in ("patient0001", "patient0002", "patient0451"):
        os.makedirs(os.path.join(root, pat))
        for view in ("2CH", "4CH"):
            t = int(rng.integers(12, 18))
            vol = rng.integers(0, 255, (t, 40, 30), np.uint8)
            gt = rng.integers(0, 4, (t, 40, 30), np.uint8)
            base = os.path.join(root, pat, f"{pat}_{view}_half_sequence")
            writer(base + ".mhd", vol, spacing=(0.3, 0.15, 1.0))
            writer(base + "_gt.mhd", gt)


def test_camus_raw_matches_jax(tmp_path):
    """write_mhd/read_mhd round-trip as the JAX package's, and the raw
    converter writes the same processed layout."""
    raw, raw_j = str(tmp_path / "raw"), str(tmp_path / "raw_j")
    _write_raw(raw, camus_raw.write_mhd)
    _write_raw(raw_j, jraw.write_mhd)
    seq = "patient0001/patient0001_2CH_half_sequence.mhd"
    vol, hdr = camus_raw.read_mhd(os.path.join(raw, seq))
    vol_j, hdr_j = jraw.read_mhd(os.path.join(raw_j, seq))
    np.testing.assert_array_equal(vol, vol_j)
    assert hdr == hdr_j and camus_raw.element_spacing(hdr) == (0.3, 0.15, 1.0)
    for mode in ("random", "official"):
        out, out_j = str(tmp_path / f"out_{mode}"), str(tmp_path / f"out_j_{mode}")
        kw = dict(image_size=24, clip_len=5, split_mode=mode, seed=1)
        assert camus_raw.convert_raw_camus(raw, out, **kw) == \
            jraw.convert_raw_camus(raw_j, out_j, **kw) == 6
        assert sorted(os.listdir(out)) == sorted(os.listdir(out_j))
        for split in os.listdir(out):
            kw = dict(split=split, image_size=24, clip_len=5)
            ds, ds_j = camus.CamusDataset(out, **kw), jcamus.CamusDataset(out_j, **kw)
            assert ds.clips == ds_j.clips
            _same_items(ds, ds_j)
            assert ds.spacing(0) == ds_j.spacing(0) is not None
    for pat in ("patient0001", "patient0400", "patient0401", "patient0450", "patient0500"):
        assert camus_raw.official_camus_split(pat) == jraw.official_camus_split(pat)
        assert camus_raw.camus_fold(pat, 10) == jraw.camus_fold(pat, 10)
    with pytest.raises(ValueError, match="split_mode"):
        camus_raw.convert_raw_camus(raw, str(tmp_path / "x"), split_mode="bogus")


@pytest.fixture(scope="module")
def echo_root(tmp_path_factory):
    pytest.importorskip("cv2")
    root = str(tmp_path_factory.mktemp("echo"))
    echonet.materialize_synthetic_echonet(root, num_train=3, num_val=2, num_frames=12,
                                          image_size=32, fps_cycle=(30.0, 50.0))
    return root


def test_echonet_matches_jax(echo_root, tmp_path):
    """The materializer writes the JAX package's CSV files and videos; the
    loaders decode the same videos, masks and (same seed) random clips."""
    jechonet.materialize_synthetic_echonet(str(tmp_path), num_train=3, num_val=2,
                                           num_frames=12, image_size=32,
                                           fps_cycle=(30.0, 50.0))
    for name in ("FileList.csv", "VolumeTracings.csv"):
        assert open(os.path.join(echo_root, name)).read() == \
            open(os.path.join(str(tmp_path), name)).read()
    for split, n in (("train", 3), ("val", 2)):
        kw = dict(split=split, image_size=32, clip_len=4, num_classes=2, seed=3)
        ds, ds_j = echonet.EchoNetDataset(echo_root, **kw), jechonet.EchoNetDataset(echo_root, **kw)
        ds_m = jechonet.EchoNetDataset(str(tmp_path), **kw)
        assert ds.videos == ds_j.videos and len(ds) == n and ds.stochastic_items
        for i in range(n):
            for a, b, c in zip(ds.full_video(i), ds_j.full_video(i), ds_m.full_video(i)):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)
        _same_items(ds, ds_j)          # the same generator draws the same windows
    with pytest.raises(FileNotFoundError, match="FileList.csv"):
        echonet.EchoNetDataset(str(tmp_path / "none"))


def test_trace_fill_and_ef_match_jax():
    """_fill_trace_mask, lv_volume_area_length and beatwise_ef against the
    JAX package's on seeded tracings, masks and volume traces."""
    rng = np.random.default_rng(0)
    ys = np.linspace(5, 25, 9)
    x1, x2 = 12 - rng.random(9) * 4, 18 + rng.random(9) * 4
    got = echonet._fill_trace_mask(x1, ys, x2, ys, (32, 32))
    np.testing.assert_array_equal(got, jechonet._fill_trace_mask(x1, ys, x2, ys, (32, 32)))
    assert got.sum() > 50
    for spacing in (None, (0.6, 0.4)):
        assert parity.lv_volume_area_length(got, spacing) == \
            jparity.lv_volume_area_length(got, spacing) > 0
    assert parity.lv_volume_area_length(np.zeros((8, 8), np.uint8)) == 0.0
    vols = 100 + 30 * np.cos(np.arange(90) * 2 * np.pi / 30) + rng.random(90)
    for fps in (None, 30.0, 50.0):
        assert parity.beatwise_ef(vols, fps=fps) == jparity.beatwise_ef(vols, fps=fps)
    assert parity.beatwise_ef(vols[:10]) == jparity.beatwise_ef(vols[:10])


# ------------------------------------------------------------- the iterator


@pytest.mark.parametrize("kind", ["camus", "packed"])
def test_batch_iterator_matches_jax(kind, camus_root, pck_root):
    """Shuffled, augmented, occluded batches across epoch boundaries equal
    the JAX package's iterator's for the same seed: the thread-pool path
    (CAMUS PNGs) and the gather path (packed)."""
    if kind == "camus":
        ds = camus.CamusDataset(camus_root, image_size=32, clip_len=4)
        ds_j = jcamus.CamusDataset(camus_root, image_size=32, clip_len=4)
    else:
        ds = packed.PackedDataset(os.path.join(pck_root, "train.pck"), num_workers=2)
        ds_j = jpacked.PackedDataset(os.path.join(pck_root, "train.pck"), num_workers=2)
    kw = dict(shuffle=True, augment=True, occlude_prob=0.7, seed=9)
    _same_batches(pipeline.batch_iterator(ds, 2, num_workers=3, **kw),
                  jpipeline.batch_iterator(ds_j, 2, num_workers=1, **kw), 7)
    # start_step fast-forwards without touching data: the tail of the stream.
    straight = pipeline.batch_iterator(ds, 2, **kw)
    head = [next(straight) for _ in range(5)]
    _same_batches(pipeline.batch_iterator(ds, 2, start_step=5, **kw), straight, 3)
    _same_batches(pipeline.batch_iterator(ds, 2, start_step=3, **kw),
                  jpipeline.batch_iterator(ds_j, 2, start_step=3, **kw), 3)
    assert head[0].frames.dtype == np.uint8 and head[0].valid.dtype == np.float32


@pytest.mark.parametrize("kind", ["camus", "packed"])
def test_one_epoch_with_ragged_tail_matches_jax(kind, camus_root, pck_root):
    """loop=False, drop_last=False: one pass, the short last batch kept."""
    if kind == "camus":
        ds = camus.CamusDataset(camus_root, image_size=32, clip_len=4)
        ds_j = jcamus.CamusDataset(camus_root, image_size=32, clip_len=4)
    else:
        ds = packed.PackedDataset(os.path.join(pck_root, "train.pck"))
        ds_j = jpacked.PackedDataset(os.path.join(pck_root, "train.pck"))
    kw = dict(shuffle=False, augment=False, drop_last=False, loop=False)
    got = list(pipeline.batch_iterator(ds, 2, **kw))
    want = list(jpipeline.batch_iterator(ds_j, 2, **kw))
    assert [b.frames.shape[0] for b in got] == [b.frames.shape[0] for b in want]
    assert got[-1].frames.shape[0] == 1 and sum(b.frames.shape[0] for b in got) == len(ds)
    for b, b_j in zip(got, want):
        np.testing.assert_array_equal(b.frames, b_j.frames)
        np.testing.assert_array_equal(b.masks, b_j.masks)
    dropped = list(pipeline.batch_iterator(ds, 2, shuffle=False, loop=False))
    assert len(dropped) == len(got) - 1


def test_make_dataset_kinds(camus_root, pck_root, echo_root):
    """Every dataset kind of the JAX factory; the documented recipe's
    config reads a CAMUS layout at its data_path."""
    data = DataConfig(image_size=32, clip_len=4)
    mk = lambda **kw: pipeline.make_dataset(dataclasses.replace(data, **kw), "train", 4)
    assert isinstance(mk(dataset="camus", data_path=camus_root), camus.CamusDataset)
    assert isinstance(mk(dataset="packed", data_path=pck_root), packed.PackedDataset)
    assert isinstance(mk(dataset="echonet", data_path=echo_root), echonet.EchoNetDataset)
    assert isinstance(mk(dataset="synthetic"), SyntheticDataset)
    with pytest.raises(ValueError, match="unknown dataset"):
        mk(dataset="bogus")
    cfg = ts8_256(data_path=camus_root)
    cfg.data.clip_len = 4
    ds = pipeline.make_dataset(cfg.data, cfg.data.train_split, cfg.model.num_classes)
    assert len(ds) == 5 and ds[0][0].shape == (4, 256, 256, 1)
    val = pipeline.make_dataset(cfg.data, cfg.data.val_split, cfg.model.num_classes)
    assert len(val) == 3
    with pytest.raises(FileNotFoundError):
        pipeline.make_dataset(ts8_256().data, "train", 4)


# ------------------------------------------------------------ the prefetcher


def _tiny():
    return SyntheticDataset(num_clips=8, clip_len=2, image_size=16)


def test_prefetch_keeps_order_and_content():
    """Batches come out as tensors, in the iterator's order, ragged tail
    included; with a CPU device nothing else happens to them."""
    ds = SyntheticDataset(num_clips=5, clip_len=2, image_size=16)
    kw = dict(shuffle=True, augment=True, seed=3, loop=False, drop_last=False)
    want = list(pipeline.batch_iterator(ds, 2, **kw))
    got = list(pipeline.prefetch_to_device(pipeline.batch_iterator(ds, 2, **kw),
                                           size=2, device="cpu"))
    assert [b.frames.shape[0] for b in got] == [2, 2, 1]
    for g, w in zip(got, want):
        assert isinstance(g.frames, torch.Tensor) and g.frames.dtype == torch.uint8
        assert g.frames.device.type == "cpu" and g.valid.dtype == torch.float32
        np.testing.assert_array_equal(g.frames.numpy(), w.frames)
        np.testing.assert_array_equal(g.masks.numpy(), w.masks)
        np.testing.assert_array_equal(g.valid.numpy(), w.valid)


def test_prefetch_abandon_stops_producer():
    """Closing the generator mid-stream stops the producer thread and the
    iterator's pool."""
    pulled = []

    def source():
        for b in pipeline.batch_iterator(_tiny(), 2, loop=True, num_workers=1):
            pulled.append(1)
            yield b

    producers = lambda: [t for t in threading.enumerate()
                         if t.name == "prefetch_to_device" and t.is_alive()]
    deadline = time.time() + 5
    while producers() and time.time() < deadline:      # earlier tests' threads
        time.sleep(0.05)
    gen = pipeline.prefetch_to_device(source(), size=1, device="cpu")
    next(gen)
    assert len(producers()) == 1
    gen.close()
    deadline = time.time() + 5
    while producers() and time.time() < deadline:
        time.sleep(0.05)
    assert not producers()
    n = len(pulled)
    time.sleep(0.3)
    assert len(pulled) == n and n <= 4       # nothing is pulled after the close


def test_prefetch_raises_in_consumer():
    """An exception in the data thread surfaces at the consumer's next()."""
    def gen_boom():
        yield next(pipeline.batch_iterator(_tiny(), 2, loop=False, num_workers=1))
        raise RuntimeError("decode exploded")

    g = pipeline.prefetch_to_device(gen_boom(), size=2, device="cpu")
    next(g)
    with pytest.raises(RuntimeError, match="decode exploded"):
        next(g)


# ------------------------------------------------------------ the device cache


def _cache(image=32, clip_len=3, n=8):
    ds = SyntheticDataset(num_clips=n, clip_len=clip_len, image_size=image, num_classes=4)
    return dc.build_device_cache(ds, "cpu"), ds


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_cache_resolve_thresholds():
    ds = SyntheticDataset(num_clips=4, clip_len=2, image_size=16)
    data = DataConfig()
    assert dc.resolve_cache_mode(data, ds) == "clip"            # tiny: auto is on
    assert dc.resolve_cache_mode(dataclasses.replace(data, device_cache="off"), ds) == "off"
    assert dc.resolve_cache_mode(dataclasses.replace(data, device_cache="on"), ds) == "clip"
    assert dc.resolve_cache_mode(
        dataclasses.replace(data, device_cache_max_mb=0), ds) == "off"   # too big
    with pytest.raises(ValueError, match="auto|on|off"):
        dc.resolve_cache_mode(dataclasses.replace(data, device_cache="maybe"), ds)
    assert dc.dataset_nbytes(ds) == 4 * (2 * 16 * 16 * 2 + 2 * 4)


def test_cache_sample_is_an_exact_gather():
    cache, ds = _cache()
    b = dc.sample_batch(cache, _gen(3), 4, augment=False)
    assert b.frames.shape == (4, 3, 32, 32, 1) and b.frames.dtype == torch.uint8
    assert b.masks.shape == (4, 3, 32, 32) and b.valid.shape == (4, 3)
    host = np.stack([ds[i][0] for i in range(len(ds))])
    got = b.frames.numpy()
    for j in range(4):        # each sampled clip is some dataset clip, byte for byte
        assert any((got[j] == host[i]).all() for i in range(len(ds)))
    b2 = dc.sample_batch(cache, _gen(3), 4, augment=False)
    assert torch.equal(b.frames, b2.frames) and torch.equal(b.masks, b2.masks)
    b3 = dc.sample_batch(cache, _gen(4), 4, augment=False)
    assert not torch.equal(b.frames, b3.frames)


def test_cache_augment_flip_consistency_and_occlusion():
    cache, ds = _cache(clip_len=4)
    host_m = np.stack([ds[i][1] for i in range(len(ds))])
    b = dc.sample_batch(cache, _gen(7), 8, augment=True, occlude_prob=1.0)
    # The occlusion's draws come last: without it, the same clips and flips.
    plain = dc.sample_batch(cache, _gen(7), 8, augment=True, occlude_prob=0.0)
    f, m, f_plain = b.frames.numpy(), b.masks.numpy(), plain.frames.numpy()
    flips = 0
    for j in range(8):
        # The mask is some clip's mask or its W-flip: neither the photometric
        # jitter nor the occlusion touches masks.
        direct = [(m[j] == host_m[i]).all() for i in range(len(ds))]
        flipped = [(m[j] == host_m[i][:, :, ::-1]).all() for i in range(len(ds))]
        assert any(direct) or any(flipped), f"clip {j}: unknown mask"
        flips += any(flipped) and not any(direct)
        # occlude_prob=1: 1-4 consecutive frames t ≥ 1 have a blanked block
        # of 0.4-0.7 of each side; frame 0 never.
        blanked = ((f[j] == 0) & (f_plain[j] != 0)).reshape(4, -1).any(1)
        changed = (f[j] != f_plain[j]).reshape(4, -1).any(1)
        assert (blanked == changed).all() and not changed[0], f"clip {j}: {changed}"
        hit = np.flatnonzero(changed)
        assert 1 <= len(hit) <= 3 and (np.diff(hit) == 1).all(), f"clip {j}: {hit}"
        box = np.argwhere((f[j, hit[0], :, :, 0] != f_plain[j, hit[0], :, :, 0]))
        assert np.ptp(box[:, 0]) < 0.7 * 32 and np.ptp(box[:, 1]) < 0.7 * 32
    assert 0 < flips < 8, f"flip should be ~p=0.5, got {flips}/8"
    assert torch.equal(plain.masks, b.masks)        # the same flips and clips


def test_cache_frames_follow_their_masks():
    """A flipped clip's frames are flipped with its mask (no photometric
    jitter drawn: compare where the clip kept its bytes)."""
    cache, ds = _cache()
    host_f = np.stack([ds[i][0] for i in range(len(ds))])
    host_m = np.stack([ds[i][1] for i in range(len(ds))])
    hits = 0
    for seed in range(6):
        b = dc.sample_batch(cache, _gen(seed), 8, augment=True)
        for j in range(8):
            for i in range(len(ds)):
                for flip in (False, True):
                    fm = host_m[i][:, :, ::-1] if flip else host_m[i]
                    ff = host_f[i][:, :, ::-1] if flip else host_f[i]
                    if (b.masks[j].numpy() == fm).all() and (b.frames[j].numpy() == ff).all():
                        hits += 1
    assert hits >= 12          # about half of 48 clips keep their bytes


def test_cache_step_seed_is_a_pure_function_of_the_step():
    a = dc.step_seed((0, 17, 0, 5))
    assert a == dc.step_seed((0, 17, 0, 5)) and 0 <= a < 2 ** 64
    assert len({dc.step_seed((0, 17, 0, s)) for s in range(100)}) == 100
    assert dc.step_seed((0, 17, 1, 5)) != a != dc.step_seed((1, 17, 0, 5))


def test_cache_stochastic_dataset_is_not_snapshot():
    class FakeStochastic:
        stochastic_items = True
        def __len__(self): return 2
        def __getitem__(self, i):
            return (np.zeros((2, 8, 8, 1), np.uint8), np.zeros((2, 8, 8), np.uint8),
                    np.ones((2,), np.float32))

    ds, data = FakeStochastic(), DataConfig()
    assert dc.resolve_cache_mode(data, ds) == "off"
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert dc.resolve_cache_mode(dataclasses.replace(data, device_cache="on"), ds) == "clip"
        assert any("FREEZES" in str(x.message) for x in w)


def test_video_cache_windows(echo_root):
    """Windows are in-bounds contiguous slices of real videos, anchored to
    a traced frame, and a pure function of the generator's seed."""
    ds = echonet.EchoNetDataset(echo_root, "train", image_size=32, clip_len=4)
    assert dc.resolve_cache_mode(DataConfig(), ds) == "video"
    assert dc.video_nbytes_estimate(ds) >= 3 * 12 * 32 * 32 * 2
    cache = dc.build_video_cache(ds, 4, "cpu")
    assert cache.frames.shape[0] == 3 and cache.frames.shape[1] >= 12
    assert cache.length.tolist() == [12, 12, 12] and cache.n_traced.tolist() == [2, 2, 2]
    full = [ds.full_video(i) for i in range(len(ds))]
    for seed in range(3):
        b = dc.sample_video_batch(cache, _gen(seed), 6, 4, augment=False)
        assert b.frames.shape == (6, 4, 32, 32, 1) and b.masks.shape == (6, 4, 32, 32)
        assert (b.valid.sum(1) >= 1).all(), b.valid       # the anchor bias
        f = b.frames.numpy()
        for j in range(6):
            assert any((f[j] == vf[s:s + 4]).all() for vf, _, _ in full
                       for s in range(vf.shape[0] - 3)), f"window {j} is no video slice"
    b2 = dc.sample_video_batch(cache, _gen(0), 6, 4)
    b0 = dc.sample_video_batch(cache, _gen(0), 6, 4)
    assert torch.equal(b0.frames, b2.frames)
    assert not torch.equal(dc.sample_video_batch(cache, _gen(1), 6, 4).frames, b0.frames)
    aug = dc.sample_video_batch(cache, _gen(0), 6, 4, augment=True, occlude_prob=1.0)
    assert aug.frames.shape == b0.frames.shape and torch.equal(aug.valid, b0.valid)


def test_video_cache_over_budget_returns_none(echo_root):
    ds = echonet.EchoNetDataset(echo_root, "train", image_size=32, clip_len=4)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert dc.build_video_cache(ds, 4, "cpu", max_bytes=1000) is None
        assert any("exceeds" in str(x.message) for x in w)
    assert dc.build_video_cache(ds, 4, "cpu", max_bytes=10 ** 9) is not None
    # A video shorter than the clip is tiled up to it.
    short = dc.build_video_cache(ds, 16, "cpu")
    assert short.frames.shape[1] == 16 and short.length.tolist() == [16] * 3
