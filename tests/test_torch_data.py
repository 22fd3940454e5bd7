"""``gluon.data``: the port against the JAX package on the CPU.

Datasets (``ArrayDataset``, ``transform``/``transform_first``, ``shard``,
``take``, ``filter``) and the samplers; the ``DataLoader`` with 0 and 2
workers gives the JAX package's batches in its order under one
``np.random.seed``; a worker's exception surfaces at its batch; the
batches are made on the consumer's thread, in its context; the vision
datasets (``synthetic=N``, and MNIST's idx files and CIFAR's binary
batches written here); every transform against the JAX one, the random
ones under the same numpy seed.  ``Resize`` matches ``jax.image.resize``
on odd sizes, on a downscale by a non-integer factor and on an upscale.
"""
import gzip
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.data.vision import transforms as jtf
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.gluon import data as gdata
from mxnet_tpu_torch.gluon.data.vision import transforms as ttf

CPU = mx.cpu()
JCPU = jmx.cpu()
RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _assert_same(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w, rtol, atol)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g.astype("f8"), w.astype("f8"), rtol=rtol,
                               atol=atol)


X = np.random.RandomState(0).rand(23, 3).astype("f4")
Y = np.arange(23, dtype="f4")


# -- datasets and samplers -------------------------------------------------------

DATASET_CASES = {
    "array_dataset": lambda pkg, ctx: [
        pkg.gluon.data.ArrayDataset(X, Y)[i] for i in (0, 7, 22)],
    "single_array": lambda pkg, ctx: [
        pkg.gluon.data.ArrayDataset(X)[5]],
    "ndarray_members": lambda pkg, ctx: list(
        pkg.gluon.data.ArrayDataset(pkg.nd.array(X, ctx=ctx),
                                    pkg.nd.array(Y, ctx=ctx))[4]),
    "transform_first": lambda pkg, ctx: list(
        pkg.gluon.data.ArrayDataset(X, Y).transform_first(
            lambda x: x * 2)[3]),
    "transform_lazy_and_eager": lambda pkg, ctx: [
        list(pkg.gluon.data.ArrayDataset(X, Y).transform(
            lambda x, y: (x + y, y), lazy=lazy)[9]) for lazy in (True,
                                                                 False)],
    "shard": lambda pkg, ctx: [
        [len(pkg.gluon.data.SimpleDataset(list(range(23))).shard(4, i)),
         pkg.gluon.data.SimpleDataset(list(range(23))).shard(4, i)[0]]
        for i in range(4)],
    "take_filter": lambda pkg, ctx: [
        len(pkg.gluon.data.SimpleDataset(list(range(23))).take(5)),
        list(pkg.gluon.data.SimpleDataset(list(range(23))).filter(
            lambda v: v % 3 == 0))],
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_datasets_match_jax(case):
    want = DATASET_CASES[case](jmx, JCPU)
    got = DATASET_CASES[case](mx, CPU)
    _assert_same(got, want)


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_match_jax(last_batch):
    def run(pkg):
        d = pkg.gluon.data
        np.random.seed(3)
        out = [list(d.SequentialSampler(5, start=2)),
               [int(i) for i in d.RandomSampler(11)]]
        bs = d.BatchSampler(d.RandomSampler(11), 4, last_batch)
        for _ in range(2):
            out.append([[int(i) for i in b] for b in bs])
        out.append(len(bs))
        return out
    assert run(mx) == run(jmx)


# -- the DataLoader -----------------------------------------------------------------

class _Samples(object):
    """A dataset of numpy samples and labels."""

    def __init__(self, n=37, fail_at=None):
        rng = np.random.RandomState(1)
        self.x = rng.rand(n, 2, 3).astype("f4")
        self.y = rng.randint(0, 5, n).astype("int32")
        self.fail_at = fail_at

    def __len__(self):
        return len(self.y)

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError(f"bad sample {i}")
        return self.x[i], self.y[i]


def _loader_batches(pkg, ctx, workers, **kw):
    np.random.seed(11)
    loader = pkg.gluon.data.DataLoader(_Samples(), batch_size=8,
                                       shuffle=True, num_workers=workers,
                                       **kw)
    with ctx:
        return [[b.asnumpy() for b in batch] for batch in loader]


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("last_batch", ["keep", "discard"])
def test_loader_order_matches_jax(workers, last_batch):
    want = _loader_batches(jmx, JCPU, workers, last_batch=last_batch)
    got = _loader_batches(mx, CPU, workers, last_batch=last_batch)
    assert len(got) == len(want) == (5 if last_batch == "keep" else 4)
    for g, w in zip(got, want):
        assert [a.dtype for a in g] == [a.dtype for a in w]
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_loader_prefetch_to_a_cpu_context_gives_the_same_batches():
    want = _loader_batches(mx, CPU, 2)
    got = _loader_batches(mx, CPU, 2, prefetch_to_device=CPU)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("workers", [0, 2])
def test_worker_exception_surfaces_at_its_batch(workers):
    loader = gdata.DataLoader(_Samples(fail_at=19), batch_size=8,
                              num_workers=workers)
    seen = 0
    with CPU, pytest.raises(ValueError, match="bad sample 19"):
        for _ in loader:
            seen += 1
    assert seen == 2        # batches 0 and 1; sample 19 is in batch 2


class _Slow(_Samples):
    """Python work in every fetch, so the workers switch often."""

    def __getitem__(self, i):
        x, y = super().__getitem__(i)
        return float(sum(range(200))) * 0 + x, y


def test_many_workers_keep_every_sample_in_order():
    """Twice as many workers as cores and a tiny switch interval: every
    batch arrives complete, in the sampler's order."""
    import os
    import sys
    ds = _Slow(n=203)
    workers = 2 * (os.cpu_count() or 8)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        loader = gdata.DataLoader(ds, batch_size=7, num_workers=workers,
                                  prefetch=2 * workers, timeout=60)
        with CPU:
            batches = [[b.asnumpy() for b in batch] for batch in loader]
    finally:
        sys.setswitchinterval(old)
    np.testing.assert_array_equal(np.concatenate([b[0] for b in batches]),
                                  ds.x)
    np.testing.assert_array_equal(np.concatenate([b[1] for b in batches]),
                                  ds.y)


class _Counted(_Samples):
    """Samples that take 10 ms each, counted."""

    def __init__(self, n):
        super().__init__(n)
        self.fetched = 0

    def __getitem__(self, i):
        import time
        time.sleep(0.01)
        self.fetched += 1
        return super().__getitem__(i)


def test_stopping_early_cancels_the_queued_fetches():
    """A consumer that stops after one batch leaves the 49 batches queued
    behind it unfetched (one worker: no lost update on the count)."""
    ds = _Counted(n=100)
    loader = gdata.DataLoader(ds, batch_size=2, num_workers=1, prefetch=50)
    it = iter(loader)
    with CPU:
        next(it)
    it.close()
    loader._pool.shutdown(wait=True)
    assert ds.fetched < 20, ds.fetched


def test_batchify_runs_on_the_consumer_thread_in_its_context():
    import threading
    threads = []

    def batchify(samples):
        threads.append(threading.current_thread())
        return gdata.dataloader.default_batchify_fn(samples)
    loader = gdata.DataLoader(_Samples(), batch_size=8, num_workers=2,
                              batchify_fn=batchify)
    with CPU:
        batches = list(loader)
    assert set(threads) == {threading.current_thread()}
    assert all(b.context == CPU for batch in batches for b in batch)
    assert len(loader) == 5


def test_loader_argument_checks():
    with pytest.raises(ValueError, match="batch_size"):
        gdata.DataLoader(_Samples())
    with pytest.raises(ValueError, match="shuffle"):
        gdata.DataLoader(_Samples(), 4, shuffle=True,
                         sampler=gdata.SequentialSampler(3))
    with pytest.raises(ValueError, match="batch_sampler"):
        gdata.DataLoader(_Samples(), 4, batch_sampler=gdata.BatchSampler(
            gdata.SequentialSampler(3), 2))


# -- vision datasets ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST", "CIFAR10",
                                  "CIFAR100"])
@pytest.mark.parametrize("train", [True, False])
def test_synthetic_vision_datasets_match_jax(name, train):
    def run(pkg):
        ds = getattr(pkg.gluon.data.vision, name)(train=train, synthetic=40)
        with (JCPU if pkg is jmx else CPU):
            return len(ds), [_np(v) for i in (0, 17, 39) for v in ds[i]]
    (jn, jw), (tn, tw) = run(jmx), run(mx)
    assert tn == jn == 40
    for g, w in zip(tw, jw):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _write_mnist(root, n, gz):
    rng = np.random.RandomState(9)
    images = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    with opener(str(root / f"train-images-idx3-ubyte{suffix}"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with opener(str(root / f"train-labels-idx1-ubyte{suffix}"), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return images, labels


@pytest.mark.parametrize("gz", [True, False])
def test_mnist_reads_idx_files(tmp_path, gz):
    images, labels = _write_mnist(tmp_path, 30, gz)
    want = jmx.gluon.data.vision.MNIST(root=str(tmp_path))
    got = gdata.vision.MNIST(root=str(tmp_path),
                             transform=lambda x, y: (x, y))
    assert len(got) == len(want) == 30
    with CPU:
        for i in (0, 29):
            x, y = got[i]
            np.testing.assert_array_equal(x.asnumpy(), images[i][..., None])
            np.testing.assert_array_equal(x.asnumpy(), want[i][0].asnumpy())
            assert y == labels[i] == want[i][1]
    with pytest.raises(mx.MXNetError, match="not found"):
        gdata.vision.MNIST(root=str(tmp_path), train=False)


def test_cifar10_reads_binary_batches(tmp_path):
    rng = np.random.RandomState(2)
    for i in range(1, 6):
        rows = np.concatenate([rng.randint(0, 10, (4, 1)),
                               rng.randint(0, 256, (4, 3072))], axis=1)
        (tmp_path / f"data_batch_{i}.bin").write_bytes(
            rows.astype(np.uint8).tobytes())
    want = jmx.gluon.data.vision.CIFAR10(root=str(tmp_path))
    got = gdata.vision.CIFAR10(root=str(tmp_path))
    assert len(got) == len(want) == 20
    with CPU:
        for i in (0, 13):
            np.testing.assert_array_equal(got[i][0].asnumpy(),
                                          want[i][0].asnumpy())
            assert got[i][1] == want[i][1]


# -- transforms --------------------------------------------------------------------------

IMG = np.random.RandomState(4).randint(0, 256, (13, 17, 3)).astype(np.uint8)
IMG_F = np.random.RandomState(5).rand(13, 17, 3).astype("f4") * 255

TRANSFORMS = {
    "to_tensor": (lambda T: T.ToTensor(), IMG, 0),
    "to_tensor_batch": (lambda T: T.ToTensor(), IMG[None].repeat(2, 0), 0),
    "normalize": (lambda T: T.Normalize((0.4, 0.5, 0.6), (0.2, 0.3, 0.1)),
                  IMG_F.transpose(2, 0, 1) / 255.0, 0),
    "cast": (lambda T: T.Cast("float16"), IMG, 0),
    "compose": (lambda T: T.Compose([T.Resize(8), T.ToTensor(),
                                     T.Normalize(0.5, 0.25)]), IMG, 1e-4),
    # odd sizes; a downscale by a non-integer factor; an upscale
    "resize_down_odd": (lambda T: T.Resize((7, 5)), IMG_F, 0),
    "resize_down_non_integer": (lambda T: T.Resize((11, 9)), IMG_F, 0),
    "resize_up": (lambda T: T.Resize((29, 23)), IMG_F, 0),
    "resize_one_axis": (lambda T: T.Resize((17, 6)), IMG_F, 0),
    "resize_keep_ratio": (lambda T: T.Resize(10, keep_ratio=True), IMG_F, 0),
    "resize_nearest": (lambda T: T.Resize((7, 19), interpolation=0),
                       IMG_F, 0),
    "resize_uint8": (lambda T: T.Resize((9, 7)), IMG, 1),
    "center_crop": (lambda T: T.CenterCrop((9, 5)), IMG, 0),
    "center_crop_upsizes": (lambda T: T.CenterCrop(20), IMG_F, 0),
    "random_resized_crop": (lambda T: T.RandomResizedCrop(8), IMG, 1),
    "random_resized_crop_fallback": (
        lambda T: T.RandomResizedCrop(6, scale=(5.0, 6.0)), IMG, 1),
    "flip_left_right": (lambda T: T.RandomFlipLeftRight(), IMG, 0),
    "flip_top_bottom": (lambda T: T.RandomFlipTopBottom(), IMG, 0),
    "brightness": (lambda T: T.RandomBrightness(0.4), IMG, 0),
    "contrast": (lambda T: T.RandomContrast(0.4), IMG, 0),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax(name):
    """Each transform against the JAX one on the same image, the random
    ones under the same numpy seed (four draws each).  Float images agree
    to float32 rounding (atol 1e-3 of values up to 255); a uint8 output
    within 1 (the truncation of a float that lies on an integer)."""
    make, img, atol = TRANSFORMS[name]
    jt, tt = make(jtf), make(ttf)
    for seed in range(4):
        np.random.seed(seed)
        want = jt(jmx.nd.array(img, ctx=JCPU, dtype=img.dtype)).asnumpy()
        np.random.seed(seed)
        got = tt(nd.array(img, ctx=CPU, dtype=img.dtype)).asnumpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got.astype("f8"), want.astype("f8"),
                                   rtol=1e-5, atol=max(atol, 1e-3))


def test_transform_first_with_to_tensor_through_the_loader():
    """train_mnist's pipeline: MNIST(synthetic) -> transform_first(ToTensor)
    -> DataLoader(shuffle, 2 workers), equal to the JAX package's."""
    def run(pkg, ctx):
        np.random.seed(7)
        ds = pkg.gluon.data.vision.MNIST(train=True, synthetic=64) \
            .transform_first(pkg.gluon.data.vision.transforms.ToTensor())
        loader = pkg.gluon.data.DataLoader(ds, 16, shuffle=True,
                                           num_workers=2)
        with ctx:
            return [[b.asnumpy() for b in batch] for batch in loader]
    want, got = run(jmx, JCPU), run(mx, CPU)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g[0].shape == (16, 1, 28, 28) and g[0].dtype == np.float32
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
