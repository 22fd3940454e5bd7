"""Persistence and ``gluon.utils``: the port against the JAX package on
the CPU.

``nd.save`` of a dict and of a list writes the JAX package's bytes; each
package loads the other's file and ``load_buffer`` reads bytes; a
reference dmlc ``.params`` file (the layout of the JAX package's
``legacy_io``, written here) loads in both; ``save_parameters`` and
``load_parameters`` carry weights across the packages either way to
equal outputs, by attribute path or by full name; ``Trainer.save_states``
and ``load_states`` continue an Adam run bit for bit; and
``split_data``, ``split_and_load`` and ``clip_global_norm``.
"""
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.base import MXNetError

CPU = mx.cpu()
JCPU = jmx.cpu()
RNG = np.random.RandomState(0)
ARRAYS = {
    "w": RNG.randn(3, 4).astype("f4"),
    "half": RNG.randn(5).astype("f2"),
    "ids": RNG.randint(0, 9, (2, 3)).astype("int32"),
    "bytes": RNG.randint(0, 255, (4,)).astype("uint8"),
    "scalar_like": np.asarray([2.5], "f4"),
}


def _arrays(pkg, ctx, as_list=False):
    out = {k: pkg.nd.array(v, ctx=ctx, dtype=v.dtype)
           for k, v in ARRAYS.items()}
    return list(out.values()) if as_list else out


@pytest.mark.parametrize("as_list", [False, True])
def test_nd_save_writes_the_jax_packages_bytes(tmp_path, as_list):
    jf, tf = str(tmp_path / "jax.nd"), str(tmp_path / "port.nd")
    jmx.nd.save(jf, _arrays(jmx, JCPU, as_list))
    nd.save(tf, _arrays(mx, CPU, as_list))
    assert open(tf, "rb").read() == open(jf, "rb").read()
    for loader, ctx, f in ((jmx.nd.load, JCPU, tf), (nd.load, CPU, jf)):
        with ctx:
            loaded = loader(f)
        if as_list:
            assert isinstance(loaded, list)
            loaded = dict(zip(ARRAYS, loaded))
        assert sorted(loaded) == sorted(ARRAYS)
        for k, v in ARRAYS.items():
            got = loaded[k].asnumpy()
            assert got.dtype == v.dtype
            np.testing.assert_array_equal(got, v)


def test_bfloat16_and_a_single_array_round_trip(tmp_path):
    f = str(tmp_path / "bf16.nd")
    a = nd.array(ARRAYS["w"], ctx=CPU).astype("bfloat16")
    nd.save(f, a)
    jf = str(tmp_path / "bf16_jax.nd")
    jmx.nd.save(jf, jmx.nd.array(ARRAYS["w"], ctx=JCPU).astype("bfloat16"))
    assert open(f, "rb").read() == open(jf, "rb").read()
    with CPU:
        (back,) = nd.load(f)
    assert str(back.dtype) == "bfloat16"
    np.testing.assert_array_equal(back.asnumpy(), a.asnumpy())


def test_load_buffer_reads_bytes(tmp_path):
    f = str(tmp_path / "b.nd")
    jmx.nd.save(f, _arrays(jmx, JCPU))
    with CPU:
        got = nd.load_buffer(open(f, "rb").read())
    np.testing.assert_array_equal(got["w"].asnumpy(), ARRAYS["w"])
    with pytest.raises(MXNetError, match="not an NDArray file"):
        nd.load_buffer(b"\0" * 16)


def _legacy_file(path, arrays, names, version):
    """The reference's dmlc layout (see legacy_io's docstring)."""
    magic = {1: 0xF993FAC8, 2: 0xF993FAC9, 3: 0xF993FACA}[version]
    flags = {np.dtype("f4"): 0, np.dtype("f8"): 1, np.dtype("f2"): 2,
             np.dtype("u1"): 3, np.dtype("i4"): 4}
    out = struct.pack("<QQQ", 0x112, 0, len(arrays))
    for a in arrays:
        out += struct.pack("<I", magic)
        if version > 1:
            out += struct.pack("<i", 0)
        out += struct.pack("<I", a.ndim)
        out += b"".join(struct.pack("<q" if version == 3 else "<I", d)
                        for d in a.shape)
        out += struct.pack("<iii", 1, 0, flags[a.dtype]) + a.tobytes()
    out += struct.pack("<Q", len(names))
    for n in names:
        out += struct.pack("<Q", len(n)) + n.encode()
    with open(path, "wb") as f:
        f.write(out)


@pytest.mark.parametrize("version", [1, 2, 3])
@pytest.mark.parametrize("named", [True, False])
def test_a_reference_dmlc_file_loads(tmp_path, version, named):
    arrays = [ARRAYS["w"], ARRAYS["ids"], ARRAYS["half"]]
    names = ["arg:fc_weight", "aux:ids", "arg:h"] if named else []
    f = str(tmp_path / "legacy.params")
    _legacy_file(f, arrays, names, version)
    with JCPU:
        want = jmx.nd.load(f)
    with CPU:
        got = nd.load(f)
    if named:
        assert sorted(got) == sorted(want) == sorted(names)
        got, want = [got[n] for n in names], [want[n] for n in names]
    for g, w, a in zip(got, want, arrays):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
        np.testing.assert_array_equal(g.asnumpy(), a)
    with open(f, "rb") as fh:
        raw = fh.read()
    with open(f, "wb") as fh:
        fh.write(raw[:40])
    with pytest.raises(MXNetError, match="truncated"):
        nd.load(f)


# -- save_parameters / load_parameters ----------------------------------------------

def _mlp(pkg, prefix="mlp_"):
    net = pkg.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(8, activation="relu"),
                pkg.gluon.nn.BatchNorm(),
                pkg.gluon.nn.Dense(3))
    return net


X = RNG.rand(5, 6).astype("f4")


def _ready(pkg, ctx, seed):
    if pkg is jmx:
        jmx.random.seed(seed)
    net = _mlp(pkg)
    kw = {} if pkg is jmx else {"seed": seed}
    net.initialize(pkg.init.Xavier(), ctx=ctx, **kw)
    net(pkg.nd.array(X, ctx=ctx))          # the deferred shapes
    return net


def _train_mode_step(pkg, net, ctx):
    """One training-mode forward (BatchNorm's running statistics move),
    then the predict-mode output."""
    with pkg.autograd.record():
        net(pkg.nd.array(X, ctx=ctx))
    return net(pkg.nd.array(X, ctx=ctx)).asnumpy()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_load_parameters_across_the_packages(tmp_path, direction):
    f = str(tmp_path / "mlp.params")
    jnet, tnet = _ready(jmx, JCPU, 1), _ready(mx, CPU, 2)
    src, dst = (jnet, tnet) if direction == "jax_to_port" else (tnet, jnet)
    dst_ctx = CPU if dst is tnet else JCPU
    _train_mode_step(jmx if src is jnet else mx, src,
                     JCPU if src is jnet else CPU)
    src.save_parameters(f)
    dst.load_parameters(f, ctx=dst_ctx)
    want = jnet(jmx.nd.array(X, ctx=JCPU)).asnumpy()
    got = tnet(nd.array(X, ctx=CPU)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for k, p in tnet.collect_params().items():
        np.testing.assert_array_equal(
            p.data().asnumpy(), jnet.collect_params()[k].data().asnumpy())


def test_load_parameters_into_a_net_not_placed_yet(tmp_path):
    """A net never initialized (its weights on ``meta``, the first
    Dense's width deferred) is placed on ``ctx`` from the file."""
    f = str(tmp_path / "mlp.params")
    jnet = _ready(jmx, JCPU, 3)
    jnet.save_parameters(f)
    tnet = _mlp(mx)
    tnet.load_parameters(f, ctx=CPU)
    np.testing.assert_allclose(
        tnet(nd.array(X, ctx=CPU)).asnumpy(),
        jnet(jmx.nd.array(X, ctx=JCPU)).asnumpy(), rtol=1e-5, atol=1e-6)


def test_load_parameters_by_full_name_and_checks(tmp_path):
    tnet = _ready(mx, CPU, 4)
    params = tnet.collect_params()
    by_name = str(tmp_path / "names.params")
    nd.save(by_name, {"arg:" + k: p.data() for k, p in params.items()})
    other = _ready(mx, CPU, 5)
    other.load_parameters(by_name)
    for k, p in other.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      params[k].data().asnumpy())
    paths = str(tmp_path / "paths.params")
    tnet.save_parameters(paths)
    with CPU:
        keys = sorted(nd.load(paths))
    assert keys == ["0.bias", "0.weight", "1.beta", "1.gamma",
                    "1.running_mean", "1.running_var", "2.bias",
                    "2.weight"]
    missing = str(tmp_path / "missing.params")
    nd.save(missing, {"0.weight": params["mlp_dense0_weight"].data()})
    with pytest.raises(MXNetError, match="missing"):
        other.load_parameters(missing)
    other.load_parameters(missing, allow_missing=True)
    extra = str(tmp_path / "extra.params")
    with CPU:
        nd.save(extra, dict(nd.load(paths), **{"9.weight": nd.ones((1,))}))
    with pytest.raises(MXNetError, match="not present"):
        other.load_parameters(extra, allow_missing=True)
    with pytest.raises(MXNetError, match="shape incompatible"):
        bad = str(tmp_path / "bad.params")
        nd.save(bad, {"0.weight": nd.ones((2, 2), ctx=CPU)})
        other.load_parameters(bad, allow_missing=True)
    with pytest.raises(MXNetError, match="unnamed"):
        unnamed = str(tmp_path / "list.params")
        nd.save(unnamed, [nd.ones((1,), ctx=CPU)])
        other.load_parameters(unnamed)


def test_trainer_states_continue_an_adam_run_bit_for_bit(tmp_path):
    y = nd.array(np.arange(5) % 3, ctx=CPU)
    x = nd.array(X, ctx=CPU)
    lf = gluon.loss.SoftmaxCrossEntropyLoss()

    def step(net, tr):
        with autograd.record():
            loss = lf(net(x), y)
        loss.backward()
        tr.step(5)

    a = _ready(mx, CPU, 6)
    tr_a = gluon.Trainer(a.collect_params(), "adam",
                         {"learning_rate": 0.01, "wd": 1e-3})
    for _ in range(3):
        step(a, tr_a)
    params, states = str(tmp_path / "a.params"), str(tmp_path / "a.states")
    a.save_parameters(params)
    tr_a.save_states(states)
    b = _ready(mx, CPU, 7)
    tr_b = gluon.Trainer(b.collect_params(), "adam",
                         {"learning_rate": 0.5})
    step(b, tr_b)      # states of its own, overwritten in place by the load
    held = tr_b._updater.states[0][0]
    scalars = tr_b.optimizer._scalars
    b.load_parameters(params)
    tr_b.load_states(states)
    # a captured step keeps reading the same state and scalar tensors
    assert tr_b._updater.states[0][0] is held
    assert tr_b.optimizer._scalars is scalars
    assert tr_b.learning_rate == 0.01
    assert tr_b.optimizer._index_update_count == \
        tr_a.optimizer._index_update_count
    assert tr_b.optimizer.param_dict[0] is list(
        b.collect_params().values())[0]
    for _ in range(2):
        step(a, tr_a)
        step(b, tr_b)
    for (k, pa), pb in zip(a.collect_params().items(),
                           b.collect_params().values()):
        np.testing.assert_array_equal(pa.data().asnumpy(),
                                      pb.data().asnumpy())


# -- gluon.utils -------------------------------------------------------------------------

def test_split_data_and_split_and_load_match_jax():
    data = np.arange(30, dtype="f4").reshape(10, 3)
    for even in (True, False):
        n = 2 if even else 3
        want = [s.asnumpy() for s in jmx.gluon.utils.split_data(
            jmx.nd.array(data, ctx=JCPU), n, even_split=even)]
        got = [s.asnumpy() for s in gluon.utils.split_data(
            nd.array(data, ctx=CPU), n, even_split=even)]
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="evenly"):
        gluon.utils.split_data(nd.array(data, ctx=CPU), 3)
    (one,) = gluon.utils.split_and_load(data, [CPU])
    assert one.context == CPU
    np.testing.assert_array_equal(one.asnumpy(), data)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_global_norm_matches_jax(max_norm):
    arrays = [RNG.randn(3, 4).astype("f4"), RNG.randn(7).astype("f4")]
    want_a = [jmx.nd.array(a, ctx=JCPU) for a in arrays]
    got_a = [nd.array(a, ctx=CPU) for a in arrays]
    want = jmx.gluon.utils.clip_global_norm(want_a, max_norm)
    got = gluon.utils.clip_global_norm(got_a, max_norm)
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-6)
    for g, w in zip(got_a, want_a):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=1e-6)
    norm = gluon.utils.clip_global_norm(got_a, max_norm,
                                        check_isfinite=False)
    assert isinstance(norm, nd.NDArray)
    with pytest.warns(UserWarning, match="nan or inf"):
        gluon.utils.clip_global_norm([nd.array([np.nan], ctx=CPU)], 1.0)
    with pytest.raises(MXNetError, match="network"):
        gluon.utils.download("http://localhost/x")
