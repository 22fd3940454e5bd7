"""The port's Transformer NMT and beam search (``models/nmt.py``) against
the JAX package's, on the CPU.

A seeded JAX ``nmt_tiny`` is carried into the port by gluon name
(``load_jax_gluon_params``: the shared embedding and the ``pos_table``
constant included), both take the same numpy-made batches, and:

* ``tests/test_nmt.py``'s twelve cases hold in the port: shapes and the
  loss (here against the JAX model's, rtol 1e-5, with label smoothing
  and valid lengths), source-padding invariance, causality, the cached
  decode equal to teacher forcing (1e-4), the loss dropping on the
  reversal task and beam translation reversing, scores sorted, the
  sampler against the brute-force optimum, the alpha length penalty, no
  NaN scores with unfilled slots, ``max_len`` capped by the position
  table, batch rows independent;
* ``translate``'s samples and lengths equal the JAX model's on a small
  trained model, its scores to 1e-4; three Adam steps equal to 1e-4
  (losses, and each weight in relative L2; a key bias, which has no
  gradient in exact arithmetic, within Adam's bound); ``share_embed=True`` reads
  one weight three times (its gradient the JAX model's, 1e-5); the
  hybridized model bit for bit the eager one;
* at 128-token buckets every attention of a training step takes the
  flash route (whose CPU version is the kernels' plain one), none the
  plain attention.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.models import nmt as jnmt
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import (TransformerNMT, get_nmt,
                                    load_jax_gluon_params, nmt_tiny,
                                    transformer_en_de_512)
from mxnet_tpu_torch.models.nmt import BeamSearchSampler, BeamSearchScorer

CPU = mx.cpu()
V = 13          # 0 = PAD, 1 = BOS, 2 = EOS, payload 3..12
BOS, EOS = 1, 2
RTOL = 1e-5
TRAJ_TOL = 1e-4


def _jax_net(seed=0, **kwargs):
    jmx.random.seed(seed)
    np.random.seed(seed)
    kwargs.setdefault("max_length", 32)
    net = jnmt.nmt_tiny(V, prefix="nmt_", **kwargs)
    net.initialize(jmx.init.Xavier())
    net(*_nd(jmx, *_reversal(1)[:2]))       # the deferred shapes
    # its calls then compile as whole programs, not an op at a time
    net.hybridize()
    return net


def _jax_params(jnet):
    return {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}


def _port_net(params=None, seed=0, **kwargs):
    kwargs.setdefault("max_length", 32)
    net = nmt_tiny(V, prefix="nmt_", **kwargs)
    net.initialize(mx.init.Xavier(), ctx=CPU, seed=seed)
    if params is not None:
        load_jax_gluon_params(net, params)
    return net


def _pair(seed=0, **kwargs):
    jnet = _jax_net(seed, **kwargs)
    return jnet, _port_net(_jax_params(jnet), **kwargs)


def _reversal(n, length=5, seed=0):
    """numpy (src, tgt_in, tgt_out): a random payload and its reversal,
    the target framed by BOS and EOS."""
    rng = np.random.RandomState(seed)
    payload = rng.randint(3, V, (n, length))
    rev = payload[:, ::-1]
    src = payload.astype("f4")
    tgt_in = np.concatenate([np.full((n, 1), BOS), rev], 1).astype("f4")
    tgt_out = np.concatenate([rev, np.full((n, 1), EOS)], 1).astype("f4")
    return src, tgt_in, tgt_out


def _nd(pkg, *arrays):
    ctx = pkg.cpu()
    return [pkg.nd.array(a, ctx=ctx) for a in arrays]


# -- teacher forcing --------------------------------------------------------------


def test_shapes_and_loss_match_jax():
    jnet, net = _pair()
    src, tgt_in, tgt_out = _reversal(4)
    sv, tv = np.array([5, 3, 4, 5], "f4"), np.array([6, 4, 2, 5], "f4")
    logits = net(*_nd(mx, src, tgt_in))
    assert logits.shape == (4, 6, V)
    np.testing.assert_allclose(
        logits.asnumpy(), jnet(*_nd(jmx, src, tgt_in)).asnumpy(),
        rtol=RTOL, atol=1e-6)
    losses = {}
    for pkg, model in ((jmx, jnet), (mx, net)):
        with pkg.autograd.record():
            loss = model.loss(*_nd(pkg, src, tgt_in, tgt_out, sv, tv),
                              label_smoothing=0.1)
        loss.backward()
        losses[pkg] = float(loss.asnumpy())
    assert np.isfinite(losses[mx])
    np.testing.assert_allclose(losses[mx], losses[jmx], rtol=RTOL)
    g = net.src_embed._gluon_param("weight").grad().asnumpy()
    assert np.abs(g).sum() > 0


def test_src_padding_mask_invariance():
    """Tokens past src_valid do not reach the logits."""
    _, net = _pair()
    src, tgt_in, _ = _reversal(2, length=6)
    sv = nd.array(np.array([4, 4], "f4"), ctx=CPU)
    base = net(*_nd(mx, src, tgt_in), sv).asnumpy()
    src2 = src.copy()
    src2[:, 4:] = 9
    got = net(*_nd(mx, src2, tgt_in), sv).asnumpy()
    np.testing.assert_allclose(base, got, rtol=1e-5, atol=1e-5)


def test_causality():
    """Position t's logits do not depend on later target tokens."""
    _, net = _pair()
    src, tgt_in, _ = _reversal(2)
    base = net(*_nd(mx, src, tgt_in)).asnumpy()
    mut = tgt_in.copy()
    mut[:, -1] = 5
    got = net(*_nd(mx, src, mut)).asnumpy()
    np.testing.assert_allclose(base[:, :-1], got[:, :-1], rtol=1e-5,
                               atol=1e-5)
    assert not np.allclose(base[:, -1], got[:, -1])


# -- incremental decode -----------------------------------------------------------


def test_decode_matches_teacher_forcing_and_jax():
    """The cached step's log-probs equal log_softmax of the full pass at
    every position (1e-4), and the JAX model's steps (rtol 1e-5)."""
    jnet, net = _pair(seed=3)
    src, tgt_in, _ = _reversal(3, seed=3)
    sv = np.array([5, 3, 4], "f4")
    steps = {}
    for pkg, model in ((jmx, jnet), (mx, net)):
        s, t, v = _nd(pkg, src, tgt_in, sv)
        full = pkg.nd.log_softmax(model(s, t, v), axis=-1).asnumpy()
        memory = model.encode(s, v)
        states, mem_kvs, mem_mask = model.init_decode(memory, t.shape[1], v)
        got = []
        for i in range(t.shape[1]):
            lp = model.decode_step(t[:, i:i + 1], states, mem_kvs, i,
                                   mem_mask).asnumpy()
            np.testing.assert_allclose(lp, full[:, i], rtol=1e-4,
                                       atol=1e-4)
            got.append(lp)
        steps[pkg] = np.stack(got)
    np.testing.assert_allclose(steps[mx], steps[jmx], rtol=RTOL, atol=1e-5)


def test_decode_writes_caches_in_place():
    """``decode_step`` writes the caches ``init_decode`` made (their
    storage stays) and records nothing outside ``autograd.record()``."""
    _, net = _pair()
    src, tgt_in, _ = _reversal(2)
    s, t = _nd(mx, src, tgt_in)
    states, mem_kvs, mask = net.init_decode(net.encode(s), 8)
    ptrs = [c._t.data_ptr() for layer in states for c in layer]
    lp = net.decode_step(t[:, :1], states, mem_kvs, 0, mask)
    assert [c._t.data_ptr() for layer in states for c in layer] == ptrs
    assert all(np.abs(layer[0].asnumpy()[:, 0]).sum() > 0
               and not layer[0].asnumpy()[:, 1:].any() for layer in states)
    assert lp._t.grad_fn is None and not lp._t.requires_grad


# -- training and translation ----------------------------------------------------------


def _train(pkg, net, steps=150, batch=32, lr=3e-3):
    net.hybridize()
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": lr})
    losses = []
    for step in range(steps):
        arrays = _nd(pkg, *_reversal(batch, seed=100 + step))
        with pkg.autograd.record():
            loss = net.loss(*arrays, label_smoothing=0.1)
        loss.backward()
        trainer.step(batch)
        losses.append(float(loss.asnumpy()))
    return losses


@pytest.fixture(scope="module")
def trained():
    """nmt_tiny trained 150 Adam steps on the reversal task in the port,
    from the JAX model's initial weights."""
    _, net = _pair(seed=1)
    return net, _train(mx, net)


def test_loss_drops(trained):
    _, losses = trained
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


def test_beam_translation_reverses(trained):
    net, _ = trained
    src, _, _ = _reversal(8, seed=999)
    samples, scores, lens = net.translate(
        nd.array(src, ctx=CPU), bos_id=BOS, eos_id=EOS, beam_size=4,
        max_len=10)
    assert all(isinstance(a, nd.NDArray) and a.context == CPU
               for a in (samples, scores, lens))
    s = samples.asnumpy().astype(int)
    expect = src.astype(int)[:, ::-1]
    correct = sum(int(s[i, 0, 0] == BOS and (s[i, 0, 1:6] == expect[i]).all()
                      and s[i, 0, 6] == EOS) for i in range(8))
    assert correct >= 6, (correct, s[:, 0], expect)


def test_beam_scores_sorted(trained):
    net, _ = trained
    src, _, _ = _reversal(4, seed=7)
    _, scores, _ = net.translate(nd.array(src, ctx=CPU), bos_id=BOS,
                                 eos_id=EOS, beam_size=4, max_len=10)
    sc = scores.asnumpy()
    assert (np.diff(sc, axis=1) <= 1e-6).all(), sc


def test_translate_matches_jax_on_a_trained_model():
    """A JAX model trained 40 steps, carried into the port: the same
    beams (samples and lengths exactly, scores to 1e-4), with and without
    source valid lengths."""
    jnet = _jax_net(seed=2)
    _train(jmx, jnet, steps=40)
    net = _port_net(_jax_params(jnet))
    src, _, _ = _reversal(6, seed=5)
    sv = np.array([5, 4, 5, 3, 5, 5], "f4")
    for valid in (None, sv):
        outs = {}
        for pkg, model in ((jmx, jnet), (mx, net)):
            extra = {} if valid is None else {
                "src_valid": _nd(pkg, valid)[0]}
            outs[pkg] = [a.asnumpy() for a in model.translate(
                _nd(pkg, src)[0], bos_id=BOS, eos_id=EOS, beam_size=3,
                max_len=9, alpha=0.6, **extra)]
        np.testing.assert_array_equal(outs[mx][0], outs[jmx][0])
        np.testing.assert_allclose(outs[mx][1], outs[jmx][1], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(outs[mx][2], outs[jmx][2])


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_three_adam_steps_match_jax():
    """Losses to 1e-4 and every weight to 1e-4 in relative L2, with
    valid lengths on both sides and the model hybridized."""
    jnet, net = _pair(seed=4, share_embed=True)
    sv, tv = np.array([5, 3, 4, 5], "f4"), np.array([6, 4, 6, 2], "f4")
    losses = {}
    for pkg, model in ((jmx, jnet), (mx, net)):
        model.hybridize()
        tr = pkg.gluon.Trainer(model.collect_params(), "adam",
                               {"learning_rate": 1e-2})
        losses[pkg] = []
        for step in range(3):
            arrays = _nd(pkg, *_reversal(4, seed=50 + step), sv, tv)
            with pkg.autograd.record():
                loss = model.loss(*arrays)
            loss.backward()
            tr.step(4)
            losses[pkg].append(float(loss.asnumpy()))
    np.testing.assert_allclose(losses[mx], losses[jmx], rtol=TRAJ_TOL)
    want = _jax_params(jnet)
    got = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    for k, w in want.items():
        if k.endswith(("_k_bias", "_key_bias")):
            # no gradient in exact arithmetic (softmax is shift-invariant
            # along a query's keys): Adam moves it by the sign of float32
            # noise, at most lr a step
            assert np.abs(got[k]).max() <= 3 * 1e-2 * 1.01, k
            continue
        assert _rel_l2(got[k], w) <= TRAJ_TOL, (k, _rel_l2(got[k], w))


def test_shared_embedding_read_three_ways():
    """share_embed and tie_output: the source embedding, the target
    embedding and the head read one weight; its gradient (the sum of the
    three reads) equals the JAX model's."""
    jnet, net = _pair(seed=5, share_embed=True)
    assert net.tgt_embed is net.src_embed
    names = [k for k in net.collect_params() if "embed" in k]
    assert names == ["nmt_src_embed_weight"]
    src, tgt_in, tgt_out = _reversal(3, seed=6)
    grads = {}
    for pkg, model in ((jmx, jnet), (mx, net)):
        with pkg.autograd.record():
            loss = model.loss(*_nd(pkg, src, tgt_in, tgt_out))
        loss.backward()
        grads[pkg] = model.collect_params()["nmt_src_embed_weight"] \
            .grad().asnumpy()
    np.testing.assert_allclose(grads[mx], grads[jmx], rtol=1e-4, atol=1e-5)
    # the head's read alone moves rows no token selects (PAD, BOS)
    assert np.abs(grads[mx][0]).sum() > 0


def test_hybridized_bit_for_bit_eager():
    """The hybridized model's loss and gradients equal the eager
    model's exactly (on the CPU the CachedOp runs the block as it is)."""
    _, eager = _pair(seed=6)
    _, hyb = _pair(seed=6)
    hyb.hybridize()
    arrays = _reversal(4, seed=8) + (np.array([5, 2, 5, 4], "f4"),
                                     np.array([6, 3, 6, 6], "f4"))
    out = {}
    for name, model in (("eager", eager), ("hyb", hyb)):
        with autograd.record():
            loss = model.loss(*_nd(mx, *arrays))
        loss.backward()
        out[name] = [loss.asnumpy()] + [
            p.grad().asnumpy() for p in model.collect_params().values()
            if p.grad_req != "null"]
    for a, b in zip(out["eager"], out["hyb"]):
        np.testing.assert_array_equal(a, b)


def test_load_jax_params_takes_constant_and_shared_names():
    """A shared, tied JAX model with its pos_table constant loads by
    name; a missing or an extra name raises."""
    jnet = _jax_net(seed=7, share_embed=True)
    params = _jax_params(jnet)
    assert "nmt_pos_table" in params
    net = _port_net(params, share_embed=True)
    np.testing.assert_array_equal(
        net.collect_params()["nmt_pos_table"].data().asnumpy(),
        params["nmt_pos_table"])
    with pytest.raises(MXNetError, match="missing"):
        load_jax_gluon_params(net, {k: v for k, v in params.items()
                                    if k != "nmt_pos_table"})
    with pytest.raises(MXNetError, match="does not have"):
        load_jax_gluon_params(net, dict(params, nmt_tgt_embed_weight=params[
            "nmt_src_embed_weight"]))


# -- the sampler on a toy decoder -------------------------------------------------------


class ToyDecoder:
    """A fixed Markov decoder over a tiny vocabulary (stateless)."""

    def __init__(self, pkg, vocab=4, seed=0):
        rng = np.random.RandomState(seed)
        logits = rng.randn(vocab, vocab) * 2.0
        self.logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        self.vocab = vocab
        self.pkg = pkg

    def __call__(self, tok, step, states):
        t = tok.asnumpy().astype(int).reshape(-1)
        return (self.pkg.nd.array(self.logp[t].astype("f4"),
                                  ctx=self.pkg.cpu()), states)

    def brute_force_best(self, start, eos, max_len, scorer):
        best = (-np.inf, None)
        stack = [([start], 0.0)]
        while stack:
            seq, lp = stack.pop()
            if len(seq) == max_len:
                sc = scorer(lp, float(len(seq)))
                if sc > best[0]:
                    best = (sc, seq)
                continue
            for nxt in range(self.vocab):
                nlp = lp + self.logp[seq[-1], nxt]
                if nxt == eos:
                    sc = scorer(nlp, float(len(seq) + 1))
                    if sc > best[0]:
                        best = (sc, seq + [eos])
                else:
                    stack.append((seq + [nxt], nlp))
        return best


def _sample_both(vocab, seed, start, batch_size, **kw):
    """The JAX and the port's sampler on the same toy decoder."""
    out = {}
    for pkg, cls in ((jmx, jnmt.BeamSearchSampler),
                     (mx, BeamSearchSampler)):
        scorer_cls = jnmt.BeamSearchScorer if pkg is jmx else \
            BeamSearchScorer
        alpha = kw.pop("alpha", None) if pkg is jmx else kw.get("alpha")
        kwj = dict(kw)
        kwj.pop("alpha", None)
        sampler = cls(scorer=scorer_cls(alpha=1.0 if alpha is None
                                        else alpha), **kwj)
        res = sampler(ToyDecoder(pkg, vocab, seed),
                      pkg.nd.array(start, ctx=pkg.cpu()), None,
                      batch_size=batch_size)
        out[pkg] = [a.asnumpy() for a in res]
        if pkg is jmx and alpha is not None:
            kw["alpha"] = alpha
    for a, b in zip(out[mx], out[jmx]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    return out[mx]


def test_sampler_finds_brute_force_optimum():
    """beam_size == vocab keeps every live prefix: the global optimum."""
    eos, max_len = 0, 6
    samples, scores, lens = _sample_both(
        4, 2, np.ones((4, 1), "f4"), 1, beam_size=4, eos_id=eos,
        max_length=max_len)
    want_sc, want = ToyDecoder(mx, 4, 2).brute_force_best(
        1, eos, max_len, BeamSearchScorer(alpha=1.0))
    assert abs(float(scores[0, 0]) - want_sc) < 1e-4
    n = int(lens[0, 0])
    assert list(samples.astype(int)[0, 0, :n]) == want


def test_alpha_length_penalty_prefers_longer():
    mean_len = []
    for alpha in (0.0, 2.0):
        _, _, lens = _sample_both(4, 5, np.ones((4, 1), "f4"), 1,
                                  beam_size=4, eos_id=0, max_length=8,
                                  alpha=alpha)
        mean_len.append(lens[0, 0])
    assert mean_len[1] >= mean_len[0], mean_len


def test_no_nan_scores_when_slots_unfilled():
    samples, scores, _ = _sample_both(3, 1, np.ones((4, 1), "f4"), 1,
                                      beam_size=4, eos_id=0, max_length=5)
    assert not np.isnan(scores).any(), scores
    s = samples.astype(int)
    assert ((s >= 0) & (s < 3)).all(), s


def test_max_len_capped_by_position_table():
    _, net = _pair()
    src = nd.array(_reversal(2)[0], ctx=CPU)
    _, _, lens = net.translate(src, bos_id=BOS, eos_id=EOS, beam_size=2,
                               max_len=100)
    assert lens.asnumpy().max() <= 32
    with pytest.raises(MXNetError, match="position table"):
        net.init_decode(net.encode(src), 100)


def test_batch_rows_independent():
    start = np.array([[1]] * 3 + [[2]] * 3, "f4")
    both = _sample_both(4, 9, start, 2, beam_size=3, eos_id=0,
                        max_length=6)
    solo = _sample_both(4, 9, np.array([[2]] * 3, "f4"), 1, beam_size=3,
                        eos_id=0, max_length=6)
    np.testing.assert_allclose(both[1][1], solo[1][0], rtol=1e-5)


def test_sampler_keeps_tensors_for_tensors():
    """Given tensors (LlamaForCausalLM.generate_beam's call), the
    decoder sees tensors and the sampler returns tensors."""
    import torch
    toy = ToyDecoder(mx, 4, 3)
    seen = []

    def decoder(tok, step, states):
        seen.append(type(tok))
        t = tok.cpu().numpy().astype(int).reshape(-1)
        return torch.from_numpy(toy.logp[t].astype("f4")), states
    out = BeamSearchSampler(beam_size=2, eos_id=0, max_length=4)(
        decoder, torch.ones(2, 1), [torch.zeros(2, 3)], batch_size=1)
    assert set(seen) == {torch.Tensor}
    assert all(isinstance(a, torch.Tensor) for a in out)


# -- the flash route at aligned lengths ---------------------------------------------------


def test_aligned_buckets_take_the_flash_route(monkeypatch):
    """At 128-token buckets with valid lengths, a recorded step's
    attentions (encoder self, decoder causal self, cross) all go to the
    flash route, whose CPU version runs the kernels' plain versions;
    none to the plain attention.  The loss equals the JAX model's."""
    from mxnet_tpu_torch.ops import attention, flash_attention as fa
    jnet, net = _pair(seed=8, max_length=256)
    rng = np.random.RandomState(9)
    src = rng.randint(3, V, (2, 128)).astype("f4")
    tgt = rng.randint(3, V, (2, 128)).astype("f4")
    sv, tv = np.array([100, 128], "f4"), np.array([128, 70], "f4")
    calls = {"plain": 0, "flash": 0, "causal_kpad": 0}
    plain, flash = attention.sdpa_plain, fa._flash_apply

    def count_plain(*a, **k):
        calls["plain"] += 1
        return plain(*a, **k)

    def count_flash(q, k, v, kmask, scale, causal, window):
        calls["flash"] += 1
        calls["causal_kpad"] += int(causal and kmask is not None)
        return flash(q, k, v, kmask, scale, causal, window)
    monkeypatch.setattr(attention, "sdpa_plain", count_plain)
    monkeypatch.setattr(fa, "_flash_apply", count_flash)
    with autograd.record():
        loss = net.loss(*_nd(mx, src, tgt, tgt, sv, tv))
    loss.backward()
    assert calls == {"plain": 0, "flash": 6, "causal_kpad": 2}
    jloss = jnet.loss(*_nd(jmx, src, tgt, tgt, sv, tv))
    np.testing.assert_allclose(float(loss.asnumpy()),
                               float(jloss.asnumpy()), rtol=RTOL)


def test_configurations():
    net = transformer_en_de_512(37000, tgt_vocab_size=37000,
                                share_embed=True)
    assert isinstance(net, TransformerNMT)
    assert (net._units, net._num_layers, net._heads) == (512, 6, 8)
    assert net._gluon_param("pos_table").shape == (512, 512)
    with pytest.raises(MXNetError, match="unknown nmt config"):
        get_nmt("nmt_huge", 10)
    with pytest.raises(MXNetError, match="equal vocabularies"):
        nmt_tiny(10, tgt_vocab_size=11, share_embed=True)
