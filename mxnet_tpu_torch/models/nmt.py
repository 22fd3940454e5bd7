"""Beam search over an incremental decoder, as the JAX package's
``models/nmt.py`` (GluonNLP's sampler): the scorer, the sampler and the
state reordering that ``LlamaForCausalLM.generate_beam`` runs on.

Each beam step runs the decoder once over the flat beam axis (batch x
beam) on the device, expands the scores and takes the top 2K candidates
of each batch row there; the (B, 2K) winners come to the host, which
keeps the hypotheses, the finished list and the EOS bookkeeping, and the
states are reordered by the survivors' parents (``index_select``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["BeamSearchScorer", "BeamSearchSampler"]


class BeamSearchScorer:
    """Google-NMT length-penalized score (Wu et al. 2016), the
    GluonNLP default: score = logprob_sum / ((K + len) / (K + 1)) **
    alpha."""

    def __init__(self, alpha=1.0, K=5.0):
        self.alpha = float(alpha)
        self.K = float(K)

    def __call__(self, log_probs, length):
        lp = ((self.K + length) / (self.K + 1.0)) ** self.alpha
        return log_probs / lp


class BeamSearchSampler:
    """Beam search over an incremental decoder.

    ``decoder(tok, step_idx, states) -> (log_probs (B*K, V), states)``
    with ``states`` any nest (lists, tuples) of tensors whose leading
    axis is the flat beam axis B*K; after each step the sampler reorders
    that axis by the surviving beams' parents.  Returns ``(samples (B,
    K, L), scores (B, K), lengths (B, K))`` as float32 tensors on the
    start tokens' device, best first; samples start with the start
    token and are padded with ``eos_id``.
    """

    def __init__(self, beam_size, eos_id, scorer=None, max_length=64):
        self.beam_size = int(beam_size)
        self.eos_id = int(eos_id)
        self.scorer = scorer or BeamSearchScorer()
        self.max_length = int(max_length)

    def __call__(self, decoder, start_tokens, states, batch_size):
        b, k = batch_size, self.beam_size
        if start_tokens.shape[0] != b * k:
            raise MXNetError(
                f"start_tokens leading axis {start_tokens.shape[0]} != "
                f"batch_size*beam_size {b * k}")
        dev = start_tokens.device
        # beam 0 of each batch row is live; the rest start at -inf so
        # the first expansion seeds distinct hypotheses from beam 0
        logp_sum = np.full((b, k), -np.inf, np.float64)
        logp_sum[:, 0] = 0.0
        hist = start_tokens.cpu().numpy().astype(np.int64).reshape(b, k, 1)
        alive = np.ones((b, k), bool)
        lengths = np.ones((b, k), np.int64)   # counts the start token
        cur = start_tokens
        finished = [[] for _ in range(b)]     # (score, token_list)

        for step in range(self.max_length - 1):
            logp, states = decoder(cur, step, states)  # (B*K, V)
            v = logp.shape[-1]
            # dead beams carry -inf sums: a finite floor keeps the add
            # free of NaN, and the -1e29 filter below drops their
            # children
            floor = np.maximum(logp_sum, -1e30).reshape(-1, 1)
            cand = logp + torch.as_tensor(floor.astype(np.float32),
                                          device=dev)
            # top-2K of each row's K*V candidates, so EOS picks never
            # starve the live-beam quota
            n_top = min(2 * k, k * v)
            top_scores, top_idx = torch.topk(cand.reshape(b, k * v),
                                             n_top, dim=-1)
            ts = top_scores.cpu().numpy().astype(np.float64)
            ti = top_idx.cpu().numpy().astype(np.int64)

            new_logp = np.full((b, k), -np.inf, np.float64)
            new_alive = np.zeros((b, k), bool)
            new_len = np.ones((b, k), np.int64)
            parent = np.zeros((b, k), np.int64)
            next_tok = np.zeros((b, k), np.int64)
            for i in range(b):
                slot = 0
                for j in range(n_top):
                    if slot == k:
                        break
                    if ts[i, j] <= -1e29:
                        continue
                    pj, tj = divmod(int(ti[i, j]), v)
                    seq_len = lengths[i, pj] + 1
                    if tj == self.eos_id:
                        seq = np.concatenate([hist[i, pj], [self.eos_id]])
                        finished[i].append(
                            (self.scorer(ts[i, j], float(seq_len)), seq))
                        continue
                    new_logp[i, slot] = ts[i, j]
                    new_alive[i, slot] = True
                    new_len[i, slot] = seq_len
                    parent[i, slot] = pj
                    next_tok[i, slot] = tj
                    slot += 1
            logp_sum, alive, lengths = new_logp, new_alive, new_len
            if not alive.any():
                break
            flat_parent = (parent + np.arange(b)[:, None] * k).reshape(-1)
            hist = np.concatenate(
                [hist[np.arange(b)[:, None], parent], next_tok[:, :, None]],
                axis=-1)
            if step < self.max_length - 2:
                # the last iteration's reorder would never be read
                states = _gather_states(
                    states, torch.as_tensor(flat_parent, device=dev))
                cur = torch.as_tensor(
                    next_tok.reshape(b * k, 1).astype(np.float32),
                    device=dev)

        # close out the beams still alive at max length
        for i in range(b):
            for j in range(k):
                if alive[i, j]:
                    finished[i].append(
                        (self.scorer(logp_sum[i, j], float(lengths[i, j])),
                         hist[i, j]))
            if not finished[i]:   # degenerate: everything pruned
                finished[i].append((-np.inf, hist[i, 0]))

        # pad and sort each batch row, best first
        max_out = max(len(seq) for row in finished for _, seq in row)
        samples = np.full((b, k, max_out), self.eos_id, np.int64)
        scores = np.full((b, k), -np.inf, np.float64)
        lens = np.zeros((b, k), np.int64)
        for i in range(b):
            best = sorted(finished[i], key=lambda t: -t[0])[:k]
            for j, (sc, seq) in enumerate(best):
                samples[i, j, :len(seq)] = seq
                scores[i, j] = sc
                lens[i, j] = len(seq)
        return tuple(torch.as_tensor(a.astype(np.float32), device=dev)
                     for a in (samples, scores, lens))


def _gather_states(states, idx):
    """Reorder the leading (flat beam) axis of every tensor in a nest."""
    if torch.is_tensor(states):
        return torch.index_select(states, 0, idx)
    if isinstance(states, (list, tuple)):
        out = [_gather_states(s, idx) for s in states]
        return out if isinstance(states, list) else tuple(out)
    return states
