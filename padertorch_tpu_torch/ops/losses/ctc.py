"""CTC loss, greedy and prefix beam decoding, and edit distance.

Counterpart of ``padertorch_tpu/ops/losses/ctc.py``.  The JAX function
wraps ``optax.ctc_loss``; the port carries that lattice recursion over in
plain torch, step for step: log-softmax inside, ``log_epsilon = -1e5``
standing for log 0 (not ``-inf``), padded frames holding the state, and
the loss read at each example's label length.  So an infeasible alignment
(more labels than frames allow) gives a large finite loss, as optax does,
where ``torch.nn.functional.ctc_loss`` gives ``inf``.

The decoders and :func:`edit_distance` are host-side numpy, copied from
the JAX package.
"""
import numpy as np
import torch

__all__ = ['ctc_loss', 'ctc_greedy_decode',
           'ctc_beam_search_decode', 'edit_distance']

# optax's numerically stable stand-in for log(0)
LOG_EPSILON = -1e5


def _update_phi(phi, added):
    """``phi[:, 1:]`` log-added with ``added`` (optax's
    ``update_phi_score``)."""
    return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)],
                     dim=-1)


def ctc_loss(logits, logit_lengths, labels, label_lengths, blank=0):
    """Per-example CTC negative log likelihood.

    Args:
        logits: (B, T, V) unnormalized scores (softmax is internal).
        logit_lengths: (B,) valid frames per example.
        labels: (B, N) padded label ids (values != ``blank``).
        label_lengths: (B,) valid labels per example.
        blank: blank label id.

    Returns:
        (B,) loss (sum over frames, not averaged: divide by
        ``label_lengths`` for the torch ``reduction='mean'`` number).

    >>> logits = torch.zeros((1, 4, 3))
    >>> l = ctc_loss(logits, [4], torch.tensor([[1, 2]]), [2])
    >>> tuple(l.shape)
    (1,)
    """
    device = logits.device
    b, t_max, num_classes = logits.shape
    labels = torch.as_tensor(labels, device=device).long()
    n = labels.shape[1]
    logit_lengths = torch.as_tensor(logit_lengths, device=device)
    label_lengths = torch.as_tensor(label_lengths, device=device).long()
    # optax requires blank == 0; remap when the caller uses another id
    # (swap blank <-> 0 in the class axis and in the label ids)
    if blank != 0:
        perm = list(range(num_classes))
        perm[0], perm[blank] = perm[blank], perm[0]
        logits = logits[..., torch.tensor(perm, device=device)]
        labels = torch.where(labels == 0, blank,
                             torch.where(labels == blank, 0, labels))
    logprobs = torch.log_softmax(logits, dim=-1)
    dtype = logprobs.dtype
    pad = (torch.arange(t_max, device=device)[None, :]
           >= logit_lengths[:, None]).to(dtype)             # (B, T)
    # repeat[b, n] == 1 where label n equals label n + 1
    repeat = torch.nn.functional.pad(
        (labels[:, :-1] == labels[:, 1:]).to(dtype), (0, 1))
    logprobs_phi = logprobs[:, :, 0:1]                      # (B, T, 1)
    logprobs_emit = torch.gather(
        logprobs, 2, labels[:, None, :].expand(b, t_max, n))  # (B, T, N)

    phi = torch.full((b, n + 1), LOG_EPSILON, dtype=dtype, device=device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    emit = torch.full((b, n), LOG_EPSILON, dtype=dtype, device=device)
    for t in range(t_max):
        lp_emit, lp_phi = logprobs_emit[:, t], logprobs_phi[:, t]
        p = pad[:, t:t + 1]
        phi_orig = phi
        # emit-to-phi epsilon transition, except before a repetition
        phi = _update_phi(phi, emit + LOG_EPSILON * repeat)
        # phi-to-emit transition and the emit self-loop
        next_emit = torch.logaddexp(phi[:, :-1] + lp_emit, emit + lp_emit)
        # phi self-loop; emit-to-phi blank only before a repetition
        next_phi = _update_phi(
            phi + lp_phi, emit + lp_phi + LOG_EPSILON * (1.0 - repeat))
        emit = p * emit + (1.0 - p) * next_emit
        phi = p * phi_orig + (1.0 - p) * next_phi
    # the last epsilon transition
    phi_last = _update_phi(phi, emit)
    return -phi_last.gather(1, label_lengths[:, None])[:, 0]


def ctc_greedy_decode(logits, logit_lengths=None, blank=0):
    """Best-path decoding: framewise argmax, collapse repeats, drop
    blanks.  Host-side (numpy): use at evaluation time.

    >>> logits = np.zeros((1, 5, 3))
    >>> logits[0, np.arange(5), [1, 1, 0, 2, 2]] = 5.0
    >>> ctc_greedy_decode(logits)
    [[1, 2]]
    """
    logits = np.asarray(logits)
    assert logits.ndim == 3, logits.shape
    path = logits.argmax(-1)  # (B, T)
    out = []
    for b in range(path.shape[0]):
        t = (int(logit_lengths[b]) if logit_lengths is not None
             else path.shape[1])
        seq, prev = [], blank
        for token in path[b, :t]:
            token = int(token)
            if token != blank and token != prev:
                seq.append(token)
            prev = token
        out.append(seq)
    return out


def edit_distance(reference, hypothesis):
    """Levenshtein distance between two token sequences.

    >>> edit_distance([1, 2, 3], [1, 3])
    1
    >>> edit_distance('kitten', 'sitting')
    3
    """
    r, h = list(reference), list(hypothesis)
    d = np.arange(len(h) + 1)
    for i, rt in enumerate(r, 1):
        prev_diag, d[0] = d[0], i
        for j, ht in enumerate(h, 1):
            cur = min(
                d[j] + 1,          # deletion
                d[j - 1] + 1,      # insertion
                prev_diag + (rt != ht),  # substitution
            )
            prev_diag, d[j] = d[j], cur
    return int(d[-1])


def _lse(a, b):
    if a == -np.inf:
        return b
    if b == -np.inf:
        return a
    m = max(a, b)
    return m + np.log(np.exp(a - m) + np.exp(b - m))


def ctc_beam_search_decode(
        logits, logit_lengths=None, blank=0, beam_width=16,
        lm_fn=None, lm_weight=0.0, prune_log_threshold=-12.0,
):
    """CTC prefix beam search (Hannun et al. 2014).  Host-side (numpy).

    Sums the posterior over all alignments of each label prefix by tracking
    per-prefix blank/non-blank ending probabilities in log space, with
    optional shallow fusion of an external language model.

    Args:
        logits: (B, T, V) unnormalized scores.
        logit_lengths: (B,) valid frames.
        blank: blank id.
        beam_width: number of prefixes kept per frame.
        lm_fn: optional ``lm_fn(prefix_tuple, next_token) -> logp``, the
            conditional LM log-probability used when a prefix is extended
            by ``next_token`` (shallow fusion).
        lm_weight: weight of the LM term in the beam score.
        prune_log_threshold: per-frame emission pruning: tokens with
            log-posterior below ``max - |threshold|`` are skipped (None
            disables it).

    Returns:
        list of B label-id lists (the best prefix per example).

    >>> logits = np.zeros((1, 5, 3))
    >>> logits[0, np.arange(5), [1, 1, 0, 2, 2]] = 5.0
    >>> ctc_beam_search_decode(logits, beam_width=4)
    [[1, 2]]
    """
    logits = np.asarray(logits, dtype=np.float64)
    assert logits.ndim == 3, logits.shape
    log_probs = logits - _logsumexp(logits, axis=-1, keepdims=True)
    b, t_max, vocab = log_probs.shape
    neg_inf = -np.inf

    out = []
    for i in range(b):
        t_len = int(logit_lengths[i]) if logit_lengths is not None \
            else t_max
        # prefix -> [log P(prefix, ends in blank), log P(..., non-blank)]
        beams = {(): [0.0, neg_inf]}
        lm_scores = {(): 0.0}  # accumulated LM log-prob per prefix
        for t in range(t_len):
            frame = log_probs[i, t]
            if prune_log_threshold is not None:
                keep = np.flatnonzero(
                    frame >= frame.max() - abs(prune_log_threshold))
            else:
                keep = np.arange(vocab)
            nxt = {}
            nxt_lm = {}

            def _get(prefix):
                if prefix not in nxt:
                    nxt[prefix] = [neg_inf, neg_inf]
                return nxt[prefix]

            for prefix, (pb, pnb) in beams.items():
                p_tot = _lse(pb, pnb)
                for k in keep:
                    k = int(k)
                    pk = frame[k]
                    if k == blank:
                        cell = _get(prefix)
                        cell[0] = _lse(cell[0], p_tot + pk)
                        nxt_lm.setdefault(prefix, lm_scores[prefix])
                    elif prefix and k == prefix[-1]:
                        # repeat: collapses unless a blank separated it
                        cell = _get(prefix)
                        cell[1] = _lse(cell[1], pnb + pk)
                        nxt_lm.setdefault(prefix, lm_scores[prefix])
                        ext = prefix + (k,)
                        cell = _get(ext)
                        cell[1] = _lse(cell[1], pb + pk)
                        if ext not in nxt_lm:
                            nxt_lm[ext] = lm_scores[prefix] + (
                                float(lm_fn(prefix, k)) if lm_fn else 0.0)
                    else:
                        ext = prefix + (k,)
                        cell = _get(ext)
                        cell[1] = _lse(cell[1], p_tot + pk)
                        if ext not in nxt_lm:
                            nxt_lm[ext] = lm_scores[prefix] + (
                                float(lm_fn(prefix, k)) if lm_fn else 0.0)

            def score(item):
                prefix, (pb, pnb) = item
                return _lse(pb, pnb) + lm_weight * nxt_lm[prefix]

            ranked = sorted(nxt.items(), key=score, reverse=True)
            beams = dict(ranked[:beam_width])
            lm_scores = {p: nxt_lm[p] for p in beams}
        best = max(
            beams.items(),
            key=lambda kv: _lse(kv[1][0], kv[1][1])
            + lm_weight * lm_scores[kv[0]])
        out.append(list(best[0]))
    return out


def _logsumexp(x, axis=None, keepdims=False):
    m = np.max(x, axis=axis, keepdims=True)
    s = m + np.log(np.sum(np.exp(x - m), axis=axis, keepdims=True))
    return s if keepdims else np.squeeze(s, axis=axis)
