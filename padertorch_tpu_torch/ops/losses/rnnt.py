"""RNN-T (transducer) loss, greedy decoding and beam search.

Counterpart of ``padertorch_tpu/ops/losses/rnnt.py``.  The transducer
lattice forward (Graves 2012) keeps the JAX package's closed form: the
textbook recurrence

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + label[t, u-1])

is, for a fixed t, a first-order linear recurrence over u in the log
semiring, ``a[u] = logaddexp(h[u], a[u-1] + c[u-1])`` with
``h = alpha[t-1] + blank[t-1]`` and ``c = label[t]``, whose closed form
``a[u] = C[u] + logcumsumexp_u(h - C)`` with ``C`` the exclusive cumsum
of ``c`` is one ``torch.logcumsumexp`` per step: one loop over t, the
label axis in parallel.  Autograd gives the gradient.

The decoders are host-side (numpy) loops around a caller's joint
function, copied from the JAX package.
"""
import numpy as np
import torch

from padertorch_tpu_torch.ops.losses.ctc import _lse

__all__ = ['rnnt_loss', 'rnnt_greedy_decode', 'rnnt_beam_search']

# Blocked transitions get a large-but-finite penalty instead of -inf: the
# closed form exponentiates h - cumsum(c), and a true -inf in c would turn
# that difference into inf or nan in the backward (a zero cotangent times
# nan is nan).  exp(-1e4) underflows to exactly 0 in float32, so blocked
# paths still contribute nothing.
_NEG_INF = -1e4


def rnnt_loss(logits, logit_lengths, labels, label_lengths, blank=0):
    """Per-example transducer negative log likelihood.

    Args:
        logits: (B, T, U+1, V) joint-network outputs (log-softmax is
            internal), where U is the padded label length: position
            ``(t, u)`` scores the next symbol after emitting ``u`` labels
            and consuming ``t`` frames.
        logit_lengths: (B,) valid frames per example.
        labels: (B, U) padded label ids (values != ``blank``).
        label_lengths: (B,) valid labels per example.
        blank: blank label id.

    Returns:
        (B,) negative log likelihood (sum over the lattice).

    >>> logits = torch.zeros((1, 3, 3, 5))
    >>> nll = rnnt_loss(logits, [3], torch.tensor([[1, 2]]), [2])
    >>> tuple(nll.shape)
    (1,)
    >>> # uniform logits: every lattice path has T+U emissions of
    >>> # prob 1/V, and there are C(T-1+U, U) = C(4, 2) = 6 paths
    >>> import math
    >>> round(float(nll[0]) - (5 * math.log(5.0) - math.log(6.0)), 4)
    0.0
    """
    device = logits.device
    b, t_max, u_plus_1, _ = logits.shape
    u_max = u_plus_1 - 1
    logit_lengths = torch.as_tensor(logit_lengths, device=device).long()
    label_lengths = torch.as_tensor(label_lengths, device=device).long()
    labels = torch.as_tensor(labels, device=device).long()
    assert tuple(labels.shape) == (b, u_max), (labels.shape, logits.shape)

    lp = torch.log_softmax(logits, dim=-1)
    blank_lp = lp[..., blank]                               # (B, T, U+1)
    # label transition u -> u+1 emits labels[:, u]
    label_lp = torch.gather(
        lp[:, :, :u_max, :], 3,
        labels[:, None, :, None].expand(b, t_max, u_max, 1))[..., 0]
    # forbid label transitions beyond each example's label length
    u_idx = torch.arange(u_max, device=device)[None, None, :]
    label_lp = torch.where(u_idx < label_lengths[:, None, None], label_lp,
                           torch.full_like(label_lp, _NEG_INF))

    # alpha[0, u]: u label moves within the first frame
    alpha = torch.cat([torch.zeros_like(label_lp[:, 0, :1]),
                       torch.cumsum(label_lp[:, 0, :], dim=1)], dim=1)
    alphas = [alpha]
    for t in range(1, t_max):
        h = alpha + blank_lp[:, t - 1]              # horizontal moves
        c = torch.nn.functional.pad(label_lp[:, t], (0, 1))
        cum_c = torch.cumsum(c, dim=1) - c          # exclusive cumsum
        alpha = cum_c + torch.logcumsumexp(h - cum_c, dim=1)
        alphas.append(alpha)
    alphas = torch.stack(alphas, dim=1)                     # (B, T, U+1)

    # NLL = -(alpha[T_b - 1, U_b] + blank[T_b - 1, U_b])
    t_last = torch.clamp(logit_lengths - 1, 0, t_max - 1)
    rows = torch.arange(b, device=device)
    return -(alphas[rows, t_last, label_lengths]
             + blank_lp[rows, t_last, label_lengths])


def rnnt_greedy_decode(joint_fn, encoder_out, logit_lengths=None,
                       blank=0, max_symbols_per_frame=4):
    """Greedy (best-path) transducer decoding.  Host-side (numpy).

    Args:
        joint_fn: ``joint_fn(enc_frame, emitted_prefix) -> (V,) scores``;
            the caller closes over its prediction network and joint.
        encoder_out: (B, T, E) encoder frames.
        logit_lengths: (B,) valid frames.
        blank: blank id.
        max_symbols_per_frame: cap on label emissions per frame.

    Returns:
        list of B label-id lists.
    """
    encoder_out = np.asarray(encoder_out)
    b, t_max = encoder_out.shape[:2]
    out = []
    for i in range(b):
        t_len = int(logit_lengths[i]) if logit_lengths is not None \
            else t_max
        seq = []
        for t in range(t_len):
            for _ in range(max_symbols_per_frame):
                scores = np.asarray(joint_fn(encoder_out[i, t], seq))
                token = int(scores.argmax())
                if token == blank:
                    break
                seq.append(token)
        out.append(seq)
    return out


def rnnt_beam_search(joint_fn, encoder_out, logit_lengths=None,
                     blank=0, beam_width=8, max_symbols_per_frame=4,
                     joint_batch_fn=None):
    """Transducer beam search, depth-synchronous per frame.

    Within each frame, hypotheses are expanded breadth-first by the number
    of labels emitted in that frame (depth): every expansion strictly
    lengthens the prefix, so all incoming probability mass of a prefix is
    summed before it is expanded.  Host-side (numpy).

    Args:
        joint_fn: ``joint_fn(enc_frame, emitted_prefix) -> (V,)``
            unnormalized scores (as :func:`rnnt_greedy_decode`'s).
        encoder_out: (B, T, E) encoder frames.
        logit_lengths: (B,) valid frames.
        blank: blank id.
        beam_width: hypotheses kept per expansion level and per frame.
        max_symbols_per_frame: cap on labels emitted per frame.
        joint_batch_fn: optional ``(frame, [prefix, ...]) -> (K, V)``
            batched scorer: all hypotheses of an expansion level in one
            call (one batch of K rows on the device instead of K calls).

    Returns:
        list of B label-id lists.
    """
    encoder_out = np.asarray(encoder_out)
    b, t_max = encoder_out.shape[:2]
    neg_inf = -np.inf

    out = []
    for i in range(b):
        t_len = int(logit_lengths[i]) if logit_lengths is not None \
            else t_max
        hyps = {(): 0.0}  # prefix -> log P(prefix, t frames consumed)
        for t in range(t_len):
            frame = encoder_out[i, t]
            lp_cache = {}

            def log_probs(prefix):
                if prefix not in lp_cache:
                    scores = np.asarray(
                        joint_fn(frame, list(prefix)), dtype=np.float64)
                    m = scores.max()
                    lp_cache[prefix] = scores - (
                        m + np.log(np.exp(scores - m).sum()))
                return lp_cache[prefix]

            def fill_cache_batched(prefixes):
                missing = [p for p in prefixes if p not in lp_cache]
                if not missing:
                    return
                scores = np.asarray(
                    joint_batch_fn(frame, missing), dtype=np.float64)
                m = scores.max(-1, keepdims=True)
                lps = scores - (m + np.log(
                    np.exp(scores - m).sum(-1, keepdims=True)))
                for p, lp in zip(missing, lps):
                    lp_cache[p] = lp

            done = {}
            level = hyps
            for depth in range(max_symbols_per_frame + 1):
                if not level:
                    break
                if joint_batch_fn is not None:
                    fill_cache_batched(list(level))
                nxt = {}
                for y, p in level.items():
                    lp = log_probs(y)
                    done[y] = _lse(done.get(y, neg_inf), p + lp[blank])
                    if depth < max_symbols_per_frame:
                        for k in range(lp.shape[0]):
                            if k == blank:
                                continue
                            ext = y + (k,)
                            nxt[ext] = _lse(
                                nxt.get(ext, neg_inf), p + lp[k])
                level = dict(sorted(
                    nxt.items(), key=lambda kv: kv[1],
                    reverse=True)[:beam_width])
            hyps = dict(sorted(done.items(), key=lambda kv: kv[1],
                               reverse=True)[:beam_width])
        best = max(hyps, key=hyps.get)
        out.append(list(best))
    return out
