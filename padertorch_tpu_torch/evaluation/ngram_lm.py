"""Count-based n-gram language model for decode-time shallow fusion.

Counterpart of ``padertorch_tpu/evaluation/ngram_lm.py``, copied: it pairs
with :func:`padertorch_tpu_torch.ops.losses.ctc.ctc_beam_search_decode`'s
``lm_fn(prefix, token)`` contract.  Pure host-side numpy: the fusion
happens inside the host beam search, the acoustic scores come from the
model's forward on its device.
"""
import numpy as np

__all__ = ['NGramLM']


class NGramLM:
    """Add-k smoothed n-gram LM over integer token sequences.

    >>> lm = NGramLM(order=2, add_k=0.1)
    >>> _ = lm.fit([[1, 2, 3], [1, 2, 1, 2]])
    >>> lm((1,), 2) > lm((1,), 3)  # "1 -> 2" seen 3x, "1 -> 3" never
    True
    >>> import numpy as np
    >>> probs = [np.exp(lm((1,), t)) for t in lm.vocab]
    >>> round(float(sum(probs)), 6)  # normalized over the vocabulary
    1.0
    """

    BOS = -1  # sentence-start context token (never predicted)

    def __init__(self, order=2, add_k=0.5):
        assert order >= 1, order
        self.order = order
        self.add_k = float(add_k)
        self._counts = {}      # context tuple -> {token: count}
        self._totals = {}      # context tuple -> total count
        self.vocab = ()

    def fit(self, sequences):
        vocab = set()
        counts = {}
        totals = {}
        for seq in sequences:
            seq = [int(t) for t in seq]
            vocab.update(seq)
            padded = [self.BOS] * (self.order - 1) + seq
            for i in range(len(seq)):
                ctx = tuple(padded[i:i + self.order - 1])
                tok = seq[i]
                bucket = counts.setdefault(ctx, {})
                bucket[tok] = bucket.get(tok, 0) + 1
                totals[ctx] = totals.get(ctx, 0) + 1
        self.vocab = tuple(sorted(vocab))
        self._counts = counts
        self._totals = totals
        # drop the memoized vocab set: a same-SIZE refit with a
        # different vocabulary would otherwise keep scoring against
        # the stale set (length-based invalidation can't see it)
        self.__dict__.pop('_vocab_set_cache', None)
        return self

    def _context(self, prefix):
        need = self.order - 1
        prefix = tuple(int(t) for t in prefix)
        if len(prefix) >= need:
            return prefix[len(prefix) - need:]
        return (self.BOS,) * (need - len(prefix)) + prefix

    def __call__(self, prefix, token):
        """log P(token | prefix) with add-k smoothing (the
        ``lm_fn`` contract of the CTC beam search)."""
        if not self.vocab:
            raise RuntimeError('NGramLM must be fit() before scoring.')
        token = int(token)
        ctx = self._context(prefix)
        bucket = self._counts.get(ctx, {})
        total = self._totals.get(ctx, 0)
        num = bucket.get(token, 0) + self.add_k
        den = total + self.add_k * len(self.vocab)
        if token not in self._vocab_set:
            # unseen token id: smoothed floor
            num = self.add_k
        return float(np.log(num) - np.log(den))

    @property
    def _vocab_set(self):
        if not hasattr(self, '_vocab_set_cache') or \
                len(self._vocab_set_cache) != len(self.vocab):
            self._vocab_set_cache = set(self.vocab)
        return self._vocab_set_cache

    def perplexity(self, sequences):
        """exp(mean negative log likelihood) over the given corpus."""
        nll, n = 0.0, 0
        for seq in sequences:
            seq = [int(t) for t in seq]
            for i in range(len(seq)):
                nll -= self(seq[:i], seq[i])
                n += 1
        return float(np.exp(nll / max(n, 1)))
