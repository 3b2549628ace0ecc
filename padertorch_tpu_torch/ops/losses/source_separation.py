"""Source separation losses: deep clustering and permutation-invariant (PIT).

Counterpart of ``padertorch_tpu/ops/losses/source_separation.py``
(reference ``padertorch/ops/losses/source_separation.py``).

The PIT minimum over the K! permutations stays on the device: the
candidates are stacked and reduced with ``min``, so a training step never
waits for the host.  The assignment algorithms for large K
(``pit_loss_from_loss_matrix`` with ``'optimal'`` or ``'greedy'``) run on
the host; only the assignment indices come back and the differentiable
gather happens on the device.
"""
import itertools

import numpy as np
import torch

__all__ = [
    'deep_clustering_loss',
    'pit_loss',
    'compute_pairwise_losses',
    'pit_loss_from_loss_matrix',
]


def deep_clustering_loss(x, t):
    """Deep clustering loss (Hershey 2016), normalized by N^2.

    Args:
        x: embeddings (N, E), assumed unit-norm per row.
        t: target mask (N, K).

    >>> x = torch.eye(4)[:, :2]
    >>> t = torch.tensor([[1., 0], [1, 0], [0, 1], [0, 1]])
    >>> round(float(deep_clustering_loss(x, t)), 4)
    0.375
    """
    n = x.shape[0]
    return (
        torch.sum(torch.einsum('ne,nE->eE', x, x) ** 2)
        - 2 * torch.sum(torch.einsum('ne,nK->eK', x, t) ** 2)
        + torch.sum(torch.einsum('nk,nK->kK', t, t) ** 2)
    ) / n ** 2


def _mse(estimate, target):
    return torch.mean((estimate - target) ** 2)


def _cross_entropy(estimate, target):
    """torch.nn.functional.cross_entropy semantics: class axis = 1."""
    return torch.nn.functional.cross_entropy(estimate, target)


def pit_loss(
        estimate,
        target,
        axis,
        loss_fn=_mse,
        return_permutation=False,
):
    """Permutation-invariant loss: min of ``loss_fn`` over all permutations.

    Does not support a batch axis.

    Args:
        estimate: e.g. (T, K, F); the speaker axis is ``axis``.
        target: same shape (or, for ``loss_fn='cross_entropy'``, the shape
            without the class axis, integer class labels).
        axis: speaker axis K; permutations are applied along it.
        loss_fn: callable(estimate, target) -> scalar, or the string
            'cross_entropy' (class axis == ``axis`` == 1).
        return_permutation: also return the argmin permutation, a (K,)
            integer tensor on the device.

    >>> T, K, F = 4, 2, 5
    >>> float(pit_loss(torch.ones((T, K, F)), torch.zeros((T, K, F)), 1))
    1.0
    >>> est = torch.stack([torch.ones((5, 4)), torch.zeros((5, 4))])
    >>> tgt = est[[1, 0]]
    >>> loss, perm = pit_loss(est, tgt, axis=0, return_permutation=True)
    >>> float(loss), tuple(int(i) for i in perm)
    (0.0, (1, 0))
    >>> round(float(pit_loss(torch.ones((4, 2, 5)),
    ...       torch.zeros((4, 5), dtype=torch.long), 1,
    ...       loss_fn='cross_entropy')), 4)
    0.6931
    """
    sources = estimate.shape[axis]
    assert sources < 30, (
        f'Are you sure? sources={sources}, estimate.shape={estimate.shape}')

    if loss_fn == 'cross_entropy' or loss_fn is _cross_entropy:
        # identity check, not __name__: a user's callable that happens to
        # be named 'cross_entropy' is not replaced by this module's
        loss_fn = _cross_entropy
        assert axis % estimate.dim() == 1, axis
        estimate_shape = list(estimate.shape)
        del estimate_shape[axis]
        assert estimate_shape == list(target.shape), (
            f'{estimate.shape} (N, K, ...) does not match {target.shape}')
    else:
        assert estimate.shape == target.shape, (
            f'{estimate.shape} != {target.shape}')

    permutations = list(itertools.permutations(range(sources)))
    parts = estimate.unbind(axis)
    candidates = torch.stack([
        loss_fn(torch.stack([parts[i] for i in p], dim=axis), target)
        for p in permutations
    ])
    min_loss, index = torch.min(candidates, dim=0)
    if return_permutation:
        table = torch.as_tensor(permutations, device=estimate.device)
        return min_loss, table[index]
    return min_loss


def compute_pairwise_losses(
        estimate,
        target,
        axis,
        loss_fn=_mse,
):
    """K x K matrix of ``loss_fn(estimate_i, target_j)``.

    For factorizable losses this reduces PIT from O(K!) to O(K^2) loss
    evaluations + an assignment problem
    (see :func:`pit_loss_from_loss_matrix`).

    >>> m = compute_pairwise_losses(
    ...     torch.ones((4, 2, 5)), torch.zeros((4, 2, 5)), 1)
    >>> m.shape
    torch.Size([2, 2])
    """
    sources = estimate.shape[axis]
    assert sources < 30, f'Are you sure? sources={sources}'
    if loss_fn == 'cross_entropy' or loss_fn is _cross_entropy:
        assert axis % estimate.dim() == 1, axis
        logp = -torch.log_softmax(estimate, dim=1)
        one_hot = torch.nn.functional.one_hot(target, sources).to(
            estimate.dtype)
        # 'nc...,n...k->ck' with mean over n and ...
        pair = torch.einsum('nc...,n...k->ck', logp, one_hot)
        return pair / target.numel()

    assert estimate.shape == target.shape, (estimate.shape, target.shape)
    return torch.stack([
        torch.stack([loss_fn(e_i, t_j) for t_j in target.unbind(axis)])
        for e_i in estimate.unbind(axis)])


def _greedy_assignment(loss_matrix):
    """Greedy assignment: repeatedly take the global min, exclude row/col."""
    loss_matrix = np.array(loss_matrix, dtype=np.float64, copy=True)
    k = loss_matrix.shape[0]
    col_ind = np.zeros(k, dtype=np.int64)
    for _ in range(k):
        i, j = np.unravel_index(np.argmin(loss_matrix), loss_matrix.shape)
        col_ind[i] = j
        loss_matrix[i, :] = np.inf
        loss_matrix[:, j] = np.inf
    return col_ind


def _optimal_assignment(loss_matrix):
    import scipy.optimize
    _, col_ind = scipy.optimize.linear_sum_assignment(
        np.asarray(loss_matrix, dtype=np.float64))
    return col_ind.astype(np.int64)


def pit_loss_from_loss_matrix(
        pair_wise_loss_matrix,
        *,
        reduction='mean',
        algorithm='optimal',
        return_permutation=False,
):
    """PIT loss given a K x K pairwise-loss matrix.

    ``algorithm='optimal'`` (Hungarian) and ``'greedy'`` solve the
    assignment on the host; ``'brute_force'`` enumerates the permutations
    on the device (for small K inside a training step).

    >>> score = torch.tensor([[11., 10, 0], [4, 5, 10], [6, 0, 5]])
    >>> float(pit_loss_from_loss_matrix(-score, reduction='sum'))
    -26.0
    >>> float(pit_loss_from_loss_matrix(
    ...     -score, reduction='sum', algorithm='greedy'))
    -21.0
    >>> [float(x) for x in pit_loss_from_loss_matrix(
    ...     -score, reduction=None, algorithm='greedy')]
    [-11.0, -10.0, -0.0]
    """
    matrix = pair_wise_loss_matrix
    assert matrix.dim() == 2, matrix.shape
    k = matrix.shape[-1]
    assert matrix.shape[-2] == k, matrix.shape
    rows = torch.arange(k, device=matrix.device)

    if algorithm == 'brute_force':
        table = torch.as_tensor(
            list(itertools.permutations(range(k))), device=matrix.device)
        per_perm = matrix[rows[None, :], table]              # (K!, K)
        idx = torch.argmin(per_perm.sum(-1))
        picked = per_perm[idx]
        col_ind = table[idx]
    else:
        if algorithm in ('optimal', 'hungarian'):
            assign = _optimal_assignment
        elif algorithm == 'greedy':
            assign = _greedy_assignment
        else:
            raise ValueError(algorithm)
        col_ind = torch.as_tensor(
            assign(matrix.detach().cpu().numpy()), device=matrix.device)
        picked = matrix[rows, col_ind]

    if reduction is None or reduction == 'none':
        min_loss = picked
    elif reduction == 'mean':
        min_loss = picked.mean()
    elif reduction == 'sum':
        min_loss = picked.sum()
    else:
        raise ValueError(reduction)

    if return_permutation:
        return min_loss, col_ind
    return min_loss
