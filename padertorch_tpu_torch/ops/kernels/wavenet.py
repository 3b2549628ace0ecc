"""Persistent WaveNet autoregressive sampler.

Counterpart of ``padertorch_tpu/ops/pallas/wavenet.py`` ``wavenet_sample``.
On CUDA tensors :func:`wavenet_sample` launches the hand-written kernel of
``csrc/wavenet_sample.cu`` once for all T steps; on CPU tensors it runs
:func:`wavenet_sample_plain`, a Python loop over the steps with the same
ring buffers.

The kernel has two routes, chosen from the shape and the card's limits
before the launch by :func:`cluster_plan`: for few rows a row runs on a
thread-block cluster of N CTAs (2 to 16), each owning 1/N of every
product's columns (with its weight slices in shared memory where they
fit); where B clusters would not run in one wave, one block per row.  A
column's sum is the same on both routes, so a row gives the same bits on
either.  A launch that fails on its route raises; it is never retried on
the other.  ``wavenet_sample.routes`` counts the launches by route.

The kernel takes every geometry the JAX sampler takes: any number of
layers (the dilations go through device memory); R, S and O that are not
multiples of 4 (the wrapper zero-pads the weights, which is exact: a zero
residual channel gates to tanh(0) sigmoid(0) = 0, and a zero skip or
hidden channel meets zero rows of the next weights; the padded outputs
take no part in the choice); and rings of any size (a ring that one block
cannot hold goes to the cluster that holds it, rows in waves of clusters;
one that no cluster holds to device memory, :class:`ClusterPlan`
``ring_global``).

Stochastic sampling is Gumbel-max over uniforms from a counter-based
generator keyed by (seed, step, row, class): :func:`wavenet_uniform` is
that generator in integer tensor operations, bit for bit what the kernel
draws, so kernel and plain version choose the same index from the same
logits.  (The TPU kernel draws from its hardware generator: the JAX
package's sampled output agrees with the port's in distribution only.)
"""
import ctypes
import functools
from typing import NamedTuple

import torch

from padertorch_tpu_torch.ops.kernels import _build

__all__ = ['wavenet_sample', 'wavenet_sample_plain', 'wavenet_uniform',
           'ring_bytes', 'ClusterPlan', 'cluster_plan', 'cluster_smem',
           'sample_smem', 'owned_columns', 'device_plan', 'cluster_weights']

START_INDEX = 128   # mu-law zero, the index "before" the first sample
WEIGHT_SHAPES = {   # in terms of L, R, S, O, C
    'w_prev': 'LRr', 'w_curr': 'LRr', 'b_dil': 'Lr', 'w_res': 'lRR',
    'b_res': 'lR', 'w_skip': 'LRS', 'b_skip': 'LS', 'w_out': 'SO',
    'w_end': 'OO', 'embed': 'CR'}
_M32 = 0xFFFFFFFF


def _mul32(x, m):
    """``(x * m) mod 2**32`` for int64 tensors below 2**32, without an
    int64 overflow: the multiplier in 16-bit halves."""
    low = x * (m & 0xFFFF)
    high = ((x * (m >> 16)) & 0xFFFF) << 16
    return (low + high) & _M32


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7feb352d)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846ca68b)
    return x ^ (x >> 16)


def wavenet_uniform(seed, steps, n_rows, n_classes, device=None):
    """The kernel's uniforms in [0, 1): float32 ``(len(steps), n_rows,
    n_classes)`` for the int steps ``steps`` (a 1-D tensor or a sequence).

    Three rounds of a 32-bit mixer over seed and step, then row, then
    class; the upper 24 bits of the result over 2**24 (the mapping of
    ``_uniform_from_bits`` in the JAX package).
    """
    steps = torch.as_tensor(steps, dtype=torch.int64, device=device)
    device = steps.device
    rows = torch.arange(n_rows, dtype=torch.int64, device=device)
    classes = torch.arange(n_classes, dtype=torch.int64, device=device)
    key = _mix32((int(seed) & _M32) ^ _mul32(steps, 0x9E3779B1))
    key = _mix32(key[:, None] ^ _mul32(rows, 0x85EBCA77)[None, :])
    bits = _mix32(key[:, :, None] ^ _mul32(classes, 0xC2B2AE3D))
    return ((bits >> 8) & 0xFFFFFF).to(torch.float32) / float(1 << 24)


def _gumbel(u):
    return -torch.log(-torch.log(u + 1e-20) + 1e-20)


def _sizes(cond_acts, weights, dilations, forced_input):
    """Check shapes, types and devices; returns (T, B, L, R, S, O, C)."""
    if cond_acts.ndim != 4 or cond_acts.shape[-1] % 2:
        raise ValueError(f'cond_acts must be (T, B, L, 2R), got '
                         f'{tuple(cond_acts.shape)}')
    t, b, n_layers, two_r = cond_acts.shape
    if len(dilations) != n_layers or n_layers < 1:
        raise ValueError(f'{len(dilations)} dilations for {n_layers} layers')
    if any(int(d) < 1 for d in dilations):
        raise ValueError(f'dilations must be positive: {dilations}')
    missing = sorted(set(WEIGHT_SHAPES) - set(weights))
    if missing:
        raise KeyError(f'weights lack {missing}')
    dims = {'L': n_layers, 'l': n_layers - 1, 'R': two_r // 2, 'r': two_r,
            'S': weights['w_skip'].shape[-1], 'O': weights['w_end'].shape[-1],
            'C': weights['embed'].shape[0]}
    for name, spec in WEIGHT_SHAPES.items():
        w = weights[name]
        want = tuple(dims[c] for c in spec)
        if tuple(w.shape) != want:
            raise ValueError(f'{name}: {tuple(w.shape)}, expected {want}')
        if w.dtype != torch.float32 or w.device != cond_acts.device:
            raise ValueError(f'{name}: {w.dtype} on {w.device}, expected '
                             f'float32 on {cond_acts.device}')
    if dims['C'] <= START_INDEX or dims['O'] > dims['C']:
        raise ValueError(
            f'the sampler starts from index {START_INDEX} and feeds its '
            f'choice among {dims["O"]} outputs back into an embedding of '
            f'{dims["C"]} rows')
    if forced_input is not None and (
            tuple(forced_input.shape) != (t, b)
            or forced_input.device != cond_acts.device):
        raise ValueError(f'forced_input must be (T, B) = {(t, b)} on '
                         f'{cond_acts.device}')
    return t, b, n_layers, dims['R'], dims['S'], dims['O'], dims['C']


def ring_bytes(dilations, n_residual_channels):
    """Bytes of one row's ring buffers (float32): sum(dilations) x R."""
    return 4 * sum(int(d) for d in dilations) * n_residual_channels


def wavenet_sample_plain(cond_acts, weights, dilations, *, seed=0,
                         sample=False, forced_input=None,
                         return_logits=False):
    """Plain PyTorch version of :func:`wavenet_sample` (same contract): a
    Python loop over the steps, one ring buffer of ``d`` slots per layer."""
    t, b, n_layers, r, _, o_dim, _ = _sizes(
        cond_acts, weights, dilations, forced_input)
    w = weights
    cond_acts = cond_acts.to(torch.float32)
    device = cond_acts.device
    rings = [cond_acts.new_zeros((int(d), b, r)) for d in dilations]
    prev = torch.full((b,), START_INDEX, dtype=torch.int64, device=device)
    indices, all_logits = [], []
    for step in range(t):
        cur = prev if forced_input is None else forced_input[step].long()
        x = w['embed'][cur]                                     # (B, R)
        skip_sum = None
        for i, d in enumerate(dilations):
            slot = step % int(d)
            in_act = (rings[i][slot] @ w['w_prev'][i] + x @ w['w_curr'][i]
                      + w['b_dil'][i] + cond_acts[step, :, i])
            acts = torch.tanh(in_act[:, :r]) * torch.sigmoid(in_act[:, r:])
            # the ring keeps the layer's input; step 0 is the phantom
            # position before the shift (training pads it with zeros)
            rings[i][slot] = x if step > 0 else 0.0
            s = acts @ w['w_skip'][i] + w['b_skip'][i]
            skip_sum = s if skip_sum is None else skip_sum + s
            if i < n_layers - 1:
                x = acts @ w['w_res'][i] + w['b_res'][i] + x
        out = torch.relu(torch.relu(skip_sum) @ w['w_out'])
        logits = out @ w['w_end']                               # (B, O)
        score = logits
        if sample:
            score = logits + _gumbel(wavenet_uniform(
                seed, [step], b, o_dim, device=device)[0])
        prev = torch.argmax(score, dim=-1)
        indices.append(prev.to(torch.int32))
        if return_logits:
            all_logits.append(logits)
    idx = torch.stack(indices)
    if return_logits:
        return idx, torch.stack(all_logits)
    return idx


CLUSTER_SIZES = (16, 8, 4, 2)   # the kernel's cluster routes, largest first


class ClusterPlan(NamedTuple):
    """How the kernel runs a batch: ``n`` CTAs per row (a cluster; 1 is
    one block per row), each with its weight slices in shared memory
    (``resident``) or read through L2, ``smem`` bytes of dynamic shared
    memory per CTA, and the rings in shared memory or, ``ring_global``, in
    device memory."""
    n: int
    resident: bool
    smem: int
    ring_global: bool = False


def _ceil(a, b):
    return -(-a // b)


def _round4(n):
    return _ceil(n, 4) * 4


def owned_columns(n_cols, n):
    """(n, ceil(n_cols / n)) int64: the columns of each CTA of a cluster of
    ``n``, CTA c owning c, c + n, c + 2n, ...; -1 past the last column."""
    idx = (torch.arange(_ceil(n_cols, n))[None, :] * n
           + torch.arange(n)[:, None])
    return torch.where(idx < n_cols, idx, -1)


def sample_smem(n_layers, r, s, o, slots, n, resident, ring=True):
    """Bytes of dynamic shared memory a CTA of a cluster of ``n`` needs
    (``csrc/wavenet_sample.cu`` ``smem_floats``): the layers' dilations
    and ring offsets (2 L ints), its ring channels (slots, ceil(R / n);
    none unless ``ring``), conditioning (L, 2, ceil(R / n)), [x_past, x],
    acts, skip and hid (2R + R + S + O), its logits (ceil(O / n)), its
    skip/residual biases (L, ceil((S + R) / n)), on a cluster two buffers
    of its values of a product and, ``resident``, its weight slices."""
    ru, cb, co = _ceil(r, n), _ceil(s + r, n), _ceil(o, n)
    floats = (_round4(2 * n_layers) + (_round4(slots * ru) if ring else 0)
              + _round4(n_layers * 2 * ru) + 3 * r + s
              + o + _round4(co) + _round4(n_layers * cb))
    if n > 1:
        floats += 2 * _round4(max(ru, cb, co))
    if resident:
        floats += (n_layers * 2 * ru * 2 * r + n_layers * cb * r
                   + co * (s + o))
    return 4 * floats


def cluster_smem(n_layers, r, s, o, slots, n, max_smem, ring=True):
    """(resident, bytes) of a CTA of a cluster of ``n`` on a card whose
    blocks may opt in to ``max_smem`` bytes of shared memory (its rings in
    shared memory unless ``ring`` is False): its weight slices stay in
    shared memory where they fit, and it asks for more than half of
    ``max_smem``, so that no two CTAs share an SM."""
    resident = sample_smem(n_layers, r, s, o, slots, n, True,
                           ring) <= max_smem
    return resident, max(sample_smem(n_layers, r, s, o, slots, n, resident,
                                     ring),
                         max_smem // 2 + 16)


def cluster_plan(batch, n_layers, r, s, o, slots, n_sm, max_smem,
                 max_clusters):
    """The route for ``batch`` rows of a sampler of ``n_layers`` layers, R,
    S and O channels and ``slots`` ring slots (the sum of the dilations),
    on a card of ``n_sm`` SMs whose blocks may opt in to ``max_smem``
    bytes of shared memory; ``max_clusters(n, smem)`` is how many clusters
    of ``n`` CTAs with ``smem`` bytes each the card runs at once.

    The largest cluster (16, 8, 4, 2) for which all ``batch`` clusters run
    in one wave, one CTA per SM (:func:`cluster_smem`), and every CTA owns
    a column of each product (n <= R, S, O).  Where no cluster size serves
    the batch in one wave (a throughput batch: 132 or 264 rows), one block
    per row.  Where one block cannot hold a row's rings, the smallest
    cluster whose CTAs hold their share, its rows in waves (clusters do
    not wait for each other); where no cluster can, the rings go to device
    memory (``ring_global``), one block per row.
    """
    sizes = [n for n in CLUSTER_SIZES if n <= min(r, s, o)]
    for n in sizes:
        if batch * n > n_sm:
            continue
        resident, smem = cluster_smem(n_layers, r, s, o, slots, n, max_smem)
        if smem <= max_smem and max_clusters(n, smem) >= batch:
            return ClusterPlan(n, resident, smem)
    smem = sample_smem(n_layers, r, s, o, slots, 1, False)
    if smem <= max_smem:
        return ClusterPlan(1, False, smem)
    for n in reversed(sizes):
        resident, smem = cluster_smem(n_layers, r, s, o, slots, n, max_smem)
        if smem <= max_smem:
            return ClusterPlan(n, resident, smem)
    return ClusterPlan(1, False, sample_smem(n_layers, r, s, o, slots, 1,
                                             False, ring=False), True)


@functools.lru_cache(maxsize=None)
def _max_clusters(device, n, smem):
    out = (ctypes.c_int * 1)()
    lib = _build.load_library()
    err = lib.wavenet_sample_max_clusters(n, smem, device,
                                          ctypes.addressof(out))
    _build.check(lib, err, 'wavenet_sample cluster occupancy')
    return out[0]


def device_plan(batch, n_layers, r, s, o, slots, device):
    """:func:`cluster_plan` at the limits of the card ``device`` (an
    index), as the CUDA runtime reports them."""
    props = torch.cuda.get_device_properties(device)
    return cluster_plan(
        batch, n_layers, r, s, o, slots, props.multi_processor_count,
        props.shared_memory_per_block_optin,
        functools.partial(_max_clusters, device))


def _gather_owned(x, dim, n):
    """``x`` with dimension ``dim`` (the columns) replaced by each CTA's
    columns (:func:`owned_columns`, zeros past the last), the CTAs as a new
    leading dimension."""
    cols = owned_columns(x.shape[dim], n)
    pad = torch.cat([x, x.new_zeros(x.shape[:dim] + (1,)
                                    + x.shape[dim + 1:])], dim=dim)
    idx = torch.where(cols < 0, x.shape[dim], cols).reshape(-1)
    out = pad.index_select(dim, idx.to(x.device))
    out = out.reshape(x.shape[:dim] + cols.shape + x.shape[dim + 1:])
    return out.movedim(dim, 0).contiguous()


def cluster_weights(weights, n):
    """The sampler's weights in the kernel's per-CTA layout for clusters
    of ``n`` (1: one block per row): ``wa`` (n, L, 2 RU, 2R), row 2u + h
    the tanh (h = 0) or sigmoid (h = 1) column of the CTA's unit u, over
    [x_past, x]; ``b_dil`` (n, L, 2, RU); ``wb`` (n, L, CB, R) the skip and
    residual columns; ``b_sr`` (n, L, CB); ``wo`` (n, CO, S) and ``we`` (n,
    CO, O), w_out's and w_end's columns (every product's weights as
    (outputs, K))."""
    w = weights
    n_layers, r = w['b_dil'].shape[0], w['w_prev'].shape[1]
    # a layer's two dilated products are one over [x_past, x], its skip
    # and residual products one with S + R outputs (no residual in the last
    # layer: zeros that the kernel does not use)
    wd_t = torch.cat([w['w_prev'], w['w_curr']], dim=1).transpose(1, 2)
    per_unit = wd_t.reshape(n_layers, 2, r, 2 * r).transpose(1, 2)
    wa = _gather_owned(per_unit, 1, n).reshape(n, n_layers, -1, 2 * r)
    b_dil = _gather_owned(w['b_dil'].reshape(n_layers, 2, r), 2, n)
    w_res = torch.cat([w['w_res'], w['w_res'].new_zeros((1, r, r))])
    wsr_t = torch.cat([w['w_skip'], w_res], dim=2).transpose(1, 2)
    b_res = torch.cat([w['b_res'], w['b_res'].new_zeros((1, r))])
    b_sr = torch.cat([w['b_skip'], b_res], dim=1)
    return {'wa': wa, 'b_dil': b_dil, 'wb': _gather_owned(wsr_t, 1, n),
            'b_sr': _gather_owned(b_sr, 1, n),
            'wo': _gather_owned(w['w_out'].t(), 0, n),
            'we': _gather_owned(w['w_end'].t(), 0, n)}


def _pad_channels(cond_acts, weights, r, s_dim, o_dim):
    """cond_acts and the weights with R, S and O zero-padded to multiples
    of 4 (the tanh and the sigmoid halves of the dilated layers' 2R columns
    each padded): what the kernel loads four at a time.  Exact: a zero
    residual channel gates to tanh(0) sigmoid(0) = 0 and carries no
    residual; a zero skip or hidden channel meets zero rows of the next
    weights.  Returns (cond_acts, weights, R, S, O) padded."""
    rp, sp, op = _round4(r), _round4(s_dim), _round4(o_dim)
    if (rp, sp, op) == (r, s_dim, o_dim):
        return cond_acts, weights, r, s_dim, o_dim

    def pad(x, *widths):
        """x zero-padded at the end of its last len(widths) axes."""
        grow = []
        for axis, width in zip(range(-1, -len(widths) - 1, -1),
                               reversed(widths)):
            grow += [0, width - x.shape[axis]]
        return torch.nn.functional.pad(x, grow)

    def gates(x):
        """(..., 2R) -> (..., 2Rp): each half padded."""
        return torch.cat([pad(x[..., :r], rp), pad(x[..., r:], rp)], dim=-1)

    w = weights
    padded = {
        'w_prev': gates(pad(w['w_prev'], rp, 2 * r)),
        'w_curr': gates(pad(w['w_curr'], rp, 2 * r)),
        'b_dil': gates(w['b_dil']),
        'w_res': pad(w['w_res'], rp, rp), 'b_res': pad(w['b_res'], rp),
        'w_skip': pad(w['w_skip'], rp, sp), 'b_skip': pad(w['b_skip'], sp),
        'w_out': pad(w['w_out'], sp, op), 'w_end': pad(w['w_end'], op, op),
        'embed': pad(w['embed'], rp)}
    return gates(cond_acts), padded, rp, sp, op


def _launch(cond_acts, weights, dilations, sizes, seed, sample, forced_input,
            return_logits):
    t, b, n_layers, r, s_dim, o_dim, n_classes = sizes
    cond_acts, weights, r, s_dim, o_dim = _pad_channels(
        cond_acts.to(torch.float32), weights, r, s_dim, o_dim)
    o_valid = sizes[5]
    stream, device = _build.stream_and_device(cond_acts)
    slots = sum(int(d) for d in dilations)
    plan = device_plan(b, n_layers, r, s_dim, o_dim, slots, device)
    lib = _build.load_library()
    cond = cond_acts.contiguous()
    w = cluster_weights(weights, plan.n)
    forced = None if forced_input is None \
        else forced_input.to(torch.int32).contiguous()
    idx = torch.empty((t, b), dtype=torch.int32, device=cond.device)
    logits = torch.empty((t, b, o_valid), dtype=torch.float32,
                         device=cond.device) if return_logits else None
    dil_host = (ctypes.c_int * n_layers)(*[int(d) for d in dilations])
    dil = torch.tensor([int(d) for d in dilations], dtype=torch.int32,
                       device=cond.device)
    ring = torch.empty((b * plan.n * slots * _ceil(r, plan.n),),
                       dtype=torch.float32, device=cond.device) \
        if plan.ring_global else None
    err = lib.wavenet_sample_fwd(
        cond.data_ptr(), None if forced is None else forced.data_ptr(),
        *[w[name].data_ptr() for name in ('wa', 'b_dil', 'wb', 'b_sr', 'wo',
                                          'we')],
        weights['embed'].contiguous().data_ptr(),
        idx.data_ptr(), None if logits is None else logits.data_ptr(),
        ctypes.cast(dil_host, ctypes.c_void_p), dil.data_ptr(),
        None if ring is None else ring.data_ptr(), t, b, n_layers, r, s_dim,
        o_dim, o_valid, n_classes, plan.n, int(plan.resident),
        int(plan.ring_global), plan.smem, int(bool(sample)),
        ctypes.c_int32(int(seed) & _M32).value, device, stream)
    route = 'one_block' if plan.n == 1 else 'cluster'
    _build.check(lib, err, f'wavenet_sample kernel ({route}, {plan})')
    wavenet_sample.launches += 1
    wavenet_sample.routes[route] += 1
    if return_logits:
        return idx, logits
    return idx


def wavenet_sample(cond_acts, weights, dilations, *, seed=0, sample=False,
                   forced_input=None, return_logits=False):
    """Run the WaveNet sample loop, all T steps, as one kernel launch.

    Args:
        cond_acts: (T, B, L, 2R) float32 pre-shifted conditioning
            activations (position t holds the conditioning of t - 1, step
            0 zeros).
        weights: dict of float32 tensors, stacked over layers:
            ``w_prev``/``w_curr`` (L, R, 2R), ``b_dil`` (L, 2R), ``w_res``
            (L-1, R, R), ``b_res`` (L-1, R), ``w_skip`` (L, R, S),
            ``b_skip`` (L, S), ``w_out`` (S, O), ``w_end`` (O, O), ``embed``
            (C, R).
        dilations: per-layer dilations (L ints).
        seed: seed of the counter-based generator (its low 32 bits).
        sample: Gumbel-max sampling from the softmax; False is the greedy
            argmax (ties go to the lowest index).
        forced_input: optional (T, B) integer teacher-forcing indices.
        return_logits: also return the (T, B, O) logits.

    Returns:
        (T, B) int32 indices, or (indices, logits).  CPU tensors run
        :func:`wavenet_sample_plain`; CUDA tensors launch the kernel (or
        raise: it has no backward).
        ``wavenet_sample.launches`` counts the launches,
        ``wavenet_sample.routes`` them by route (``cluster``,
        ``one_block``).  On a cluster a CTA that waits for a peer's values
        longer than about 35 s traps (a guard against a hang, not a limit
        a correct launch comes near); the error ends the process's CUDA
        context.
    """
    sizes = _sizes(cond_acts, weights, dilations, forced_input)
    if torch.is_grad_enabled() and (
            cond_acts.requires_grad
            or any(weights[n].requires_grad for n in WEIGHT_SHAPES)):
        raise ValueError(
            'wavenet_sample is an inference kernel without a backward: '
            'call it under torch.no_grad() or on detached tensors')
    if cond_acts.device.type == 'cpu':
        return wavenet_sample_plain(
            cond_acts, weights, dilations, seed=seed, sample=sample,
            forced_input=forced_input, return_logits=return_logits)
    if cond_acts.device.type != 'cuda':
        raise ValueError(f'no kernel for device {cond_acts.device}')
    return _launch(cond_acts, weights, dilations, sizes, seed, sample,
                   forced_input, return_logits)


wavenet_sample.launches = 0
wavenet_sample.routes = {'cluster': 0, 'one_block': 0}
