"""Every geometry the reference's kernels take, on the CPU: the port's
planners at an H100's limits and its plain versions against the JAX
package at the shapes that the card used to refuse.

- The cooperative LSTM and GRU kernels stream ``W_hh`` from device memory
  exactly where no grid that stages it is co-resident (two float32
  directions of 1024 units, two of 2048 for the GRU, bf16 at 1536), on a
  grid of one wave, and no width is refused (``lstm.scan_grid``).
- ``fused_logmel`` plans a long hop (1600/800, 1024/1024) on its sliced
  route, and the recipes' hops keep their span route and plans.
- The WaveNet sampler plans the 785,664-byte ring of 30 layers to dilation
  512 at R = 64 on a cluster whose CTAs hold it, at 1, 8 and 132 rows,
  and a ring no cluster holds in device memory.
- The plain versions, which the kernels are held to on the card, against
  the Pallas kernels in interpret mode at those geometries (small sizes):
  a wide LSTM and GRU, the sampler at R = 60, S = 250, O = 254 and at 80
  layers (greedy and teacher-forced), the log-mel at long hops, and
  attention at head sizes 192 and 256 (forward and gradients, float32
  and bf16).  The wrapper's zero-padding of the sampler's channels
  changes no logit.
- The bf16 attention backward's products take P and dS as three bf16
  pieces: emulated here against the float64 product, within float32's
  accuracy, where one piece (P and dS rounded to bf16) is not.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu.ops.pallas.attention import (
    flash_attention as jax_flash_attention)
from padertorch_tpu.ops.pallas.gru import gru_cell_scan as jax_gru
from padertorch_tpu.ops.pallas.logmel import (
    LogMelFrontend as JaxLogMelFrontend)
from padertorch_tpu.ops.pallas.lstm import lstm_cell_scan as jax_lstm
from padertorch_tpu.ops.pallas.wavenet import (
    wavenet_sample as jax_wavenet_sample)
from padertorch_tpu_torch.ops.kernels import wavenet as wavenet_kernels
from padertorch_tpu_torch.ops.kernels.attention import (
    flash_attention, flash_attention_bwd_plain, flash_attention_fwd_plain)
from padertorch_tpu_torch.ops.kernels.gru import gru_cell_scan_plain
from padertorch_tpu_torch.ops.kernels.logmel import (
    LogMelFrontend, logmel_plan, logmel_smem)
from padertorch_tpu_torch.ops.kernels.lstm import (
    _pick_scan_grid, _scan_smem_of, lstm_cell_scan_plain, packed_bytes,
    scan_grid, scan_smem)
from padertorch_tpu_torch.ops.kernels.wavenet import (
    cluster_plan, ring_bytes, sample_smem, wavenet_sample_plain)

torch.set_num_threads(2)

N_SM, MAX_SMEM = 132, 232448   # an H100
KERNELS = ('lstm_fwd', 'lstm_bwd', 'gru_fwd', 'gru_bwd')


def _one_wave(grid):
    """The blocks a grid of this shape keeps on the card at once (the
    planner's occupancy) hold all of its blocks."""
    per_sm = min(2048 // grid.threads, 32, 1024 // grid.threads,
                 (MAX_SMEM + 1024) // (grid.smem + 1024))
    return per_sm >= 1 and grid.blocks <= per_sm * N_SM


@pytest.mark.parametrize('elem', [4, 2])
@pytest.mark.parametrize('kernel', KERNELS)
def test_scan_grid_streams_exactly_where_no_staged_grid_fits(kernel, elem):
    """From 16 to 4096 units, two directions of 16 rows: a grid of one
    wave for every width, streamed exactly where the staged search finds
    none, its shared memory then without the weights."""
    streamed_from = None
    for hdim in list(range(16, 1025, 16)) + [1536, 2048, 3072, 4096]:
        grid = scan_grid(kernel, 2, 16, hdim, N_SM, MAX_SMEM, elem)
        assert grid is not None and _one_wave(grid), (hdim, grid)
        assert grid.smem <= MAX_SMEM
        k_len = -(-3 * hdim // 4) if kernel == 'gru_bwd' else hdim
        staged = _pick_scan_grid(
            2, 16, hdim, k_len, N_SM, MAX_SMEM,
            lambda u, rb, rs, ks: _scan_smem_of(kernel, hdim, elem, False,
                                                u, rb, rs, ks), 64)
        assert grid.streamed == (staged is None), hdim
        assert grid.smem == scan_smem(kernel, hdim, grid.U, grid.RB,
                                      grid.RS, grid.KS, elem, grid.streamed)
        if grid.streamed and streamed_from is None:
            streamed_from = hdim
        if streamed_from is not None:
            assert grid.streamed, hdim   # wider layers stay streamed
    assert streamed_from is not None and 800 <= streamed_from <= 1536


@pytest.mark.parametrize('kernel,rows,hdim,elem,streamed', [
    ('lstm_fwd', 16, 600, 4, False),      # uPIT, the flagship width
    ('lstm_bwd', 16, 600, 4, False),
    ('lstm_fwd', 260, 128, 4, False),     # the DPRNN's chunk rows
    ('lstm_bwd', 400, 128, 2, False),
    ('gru_fwd', 8, 256, 4, False),        # the classifier defaults
    ('gru_bwd', 8, 256, 2, False),
    ('lstm_fwd', 2, 1024, 4, True),       # the widths the card refused
    ('lstm_bwd', 2, 1024, 4, True),
    ('lstm_fwd', 2, 1536, 2, True),
    ('lstm_bwd', 2, 1536, 2, True),
    ('gru_fwd', 2, 1024, 4, True),
    ('gru_bwd', 2, 2048, 4, True),
    ('gru_fwd', 2, 2048, 2, True),
    ('gru_bwd', 2, 2048, 2, True),
])
def test_the_card_shapes_take_their_routes(kernel, rows, hdim, elem,
                                           streamed):
    grid = scan_grid(kernel, 2, rows, hdim, N_SM, MAX_SMEM, elem)
    assert grid.streamed is streamed and _one_wave(grid)


@pytest.mark.parametrize('bf16', [False, True])
@pytest.mark.parametrize('kernel', KERNELS)
def test_packed_weights_hold_the_staged_slots(kernel, bf16):
    """An emulation of the streamed route's packed weights
    (``pack_slots``, ``csrc/lstm_common.cuh``) at H = 6: ``packed_bytes``
    of slots of four values, read the way the streamed kernels read them
    (forwards: slot (d, k, j) holds unit j's gates at row k; backwards:
    slot (d, c, j) holds columns 4c ... 4c + 3 of row j, zeros past the
    last), give the plain product, with W_hh rounded to bf16 once."""
    rng = np.random.RandomState(0)
    hdim, n_dir = 6, 2
    gates = 4 if kernel.startswith('lstm') else 3
    width = gates * hdim
    w = torch.from_numpy(rng.randn(n_dir, hdim, width).astype('float32'))
    if bf16:
        w = w.to(torch.bfloat16).float()
    x = torch.from_numpy(rng.randn(n_dir, 3, hdim if kernel.endswith('fwd')
                                   else width).astype('float32'))
    if kernel.endswith('fwd'):
        slots = torch.zeros(n_dir, hdim, hdim, 4)
        slots[..., :gates] = w.reshape(n_dir, hdim, gates, hdim) \
            .permute(0, 1, 3, 2)
        got = torch.einsum('drk,dkji->drji', x, slots)[..., :gates]
        want = (x @ w).reshape(n_dir, 3, gates, hdim).permute(0, 1, 3, 2)
    else:
        g4 = -(-width // 4)
        padded = torch.nn.functional.pad(w, (0, 4 * g4 - width))
        slots = padded.reshape(n_dir, hdim, g4, 4).permute(0, 2, 1, 3)
        x_slots = torch.nn.functional.pad(x, (0, 4 * g4 - width)) \
            .reshape(n_dir, 3, g4, 4)
        got = torch.einsum('drci,dcji->drj', x_slots, slots)
        want = x @ w.transpose(1, 2)
    assert slots.numel() * (2 if bf16 else 4) == packed_bytes(
        kernel, n_dir, hdim, bf16)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize('size,shift,mels,sliced', [
    (1600, 800, 80, True), (1024, 1024, 64, True),
    (512, 128, 64, False), (1024, 200, 80, False), (512, 160, 40, False)])
def test_logmel_plan_takes_every_hop_the_jax_class_takes(size, shift, mels,
                                                         sliced):
    front = LogMelFrontend(size=size, shift=shift, n_mels=mels)
    plan = logmel_plan(16, 503, size, shift, size // 2 + 1,
                       front.n_partials, N_SM, MAX_SMEM)
    assert plan is not None and plan.sliced is sliced
    assert plan.smem == logmel_smem(size, shift, front.n_partials, sliced)
    assert plan.smem <= MAX_SMEM
    assert (logmel_smem(size, shift, front.n_partials) > MAX_SMEM) is sliced


def test_logmel_plans_of_the_recipes_are_unchanged():
    assert logmel_plan(8, 66, 512, 128, 257, 78, N_SM, MAX_SMEM)[:3] == (
        9, 9, 144)
    assert logmel_plan(16, 503, 512, 128, 257, 78, N_SM, MAX_SMEM)[:3] == (
        2, 9, 256)


DEEP = [2 ** (i % 10) for i in range(30)]   # 30 layers to dilation 512


def _max_clusters(n, smem):
    """Clusters of n CTAs of ``smem`` bytes an H100 runs at once: one CTA
    per SM above half of the shared memory."""
    return N_SM // n


@pytest.mark.parametrize('rows', [1, 8, 132])
def test_wavenet_plan_holds_the_large_ring(rows):
    assert ring_bytes(DEEP, 64) == 785_664
    plan = cluster_plan(rows, 30, 64, 256, 256, sum(DEEP), N_SM, MAX_SMEM,
                        _max_clusters)
    assert not plan.ring_global and plan.n > 1
    assert plan.smem <= MAX_SMEM
    assert plan.smem >= sample_smem(30, 64, 256, 256, sum(DEEP), plan.n,
                                    plan.resident)
    # one block would need more than the card offers
    assert sample_smem(30, 64, 256, 256, sum(DEEP), 1, False) > MAX_SMEM


def test_wavenet_plans_a_ring_no_cluster_holds_in_device_memory():
    plan = cluster_plan(4, 30, 512, 256, 256, sum(DEEP), N_SM, MAX_SMEM,
                        _max_clusters)
    assert plan.ring_global and plan.n == 1
    assert plan.smem == sample_smem(30, 512, 256, 256, sum(DEEP), 1, False,
                                    ring=False) <= MAX_SMEM


def test_wavenet_plans_of_the_vocoder_keep_their_routes():
    slots = 2 * sum(2 ** i for i in range(8))
    assert cluster_plan(5, 16, 64, 256, 256, slots, N_SM, MAX_SMEM,
                        _max_clusters)[:2] == (16, True)
    assert cluster_plan(132, 16, 64, 256, 256, slots, N_SM, MAX_SMEM,
                        _max_clusters)[:2] == (1, False)


# -- the plain versions against the Pallas kernels ------------------------

def _recurrence(n_gates, hdim, t_len=3, batch=1, seed=0):
    rng = np.random.RandomState(seed)
    rows = 2 * batch
    bound = 1 / np.sqrt(hdim)
    return [rng.uniform(-1, 1, (t_len, rows, n_gates * hdim)),
            rng.uniform(-bound, bound, (2, hdim, n_gates * hdim)),
            None, rng.uniform(-0.5, 0.5, (rows, hdim)),
            rng.uniform(-0.5, 0.5, (rows, hdim))]


def _close(got, want, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=0)


def test_plain_lstm_at_a_streamed_width_matches_the_pallas_kernel():
    arrays = [None if a is None else a.astype('float32')
              for a in _recurrence(4, 1024)]
    want = jax_lstm(*[None if a is None else jnp.asarray(a)
                      for a in arrays], True)
    got = lstm_cell_scan_plain(*[None if a is None else torch.from_numpy(a)
                                 for a in arrays])
    _close([x.numpy() for x in got], want, 1e-5)


def test_plain_gru_at_a_streamed_width_matches_the_pallas_kernel():
    gx, w, mask, h0, _ = [None if a is None else a.astype('float32')
                          for a in _recurrence(3, 1024)]
    want = jax_gru(jnp.asarray(gx), jnp.asarray(w), None, jnp.asarray(h0),
                   True)
    got = gru_cell_scan_plain(torch.from_numpy(gx), torch.from_numpy(w),
                              None, torch.from_numpy(h0))
    _close([x.numpy() for x in got], want, 1e-5)


def _sampler(n_layers, r, s, o, dilations, t_len=10, batch=2, seed=0):
    rng = np.random.RandomState(seed)

    def u(*shape):
        return rng.uniform(-0.3, 0.3, shape).astype('float32')

    w = {'w_prev': u(n_layers, r, 2 * r), 'w_curr': u(n_layers, r, 2 * r),
         'b_dil': u(n_layers, 2 * r), 'w_res': u(n_layers - 1, r, r),
         'b_res': u(n_layers - 1, r), 'w_skip': u(n_layers, r, s),
         'b_skip': u(n_layers, s), 'w_out': u(s, o), 'w_end': u(o, o),
         'embed': rng.randn(256, r).astype('float32')}
    cond = rng.randn(t_len, batch, n_layers, 2 * r).astype('float32')
    forced = rng.randint(0, o, (t_len, batch)).astype('int32')
    return w, cond, forced


SAMPLERS = {
    'R60 S250 O254': (4, 60, 250, 254, (1, 2, 4, 3)),
    '80 layers': (80, 8, 16, 256, tuple(2 ** (i % 3) for i in range(80))),
}


@pytest.fixture(scope='module')
def jax_samples():
    """{name: (greedy indices, forced indices, forced logits)} of the
    Pallas sampler in interpret mode, once per module."""
    out = {}
    for name, (n_layers, r, s, o, dilations) in SAMPLERS.items():
        w, cond, forced = _sampler(n_layers, r, s, o, dilations)
        jw = {k: jnp.asarray(v) for k, v in w.items()}
        greedy = jax_wavenet_sample(jnp.asarray(cond), jw, dilations,
                                    interpret=True)
        idx, logits = jax_wavenet_sample(
            jnp.asarray(cond), jw, dilations,
            forced_input=jnp.asarray(forced), return_logits=True,
            interpret=True)
        out[name] = tuple(np.asarray(x) for x in (greedy, idx, logits))
    return out


@pytest.mark.parametrize('name', sorted(SAMPLERS))
def test_plain_sampler_matches_the_pallas_kernel(name, jax_samples):
    n_layers, r, s, o, dilations = SAMPLERS[name]
    w, cond, forced = _sampler(n_layers, r, s, o, dilations)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    greedy = wavenet_sample_plain(torch.from_numpy(cond), tw, dilations)
    idx, logits = wavenet_sample_plain(
        torch.from_numpy(cond), tw, dilations,
        forced_input=torch.from_numpy(forced), return_logits=True)
    want_greedy, want_idx, want_logits = jax_samples[name]
    np.testing.assert_array_equal(greedy.numpy(), want_greedy)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize('name', sorted(SAMPLERS))
def test_padding_the_sampler_channels_changes_no_logit(name):
    """The wrapper zero-pads R, S and O to multiples of 4 before the
    kernel: the plain sampler on the padded weights gives the same logits
    (the padded outputs 0, which the kernel leaves out of the choice)."""
    n_layers, r, s, o, dilations = SAMPLERS[name]
    w, cond, forced = _sampler(n_layers, r, s, o, dilations)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    cond_p, w_p, rp, sp, op = wavenet_kernels._pad_channels(
        torch.from_numpy(cond), tw, r, s, o)
    assert (rp % 4, sp % 4, op % 4) == (0, 0, 0)
    forced_t = torch.from_numpy(forced)
    _, want = wavenet_sample_plain(torch.from_numpy(cond), tw, dilations,
                                   forced_input=forced_t,
                                   return_logits=True)
    _, got = wavenet_sample_plain(cond_p, w_p, dilations,
                                  forced_input=forced_t, return_logits=True)
    torch.testing.assert_close(got[..., :o], want, atol=1e-6, rtol=0)
    assert not bool(got[..., o:].any())


@pytest.mark.parametrize('size,shift,mels', [(1600, 800, 80),
                                             (1024, 1024, 64)])
def test_plain_logmel_at_a_long_hop_matches_the_pallas_kernel(size, shift,
                                                             mels):
    x = np.random.RandomState(size).randn(2, 9000).astype('float32')
    want = np.asarray(JaxLogMelFrontend(
        sample_rate=16000, size=size, shift=shift, n_mels=mels,
        interpret=True)(jnp.asarray(x)))
    got = LogMelFrontend(size=size, shift=shift, n_mels=mels)(
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


WIDE_HEADS = {
    'd192 causal ragged': (2, 2, 2, 24, 24, 192,
                           {'causal': True, 'key_padding_lens': [24, 9]}),
    'd256 full gqa': (1, 4, 2, 20, 28, 256, {}),
}


def _heads(name, dtype):
    b, h, h_kv, tq, tk, d, kwargs = WIDE_HEADS[name]
    rng = np.random.RandomState(d)
    arrays = [rng.randn(*shape).astype('float32')
              for shape in ((b, h, tq, d), (b, h_kv, tk, d),
                            (b, h_kv, tk, d), (b, h, tq, d))]
    if dtype == 'bfloat16':
        arrays = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                             .astype(jnp.float32)) for a in arrays]
    return arrays, kwargs


@pytest.fixture(scope='module')
def jax_wide_heads():
    """{(name, dtype): (o, (dq, dk, dv))} of the Pallas kernel in
    interpret mode, which pads the heads to 256, once per module."""
    out = {}
    for name in WIDE_HEADS:
        for dtype in ('float32', 'bfloat16'):
            arrays, kwargs = _heads(name, dtype)
            q, k, v, d_o = (jnp.asarray(a).astype(dtype) for a in arrays)
            jkw = dict(kwargs, interpret=True)
            if 'key_padding_lens' in jkw:
                jkw['key_padding_lens'] = jnp.asarray(
                    jkw['key_padding_lens'])
            o, vjp = jax.vjp(
                lambda q, k, v: jax_flash_attention(q, k, v, **jkw), q, k, v)
            out[name, dtype] = (
                np.asarray(o.astype(jnp.float32)),
                tuple(np.asarray(g.astype(jnp.float32)) for g in vjp(d_o)))
    return out


def _beyond_one_unit(got, want):
    """(largest difference beyond one bf16 unit of the larger value, share
    of elements that differ)."""
    got, want = got.float(), torch.from_numpy(want)
    diff = (got - want).abs()
    big = torch.maximum(got.abs(), want.abs())
    ulp = torch.where(big > 0, torch.exp2(torch.floor(torch.log2(
        torch.where(big > 0, big, torch.ones_like(big)))) - 7),
        torch.zeros_like(big))
    return float((diff - ulp).max()), float((diff > 0).float().mean())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', sorted(WIDE_HEADS))
def test_plain_attention_at_wide_heads_matches_the_pallas_kernel(
        name, dtype, jax_wide_heads):
    arrays, kwargs = _heads(name, dtype)
    torch_dtype = getattr(torch, dtype)
    q, k, v, d_o = (torch.from_numpy(a).to(torch_dtype) for a in arrays)
    want_o, want_grads = jax_wide_heads[name, dtype]
    if dtype == 'float32':
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = flash_attention(*leaves, **kwargs)
        grads = torch.autograd.grad(out, leaves, d_o)
        np.testing.assert_allclose(out.detach().numpy(), want_o, atol=1e-5,
                                   rtol=0)
        for g, w in zip(grads, want_grads):
            np.testing.assert_allclose(g.numpy(), w, atol=5e-5, rtol=0)
        return
    o, lse = flash_attention_fwd_plain(q, k, v, **kwargs)
    grads = flash_attention_bwd_plain(q, k, v, o, lse, d_o, **kwargs)
    for got, want in zip((o, *grads), (want_o, *want_grads)):
        excess, share = _beyond_one_unit(got, want)
        assert excess <= 1e-5 and share <= 0.03, (excess, share)


def _pieces(x):
    """x (float32) as three bf16 pieces, hi + mid + lo: the split the bf16
    attention backward makes of P and dS."""
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    lo = (x - hi - mid).bfloat16().float()
    return hi, mid, lo


@pytest.mark.parametrize('seed', range(3))
def test_three_bf16_pieces_carry_float32_products(seed):
    """dV = P^T dO with P float32 and dO bf16, the kernel's way: each piece
    a product of bf16 operands (exact terms, float32 sums), the pieces'
    products added lo, mid, hi.  Against the float64 product the error is
    that of a float32 product (both within 2^-19 of the terms' sum of
    magnitudes); rounding P to bf16, one piece, misses by about 2^-9."""
    g = torch.Generator().manual_seed(seed)
    s = torch.randn(64, 64, generator=g) * 3
    p = torch.softmax(s, dim=-1)                       # probabilities
    ds = p * (torch.randn(64, 64, generator=g) - 0.1)  # P (dP - delta)
    d_o = torch.randn(64, 48, generator=g).bfloat16().float()
    for x in (p, ds):
        ref = x.double().T @ d_o.double()
        size = x.double().abs().T @ d_o.double().abs()
        hi, mid, lo = _pieces(x)
        assert torch.equal(hi + mid + lo, x) or float(
            ((hi + mid + lo) - x).abs().max()) <= 2 ** -24 * float(
                x.abs().max())
        three = (lo.T @ d_o) + (mid.T @ d_o) + (hi.T @ d_o)
        one = hi.T @ d_o
        f32 = x.T @ d_o
        err = lambda y: float(((y.double() - ref).abs() / size).max())
        assert err(three) <= 2 ** -19 and err(f32) <= 2 ** -19
        assert err(one) >= 2 ** -12
