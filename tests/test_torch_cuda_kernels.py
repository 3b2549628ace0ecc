"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at shapes off the main path (ragged hidden widths, one
direction, other STFT geometries).  The bf16 LSTM kernels are held to their
plain bf16 versions (each stream element within one bf16 unit in the last
place plus 1e-3 or 2e-3, at most 5% of them other, float32 states within
3e-4 and 1e-3), the bf16 attention kernels to theirs at ``chip_smoke.py``
phase 26's limits (O within one unit plus 2e-3 of plain in the kernel's
key tiles, gradients within one unit plus 1e-5 of each one's largest
entry, at most 1% of either other, the gradients' by more than that),
with the control (logits, P and dS rounded to bf16) failing them;
the bf16 GRU kernels to theirs at the LSTM's limits, at ``chip_smoke.py``
phase 28's shapes, the bf16 resident routes' widest H and one above, the
``mma`` route's and the lean forward's ``cluster`` route's, with the
control (float32 products) failing them.  The GRU
forwards' resident and
cooperative routes are each held to plain at the shapes that pick them,
with the route read from ``gru_cell_scan.routes``.  The LSTM training kernels (forward
with residuals, backward) are held against their step-by-step plain
versions (1e-5: the same f32 arithmetic, sums in another order) and,
through the ``autograd.Function``, against autograd through the plain
forward (1e-4 relative to each gradient's largest entry); the GRU
kernels likewise.  The attention kernels are held against the masked
softmax formula (``flash_attention_plain`` and autograd through it) in every
mask mode, for every head size of the template set and one outside it.
The WaveNet sampler is held against its plain step loop (greedy and
teacher-forced Gumbel indices equal, logits 2e-5), and its two routes (a
cluster of CTAs per row, one block per row) against each other bit for
bit, and the fused log-mel
front end against its plain version (1e-4 on log-mel values), both at odd
batch sizes, lengths and widths; a ``WaveNetVocoder`` and a ``SpeakerClf``
on the card are held against the CPU and moved to the JAX layout and back.
The three LSTM kernels and ``masked_istft`` are held at the mask
estimator's shapes, and a first training step of the Conv-TasNet, OR-PIT,
the mask estimator and the deep-clustering model against the CPU; the LSTM
kernels of one direction at the transducer's prediction network's shapes,
the attention kernels at the conformer's and the attention decoder's
(heads of 24), and a first training step of each speech-recognition head
against the CPU.
Marked
``cuda``: they skip without a card.  Run them on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -q
"""
import copy

import numpy as np
import pytest
import torch

import chip_smoke

from chip_smoke import (
    ATTENTION_WIDE_CASES, LOGMEL_LONG_HOPS, WAVENET_GEOMETRIES,
    WIDE_RECURRENCES, attention_bf16_case, attention_wide_case,
    logmel_long_hop_case, logmel_routes_agree, wavenet_geometry_case,
    wide_recurrence_case,
    GRU_BF16_SHAPES, gru_bf16_case, gru_bf16_limit_shapes,
    ATTENTION_BF16_FWD_ATOL, ATTENTION_BF16_FWD_SHARE,
    ATTENTION_BF16_GRAD_SHARE, ATTENTION_BF16_LSE_TOL, LSTM_BF16_SHARE,
    LSTM_BF16_STATE_TOL, LSTM_BF16_STREAM_TOL,
    attention_bf16_control_bwd, attention_bf16_control_fwd,
    attention_bf16_fwd_plain, bf16_distance, bf16_grad_distance,
    lse_distance)

from padertorch_tpu_torch.ops._stft import HostSTFT, STFT
from padertorch_tpu_torch.models.bss import PermutationInvariantTrainingModel
from padertorch_tpu_torch.models.tasnet import TasDecoder, TasEncoder, TasNet
from padertorch_tpu_torch.modules.dual_path_rnn import DPRNN
from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    MultiheadAttention, set_attention_backend)
from padertorch_tpu_torch.modules.dual_path_transformer import (
    DualPathTransformer)
from padertorch_tpu_torch.ops.kernels import _build
from padertorch_tpu_torch.ops.kernels import gru as gru_kernels
from padertorch_tpu_torch.ops.kernels import lstm as lstm_kernels
from padertorch_tpu_torch.ops.kernels.attention import (
    flash_attention, flash_attention_bwd_plain, flash_attention_fwd_plain,
    flash_attention_plain)
from padertorch_tpu_torch.ops.kernels import attention as attention_kernels
from padertorch_tpu_torch.ops.kernels.gru import (
    gru_cell_scan, gru_cell_scan_plain, gru_cell_scan_train_plain,
    gru_cell_scan_bwd_plain)
from padertorch_tpu_torch.ops.kernels.lstm import (
    lstm_cell_scan, lstm_cell_scan_plain, lstm_cell_scan_train_plain,
    lstm_cell_scan_bwd_plain)
from padertorch_tpu_torch.ops.kernels import masked_istft as istft_kernels
from padertorch_tpu_torch.ops.kernels.masked_istft import (
    masked_istft, masked_istft_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    # float32 is the package's own decision, made where it is imported
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    return torch.device('cuda')


@pytest.mark.parametrize('n_dir,batch,hdim,t_len,masked', [
    (1, 1, 8, 5, False),
    (2, 3, 37, 40, True),
    (2, 5, 130, 64, True),
    (1, 64, 256, 33, True),
])
def test_lstm_kernel_matches_plain(cuda, n_dir, batch, hdim, t_len, masked):
    rng = np.random.RandomState(hdim)
    rows = n_dir * batch
    mask = None
    if masked:
        lens = rng.randint(1, t_len + 1, size=batch)
        fwd = np.arange(t_len)[:, None] < lens[None, :]
        mask = np.concatenate([fwd, fwd[::-1]][:n_dir], axis=1)
    bound = 1 / np.sqrt(hdim)
    arrays = [rng.uniform(-1, 1, (t_len, rows, 4 * hdim)),
              rng.uniform(-bound, bound, (n_dir, hdim, 4 * hdim)), mask,
              rng.uniform(-0.1, 0.1, (rows, hdim)),
              rng.uniform(-0.1, 0.1, (rows, hdim))]
    args = [None if a is None else torch.tensor(a, dtype=torch.float32,
                                                device=cuda)
            for a in arrays]
    before = dict(lstm_cell_scan.launches)
    got = lstm_cell_scan(*args)
    want = lstm_cell_scan_plain(*args)
    torch.cuda.synchronize()
    assert lstm_cell_scan.launches == {**before, 'fwd': before['fwd'] + 1}
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


def test_lstm_kernel_rejects_what_it_does_not_take(cuda):
    gx = torch.zeros((3, 2, 16), device=cuda)
    w = torch.zeros((1, 4, 16), device=cuda)
    h = torch.zeros((2, 4), device=cuda)
    with pytest.raises(TypeError):
        lstm_cell_scan(gx.double(), w, None, h, h)
    with pytest.raises(ValueError):
        lstm_cell_scan(gx, w, None, h.t().contiguous().t(), h)
    with pytest.raises(ValueError):
        lstm_cell_scan(gx, w.cpu(), None, h, h)


@pytest.mark.parametrize('batch,hdim,t_len,mask_kind', [
    (260, 128, 12, 'none'),      # the DPRNN intra shape's rows, 16 ranges
    (400, 128, 9, 'chunks'),     # the inter shape's, its chunk-count mask
    (260, 128, 11, 'ragged'),
    (16, 600, 10, 'ragged'),     # uPIT: one range of all 16 rows
])
def test_lstm_forward_kernels_split_rows_and_match_plain(
        cuda, batch, hdim, t_len, mask_kind):
    """Both forward kernels split a direction's rows over blocks (and keep
    c of their own rows): lean and training forward against plain at row
    counts that take several row ranges, and at the uPIT width."""
    rng = np.random.RandomState(batch + t_len)
    mask = None
    if mask_kind == 'chunks':
        lens = np.repeat([t_len, t_len - 2, t_len - 4, t_len - 6], batch // 4)
    elif mask_kind == 'ragged':
        lens = rng.randint(1, t_len + 1, size=batch)
    if mask_kind != 'none':
        fwd = np.arange(t_len)[:, None] < lens[None, :]
        mask = np.concatenate([fwd, fwd[::-1]], axis=1)
    bound = 1 / np.sqrt(hdim)
    arrays = [rng.uniform(-1, 1, (t_len, 2 * batch, 4 * hdim)),
              rng.uniform(-bound, bound, (2, hdim, 4 * hdim)), mask,
              rng.uniform(-0.5, 0.5, (2 * batch, hdim)),
              rng.uniform(-0.5, 0.5, (2 * batch, hdim))]
    args = [None if a is None else torch.tensor(a, dtype=torch.float32,
                                                device=cuda)
            for a in arrays]
    gx, w, mask_t, h0, c0 = args
    got = lstm_cell_scan(*args)
    got_train = lstm_kernels._launch(gx, w, 2, mask_t, h0, c0, train=True)
    torch.cuda.synchronize()
    for g, e in zip(got, lstm_cell_scan_plain(*args)):
        torch.testing.assert_close(g, e, atol=1e-5, rtol=0)
    for g, e in zip(got_train, lstm_cell_scan_train_plain(*args)):
        torch.testing.assert_close(g, e, atol=1e-5, rtol=0)



@pytest.mark.parametrize('batch,hdim,t_len,mask_kind', [
    (260, 128, 12, 'none'),      # the DPRNN intra shape's rows
    (400, 128, 9, 'chunks'),     # the inter shape's, its chunk-count mask
    (260, 128, 11, 'ragged'),
    (16, 600, 10, 'ragged'),     # uPIT: one range of all 16 rows
])
def test_lstm_backward_kernel_splits_rows_and_matches_plain(
        cuda, batch, hdim, t_len, mask_kind):
    """The backward kernel splits a direction's rows over blocks at the
    DPRNN's row counts (and keeps dh, dc of its own rows): dgates_x, dh0
    and dc0 against the plain backward on the same residuals, and the
    whole ``LSTMCellScan`` against autograd through the plain forward."""
    rng = np.random.RandomState(batch + t_len)
    mask = None
    if mask_kind == 'chunks':
        lens = np.repeat([t_len, t_len - 2, t_len - 4, t_len - 6], batch // 4)
    elif mask_kind == 'ragged':
        lens = rng.randint(1, t_len + 1, size=batch)
    if mask_kind != 'none':
        fwd = np.arange(t_len)[:, None] < lens[None, :]
        mask = np.concatenate([fwd, fwd[::-1]], axis=1)
    bound = 1 / np.sqrt(hdim)
    arrays = [rng.uniform(-1, 1, (t_len, 2 * batch, 4 * hdim)),
              rng.uniform(-bound, bound, (2, hdim, 4 * hdim)), mask,
              rng.uniform(-0.5, 0.5, (2 * batch, hdim)),
              rng.uniform(-0.5, 0.5, (2 * batch, hdim)),
              rng.uniform(-1, 1, (t_len, 2 * batch, hdim)),
              rng.uniform(-1, 1, (2 * batch, hdim)),
              rng.uniform(-1, 1, (2 * batch, hdim))]
    tensors = [None if a is None else torch.tensor(a, dtype=torch.float32,
                                                   device=cuda)
               for a in arrays]
    args, cotangents = tensors[:5], tensors[5:]
    gx, w, mask_t, h0, c0 = args
    grid = lstm_kernels.bwd_grid(2, batch, hdim)
    assert grid['blocks'] > 0
    assert grid['RB'] * grid['n_rb'] >= batch
    if batch >= 260:
        assert grid['n_rb'] > 1, grid
    _, c_seq, gates, _, _ = lstm_cell_scan_train_plain(*args)
    before = dict(lstm_cell_scan.launches)
    got = lstm_kernels._launch_bwd(gates, c_seq, w, 2, mask_t, *cotangents)
    want = lstm_cell_scan_bwd_plain(gates, c_seq, w, mask_t, *cotangents)
    torch.cuda.synchronize()
    assert lstm_cell_scan.launches['bwd'] == before['bwd'] + 1
    for g, e in zip(got, want):  # dgates_x, dh0, dc0
        torch.testing.assert_close(g, e, atol=1e-5, rtol=0)

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (gx, w, h0, c0)]
        outs = fn(leaves[0], leaves[1], mask_t, leaves[2], leaves[3])
        return torch.autograd.grad(outs, leaves, cotangents)

    for g, e in zip(grads(lstm_cell_scan), grads(lstm_cell_scan_plain)):
        scale = float(e.abs().max()) + 1e-12
        assert float((g - e).abs().max()) / scale <= 1e-4


TRAIN_SHAPES = [
    # n_dir, batch, hdim, t_len, mask
    (1, 1, 8, 1, 'none'),        # one row, T=1
    (2, 3, 37, 40, 'ragged'),    # H not a multiple of 4
    (2, 5, 130, 64, 'ragged'),
    (1, 20, 64, 33, 'suffix'),   # rows above 16 per direction
    (2, 24, 50, 21, 'none'),     # no mask, rows above 16
    (2, 17, 64, 9, 'ragged'),    # rows that do not split evenly in chunks
    (2, 1, 600, 20, 'ragged'),   # the flagship width, one row a direction
    (1, 40, 32, 7, 'none'),
    (1, 8, 96, 9, 'none'),       # the transducer's prediction network
    (1, 1, 96, 5, 'none'),       # and its greedy decode's one history
]


def _train_inputs(cuda, n_dir, batch, hdim, t_len, mask_kind):
    rng = np.random.RandomState(hdim + t_len)
    rows = n_dir * batch
    mask = None
    if mask_kind != 'none':
        lens = rng.randint(1, t_len + 1, size=batch)
        fwd = np.arange(t_len)[:, None] < lens[None, :]
        parts = [fwd, fwd[::-1]] if mask_kind == 'ragged' else [fwd, fwd]
        mask = np.concatenate(parts[:n_dir], axis=1)
    bound = 1 / np.sqrt(hdim)
    arrays = [rng.uniform(-1, 1, (t_len, rows, 4 * hdim)),
              rng.uniform(-bound, bound, (n_dir, hdim, 4 * hdim)), mask,
              rng.uniform(-0.5, 0.5, (rows, hdim)),
              rng.uniform(-0.5, 0.5, (rows, hdim)),
              rng.uniform(-1, 1, (t_len, rows, hdim)),
              rng.uniform(-1, 1, (rows, hdim)),
              rng.uniform(-1, 1, (rows, hdim))]
    tensors = [None if a is None else torch.tensor(
        a, dtype=torch.float32, device=cuda) for a in arrays]
    return tensors[:5], tensors[5:]


@pytest.mark.parametrize('n_dir,batch,hdim,t_len,mask_kind', TRAIN_SHAPES)
def test_lstm_training_kernels_match_plain(cuda, n_dir, batch, hdim, t_len,
                                           mask_kind):
    args, cotangents = _train_inputs(cuda, n_dir, batch, hdim, t_len,
                                     mask_kind)
    gx, w, mask, h0, c0 = args
    before = dict(lstm_cell_scan.launches)
    got = lstm_kernels._launch(gx, w, n_dir, mask, h0, c0, train=True)
    want = lstm_cell_scan_train_plain(*args)
    torch.cuda.synchronize()
    for g, e in zip(got, want):  # out, c_seq, gates, h_T, c_T
        torch.testing.assert_close(g, e, atol=1e-5, rtol=0)
    _, c_seq, gates, _, _ = want
    got = lstm_kernels._launch_bwd(gates, c_seq, w, n_dir, mask, *cotangents)
    want = lstm_cell_scan_bwd_plain(gates, c_seq, w, mask, *cotangents)
    torch.cuda.synchronize()
    for g, e in zip(got, want):  # dgates_x, dh0, dc0
        torch.testing.assert_close(g, e, atol=1e-5, rtol=0)
    assert lstm_cell_scan.launches == {
        **before, 'fwd_train': before['fwd_train'] + 1,
        'bwd': before['bwd'] + 1}


@pytest.mark.parametrize('n_dir,batch,hdim,t_len,mask_kind', TRAIN_SHAPES)
def test_lstm_function_matches_autograd_through_plain(
        cuda, n_dir, batch, hdim, t_len, mask_kind):
    args, cotangents = _train_inputs(cuda, n_dir, batch, hdim, t_len,
                                     mask_kind)
    gx, w, mask, h0, c0 = args

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (gx, w, h0, c0)]
        outs = fn(leaves[0], leaves[1], mask, leaves[2], leaves[3])
        assert all(o.grad_fn is not None for o in outs)
        return torch.autograd.grad(outs, leaves, cotangents)

    got = grads(lstm_cell_scan)
    want = grads(lstm_cell_scan_plain)
    torch.cuda.synchronize()
    for g, e in zip(got, want):  # dgates_x, dW_hh, dh0, dc0
        scale = float(e.abs().max()) + 1e-12
        assert float((g - e).abs().max()) / scale <= 1e-4


@pytest.mark.parametrize('label', [case[0] for case in WIDE_RECURRENCES
                                   if case[1] == 'lstm'])
def test_lstm_kernels_take_wide_layers_on_the_streamed_route(cuda, label):
    """Two directions of 1024 units (float32) and of 1536 (bf16): no grid
    that stages W_hh is co-resident, so the three kernels take the
    streamed route (the card's planner and its mirror ``scan_grid`` agree)
    and match their plain versions (``chip_smoke.wide_recurrence_case``
    raises otherwise)."""
    case = next(c for c in WIDE_RECURRENCES if c[0] == label)
    rows = wide_recurrence_case(*case, timed=False)
    assert set(rows) == {'fwd', 'fwd_train', 'bwd'}


def test_lstm_function_takes_missing_and_strided_cotangents(cuda):
    """Only ``out`` feeds the loss (h_T and c_T get no cotangent), through
    a transposed view (a cotangent that is not contiguous)."""
    args, _ = _train_inputs(cuda, 2, 3, 12, 9, 'ragged')
    gx, w, mask, h0, c0 = args

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (gx, w, h0, c0)]
        out, _, _ = fn(leaves[0], leaves[1], mask, leaves[2], leaves[3])
        loss = (out.transpose(0, 1).reshape(6, -1).cumsum(0) ** 2).sum()
        return torch.autograd.grad(loss, leaves)

    for g, e in zip(grads(lstm_cell_scan), grads(lstm_cell_scan_plain)):
        torch.testing.assert_close(g, e, atol=1e-4, rtol=1e-4)


def test_no_grad_and_detached_inputs_take_the_lean_kernel(cuda):
    args, _ = _train_inputs(cuda, 2, 3, 12, 9, 'ragged')
    before = dict(lstm_cell_scan.launches)
    out, _, _ = lstm_cell_scan(*args)
    with torch.no_grad():
        leaves = [a if a is None else a.clone().requires_grad_(
            a.is_floating_point()) for a in args]
        lstm_cell_scan(leaves[0], leaves[1], args[2], *leaves[3:])
    assert out.grad_fn is None
    assert lstm_cell_scan.launches == {**before, 'fwd': before['fwd'] + 2}


def test_model_on_the_card_gets_every_gradient(cuda):
    """The fault that only training shows: without the autograd.Function
    the LSTM parameters' gradients stay None on the card."""
    torch.manual_seed(0)
    model = PermutationInvariantTrainingModel(
        F=33, recurrent_layers=2, units=20, K=2).to(cuda).train()
    rng = np.random.RandomState(0)
    batch = {
        'Y_abs': torch.tensor(np.abs(rng.randn(3, 17, 33)), device=cuda,
                              dtype=torch.float32),
        'X_abs': torch.tensor(np.abs(rng.randn(3, 17, 2, 33)), device=cuda,
                              dtype=torch.float32),
        'cos_phase_difference': torch.tensor(
            rng.uniform(-1, 1, (3, 17, 2, 33)), device=cuda,
            dtype=torch.float32),
        'num_frames': torch.tensor([17, 11, 5], device=cuda),
    }
    review = model.review(batch, model(batch))
    review['losses']['pit_mse_loss'].backward()
    for name, p in model.named_parameters():
        if p.requires_grad:
            assert p.grad is not None, name
            assert bool(torch.isfinite(p.grad).all()), name
            assert float(p.grad.abs().max()) > 0, name
        else:
            assert name.startswith('blstm.bias_hh'), name


@pytest.mark.parametrize('size,shift,fading,rep,lead', [
    (64, 16, None, 'stacked', (3,)),
    (128, 64, 'full', 'stacked', (2, 2)),
    (256, 64, 'half', 'concat', (1,)),
    (512, 128, 'full', 'complex', (2,)),
])
def test_masked_istft_kernel_matches_plain(cuda, size, shift, fading, rep,
                                           lead):
    stft = STFT(size, shift, fading=fading, complex_representation=rep)
    rng = np.random.RandomState(size)
    x = torch.tensor(rng.randn(*lead, 3000), dtype=torch.float32,
                     device=cuda)
    spec = stft(x)
    frames = spec.shape[-3] if rep == 'stacked' else spec.shape[-2]
    mask = torch.tensor(rng.rand(*lead, frames, size // 2 + 1),
                        dtype=torch.float32, device=cuda)
    before = masked_istft.launches
    fft_before = masked_istft.routes['fft']
    got = masked_istft(spec, mask, stft=stft)
    want = masked_istft_plain(spec, mask, stft=stft)
    torch.cuda.synchronize()
    assert masked_istft.launches == before + 1
    assert masked_istft.routes['fft'] == fft_before + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    if fading == 'full':  # perfect reconstruction through the kernel
        unmasked = stft.masked_inverse(spec)
        torch.testing.assert_close(unmasked[..., :3000], x, atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize('spec_lead,mask_lead', [
    ((), (2,)),         # the recipe: K source masks on one mixture
    ((3,), (2, 3)),     # K masks per mixture of a batch
    ((2, 1), (2, 3)),   # the mask broadcasts the spectrogram mid-shape
])
def test_masked_istft_kernel_broadcasts_like_plain(cuda, spec_lead,
                                                   mask_lead):
    stft = STFT(512, 128, fading='full', complex_representation='stacked')
    rng = np.random.RandomState(len(mask_lead))
    x = torch.tensor(rng.randn(*spec_lead, 2000), dtype=torch.float32,
                     device=cuda)
    spec = stft(x)
    mask = torch.tensor(rng.rand(*mask_lead, spec.shape[-3], 257),
                        dtype=torch.float32, device=cuda)
    before = masked_istft.launches
    got = masked_istft(spec, mask, stft=stft)
    want = masked_istft_plain(spec, mask, stft=stft)
    torch.cuda.synchronize()
    assert masked_istft.launches == before + 1
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def _istft_launch(spec, mask, stft, **launch):
    """The kernel through its launch with ``launch``'s options (a plan),
    cropped as ``masked_istft`` does."""
    re, im, rows_mask, lead = istft_kernels._split(spec, mask, stft)
    rows = istft_kernels._launch(re, im, rows_mask, stft, **launch)
    return stft.crop_fading(rows.reshape(*lead, rows.shape[-1]))


def _istft_case(cuda, stft, lead, samples, seed):
    rng = np.random.RandomState(seed)
    spec = stft(torch.tensor(rng.randn(*lead, samples), dtype=torch.float32,
                             device=cuda))
    mask = torch.tensor(rng.rand(*lead, spec.shape[-3], stft.size // 2 + 1),
                        dtype=torch.float32, device=cuda)
    return spec, mask


# geometries the parent kernel refused or never met on the card, each with
# the route it takes: size 4096 (2049 bins did not fit one block's shared
# memory), size 8192 (the fft route's largest, 16 values a thread),
# windows shorter than the size, a size that is no power of two, and
# 70,000 signal rows (more than gridDim.y holds) on both routes
ISTFT_ROUTE_CASES = [
    ((4096, 1024, None), (2,), 12000, 'fft'),
    ((4096, 2048, None), (2,), 12000, 'fft'),
    ((8192, 2048, None), (2,), 24000, 'fft'),
    ((512, 100, 400), (3,), 3000, 'fft'),
    ((512, 20, 40), (2, 6), 203, 'fft'),
    ((400, 100, None), (2,), 3000, 'dft'),
    ((64, 16, None), (70000,), 100, 'fft'),
    ((48, 12, None), (70000,), 100, 'dft'),
]


@pytest.mark.parametrize('geometry,lead,samples,want_route',
                         ISTFT_ROUTE_CASES)
def test_masked_istft_takes_every_geometry_of_the_reference(
        cuda, geometry, lead, samples, want_route):
    size, shift, window_length = geometry
    stft = STFT(size, shift, window_length=window_length, fading='full',
                complex_representation='stacked')
    assert istft_kernels.route(size, stft.window_length) == want_route
    spec, mask = _istft_case(cuda, stft, lead, samples, size + shift)
    before = dict(masked_istft.routes)
    got = masked_istft(spec, mask, stft=stft)
    want = masked_istft_plain(spec, mask, stft=stft)
    torch.cuda.synchronize()
    assert masked_istft.routes[want_route] == before[want_route] + 1
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_masked_istft_dft_route_at_the_recipe_geometry(cuda):
    """The dft route forced at a power-of-two size agrees with plain."""
    stft = STFT(512, 128, fading='full', complex_representation='stacked')
    spec, mask = _istft_case(cuda, stft, (2,), 16000, 7)
    plan = istft_kernels.dft_plan(2, spec.shape[-3], 257, 128, 4, 232448)
    before = masked_istft.routes['dft']
    got = _istft_launch(spec, mask, stft, plan=plan)
    torch.cuda.synchronize()
    assert masked_istft.routes['dft'] == before + 1
    torch.testing.assert_close(got, masked_istft_plain(spec, mask, stft=stft),
                               atol=1e-4, rtol=0)


def test_masked_istft_signal_is_the_same_bits_alone_in_a_batch_and_any_plan(
        cuda):
    """Signal 5 of a batch of 32 against itself alone, and under two
    plans of the fft route: one output row a block, four frames at once;
    sixteen rows a block, two frames at once."""
    stft = STFT(512, 128, fading='full', complex_representation='stacked')
    spec, mask = _istft_case(cuda, stft, (32,), 16000, 11)
    batch = masked_istft(spec, mask, stft=stft)
    alone = masked_istft(spec[5:6], mask[5:6], stft=stft)
    frames = spec.shape[-3]
    plans = [istft_kernels.FftPlan(
        rows, at_once, 4, at_once * 64, 32 * -(-(frames + 3) // rows),
        istft_kernels.fft_smem(512, 128, rows, at_once))
        for rows, at_once in ((1, 4), (16, 2))]
    planned = [_istft_launch(spec, mask, stft, plan=plan) for plan in plans]
    torch.cuda.synchronize()
    assert torch.equal(batch[5:6], alone)
    for out in planned:
        assert torch.equal(out, batch)


@pytest.mark.parametrize('size,shift', [(512, 100), (128, 128)])
def test_masked_inverse_on_the_card_raises_for_unsupported_geometry(
        cuda, size, shift):
    """No fallback to the composition on the card: STFT and HostSTFT
    refuse a geometry the kernel does not take, as the JAX kernel does."""
    before = masked_istft.launches
    stft = STFT(size, shift, complex_representation='stacked')
    spec = torch.zeros((1, 4, size // 2 + 1, 2), device=cuda)
    with pytest.raises(ValueError):
        stft.masked_inverse(spec, torch.ones((2, 1, 4, size // 2 + 1),
                                             device=cuda))
    host = HostSTFT(size, shift, complex_representation='complex')
    with pytest.raises(ValueError):
        host.masked_inverse(np.zeros((4, size // 2 + 1), np.complex64),
                            np.ones((2, 4, size // 2 + 1), np.float32),
                            device=cuda)
    assert masked_istft.launches == before


GRU_SHAPES = TRAIN_SHAPES + [
    (2, 70, 128, 12, 'ragged'),  # rows split over blocks, several ranges
    (1, 300, 16, 5, 'none'),     # more rows than one staging chunk
    (2, 2, 600, 6, 'ragged'),
]


def _gru_inputs(cuda, n_dir, batch, hdim, t_len, mask_kind):
    (gx, w, mask, h0, _), (d_out, dh_t, _) = _train_inputs(
        cuda, n_dir, batch, hdim, t_len, mask_kind)
    return ([gx[..., :3 * hdim].contiguous(),
             w[..., :3 * hdim].contiguous(), mask, h0], [d_out, dh_t])


@pytest.mark.parametrize('n_dir,batch,hdim,t_len,mask_kind', GRU_SHAPES)
def test_gru_kernels_match_plain(cuda, n_dir, batch, hdim, t_len, mask_kind):
    args, cotangents = _gru_inputs(cuda, n_dir, batch, hdim, t_len,
                                   mask_kind)
    gx, w, mask, h0 = args
    before = dict(gru_cell_scan.launches)
    got = gru_cell_scan(*args)
    want = gru_cell_scan_plain(*args)
    torch.cuda.synchronize()
    for g, e in zip(got, want):  # out, h_T
        torch.testing.assert_close(g, e, atol=1e-5, rtol=0)
    got = gru_kernels._launch(gx, w, n_dir, mask, h0, train=True)
    want = gru_cell_scan_train_plain(*args)
    torch.cuda.synchronize()
    for g, e in zip(got, want):  # out, acts, gh_n, h_prev, h_T
        torch.testing.assert_close(g, e, atol=1e-5, rtol=0)
    _, acts, gh_n, h_prev, _ = want
    got = gru_kernels._launch_bwd(acts, gh_n, h_prev, w, n_dir, mask,
                                  *cotangents)
    want = gru_cell_scan_bwd_plain(acts, gh_n, h_prev, w, mask, *cotangents)
    torch.cuda.synchronize()
    for g, e in zip(got, want):  # dgates_x, dgh, dh0
        torch.testing.assert_close(g, e, atol=1e-5, rtol=0)
    assert gru_cell_scan.launches == {
        **before, 'fwd': before['fwd'] + 1,
        'fwd_train': before['fwd_train'] + 1, 'bwd': before['bwd'] + 1}


@pytest.mark.parametrize('n_dir,batch,hdim,t_len,mask_kind', GRU_SHAPES)
def test_gru_function_matches_autograd_through_plain(
        cuda, n_dir, batch, hdim, t_len, mask_kind):
    args, cotangents = _gru_inputs(cuda, n_dir, batch, hdim, t_len,
                                   mask_kind)
    gx, w, mask, h0 = args

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (gx, w, h0)]
        outs = fn(leaves[0], leaves[1], mask, leaves[2])
        assert all(o.grad_fn is not None for o in outs)
        return torch.autograd.grad(outs, leaves, cotangents)

    got = grads(gru_cell_scan)
    want = grads(gru_cell_scan_plain)
    torch.cuda.synchronize()
    for g, e in zip(got, want):  # dgates_x, dW_hh, dh0
        scale = float(e.abs().max()) + 1e-12
        assert float((g - e).abs().max()) / scale <= 1e-4


@pytest.mark.parametrize('label', [case[0] for case in WIDE_RECURRENCES
                                   if case[1] == 'gru'])
def test_gru_kernels_take_wide_layers_on_the_streamed_route(cuda, label):
    """Two directions of 1024 and 2048 units (float32) and of 2048 (bf16):
    the forwards on the streamed route, the backward on the route its
    planner names (staged at 1024 float32), against plain as the LSTM's."""
    case = next(c for c in WIDE_RECURRENCES if c[0] == label)
    rows = wide_recurrence_case(*case, timed=False)
    assert set(rows) == {'fwd', 'fwd_train', 'bwd'}


def test_gru_kernel_rejects_what_it_does_not_take(cuda):
    gx = torch.zeros((3, 2, 12), device=cuda)
    w = torch.zeros((1, 4, 12), device=cuda)
    h = torch.zeros((2, 4), device=cuda)
    with pytest.raises(TypeError):
        gru_cell_scan(gx.double(), w, None, h)
    with pytest.raises(ValueError):
        gru_cell_scan(gx, w, None, h.t().contiguous().t())
    with pytest.raises(ValueError):
        gru_cell_scan(gx, w.cpu(), None, h)
    with pytest.raises(ValueError):
        gru_cell_scan(gx[..., :11], w, None, h)


def test_gru_function_takes_missing_and_strided_cotangents(cuda):
    args, _ = _gru_inputs(cuda, 2, 3, 12, 9, 'ragged')
    gx, w, mask, h0 = args

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (gx, w, h0)]
        out, _ = fn(leaves[0], leaves[1], mask, leaves[2])
        loss = (out.transpose(0, 1).reshape(6, -1).cumsum(0) ** 2).sum()
        return torch.autograd.grad(loss, leaves)

    for g, e in zip(grads(gru_cell_scan), grads(gru_cell_scan_plain)):
        torch.testing.assert_close(g, e, atol=1e-4, rtol=1e-4)


# the resident route's cases: (n_dir, rows per direction, H, T, mask, scale
# of h0, route)
GRU_ROUTE_CASES = {
    'DPRNN intra rows, unmasked': (2, 260, 128, 12, 'none', 0.5, 'resident'),
    'DPRNN inter rows, chunk mask': (2, 400, 128, 10, 'chunks', 0.5,
                                     'resident'),
    'rows not a multiple of RB': (2, 263, 128, 7, 'ragged', 0.5, 'resident'),
    'rows beyond one register chunk': (2, 1000, 128, 5, 'ragged', 0.5,
                                       'resident'),
    'H=64 one direction, ragged': (1, 37, 64, 15, 'ragged', 0.5, 'resident'),
    # the distance estimator's GRU: 8 rows of 128 frames pooled to 32
    'distance estimator, one direction': (1, 8, 64, 32, 'ragged', 0.5,
                                          'resident'),
    'distance estimator, 128 steps': (1, 8, 64, 128, 'ragged', 0.5,
                                      'resident'),
    'prefix padding, large h0': (2, 30, 128, 9, 'prefix', 3.0, 'resident'),
    'largest resident H': (2, 5, 138, 6, 'ragged', 0.5, 'resident'),
    'smallest cooperative H': (2, 5, 139, 6, 'ragged', 0.5, 'cooperative'),
}


def _gru_route_inputs(cuda, n_dir, batch, hdim, t_len, mask_kind, scale):
    """Kernel inputs and cotangents; 'chunks': lengths shared by blocks of
    rows (an inter-chunk RNN's), 'prefix': padding before the valid steps,
    the second direction's masks reversed in time."""
    rng = np.random.RandomState(batch + hdim + t_len)
    rows = n_dir * batch
    mask = None
    if mask_kind != 'none':
        if mask_kind == 'chunks':
            lens = np.repeat([t_len, t_len - 2, t_len - 4, t_len - 5],
                             batch // 4)
        else:
            lens = rng.randint(1, t_len + 1, size=batch)
        steps = np.arange(t_len)[:, None]
        fwd = (steps >= t_len - lens[None, :] if mask_kind == 'prefix'
               else steps < lens[None, :])
        mask = np.concatenate([fwd, fwd[::-1]][:n_dir], axis=1)
    bound = 1 / np.sqrt(hdim)
    arrays = [rng.uniform(-1, 1, (t_len, rows, 3 * hdim)),
              rng.uniform(-bound, bound, (n_dir, hdim, 3 * hdim)), mask,
              rng.uniform(-scale, scale, (rows, hdim)),
              rng.uniform(-1, 1, (t_len, rows, hdim)),
              rng.uniform(-1, 1, (rows, hdim))]
    tensors = [None if a is None else torch.tensor(
        a, dtype=torch.float32, device=cuda) for a in arrays]
    return tensors[:4], tensors[4:]


@pytest.mark.parametrize('name', sorted(GRU_ROUTE_CASES))
def test_gru_forwards_take_their_route_and_match_plain(cuda, name):
    """Both forwards on the route their shape picks, against the plain
    versions (1e-5: the same float32 arithmetic, sums in another order),
    the same bits on a second run; the Function against autograd through
    the plain forward."""
    n_dir, batch, hdim, t_len, kind, scale, route = GRU_ROUTE_CASES[name]
    args, cotangents = _gru_route_inputs(cuda, n_dir, batch, hdim, t_len,
                                         kind, scale)
    gx, w, mask, h0 = args
    plan = gru_kernels.resident_plan(
        n_dir, batch, hdim,
        *gru_kernels.device_limits(torch.cuda.current_device()))
    assert (plan is not None) == (route == 'resident')
    before = {k: dict(gru_cell_scan.routes[k]) for k in ('fwd', 'fwd_train')}
    got = [gru_cell_scan(*args), gru_cell_scan(*args)]
    got_train = [gru_kernels._launch(gx, w, n_dir, mask, h0, train=True)
                 for _ in range(2)]
    torch.cuda.synchronize()
    for kernel, counts in before.items():
        assert gru_cell_scan.routes[kernel] == {**counts,
                                                route: counts[route] + 2}
    for want, runs in ((gru_cell_scan_plain(*args), got),
                       (gru_cell_scan_train_plain(*args), got_train)):
        for g, again, e in zip(*runs, want):
            torch.testing.assert_close(g, e, atol=1e-5, rtol=0)
            assert torch.equal(g, again)

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (gx, w, h0)]
        outs = fn(leaves[0], leaves[1], mask, leaves[2])
        assert all(o.grad_fn is not None for o in outs)
        return torch.autograd.grad(outs, leaves, cotangents)

    for g, e in zip(grads(gru_cell_scan), grads(gru_cell_scan_plain)):
        scale_e = float(e.abs().max()) + 1e-12
        assert float((g - e).abs().max()) / scale_e <= 1e-4


def test_gru_resident_launch_that_fails_raises(cuda):
    """A plan the kernel does not take is refused before anything runs and
    raises; nothing retries it on the other route."""
    args, _ = _gru_route_inputs(cuda, 2, 260, 128, 3, 'none', 0.5)
    gx, w, _, h0 = args
    plan = gru_kernels.resident_plan(2, 260, 128, 132, 232_448)
    lib = _build.load_library()
    stream, device = _build.stream_and_device(gx)
    out, h_t = torch.empty(3, 520, 128, device=cuda), torch.empty_like(h0)
    before = {k: dict(v) for k, v in gru_cell_scan.routes.items()}
    err = lib.gru_cell_scan_fwd_resident(
        gx.data_ptr(), w.data_ptr(), None, h0.data_ptr(), out.data_ptr(),
        h_t.data_ptr(), 3, 2, 260, 128, plan.RB, plan.RS, plan.KS,
        plan.threads, plan.smem + 4, device, stream)
    with pytest.raises(RuntimeError, match='gru_cell_scan kernel failed'):
        _build.check(lib, err, 'gru_cell_scan kernel')
    assert gru_cell_scan.routes == before


# the backward's cases: (n_dir, rows per direction, H, T, mask, scale of
# h0, route)
GRU_BWD_ROUTE_CASES = {
    'DPRNN intra rows, unmasked': (2, 260, 128, 12, 'none', 0.5, 'resident'),
    'DPRNN inter rows, chunk mask': (2, 400, 128, 10, 'chunks', 0.5,
                                     'resident'),
    'classifier recipe, one direction': (1, 8, 64, 15, 'ragged', 0.5,
                                         'resident'),
    'distance estimator, one direction': (1, 8, 64, 32, 'ragged', 0.5,
                                          'resident'),
    'distance estimator, 128 steps': (1, 8, 64, 128, 'ragged', 0.5,
                                      'resident'),
    'rows not a multiple of RB': (2, 263, 128, 7, 'ragged', 0.5, 'resident'),
    'rows beyond one register chunk': (2, 1000, 128, 5, 'ragged', 0.5,
                                       'resident'),
    'narrow ragged H': (2, 3, 37, 9, 'ragged', 0.5, 'resident'),
    'largest resident backward H': (2, 5, 137, 6, 'ragged', 0.5,
                                    'resident'),
    'smallest cooperative backward H': (2, 5, 138, 6, 'ragged', 0.5,
                                        'cooperative'),
    'classifier defaults, one direction': (1, 16, 256, 9, 'ragged', 0.5,
                                           'cooperative'),
}


@pytest.mark.parametrize('name', sorted(GRU_BWD_ROUTE_CASES))
def test_gru_backward_takes_its_route_and_matches_plain(cuda, name):
    """The backward on the route its shape picks, against the plain
    version on the same residuals (1e-5: the same float32 arithmetic, sums
    in another order), the same bits on a second run, the route read from
    ``gru_cell_scan.routes['bwd']``; the Function against autograd through
    the plain forward (5e-5 relative)."""
    n_dir, batch, hdim, t_len, kind, scale, route = GRU_BWD_ROUTE_CASES[name]
    args, cotangents = _gru_route_inputs(cuda, n_dir, batch, hdim, t_len,
                                         kind, scale)
    gx, w, mask, h0 = args
    plan = gru_kernels.resident_bwd_plan(
        n_dir, batch, hdim,
        *gru_kernels.device_limits(torch.cuda.current_device()))
    assert (plan is not None) == (route == 'resident')
    _, acts, gh_n, h_prev, _ = gru_cell_scan_train_plain(*args)
    before = dict(gru_cell_scan.routes['bwd'])
    runs = [gru_kernels._launch_bwd(acts, gh_n, h_prev, w, n_dir, mask,
                                    *cotangents) for _ in range(2)]
    want = gru_cell_scan_bwd_plain(acts, gh_n, h_prev, w, mask, *cotangents)
    torch.cuda.synchronize()
    assert gru_cell_scan.routes['bwd'] == {**before,
                                           route: before[route] + 2}
    for g, again, e in zip(*runs, want):  # dgates_x, dgh, dh0
        torch.testing.assert_close(g, e, atol=1e-5, rtol=0)
        assert torch.equal(g, again)

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in (gx, w, h0)]
        outs = fn(leaves[0], leaves[1], mask, leaves[2])
        return torch.autograd.grad(outs, leaves, cotangents)

    before = dict(gru_cell_scan.routes['bwd'])
    got = grads(gru_cell_scan)
    assert gru_cell_scan.routes['bwd'][route] == before[route] + 1
    for g, e in zip(got, grads(gru_cell_scan_plain)):
        scale_e = float(e.abs().max()) + 1e-12
        assert float((g - e).abs().max()) / scale_e <= 5e-5


def test_gru_resident_backward_launch_that_fails_raises(cuda):
    """A backward plan the kernel does not take is refused before anything
    runs and raises."""
    args, cotangents = _gru_route_inputs(cuda, 2, 260, 128, 3, 'none', 0.5)
    gx, w, mask, h0 = args
    _, acts, gh_n, h_prev, _ = gru_cell_scan_train_plain(*args)
    plan = gru_kernels.resident_bwd_plan(2, 260, 128, 132, 232_448)
    lib = _build.load_library()
    stream, device = _build.stream_and_device(gx)
    dgx, dgh = torch.empty_like(acts), torch.empty_like(acts)
    dh0 = torch.empty_like(h0)
    err = lib.gru_cell_scan_bwd_resident(
        acts.data_ptr(), gh_n.data_ptr(), h_prev.data_ptr(), w.data_ptr(),
        None, cotangents[0].data_ptr(), cotangents[1].data_ptr(),
        dgx.data_ptr(), dgh.data_ptr(), dh0.data_ptr(), 3, 2, 260, 128,
        plan.RB, plan.RS, plan.KS, plan.threads, plan.smem + 4, device,
        stream)
    with pytest.raises(RuntimeError, match='backward kernel failed'):
        _build.check(lib, err, 'gru_cell_scan backward kernel')


@pytest.mark.parametrize('rnn_type', ['bgru', 'blstm', 'gru'])
def test_tasnet_on_the_card_matches_the_cpu_and_gets_every_gradient(
        cuda, rnn_type):
    """A small DPRNN-TasNet: outputs and losses on the card against the
    CPU (1e-4), every trained parameter with a finite, nonzero gradient,
    and evaluation twice gives the same bits (the overlap-add has a fixed
    order)."""
    torch.manual_seed(0)
    model = TasNet(
        encoder=TasEncoder(20, 32), decoder=TasDecoder(20, 32),
        separator=DPRNN(16, 24, window_length=10, hop_size=5, num_blocks=2,
                        inter_chunk_type=rnn_type,
                        intra_chunk_type=rnn_type)).train()
    rng = np.random.RandomState(0)
    lens = np.array([1203, 1000, 777])
    valid = np.arange(1203)[None, :] < lens[:, None]
    s = (rng.randn(3, 2, 1203) * 0.3 * valid[:, None]).astype('float32')
    batch = {'y': s.sum(1), 's': s, 'num_samples': lens}
    want = model.loss(model.example_to_device(batch),
                      model(model.example_to_device(batch)))
    model = model.to(cuda)
    example = model.example_to_device(batch)
    assert isinstance(example['num_samples'], np.ndarray)
    out = model(example)
    losses = model.loss(example, out)
    for key in losses:
        torch.testing.assert_close(losses[key].cpu(), want[key], atol=1e-4,
                                   rtol=1e-4)
    losses['si-sdr'].backward()
    for name, p in model.named_parameters():
        if p.requires_grad:
            assert p.grad is not None, name
            assert bool(torch.isfinite(p.grad).all()), name
            assert float(p.grad.abs().max()) > 0, name
        else:
            assert 'bias_hh' in name, name
    with torch.no_grad():
        model.eval()
        assert torch.equal(model(example)['out'], model(example)['out'])


def test_time_groups_divide_the_steps_and_fill_the_card(cuda):
    from padertorch_tpu_torch.ops.kernels.lstm import sum_outer, time_groups
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for t_len, rows, cols in ((100, 128, 384), (65, 384, 64), (33, 128, 512),
                              (127, 600, 2400), (500, 2400, 1200)):
        groups = time_groups(t_len, rows, cols, 2, cuda)
        tiles = 2 * -(-rows // 128) * -(-cols // 128)
        assert t_len % groups == 0 and 1 <= groups <= max(1, sms // tiles)
    assert time_groups(100, 128, 384, 2, cuda) > 1
    assert time_groups(500, 2400, 1200, 2, cuda) == 1
    rng = np.random.RandomState(0)
    a = torch.tensor(rng.randn(100, 520, 128), dtype=torch.float32,
                     device=cuda)
    b = torch.tensor(rng.randn(100, 520, 384), dtype=torch.float32,
                     device=cuda)
    want = torch.einsum('tdbm,tdbn->dmn', a.reshape(100, 2, 260, 128),
                        b.reshape(100, 2, 260, 384))
    got = sum_outer(a, b, 2)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


# name: (B, H, Hkv, Tq, Tk, D, kwargs)
ATTENTION_CASES = {
    'd16_full': (3, 2, 2, 100, 100, 16, {}),
    'd16_padding_with_empty_rows': (
        5, 2, 2, 66, 66, 16, {'key_padding_lens': [66, 30, 1, 0, 65]}),
    'd32_causal_padding': (
        2, 4, 4, 37, 37, 32, {'causal': True, 'key_padding_lens': [37, 20]}),
    'd64_tq_ne_tk': (2, 4, 4, 300, 517, 64, {}),
    'd64_causal_more_queries_than_keys': (
        2, 2, 2, 150, 70, 64, {'causal': True}),
    'd64_window': (1, 3, 3, 333, 333, 64, {'window': (40, 9)}),
    'd64_window_left_only_causal': (
        1, 2, 2, 200, 200, 64, {'window': (31, None), 'causal': True}),
    'd64_window_right_only': (1, 2, 2, 130, 190, 64, {'window': (None, 5)}),
    'd128_gqa_padding': (
        2, 8, 2, 130, 77, 128, {'key_padding_lens': [77, 50]}),
    'd64_mqa_causal': (2, 4, 1, 129, 129, 64, {'causal': True}),
    'd24_padded_head': (2, 4, 4, 50, 50, 24, {'window': (7, 3)}),
    # the conformer's self-attention and the attention decoder's
    # cross-attention of the speech-recognition recipe
    'd24_conformer_window_padding': (
        8, 4, 4, 32, 32, 24, {'window': (16, 16),
                              'key_padding_lens': chip_smoke.ASR_LENS}),
    'd24_decoder_cross_padding': (
        8, 4, 4, 9, 32, 24, {'key_padding_lens': chip_smoke.ASR_LENS}),
    'd8_one_query': (2, 2, 2, 1, 40, 8, {'key_padding_lens': [40, 3]}),
    'd64_long': (1, 2, 2, 1100, 1100, 64,
                 {'causal': True, 'key_padding_lens': [900]}),
    'd192_causal_padding': (
        3, 2, 2, 70, 80, 192, {'causal': True, 'key_padding_lens': [80, 1, 0]}),
    'd256_gqa_window_padding': (
        2, 4, 2, 130, 130, 256, {'window': (40, 9),
                                 'key_padding_lens': [130, 0]}),
}


@pytest.mark.parametrize('label', [
    case[0] for case in chip_smoke.ATTENTION_BF16_CASES if case[-1]])
def test_bf16_attention_backward_at_phase_26s_shapes(cuda, label):
    """The bf16 backward (``wgmma``, P and dS in three bf16 pieces) at
    phase 26's timed shapes, the SepFormer's two and bench.py's among them,
    and at heads of 128 and 256: within phase 26's limits of plain, the
    control (P and dS rounded to bf16) outside them, two runs the same
    bits (``chip_smoke.attention_bf16_case`` raises otherwise)."""
    label, *shape, masks, _ = next(
        case for case in chip_smoke.ATTENTION_BF16_CASES if case[0] == label)
    attention_bf16_case(label, *shape, masks, timed=False)


def _attention_inputs(cuda, name):
    b, h, h_kv, tq, tk, d, kwargs = ATTENTION_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))

    def make(*shape):
        return torch.tensor(rng.randn(*shape), dtype=torch.float32,
                            device=cuda)

    return (make(b, h, tq, d), make(b, h_kv, tk, d), make(b, h_kv, tk, d),
            make(b, h, tq, d), kwargs)


@pytest.mark.parametrize('name', sorted(ATTENTION_CASES))
def test_attention_kernels_match_plain(cuda, name):
    """Forward (lean and training, with the log-sum-exp) 1e-5 absolute;
    dq, dk, dv through ``FlashAttention`` against autograd through the
    plain version, 5e-5 of each gradient's largest entry; two backward
    runs give the same bits (no atomics)."""
    q, k, v, d_o, kwargs = _attention_inputs(cuda, name)
    before = dict(flash_attention.launches)
    with torch.no_grad():
        got = flash_attention(q, k, v, **kwargs)
        want, want_lse = flash_attention_fwd_plain(q, k, v, **kwargs)
    assert got.shape == want.shape and got.grad_fn is None
    assert float((got - want).abs().max()) <= 1e-5
    assert flash_attention.launches['fwd'] == before['fwd'] + 1

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, **kwargs)
        assert out.grad_fn is not None
        return out, torch.autograd.grad(out, leaves, d_o)

    out, got_grads = grads(flash_attention)
    _, want_grads = grads(flash_attention_plain)
    assert float((out - want).abs().max()) <= 1e-5
    for g, w, label in zip(got_grads, want_grads, 'qkv'):
        assert g.shape == w.shape, label
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 5e-5 * max(scale, 1e-3), label
    _, again = grads(flash_attention)
    assert all(torch.equal(a, b) for a, b in zip(got_grads, again))
    assert flash_attention.launches['fwd_train'] == before['fwd_train'] + 2
    assert flash_attention.launches['bwd'] == before['bwd'] + 2
    lens = kwargs.get('key_padding_lens')
    if lens is not None and 0 in lens:
        row = lens.index(0)
        assert float(out[row].abs().max()) == 0.0
        assert float(got_grads[0][row].abs().max()) == 0.0
        assert float(got_grads[1][row].abs().max()) == 0.0
        assert float(got_grads[2][row].abs().max()) == 0.0



# head size: (B, H, Hkv, Tq, Tk, kwargs); every case has a row with one key
# and a row with none
ATTENTION_BWD_CASES = {
    16: (3, 4, 2, 70, 130, {'window': (20, 5),
                            'key_padding_lens': [130, 1, 0]}),
    32: (3, 2, 1, 200, 150, {'causal': True,
                             'key_padding_lens': [150, 1, 0]}),
    64: (3, 4, 2, 129, 257, {'key_padding_lens': [257, 1, 0]}),
    128: (3, 4, 4, 100, 90, {'causal': True, 'window': (30, None),
                             'key_padding_lens': [90, 1, 0]}),
    24: (3, 6, 3, 65, 33, {'window': (3, 7), 'key_padding_lens': [33, 1, 0]}),
    192: (3, 2, 2, 60, 70, {'causal': True, 'key_padding_lens': [70, 1, 0]}),
    256: (3, 4, 2, 100, 90, {'window': (30, 10),
                             'key_padding_lens': [90, 1, 0]}),
}


@pytest.mark.parametrize('d', sorted(ATTENTION_BWD_CASES))
def test_attention_backward_kernel_matches_plain_at_every_head_size(cuda, d):
    """The backward kernels' 3xTF32 tensor-core products at every head size
    of the template set and one that is padded (24), with Tq != Tk,
    grouped-query heads, causal and windowed masks: dq, dk, dv within 5e-5
    of each gradient's largest entry of autograd through the plain
    version, the same bits on two runs, and zero gradients for the batch
    row that sees no key."""
    b, h, h_kv, tq, tk, kwargs = ATTENTION_BWD_CASES[d]
    rng = np.random.RandomState(d)
    q, k, v, d_o = (
        torch.tensor(rng.randn(*shape), dtype=torch.float32, device=cuda)
        for shape in ((b, h, tq, d), (b, h_kv, tk, d), (b, h_kv, tk, d),
                      (b, h, tq, d)))

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        return torch.autograd.grad(fn(*leaves, **kwargs), leaves, d_o)

    before = flash_attention.launches['bwd']
    got = grads(flash_attention)
    again = grads(flash_attention)
    want = grads(flash_attention_plain)
    torch.cuda.synchronize()
    assert flash_attention.launches['bwd'] == before + 2
    for g, w, label in zip(got, want, 'qkv'):
        assert g.shape == w.shape, label
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 5e-5 * scale, label
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    empty = kwargs['key_padding_lens'].index(0)
    assert all(float(g[empty].abs().max()) == 0.0 for g in got)


def test_attention_training_forward_writes_the_log_sum_exp(cuda):
    q, k, v, _, kwargs = _attention_inputs(
        cuda, 'd16_padding_with_empty_rows')
    lens = torch.tensor(kwargs['key_padding_lens'], dtype=torch.int32,
                        device=cuda)
    out, lse = attention_kernels._launch_fwd(
        q, k, v, lens, False, None, None, 0.25, train=True)
    want, want_lse = flash_attention_fwd_plain(q, k, v, **kwargs)
    assert float((out - want).abs().max()) <= 1e-5
    assert float((lse - want_lse).abs().max()) <= 1e-5
    assert bool((lse[3] == -1e30).all())


def test_attention_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((2, 4, 5, 16), device=cuda)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        flash_attention(q.bfloat16(), q, q.bfloat16())
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :3], q[:, :3])          # 4 % 3 heads
    with pytest.raises(ValueError, match='256'):
        big = torch.zeros((1, 1, 3, 320), device=cuda)
        flash_attention(big, big, big)
    # views and strided inputs are made contiguous, not refused
    x = torch.randn((2, 5, 4, 16), device=cuda).transpose(1, 2)
    want = flash_attention_plain(x, x, x)
    assert float((flash_attention(x, x, x) - want).abs().max()) <= 1e-5


def test_attention_takes_strided_cotangents_and_a_partial_graph(cuda):
    q, k, v, _, kwargs = _attention_inputs(cuda, 'd32_causal_padding')

    def grads(fn):
        leaves = [q.clone().requires_grad_(), k,
                  v.clone().requires_grad_()]
        out = fn(*leaves, **kwargs)
        loss = (out.transpose(1, 2).reshape(2, 37, -1).cumsum(1) ** 2).sum()
        return torch.autograd.grad(loss, [leaves[0], leaves[2]])

    # relative to each gradient's largest entry: the first query sees one
    # key, so its dq is zero in exact arithmetic and rounding noise here
    for g, e in zip(grads(flash_attention), grads(flash_attention_plain)):
        assert float((g - e).abs().max()) <= 5e-5 * float(e.abs().max())


def test_multihead_attention_forced_onto_the_kernels_matches_dense(cuda):
    torch.manual_seed(0)
    mha = MultiheadAttention(64, 4, use_rope=True, num_kv_heads=2,
                             use_flash=False).to(cuda)
    x = torch.randn((3, 50, 64), device=cuda)
    lens = torch.tensor([50, 31, 7], device=cuda)
    dense = mha(x, key_padding_lens=lens, causal=True)
    before = dict(flash_attention.launches)
    fused = set_attention_backend(mha, True)(x, key_padding_lens=lens,
                                             causal=True)
    assert flash_attention.launches['fwd_train'] == before['fwd_train'] + 1
    assert fused.grad_fn is not None
    assert float((fused - dense).abs().max()) <= 1e-5


def test_multihead_attention_at_heads_of_256_takes_the_measured_backend(
        cuda):
    """Heads of 256: 'auto' takes the backend ``should_use_flash`` picks
    from phase 12's table, bit for bit; the kernels forced agree with the
    dense path on the valid rows; a head of 320 forced on the kernels
    raises with their stated message."""
    torch.manual_seed(0)
    mha = MultiheadAttention(512, 2, use_rope=True).to(cuda)
    x = torch.randn((2, 40, 512), device=cuda)
    lens = torch.tensor([40, 23], device=cuda)
    pick = attention_kernels.should_use_flash(x.device, x.dtype, 256)
    before = dict(flash_attention.launches)
    auto = mha(x, key_padding_lens=lens, causal=True)
    assert (flash_attention.launches != before) is pick
    fused = set_attention_backend(mha, True)(x, key_padding_lens=lens,
                                             causal=True)
    dense = set_attention_backend(mha, False)(x, key_padding_lens=lens,
                                              causal=True)
    assert torch.equal(auto, fused if pick else dense)
    assert float((fused - dense)[0].abs().max()) <= 1e-4
    assert float((fused - dense)[1, :23].abs().max()) <= 1e-4
    wide = set_attention_backend(
        MultiheadAttention(640, 2, use_rope=True).to(cuda), True)
    with pytest.raises(ValueError, match='at most 256'):
        wide(torch.randn((1, 8, 640), device=cuda))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('label', [case[0] for case in ATTENTION_WIDE_CASES])
def test_attention_kernels_take_heads_above_128(cuda, label, dtype):
    """Heads of 192 (padded to 256 by the wrapper) and 256, float32 and
    bf16, forward and backward, against the plain versions
    (``chip_smoke.attention_wide_case`` raises otherwise)."""
    case = next(c for c in ATTENTION_WIDE_CASES if c[0] == label)
    attention_wide_case(*case, dtype)


@pytest.mark.parametrize('use_flash', [True, False])
def test_sepformer_tasnet_on_the_card_matches_the_cpu(cuda, use_flash):
    """A small SepFormer-TasNet: losses on the card against the CPU (1e-4),
    every parameter with a finite gradient, evaluation twice gives the same
    bits, and the forced backend launches one kernel per layer."""
    torch.manual_seed(0)
    model = set_attention_backend(TasNet(
        encoder=TasEncoder(20, 32), decoder=TasDecoder(20, 32),
        separator=DualPathTransformer(
            16, window_length=10, hop_size=5, num_blocks=2,
            num_layers_intra=1, num_layers_inter=2, num_heads=2)).train(),
        use_flash)
    rng = np.random.RandomState(0)
    lens = np.array([1203, 1000, 777])
    valid = np.arange(1203)[None, :] < lens[:, None]
    s = (rng.randn(3, 2, 1203) * 0.3 * valid[:, None]).astype('float32')
    batch = {'y': s.sum(1), 's': s, 'num_samples': lens}
    want = model.loss(model.example_to_device(batch),
                      model(model.example_to_device(batch)))
    model = model.to(cuda)
    example = model.example_to_device(batch)
    before = dict(flash_attention.launches)
    losses = model.loss(example, model(example))
    for key in losses:
        torch.testing.assert_close(losses[key].cpu(), want[key], atol=1e-4,
                                   rtol=1e-4)
    losses['si-sdr'].backward()
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()), name
    layers = 6 if use_flash else 0
    assert flash_attention.launches == {
        **before, 'fwd_train': before['fwd_train'] + layers,
        'bwd': before['bwd'] + layers}
    with torch.no_grad():
        model.eval()
        assert torch.equal(model(example)['out'], model(example)['out'])
    assert flash_attention.launches['fwd'] == before['fwd'] + 2 * layers


# bf16: (B, H, Hkv, Tq, Tk, D, kwargs), every head size and mask mode, a
# row with one key and one with none where there is padding
ATTENTION_BF16_CASES = {
    'd16_padding_with_empty_rows': (
        5, 2, 2, 66, 66, 16, {'key_padding_lens': [66, 30, 1, 0, 65]}),
    'd32_causal_padding': (
        2, 4, 4, 37, 37, 32, {'causal': True, 'key_padding_lens': [37, 20]}),
    'd64_tq_ne_tk': (2, 4, 4, 300, 517, 64, {}),
    'd64_window': (1, 3, 3, 333, 333, 64, {'window': (40, 9)}),
    'd64_mqa_causal': (2, 4, 1, 129, 129, 64, {'causal': True}),
    'd128_gqa_causal_window_padding': (
        3, 4, 2, 100, 90, 128, {'causal': True, 'window': (30, None),
                                'key_padding_lens': [90, 1, 0]}),
    'd24_padded_head': (2, 4, 4, 50, 50, 24, {'window': (7, 3)}),
    'd64_long': (1, 2, 2, 1100, 1100, 64,
                 {'causal': True, 'key_padding_lens': [900]}),
    'd192_causal_padding': (
        3, 2, 2, 70, 80, 192, {'causal': True, 'key_padding_lens': [80, 1, 0]}),
    'd256_gqa_window_padding': (
        2, 4, 2, 130, 130, 256, {'window': (40, 9),
                                 'key_padding_lens': [130, 0]}),
}


@pytest.mark.parametrize('name', sorted(ATTENTION_BF16_CASES))
def test_bf16_attention_kernels_match_plain(cuda, name):
    """The bf16 forward (lean and training) against plain in the kernel's
    key tiles, the bf16 backward through ``FlashAttention`` against
    ``flash_attention_bwd_plain`` on the same residuals, at phase 26's
    limits; the control (logits rounded to bf16 in the forward, P and dS
    in the backward) fails them; the bf16 launches are counted; a row with
    no key gives zeros; two runs give the same bits."""
    b, h, h_kv, tq, tk, d, kwargs = ATTENTION_BF16_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    q, k, v, d_o = (
        torch.tensor(rng.randn(*shape), dtype=torch.float32,
                     device=cuda).bfloat16()
        for shape in ((b, h, tq, d), (b, h_kv, tk, d), (b, h_kv, tk, d),
                      (b, h, tq, d)))
    before = dict(flash_attention.launches)
    with torch.no_grad():
        lean = flash_attention(q, k, v, **kwargs)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, **kwargs)
    grads = torch.autograd.grad(out, leaves, d_o)
    again = torch.autograd.grad(flash_attention(*leaves, **kwargs), leaves,
                                d_o)
    assert flash_attention.launches == {
        **before, 'fwd_bf16': before['fwd_bf16'] + 1,
        'fwd_train_bf16': before['fwd_train_bf16'] + 2,
        'bwd_bf16': before['bwd_bf16'] + 2}
    assert lean.dtype == out.dtype == torch.bfloat16
    assert torch.equal(lean, out.detach())
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    want, lse = attention_bf16_fwd_plain(q, k, v, **kwargs)
    excess, share = bf16_distance([out.detach()], [want],
                                  ATTENTION_BF16_FWD_ATOL)
    assert excess <= 0 and share <= ATTENTION_BF16_FWD_SHARE, (excess, share)
    want_grads = flash_attention_bwd_plain(q, k, v, out.detach(), lse, d_o,
                                           **kwargs)
    excess, share = bf16_grad_distance(grads, want_grads)
    assert excess <= 0 and share <= ATTENTION_BF16_GRAD_SHARE, (excess, share)
    for g, x in zip(grads, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape
    control, = attention_bf16_control_fwd(q, k, v, **kwargs)
    _, control_share = bf16_distance([control], [want],
                                     ATTENTION_BF16_FWD_ATOL)
    assert control_share > ATTENTION_BF16_FWD_SHARE
    _, control_share = bf16_grad_distance(
        attention_bf16_control_bwd(q, k, v, out.detach(), lse, d_o,
                                   **kwargs), want_grads)
    assert control_share > ATTENTION_BF16_GRAD_SHARE
    lens = kwargs.get('key_padding_lens')
    if lens is not None and 0 in lens:
        row = lens.index(0)
        assert all(float(x[row].abs().max()) == 0.0 for x in (out, *grads))


def test_bf16_attention_training_forward_writes_a_float32_log_sum_exp(cuda):
    b, h, h_kv, tq, tk, d, kwargs = ATTENTION_BF16_CASES[
        'd16_padding_with_empty_rows']
    rng = np.random.RandomState(0)
    q, k, v = (torch.tensor(rng.randn(*shape), dtype=torch.float32,
                            device=cuda).bfloat16()
               for shape in ((b, h, tq, d), (b, h_kv, tk, d),
                             (b, h_kv, tk, d)))
    lens = torch.tensor(kwargs['key_padding_lens'], dtype=torch.int32,
                        device=cuda)
    out, lse = attention_kernels._launch_fwd(q, k, v, lens, False, None,
                                             None, 0.25, train=True)
    _, want = attention_bf16_fwd_plain(q, k, v, **kwargs)
    assert lse.dtype == torch.float32 and out.dtype == torch.bfloat16
    assert lse_distance(lse, want) <= ATTENTION_BF16_LSE_TOL
    assert bool((lse[3] == -1e30).all())


def test_bf16_multihead_attention_auto_takes_the_bf16_kernel(cuda):
    """A bf16 ``MultiheadAttention`` with ``use_flash='auto'`` on the card
    takes the bf16 kernels (the measured table) and equals the forced
    fused backend bit for bit; its dense backend agrees within bf16's
    rounding."""
    torch.manual_seed(0)
    mha = MultiheadAttention(64, 4, use_rope=True, num_kv_heads=2).to(
        cuda, torch.bfloat16)
    x = torch.randn((3, 50, 64), device=cuda, dtype=torch.bfloat16)
    lens = torch.tensor([50, 31, 7], device=cuda)
    before = dict(flash_attention.launches)
    with torch.no_grad():
        auto = mha(x, key_padding_lens=lens, causal=True)
        assert flash_attention.launches == {
            **before, 'fwd_bf16': before['fwd_bf16'] + 1}
        fused = set_attention_backend(mha, True)(
            x, key_padding_lens=lens, causal=True)
        dense = set_attention_backend(mha, False)(
            x, key_padding_lens=lens, causal=True)
    assert torch.equal(auto, fused)
    assert float((fused.float() - dense.float()).abs().max()) <= 5e-2


# ---------------------------------------------------------------- WaveNet
def _wavenet_weights(n_layers, r, s, o, c, rng, device):
    def u(*shape):
        bound = np.sqrt(3.0 / shape[-2]) if len(shape) > 2 else 0.1
        return torch.from_numpy(
            rng.uniform(-bound, bound, shape).astype('float32')).to(device)
    return {'w_prev': u(n_layers, r, 2 * r), 'w_curr': u(n_layers, r, 2 * r),
            'b_dil': u(n_layers, 2 * r), 'w_res': u(n_layers - 1, r, r),
            'b_res': u(n_layers - 1, r), 'w_skip': u(n_layers, r, s),
            'b_skip': u(n_layers, s), 'w_out': u(1, s, o)[0],
            'w_end': u(1, o, o)[0],
            'embed': torch.from_numpy(
                rng.randn(c, r).astype('float32')).to(device)}


@pytest.mark.parametrize('t_len,batch,dilations,r,s,o', [
    (37, 1, (1, 2, 4, 1), 16, 32, 256),
    (50, 5, (1, 2, 4, 8, 1, 2), 16, 32, 256),
    (23, 3, (3, 1, 5), 12, 20, 132),
    (40, 7, (1,), 64, 256, 256),
    (64, 133, (1, 2), 8, 16, 256),
])
def test_wavenet_sample_kernel_matches_plain(cuda, t_len, batch, dilations,
                                             r, s, o):
    from padertorch_tpu_torch.ops.kernels.wavenet import (
        wavenet_sample, wavenet_sample_plain)
    rng = np.random.RandomState(t_len)
    n_layers = len(dilations)
    w = _wavenet_weights(n_layers, r, s, o, 256, rng, cuda)
    cond = torch.from_numpy(rng.randn(
        t_len, batch, n_layers, 2 * r).astype('float32')).to(cuda) * 0.5
    forced = torch.from_numpy(
        rng.randint(0, o, (t_len, batch)).astype('int32')).to(cuda)
    before = wavenet_sample.launches
    for sample in (False, True):
        got_i, got_l = wavenet_sample(
            cond, w, dilations, forced_input=forced, return_logits=True,
            sample=sample, seed=11)
        want_i, want_l = wavenet_sample_plain(
            cond, w, dilations, forced_input=forced, return_logits=True,
            sample=sample, seed=11)
        assert got_i.dtype == torch.int32 and got_i.shape == (t_len, batch)
        assert float((got_l - want_l).abs().max()) <= 2e-5
        # the choice from the kernel's own logits: ties and draws as plain
        assert bool((got_i == want_i).all())
    free = wavenet_sample(cond, w, dilations)
    assert bool((free == wavenet_sample_plain(cond, w, dilations)).all())
    assert wavenet_sample.launches == before + 3


@pytest.mark.parametrize('dilations,r,s,o', [
    ((1, 2, 4, 8, 16, 32, 64, 128) * 2, 64, 256, 256),
    ((3, 1, 5), 12, 20, 132),
])
def test_wavenet_rows_are_the_same_on_every_route(cuda, dilations, r, s, o,
                                                  monkeypatch):
    """The sampler's routes split columns, never a column's sum: each row
    of a batch that runs one block per row equals the same row in a batch
    of 1, 5, 8, 16 or 33 rows on clusters of CTAs, logits and indices bit
    for bit.  On an H100 (132 SMs) those batches take clusters of 16 (8
    where R < 16), 8, 4 and 2 CTAs: the cluster sizes launched are read
    from the weights' layout the wrapper builds for each launch, the
    routes from ``wavenet_sample.routes``."""
    from padertorch_tpu_torch.ops.kernels import wavenet as wavenet_kernels
    from padertorch_tpu_torch.ops.kernels.wavenet import wavenet_sample
    rng = np.random.RandomState(r)
    n_layers, t_len, batch = len(dilations), 60, 140
    w = _wavenet_weights(n_layers, r, s, o, 256, rng, cuda)
    cond = torch.from_numpy(rng.randn(
        t_len, batch, n_layers, 2 * r).astype('float32')).to(cuda)
    forced = torch.from_numpy(
        rng.randint(0, o, (t_len, batch)).astype('int32')).to(cuda)
    launched = []
    layout = wavenet_kernels.cluster_weights
    monkeypatch.setattr(wavenet_kernels, 'cluster_weights', lambda w, n: (
        launched.append(n) or layout(w, n)))
    before = dict(wavenet_sample.routes)
    many_i, many_l = wavenet_sample(cond, w, dilations, forced_input=forced,
                                    return_logits=True)
    assert wavenet_sample.routes['one_block'] == before['one_block'] + 1
    cases = [(slice(0, 1), 16), (slice(77, 78), 16), (slice(3, 8), 16),
             (slice(0, 8), 8), (slice(40, 56), 4), (slice(100, 133), 2)]
    for rows, n in cases:
        plan = wavenet_kernels.device_plan(
            rows.stop - rows.start, n_layers, r, s, o, sum(dilations),
            cond.get_device())
        got_i, got_l = wavenet_sample(
            cond[:, rows].contiguous(), w, dilations,
            forced_input=forced[:, rows].contiguous(), return_logits=True)
        assert launched[-1] == plan.n
        if torch.cuda.get_device_properties(
                cond.get_device()).multi_processor_count == 132:
            assert plan.n == min(n, 8 if r < 16 else 16)
        assert torch.equal(got_i, many_i[:, rows])
        assert torch.equal(got_l, many_l[:, rows])
    assert launched[0] == 1 and all(n > 1 for n in launched[1:])
    assert wavenet_sample.routes['cluster'] == before['cluster'] + len(cases)


def test_wavenet_cluster_launch_that_fails_raises(cuda, monkeypatch):
    """A cluster plan the card cannot launch (more shared memory than a
    block may have) raises; it is not retried on the one-block route."""
    from padertorch_tpu_torch.ops.kernels import wavenet as wavenet_kernels
    from padertorch_tpu_torch.ops.kernels.wavenet import wavenet_sample
    rng = np.random.RandomState(0)
    w = _wavenet_weights(2, 16, 32, 256, 256, rng, cuda)
    cond = torch.zeros(4, 1, 2, 32, device=cuda)
    limit = torch.cuda.get_device_properties(
        cond.get_device()).shared_memory_per_block_optin
    monkeypatch.setattr(
        wavenet_kernels, 'device_plan',
        lambda *args: wavenet_kernels.ClusterPlan(16, False, limit + 1024))
    before = dict(wavenet_sample.routes)
    with pytest.raises(RuntimeError, match='cluster'):
        wavenet_sample(cond, w, (1, 2))
    assert wavenet_sample.routes == before


@pytest.mark.parametrize('label', [case[0] for case in WAVENET_GEOMETRIES])
def test_wavenet_sample_kernel_takes_every_geometry(cuda, label):
    """Rings beyond one block (30 layers to dilation 512 at R = 64, 1, 8
    and 132 rows; 24 layers to 128 at R = 128), channels that are no
    multiple of 4 (R = 60, S = 250, O = 254), 80 layers, and rings no
    cluster holds (in device memory): teacher-forced logits and choices
    against plain, a row alone equal to the row in its batch
    (``chip_smoke.wavenet_geometry_case`` raises otherwise)."""
    case = next(c for c in WAVENET_GEOMETRIES if c[0] == label)
    plan = wavenet_geometry_case(*case)
    if 'device memory' in label:
        assert plan.ring_global


def test_wavenet_sample_kernel_refuses_a_gradient(cuda):
    from padertorch_tpu_torch.ops.kernels.wavenet import wavenet_sample
    rng = np.random.RandomState(0)
    w = _wavenet_weights(2, 64, 16, 256, 256, rng, cuda)
    cond = torch.zeros(4, 1, 2, 128, device=cuda)
    with pytest.raises(ValueError, match='inference kernel'):
        wavenet_sample(cond.requires_grad_(), w, (1, 2))


def test_wavenet_vocoder_on_the_card_matches_the_cpu_and_round_trips(cuda):
    import copy
    from padertorch_tpu_torch.contrib.examples.audio_synthesis.wavenet.model \
        import WaveNetVocoder
    from padertorch_tpu_torch.migrate import (
        from_jax_state_dict, to_jax_state_dict)
    from padertorch_tpu_torch.modules.wavenet import WaveNet
    from padertorch_tpu_torch.ops.kernels.wavenet import wavenet_sample
    torch.manual_seed(0)
    kw = dict(n_cond_channels=8, upsamp_window=8, upsamp_stride=4, n_layers=4,
              max_dilation=4, n_residual_channels=16, n_skip_channels=32)
    cpu = WaveNetVocoder(WaveNet(**kw)).eval()
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.RandomState(0)
    features = torch.from_numpy(rng.randn(2, 8, 40).astype('float32'))
    before = wavenet_sample.launches
    with torch.no_grad():
        want = cpu.wavenet.infer(features, sample=False)
        got = card.wavenet.infer(features.to(cuda), sample=False)
        chunked = card.wavenet.infer(features.to(cuda), chunk_length=60,
                                     chunk_overlap=20, sample=False,
                                     parallel=True)
    assert wavenet_sample.launches == before + 2
    assert got.shape == want.shape == chunked.shape == (2, 156)
    # mu-law decoding differs by an ulp between card and CPU; neighbouring
    # levels are at least 1.7e-4 apart
    assert float((got.cpu() - want).abs().max()) <= 1e-5
    # the JAX layout and back: every tensor as it was
    state = to_jax_state_dict(card)
    other = WaveNetVocoder(WaveNet(**kw)).to(cuda)
    from_jax_state_dict(other, state)
    for (name, a), (_, b) in zip(card.state_dict().items(),
                                 other.state_dict().items()):
        assert torch.equal(a, b), name


def test_wavenet_trainer_built_outside_the_recipe_passes_test_run(
        cuda, tmp_path):
    """``Trainer.from_config`` without the recipe's ``main``: the
    convolutions are float32 all the same, so ``test_run``'s comparison of
    two validation passes (1e-5) holds on the card."""
    from padertorch_tpu_torch.contrib.examples.audio_synthesis.wavenet \
        import data, train
    from padertorch_tpu_torch.train.trainer import Trainer
    torch.manual_seed(0)
    trainer = Trainer.from_config(train.get_trainer_config(
        tmp_path, {'model': train.SMALL}))
    trainer.to('cuda')
    train_ds, dev_ds = (data.prepare_dataset(
        data.synthetic_database(num_examples=4, seed=seed), batch_size=2,
        segment_length=4000, shuffle=False, prefetch=False)
        for seed in (0, 1))
    trainer.test_run(train_ds, dev_ds)
    assert not torch.backends.cudnn.allow_tf32


# ---------------------------------------------------------------- log-mel
@pytest.mark.parametrize('batch,samples,size,shift,window_length,n_mels', [
    (1, 4000, 512, 128, None, 64),
    (3, 12345, 512, 160, 400, 40),     # the hop does not divide the window
    (5, 7001, 1024, 200, 800, 80),
    (2, 300, 512, 128, None, 64),      # shorter than a window
    (7, 16000, 256, 100, 250, 40),
    (2, 5000, 512, 150, 450, 64),      # a hop that is no multiple of 4
])
@pytest.mark.parametrize('fading', ['full', 'half', None])
def test_fused_logmel_kernel_matches_plain(cuda, batch, samples, size, shift,
                                           window_length, n_mels, fading):
    from padertorch_tpu_torch.ops.kernels.logmel import (
        LogMelFrontend, fused_logmel)
    rng = np.random.RandomState(samples)
    x = torch.from_numpy(rng.randn(batch, samples).astype('float32')).to(cuda)
    frontend = LogMelFrontend(size=size, shift=shift,
                              window_length=window_length, n_mels=n_mels,
                              fading=fading)
    before = fused_logmel.launches
    got = frontend(x)
    want = frontend.plain(x)
    assert fused_logmel.launches == before + 1
    assert got.shape == want.shape and got.shape[-1] == n_mels
    # log of a sum of 2 * window_length * F float32 products: 1e-4 on
    # values between -28 and 10
    assert float((got - want).abs().max()) <= 1e-4
    assert torch.equal(frontend(x[0]), got[:1])
    with pytest.raises(ValueError, match='gradient'):
        frontend(x.clone().requires_grad_())


# chip_smoke.py's LOGMEL_SHAPES: (batch, samples, size, shift, window, mels)
LOGMEL_MAIN_SHAPES = [
    (16, 64000, 512, 128, None, 64),
    (8, 8000, 512, 128, None, 64),
    (2, 16000, 1024, 200, 800, 80),
    (3, 12345, 512, 160, 400, 40),
]


@pytest.mark.parametrize('batch,samples,size,shift,window_length,n_mels',
                         LOGMEL_MAIN_SHAPES)
def test_fused_logmel_kernel_matches_plain_at_the_main_shapes(
        cuda, batch, samples, size, shift, window_length, n_mels):
    """The shapes the recipes and chip_smoke.py phase 16 run: one launch,
    within 1e-5 of plain (the kernel's DFT products are 3xTF32), the same
    bits on a second call and for each signal alone (every plan adds the
    same sums in the same order)."""
    from padertorch_tpu_torch.ops.kernels.logmel import (
        LogMelFrontend, fused_logmel)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(
        rng.randn(batch, samples).astype('float32') * 0.1).to(cuda)
    frontend = LogMelFrontend(size=size, shift=shift,
                              window_length=window_length, n_mels=n_mels)
    before = fused_logmel.launches
    got = frontend(x)
    assert fused_logmel.launches == before + 1
    want = frontend.plain(x)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(frontend(x), got)
    assert torch.equal(frontend(x[-1]), got[-1:])


@pytest.mark.parametrize('label', [case[0] for case in LOGMEL_LONG_HOPS])
def test_fused_logmel_takes_long_hops_on_the_sliced_route(cuda, label):
    """Hops whose 64 frames' span does not fit one block (1600/800 with 80
    mels, 1024/1024 with 64): the sliced route, within 1e-5 of plain
    (``chip_smoke.logmel_long_hop_case`` raises otherwise)."""
    logmel_long_hop_case(*next(c for c in LOGMEL_LONG_HOPS if c[0] == label))


def test_fused_logmel_sliced_route_gives_the_span_routes_bits(cuda):
    logmel_routes_agree()


def test_speaker_clf_on_the_card_matches_the_cpu_and_round_trips(cuda):
    import copy
    from padertorch_tpu_torch.contrib.examples.speaker_classification \
        .supervised.model import SpeakerClf
    from padertorch_tpu_torch.contrib.je.modules.features import (
        FusedAudioLogMelExtractor)
    from padertorch_tpu_torch.migrate import (
        from_jax_state_dict, to_jax_state_dict)
    from padertorch_tpu_torch.ops.kernels.logmel import fused_logmel

    def build():
        return SpeakerClf(
            FusedAudioLogMelExtractor(16000, 512, 128, 64), num_speakers=5,
            cnn_channels=(4, 8), hidden_size=16)

    torch.manual_seed(0)
    cpu = build()
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.RandomState(0)
    batch = {'audio_data': rng.randn(3, 6000).astype('float32'),
             'seq_len': np.array([6000, 4000, 3000], 'int32'),
             'speaker_id': np.array([0, 3, 4], 'int32')}
    before = fused_logmel.launches
    reviews = {}
    for name, model in (('cpu', cpu), ('card', card)):
        model.train()     # the running statistics move
        example = model.example_to_device(batch)
        review = model.review(example, model(example))
        review['loss'].backward()
        reviews[name] = review
    assert fused_logmel.launches == before + 1
    np.testing.assert_allclose(float(reviews['card']['loss']),
                               float(reviews['cpu']['loss']), rtol=1e-5)
    for (name, p), (_, q) in zip(card.named_parameters(),
                                 cpu.named_parameters()):
        if not q.requires_grad:     # the GRU's frozen bias_hh
            assert p.grad is None
            continue
        scale = float(q.grad.abs().max()) or 1.0
        assert float((p.grad.cpu() - q.grad).abs().max()) <= 1e-4 * scale, \
            name
    for (name, a), (_, b) in zip(card.named_buffers(), cpu.named_buffers()):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    state = to_jax_state_dict(card)
    other = build().to(cuda)
    from_jax_state_dict(other, state)
    for (name, a), (_, b) in zip(card.state_dict().items(),
                                 other.state_dict().items()):
        assert torch.equal(a, b), name


INT8_SHAPES = [(m, k, n) for m in (1, 8, 16, 32, 64, 128, 256)
               for k, n in ((1024, 1024), (1024, 4096), (4096, 1024))]
INT8_SHAPES += [(1, 1000, 1030), (5, 1000, 1030), (37, 1000, 1030),
                (70, 1000, 1030), (3, 96, 200), (2, 40, 7), (9, 1001, 64)]


def _int8_inputs(cuda, m, k, n, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(m, k), dtype=dtype, device=cuda)
    w_q = torch.tensor(rng.randint(-127, 128, (k, n)), dtype=torch.int8,
                       device=cuda)
    scale = torch.tensor((rng.rand(n) + 0.5) / 127.0 / np.sqrt(k),
                         dtype=torch.float32, device=cuda)
    bias = torch.tensor(rng.randn(n), dtype=torch.float32, device=cuda)
    return x, w_q, scale, bias


def _bf16_limit(want):
    """One bf16 unit in the last place of each output, plus the float32
    limit (1e-5 of the largest output) for the order of the sums that both
    sides round: an output near zero is a float32 sum with cancellation."""
    mag = want.float().abs()
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=1e-30))) - 7)
    return ulp + 1e-5 * float(mag.max())


@pytest.mark.parametrize('m,k,n', INT8_SHAPES)
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_int8_matmul_kernel_matches_plain(cuda, m, k, n, dtype):
    """float32: 1e-5 of the largest output (the same sums in another
    order); bf16: one unit in the last place of each output, plus that."""
    from padertorch_tpu_torch.ops.kernels.int8_matmul import (
        int8_matmul, int8_matmul_plain)
    x, w_q, scale, bias = _int8_inputs(cuda, m, k, n, getattr(torch, dtype))
    for b in (bias, None, bias.to(torch.bfloat16)):
        before = int8_matmul.launches
        got = int8_matmul(x, w_q, scale, b)
        want = int8_matmul_plain(x, w_q, scale, b)
        torch.cuda.synchronize()
        assert int8_matmul.launches == before + 1
        assert got.dtype == x.dtype and got.shape == (m, n)
        if dtype == 'float32':
            assert float((got - want).abs().max()) <= \
                1e-5 * float(want.abs().max())
        else:
            assert bool(((got.float() - want.float()).abs()
                         <= _bf16_limit(want)).all())


def test_int8_matmul_rows_are_the_same_bits_in_any_batch(cuda):
    """The order of every sum is fixed by (K, N): the rows of a batch of 1,
    8, 32, 128 or 256 equal the same rows of any other batch, bit for bit
    (in bf16 the products of 8, 16, 32 or 64 rows at a time run as one
    tensor-core instruction of that width), and two launches agree."""
    from padertorch_tpu_torch.ops.kernels.int8_matmul import int8_matmul
    for dtype in (torch.float32, torch.bfloat16):
        x, w_q, scale, bias = _int8_inputs(cuda, 256, 1024, 4096, dtype)
        full = int8_matmul(x, w_q, scale, bias)
        assert torch.equal(full, int8_matmul(x, w_q, scale, bias))
        for m in (1, 8, 32, 128):
            assert torch.equal(int8_matmul(x[:m], w_q, scale, bias),
                               full[:m]), (dtype, m)
        for rows in (x[5:6], x[127:135], x[255:]):
            part = int8_matmul(rows, w_q, scale, bias)
            start = int((rows.data_ptr() - x.data_ptr())
                        // (x.element_size() * x.shape[1]))
            assert torch.equal(part, full[start:start + rows.shape[0]])


def test_int8_matmul_counters_reset_between_calls_and_in_a_graph(cuda):
    """The bf16 kernel's last block of each column tile resets the tile's
    counter: calls in a row, calls replayed from a CUDA graph and a call
    after the replays give the same bits."""
    from padertorch_tpu_torch.ops.kernels.int8_matmul import (
        bf16_split_rows, int8_matmul)
    x, w_q, scale, bias = _int8_inputs(cuda, 8, 4096, 1024, torch.bfloat16)
    assert -(-4096 // bf16_split_rows(4096, 1024)) > 1   # several splits
    want = int8_matmul(x, w_q, scale, bias)
    for _ in range(3):
        assert torch.equal(int8_matmul(x, w_q, scale, bias), want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        int8_matmul(x, w_q, scale, bias)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [int8_matmul(x, w_q, scale, bias) for _ in range(4)]
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(out, want) for out in outs)
    assert torch.equal(int8_matmul(x, w_q, scale, bias), want)


def test_int8_matmul_split_launches_on_two_streams_at_once(cuda):
    """bf16 launches with several K splits on two streams at once, many
    times: each output equals its one-stream result bit for bit, and the
    per-tile counters read zero afterwards (each stream counts into its
    own)."""
    from padertorch_tpu_torch.ops.kernels import int8_matmul as int8_kernels
    from padertorch_tpu_torch.ops.kernels.int8_matmul import (
        bf16_split_rows, int8_matmul)
    assert -(-4096 // bf16_split_rows(4096, 1024)) > 1
    inputs = [_int8_inputs(cuda, 8, 4096, 1024, torch.bfloat16, seed=s)
              for s in (1, 2)]
    want = [int8_matmul(*args) for args in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    assert streams[0].cuda_stream != streams[1].cuda_stream
    outs = [[], []]
    for stream in streams:
        stream.wait_stream(torch.cuda.current_stream())
    for _ in range(200):
        for i, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                outs[i].append(int8_matmul(*inputs[i]))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(out, want[i]) for out in outs[i])
    for key, counters in int8_kernels._counters.items():
        assert not bool(counters.any()), key


def test_int8_matmul_kernel_rejects_what_it_does_not_take(cuda):
    from padertorch_tpu_torch.ops.kernels.int8_matmul import int8_matmul
    x, w_q, scale, bias = _int8_inputs(cuda, 4, 64, 32, torch.float32)
    with pytest.raises(ValueError, match='inference only'):
        int8_matmul(x.clone().requires_grad_(), w_q, scale, bias)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        int8_matmul(x.half(), w_q, scale, bias)
    with pytest.raises(ValueError, match='is on cpu'):
        int8_matmul(x, w_q.cpu(), scale, bias)
    with pytest.raises(ValueError, match='contraction mismatch'):
        int8_matmul(x[:, :60], w_q, scale)
    # a strided x and a weight that is not 16-byte aligned still agree
    wide = torch.zeros((64, 33), dtype=torch.int8, device=cuda)
    wide[:, 1:] = w_q
    got = int8_matmul(x.t().contiguous().t(), wide[:, 1:], scale, bias)
    want = int8_matmul(x, w_q, scale, bias)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_quantized_decoder_on_the_card_matches_the_cpu(cuda):
    """The decode loop with int8 weights on the kernel route, card against
    CPU (plain version): logits within 1e-4, the same greedy tokens; the
    batcher equals each request alone; a bf16 forward forced onto the
    fused attention backend runs the bf16 attention kernel (it raised
    before the kernel's bf16 variant was ported)."""
    from padertorch_tpu_torch.contrib.mk.modules.transformer import (
        TransformerDecoder, autoregressive_generate)
    from padertorch_tpu_torch.ops.kernels.int8_matmul import int8_matmul
    from padertorch_tpu_torch.quantize import quantize_module
    from padertorch_tpu_torch.serve import ContinuousBatcher
    torch.manual_seed(0)
    cpu = TransformerDecoder(d_model=64, num_layers=2, num_heads=4,
                             num_kv_heads=2).eval()
    quantize_module(cpu)
    for mod in cpu.modules():
        if hasattr(mod, 'use_kernel'):
            mod.use_kernel = True
    card = copy.deepcopy(cpu).to(cuda)
    emb = torch.randn(50, 64)
    head = torch.nn.Linear(64, 50)
    memory = torch.randn(3, 7, 64)
    tokens, logits = {}, {}
    for name, dec, dev in (('cpu', cpu, 'cpu'), ('card', card, cuda)):
        e, h = emb.to(dev), copy.deepcopy(head).to(dev)
        seen = []

        def record(x, h=h, seen=seen):
            out = h(x)
            seen.append(out.cpu())
            return out

        before = int8_matmul.launches
        tokens[name], _ = autoregressive_generate(
            dec, memory.to(dev), embed=lambda t, e=e: e[t],
            logits_head=record, bos_id=0, max_len=6)
        logits[name] = torch.stack(seen)
        if name == 'card':
            # cross K/V once per layer, then 8 products per layer and token
            assert int8_matmul.launches - before == 2 * 2 + 6 * 2 * 8
    assert float((logits['card'] - logits['cpu']).abs().max()) <= 1e-4
    assert torch.equal(tokens['card'].cpu(), tokens['cpu'])
    batcher = ContinuousBatcher(
        card, embed=lambda t: emb.to(cuda)[t], logits_head=head.to(cuda),
        num_slots=2, max_len=6, max_memory_len=7, d_memory=64, bos_id=0,
        eos_id=-1)
    ids = [batcher.submit(memory[i]) for i in range(3)]
    outputs = batcher.run_until_done()
    for i, rid in enumerate(ids):
        assert outputs[rid] == tokens['card'][i].tolist()
    mha = MultiheadAttention(64, 4, use_flash=True).to(cuda, torch.bfloat16)
    before = dict(flash_attention.launches)
    with torch.no_grad():
        out = mha(torch.zeros((1, 3, 64), device=cuda, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert flash_attention.launches == {
        **before, 'fwd_bf16': before['fwd_bf16'] + 1}


# the bf16 LSTM kernels (bf16 streams, bf16 products summed in float32)
# against their plain bf16 versions: the float32 states within 3e-4
# forward and 1e-3 backward (the same products summed in another order: a
# value at a rounding boundary rounds the other way, and the recurrence
# carries that on), every stream element within one bf16 unit in the last
# place of the two values plus 1e-3 (backward 2e-3), and at most 5% of them
# other than plain's; chip_smoke.py phase 23 holds the same limits at the
# main shapes.  Odd H (37) takes both kernels' row copies
# without 16-byte copies; H = 130 the forward's scalar h copies alone.
LSTM_BF16_CASES = [
    (1, 1, 8, 5, False),
    (2, 3, 37, 40, True),
    (2, 5, 130, 64, True),
    (1, 64, 256, 33, True),
    (2, 260, 128, 20, False),
]


def _lstm_bf16_inputs(cuda, n_dir, batch, hdim, t_len, masked, seed=0):
    rng = np.random.RandomState(seed + hdim)
    rows = n_dir * batch
    mask = None
    if masked:
        lens = rng.randint(1, t_len + 1, size=batch)
        lens[0] = t_len
        fwd = np.arange(t_len)[:, None] < lens[None, :]
        mask = torch.from_numpy(np.concatenate(
            [fwd, fwd[::-1]][:n_dir], 1).astype('float32')).to(cuda)
    bound = 1 / np.sqrt(hdim)

    def put(*shape, scale=1.0):
        return torch.from_numpy(rng.uniform(-scale, scale, shape).astype(
            'float32')).to(cuda)

    gx = put(t_len, rows, 4 * hdim).to(torch.bfloat16)
    w = put(n_dir, hdim, 4 * hdim, scale=bound)
    h0, c0 = put(rows, hdim, scale=0.1), put(rows, hdim, scale=0.1)
    cot = (put(t_len, rows, hdim).to(torch.bfloat16), put(rows, hdim),
           put(rows, hdim))
    return (gx, w, mask, h0, c0), cot


@pytest.mark.parametrize('n_dir,batch,hdim,t_len,masked', LSTM_BF16_CASES)
def test_lstm_bf16_kernels_match_plain(cuda, n_dir, batch, hdim, t_len,
                                       masked):
    args, cot = _lstm_bf16_inputs(cuda, n_dir, batch, hdim, t_len, masked)
    gx, w, mask, h0, c0 = args
    before = dict(lstm_cell_scan.launches)
    lean = lstm_cell_scan(*args, compute_dtype='bfloat16')
    train = lstm_kernels._launch(gx, w, n_dir, mask, h0, c0, train=True)
    want_train = lstm_cell_scan_train_plain(*args, 'bfloat16')
    _, c_seq, gates, _, _ = want_train
    bwd = lstm_kernels._launch_bwd(gates, c_seq, w, n_dir, mask, *cot)
    want_bwd = lstm_cell_scan_bwd_plain(gates, c_seq, w, mask, *cot,
                                        'bfloat16')
    assert lstm_cell_scan.launches == {
        **before, 'fwd_bf16': before['fwd_bf16'] + 1,
        'fwd_train_bf16': before['fwd_train_bf16'] + 1,
        'bwd_bf16': before['bwd_bf16'] + 1}
    cases = ((lean, lstm_cell_scan_plain(*args, 'bfloat16'), 1, 3e-4, 1e-3),
             (train, want_train, 3, 3e-4, 1e-3),
             (bwd, want_bwd, 1, 1e-3, 2e-3))
    for got, want, streams, tol, stream_tol in cases:
        assert [g.dtype for g in got] == [w_.dtype for w_ in want]
        assert {g.dtype for g in got[:streams]} == {torch.bfloat16}
        assert {g.dtype for g in got[streams:]} == {torch.float32}
        excess, share = bf16_distance(got[:streams], want[:streams],
                                      stream_tol)
        assert excess <= 0 and share <= 0.05, (excess, share)
        for g, w_ in zip(got[streams:], want[streams:]):
            assert float((g - w_).abs().max()) <= tol


def test_lstm_bf16_function_gives_bf16_dgates_and_float32_dw(cuda):
    args, (d_out, dh, dc) = _lstm_bf16_inputs(cuda, 2, 3, 37, 40, True)
    gx, w, mask, h0, c0 = (None if a is None else a.clone().requires_grad_(
        a.is_floating_point() and a is not args[2]) for a in args)
    out, h_t, c_t = lstm_cell_scan(gx, w, mask, h0, c0,
                                   compute_dtype='bfloat16')
    assert out.dtype == torch.bfloat16
    assert h_t.dtype == c_t.dtype == torch.float32
    torch.autograd.backward([out, h_t, c_t], [d_out, dh, dc])
    assert gx.grad.dtype == torch.bfloat16
    assert w.grad.dtype == h0.grad.dtype == c0.grad.dtype == torch.float32
    # dW_hh: bf16 GEMMs with float32 sums on the card against the same
    # operands widened on the CPU
    out_k, c_seq_k, gates_k, _, _ = lstm_kernels._launch(
        gx.detach(), w.detach(), 2, mask, h0.detach(), c0.detach(),
        train=True)
    dgx, _, _ = lstm_kernels._launch_bwd(gates_k, c_seq_k, w.detach(), 2,
                                         mask, d_out, dh, dc)
    assert torch.equal(dgx, gx.grad)
    want = lstm_kernels.recurrent_weight_grad(
        dgx.cpu(), out_k.cpu(), h0.detach().cpu(), mask.cpu(), 2,
        'bfloat16')
    got = w.grad.cpu()
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_lstm_kernels_refuse_mixed_streams_and_products(cuda):
    args, _ = _lstm_bf16_inputs(cuda, 1, 2, 8, 4, False)
    gx, w, mask, h0, c0 = args
    with pytest.raises(TypeError, match='bfloat16'):
        lstm_cell_scan(gx.float(), w, mask, h0, c0, compute_dtype='bfloat16')
    with pytest.raises(TypeError, match='float32'):
        lstm_cell_scan(gx, w, mask, h0, c0)
    with pytest.raises(TypeError, match='float32'):
        lstm_cell_scan(gx, w.bfloat16(), mask, h0, c0,
                       compute_dtype='bfloat16')
    with pytest.raises(TypeError, match='float32'):
        lstm_cell_scan(gx, w, mask, h0.bfloat16(), c0,
                       compute_dtype='bfloat16')


GRU_BF16_LIMIT_NAMES = ['widest resident forward', 'one above it',
                        'widest resident backward', 'one above it too',
                        'widest mma training forward and backward',
                        'one above the widest mma',
                        'lean cluster at H = 160', 'widest lean cluster',
                        'one above the widest lean cluster']


@pytest.mark.parametrize('shape', [s[0] for s in GRU_BF16_SHAPES]
                         + GRU_BF16_LIMIT_NAMES)
def test_gru_bf16_kernels_match_plain(cuda, shape):
    """The three bf16 GRU kernels against their plain bf16 versions at
    ``chip_smoke.py`` phase 28's shapes, the bf16 resident routes' widest
    H and one above, the ``mma`` route's widest H and one above, and the
    lean forward's ``cluster`` route at H = 160, its widest H and one
    above (read from the planners at the card's limits), on the route the
    planners pick, read from ``gru_cell_scan.routes`` (on ``mma`` and
    ``cluster`` the card's plan the mirror's); the control with float32
    products must fail the limits (``chip_smoke.gru_bf16_case`` raises
    otherwise)."""
    limit_shapes, _ = gru_bf16_limit_shapes()
    shapes = {s[0]: s for s in GRU_BF16_SHAPES}
    shapes.update(zip(GRU_BF16_LIMIT_NAMES, limit_shapes))
    rows = gru_bf16_case(*shapes[shape], timed=False)
    assert rows['fwd']['gru_route'] in {'mma', 'cluster', 'cooperative'}
    assert {row['gru_route'] for row in rows.values()} <= {
        'resident', 'cooperative', 'mma', 'cluster'}


def test_gru_bf16_limit_shapes_take_both_routes(cuda):
    limit_shapes, widest = gru_bf16_limit_shapes()
    limits = gru_kernels.device_limits(torch.cuda.current_device())
    fwd_routes = [gru_kernels.resident_plan(n_dir, batch, hdim, *limits,
                                            elem=2) is not None
                  for _, _, batch, hdim, _, n_dir, _ in limit_shapes]
    bwd_routes = [gru_kernels.resident_bwd_plan(n_dir, batch, hdim, *limits,
                                                elem=2) is not None
                  for _, _, batch, hdim, _, n_dir, _ in limit_shapes]
    assert fwd_routes[:2] == [True, False]
    assert bwd_routes[2:4] == [True, False]
    assert widest['fwd'] > 138 and widest['bwd'] > 137
    mma = [gru_kernels.kernel_route('bwd', n_dir, batch, hdim, True, *limits)
           for _, _, batch, hdim, _, n_dir, _ in limit_shapes[4:6]]
    assert mma == ['mma', 'resident'] and widest['mma'] == 128
    lean = [gru_kernels.kernel_route('fwd', n_dir, batch, hdim, True,
                                     *limits)
            for _, _, batch, hdim, _, n_dir, _ in limit_shapes[4:]]
    assert lean == ['mma', 'cluster', 'cluster', 'cluster', None]
    assert widest['cluster'] == 320


def test_gru_bf16_function_gives_bf16_dgates_and_float32_dw(cuda):
    args, (d_out, dh) = _gru_route_inputs(cuda, 2, 7, 40, 30, 'ragged', 0.5)
    gx, w, mask, h0 = args
    gx16 = gx.to(torch.bfloat16).requires_grad_()
    w_, h0_ = w.clone().requires_grad_(), h0.clone().requires_grad_()
    before = dict(gru_cell_scan.launches)
    out, h_t = gru_cell_scan(gx16, w_, mask, h0_, compute_dtype='bfloat16')
    assert out.dtype == torch.bfloat16 and h_t.dtype == torch.float32
    torch.autograd.backward([out, h_t], [d_out.to(torch.bfloat16), dh])
    assert gru_cell_scan.launches == {
        **before, 'fwd_train_bf16': before['fwd_train_bf16'] + 1,
        'bwd_bf16': before['bwd_bf16'] + 1}
    assert gx16.grad.dtype == torch.bfloat16
    assert w_.grad.dtype == h0_.grad.dtype == torch.float32
    # dW_hh: bf16 GEMMs with float32 sums on the card against the same
    # operands widened on the CPU; dgx the backward kernel's
    _, acts, gh_n, h_prev, _ = gru_kernels._launch(
        gx16.detach(), w, 2, mask, h0, train=True)
    dgx, dgh, _ = gru_kernels._launch_bwd(
        acts, gh_n, h_prev, w, 2, mask, d_out.to(torch.bfloat16), dh)
    assert torch.equal(dgx, gx16.grad)
    want = gru_kernels.recurrent_weight_grad(dgh.cpu(), h_prev.cpu(), 2)
    got = w_.grad.cpu()
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    # the missing cotangents: d_out bf16 zeros, dh_T float32 zeros
    gx16.grad = None
    out, _ = gru_cell_scan(gx16, w_, mask, h0_, compute_dtype='bfloat16')
    out.float().sum().backward()
    assert gx16.grad.dtype == torch.bfloat16


def test_gru_kernels_refuse_mixed_streams_and_products(cuda):
    args, _ = _gru_route_inputs(cuda, 2, 3, 8, 4, 'none', 0.5)
    gx, w, mask, h0 = args
    before = dict(gru_cell_scan.launches)
    with pytest.raises(TypeError, match='bfloat16'):
        gru_cell_scan(gx, w, mask, h0, compute_dtype='bfloat16')
    with pytest.raises(TypeError, match='float32'):
        gru_cell_scan(gx.to(torch.bfloat16), w, mask, h0)
    with pytest.raises(TypeError, match='float32'):
        gru_cell_scan(gx.to(torch.bfloat16), w.to(torch.bfloat16), mask, h0,
                      compute_dtype='bfloat16')
    with pytest.raises(TypeError, match='float32'):
        gru_cell_scan(gx.to(torch.bfloat16), w, mask, h0.to(torch.bfloat16),
                      compute_dtype='bfloat16')
    assert gru_cell_scan.launches == before


def test_bgru_dprnn_with_bf16_grus_on_the_card_matches_the_cpu(cuda):
    """A DPRNN of ``bgru`` chunk RNNs after ``set_rnn_backend(...,
    compute_dtype='bfloat16')``: the card (the bf16 kernels, both
    forwards and the backward; no float32 GRU launch) against the CPU
    (the plain bf16 versions), outputs and input gradients; the scan
    backend and remat raise on the card."""
    from padertorch_tpu_torch.modules.recurrent import set_rnn_backend
    torch.manual_seed(0)
    model_cpu = set_rnn_backend(
        DPRNN(16, 32, window_length=10, hop_size=5, num_blocks=2,
              inter_chunk_type='bgru', intra_chunk_type='bgru'),
        'pallas', compute_dtype='bfloat16')
    model = copy.deepcopy(model_cpu).to(cuda)
    with pytest.raises(NotImplementedError,
                       match='padertorch_tpu/modules/recurrent.py'):
        set_rnn_backend(model, 'scan')
    with pytest.raises(NotImplementedError, match='remat'):
        set_rnn_backend(model, 'pallas', remat=True)
    x = torch.randn(3, 60, 16)
    lens = [60, 41, 23]
    x_cpu = x.clone().requires_grad_()
    x_card = x.to(cuda).requires_grad_()
    want = model_cpu(x_cpu, sequence_lengths=lens)
    before = dict(gru_cell_scan.launches)
    got = model(x_card, sequence_lengths=lens)
    (want ** 2).sum().backward()
    (got ** 2).sum().backward()
    launched = {k: gru_cell_scan.launches[k] - before[k] for k in before}
    assert launched == {**dict.fromkeys(launched, 0), 'fwd_train_bf16': 4,
                        'bwd_bf16': 4}
    np.testing.assert_allclose(got.detach().cpu().numpy(),
                               want.detach().numpy(), atol=5e-2, rtol=0)
    np.testing.assert_allclose(x_card.grad.cpu().numpy(), x_cpu.grad.numpy(),
                               atol=0.35, rtol=0.05)


def test_gru_and_attention_raise_for_bf16_on_the_card(cuda):
    """Since the GRU's bf16 variants were ported, a GRU with compute_dtype
    launches them on the card (and raises for a mix of stream and product
    types); the attention kernels take bf16 since their bf16 variants were
    ported, and raise for a mix of types; nothing is widened to float32
    quietly: the forced kernels and 'auto' (the measured table) launch the
    bf16 forward."""
    from padertorch_tpu_torch.modules.recurrent import GRU
    gru = GRU(6, 8, bidirectional=True, compute_dtype='bfloat16').to(cuda)
    before = dict(gru_cell_scan.launches)
    with torch.no_grad():
        out, h = gru(torch.zeros((2, 5, 6), device=cuda))
    assert out.dtype == torch.float32 and h.dtype == torch.float32
    assert gru_cell_scan.launches == {
        **before, 'fwd_bf16': before['fwd_bf16'] + 1}
    gx = torch.zeros((3, 4, 24), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((2, 8, 24), device=cuda)
    with pytest.raises(TypeError, match='float32'):
        gru_cell_scan(gx, w, None, torch.zeros((4, 8), device=cuda))
    q = torch.zeros((2, 4, 5, 16), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        flash_attention(q, q.float(), q)
    x = torch.randn((2, 5, 64), device=cuda, dtype=torch.bfloat16)
    for use_flash in (True, 'auto'):
        mha = MultiheadAttention(64, 4, use_flash=use_flash).to(
            cuda, torch.bfloat16)
        before = dict(flash_attention.launches)
        with torch.no_grad():
            assert mha(x).dtype == torch.bfloat16
        assert flash_attention.launches == {
            **before, 'fwd_bf16': before['fwd_bf16'] + 1}


def test_pit_model_with_compute_dtype_on_the_card_matches_the_cpu(cuda):
    torch.manual_seed(0)
    model_cpu = PermutationInvariantTrainingModel(
        F=33, recurrent_layers=2, units=24, K=2, compute_dtype='bfloat16')
    model = copy.deepcopy(model_cpu).to(cuda)
    rng = np.random.RandomState(0)
    batch = {'Y_abs': torch.from_numpy(
        np.abs(rng.randn(3, 40, 33)).astype('float32')),
        'num_frames': torch.tensor([40, 31, 12])}
    before = dict(lstm_cell_scan.launches)
    with torch.no_grad():
        got = model({k: v.to(cuda) for k, v in batch.items()}).cpu()
        want = model_cpu(batch)
    assert lstm_cell_scan.launches['fwd_bf16'] == before['fwd_bf16'] + 2
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 5e-2
    # one request alone: one row a direction
    with torch.no_grad():
        one = model({'Y_abs': batch['Y_abs'][:1].to(cuda),
                     'num_frames': batch['num_frames'][:1]}).cpu()
    assert float((one - want[:1]).abs().max()) <= 5e-2


def test_bf16_policy_trains_on_the_card_with_float32_masters(cuda, tmp_path):
    from padertorch_tpu_torch.train.optimizer import Adam
    from padertorch_tpu_torch.train.trainer import Trainer
    torch.manual_seed(0)
    model = PermutationInvariantTrainingModel(
        F=33, recurrent_layers=2, units=24, K=2, compute_dtype='bfloat16')
    trainer = Trainer(model, tmp_path, Adam(gradient_clipping=10.0),
                      loss_weights={'pit_mse_loss': 1.0,
                                    'pit_ips_loss': 1.0},
                      precision='bfloat16').to(cuda)
    rng = np.random.RandomState(1)
    batch = {
        'Y_abs': np.abs(rng.randn(3, 40, 33)).astype('float32'),
        'X_abs': np.abs(rng.randn(3, 40, 2, 33)).astype('float32'),
        'cos_phase_difference': np.cos(rng.randn(3, 40, 2, 33)).astype(
            'float32'),
        'num_frames': np.asarray([40, 31, 12]),
    }
    before = dict(lstm_cell_scan.launches)
    losses = []
    for _ in range(5):
        loss = trainer.train_step(trainer.model, batch)[0]
        loss.backward()
        trainer.optimizer.step()
        trainer.optimizer.zero_grad()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    assert lstm_cell_scan.launches['fwd_train_bf16'] == \
        before['fwd_train_bf16'] + 10
    assert lstm_cell_scan.launches['bwd_bf16'] == before['bwd_bf16'] + 10
    assert {p.dtype for p in trainer.model.parameters()} == {torch.float32}


# the bf16 LSTM backward's `mma` route (bf16 mma.sync, W_hh's slice in
# registers): (T, rows per direction, H, mask) of chip_smoke.py phase 23
# and a few more; every one on the mma route
LSTM_BF16_MMA_SHAPES = [(label, t_len, batch, hdim, kind)
                        for label, t_len, batch, hdim, kind, _
                        in chip_smoke.LSTM_BF16_SHAPES] + [
    ('one row, H = 8', 7, 1, 8, None),
    ('H = 130 ragged', 33, 5, 130, 'ragged'),
    ('400 rows, H = 40', 40, 400, 40, 'chunks'),
    # 1600 pairs a block (more than two a thread) in staged chunks of rows
    ('100 rows, H = 600', 12, 100, 600, 'ragged'),
]


@pytest.mark.parametrize('label', [s[0] for s in LSTM_BF16_MMA_SHAPES])
def test_lstm_bf16_backward_takes_the_mma_route(cuda, label):
    """The bf16 backward on the ``mma`` route (counted by
    ``lstm_cell_scan.routes``) against its plain bf16 version at phase
    23's limits, the float32-product control outside them, two runs the
    same bits, and the card's plan equal to its mirror ``mma_plan``."""
    _, t_len, batch, hdim, kind = next(
        s for s in LSTM_BF16_MMA_SHAPES if s[0] == label)
    args, cot = chip_smoke.recurrence_inputs(t_len, batch, hdim, kind,
                                             gates=4)
    gx, w, mask, h0, c0 = args
    _, c_seq, gates, _, _ = lstm_cell_scan_train_plain(
        gx.bfloat16(), w, mask, h0, c0, 'bfloat16')
    bwd_in = (gates, c_seq, w, mask, cot[0].bfloat16(), cot[1], cot[2])
    routes = chip_smoke.lstm_routes()
    got = lstm_kernels._launch_bwd(gates, c_seq, w, 2, mask, *bwd_in[4:])
    again = lstm_kernels._launch_bwd(gates, c_seq, w, 2, mask, *bwd_in[4:])
    torch.cuda.synchronize()
    assert chip_smoke.routes_since(routes) == {'bwd_bf16': {'mma': 2}}
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = lstm_cell_scan_bwd_plain(*bwd_in, 'bfloat16')
    excess, share = bf16_distance(got[:1], want[:1],
                                  LSTM_BF16_STREAM_TOL['bwd'])
    assert excess <= 0 and share <= LSTM_BF16_SHARE, (excess, share)
    for g, w_ in zip(got[1:], want[1:]):
        assert float((g - w_).abs().max()) <= LSTM_BF16_STATE_TOL['bwd']
    control = lstm_cell_scan_bwd_plain(*bwd_in)
    _, control_share = bf16_distance(control[:1], want[:1],
                                     LSTM_BF16_STREAM_TOL['bwd'])
    if t_len * batch >= 1000:   # enough steps and rows to tell them apart
        assert control_share > LSTM_BF16_SHARE, control_share
    grid = lstm_kernels.bwd_grid(2, batch, hdim, bf16=True)
    plan = lstm_kernels.mma_plan(2, batch, hdim, *gru_kernels.device_limits(
        torch.cuda.current_device()))
    assert grid['mma'] == 1 and grid['streamed'] == 0
    assert (grid['U'], grid['n_rb'], grid['RB'], grid['RS'], grid['KS'],
            grid['blocks']) == (lstm_kernels.MMA_UNITS, plan.n_rb, plan.RB,
                                plan.RS, plan.KCH, plan.blocks)


@pytest.mark.parametrize('label', [s[0] for s in LSTM_BF16_MMA_SHAPES])
def test_lstm_bf16_forwards_take_the_mma_route(cuda, label):
    """The two bf16 forwards (lean and training) on the ``mma`` route
    (counted by ``lstm_cell_scan.routes``) against their plain bf16
    versions at phase 23's limits, the float32-product control outside
    them, two runs the same bits, and the card's plan equal to its mirror
    ``mma_plan(..., 'lstm_fwd')``."""
    _, t_len, batch, hdim, kind = next(
        s for s in LSTM_BF16_MMA_SHAPES if s[0] == label)
    args, _ = chip_smoke.recurrence_inputs(t_len, batch, hdim, kind,
                                           gates=4)
    gx, w, mask, h0, c0 = args
    args16 = (gx.bfloat16(), w, mask, h0, c0)
    routes = chip_smoke.lstm_routes()
    with torch.no_grad():
        lean = [lstm_cell_scan(*args16, compute_dtype='bfloat16')
                for _ in range(2)]
    train = [lstm_kernels._launch(args16[0], w, 2, mask, h0, c0, train=True)
             for _ in range(2)]
    torch.cuda.synchronize()
    assert chip_smoke.routes_since(routes) == {
        'fwd_bf16': {'mma': 2}, 'fwd_train_bf16': {'mma': 2}}
    limits = gru_kernels.device_limits(torch.cuda.current_device())
    plan = lstm_kernels.mma_plan(2, batch, hdim, *limits, 'lstm_fwd')
    assert lstm_kernels.fwd_route(2, batch, hdim, True, *limits) == 'mma'
    for name, got, want, control, n in (
            ('fwd', lean, lstm_cell_scan_plain(*args16, 'bfloat16'),
             lstm_cell_scan_plain(*args16), 1),
            ('fwd_train', train, lstm_cell_scan_train_plain(*args16,
                                                           'bfloat16'),
             lstm_cell_scan_train_plain(*args16), 3)):
        assert all(torch.equal(x, y) for x, y in zip(*got)), name
        excess, share = bf16_distance(got[0][:n], want[:n],
                                      LSTM_BF16_STREAM_TOL[name])
        assert excess <= 0 and share <= LSTM_BF16_SHARE, (name, excess,
                                                          share)
        for g, w_ in zip(got[0][n:], want[n:]):
            assert float((g - w_).abs().max()) <= LSTM_BF16_STATE_TOL[name]
        _, control_share = bf16_distance(control[:n], want[:n],
                                         LSTM_BF16_STREAM_TOL[name])
        if t_len * batch >= 1000:   # enough steps and rows to tell apart
            assert control_share > LSTM_BF16_SHARE, (name, control_share)
        grid = lstm_kernels.device_grid(
            'lstm_fwd', 2, batch, hdim, True, torch.cuda.current_device(),
            name == 'fwd_train')
        assert grid['mma'] == 1 and grid['streamed'] == 0
        assert (grid['U'], grid['n_rb'], grid['RB'], grid['RS'], grid['KS'],
                grid['blocks']) == (lstm_kernels.MMA_UNITS, plan.n_rb,
                                    plan.RB, plan.RS, plan.KCH, plan.blocks)


def test_lstm_bf16_forward_routes_follow_the_mirror(cuda):
    """The card's route of the bf16 forwards (``device_grid``) is the one
    ``lstm.fwd_route`` names from the card's limits: ``mma`` to the widest
    H whose slices of 16 units fit the SMs, ``streamed`` above, where the
    FMA grid that staged ``W_hh`` used to run (two rows a direction at H
    = 1100) too; one direction to the widest K chunk."""
    limits = gru_kernels.device_limits(torch.cuda.current_device())
    widest = limits[0] // 2 * 16
    for n_dir, rows, hdim in [(2, 16, 600), (2, 2, widest),
                              (2, 2, widest + 1), (2, 2, 1100),
                              (2, 16, 1536), (1, 16, 1280), (1, 16, 1290)]:
        for train in (False, True):
            grid = lstm_kernels.device_grid('lstm_fwd', n_dir, rows, hdim,
                                            True, torch.cuda.current_device(),
                                            train)
            route = lstm_kernels.fwd_route(n_dir, rows, hdim, True, *limits)
            got = 'mma' if grid['mma'] else (
                'streamed' if grid['streamed'] else 'cooperative')
            assert got == route, (n_dir, rows, hdim, grid, route)
    assert lstm_kernels.fwd_route(2, 2, widest, True, *limits) == 'mma'
    assert lstm_kernels.fwd_route(2, 2, 1100, True, *limits) == 'streamed'


def test_lstm_bf16_backward_routes_follow_the_mirror(cuda):
    """The card's route of the bf16 backward (``bwd_grid``) is the one
    ``lstm.bwd_route`` names from the card's limits: ``mma`` to the widest
    H whose slices of 16 units fit the SMs, ``streamed`` one above."""
    limits = gru_kernels.device_limits(torch.cuda.current_device())
    widest = limits[0] // 2 * 16
    for rows, hdim in [(16, 600), (2, widest), (2, widest + 1), (16, 1536)]:
        grid = lstm_kernels.bwd_grid(2, rows, hdim, bf16=True)
        route = lstm_kernels.bwd_route(2, rows, hdim, True, *limits)
        got = 'mma' if grid['mma'] else (
            'streamed' if grid['streamed'] else 'cooperative')
        assert got == route, (rows, hdim, grid, route)
    assert lstm_kernels.bwd_route(2, 2, widest, True, *limits) == 'mma'


# The separation and enhancement models ported last: the mask estimator's
# BLSTM (257 inputs, 2 x 256 units) at a request's and a training batch's
# shape (4 rows a direction, T = 128 frames of 16000 samples) and a ragged
# batch, its request's masked_istft (one signal), and a first training step
# of each model on the card against the CPU.

@pytest.mark.parametrize('kind', ['full', 'ragged'])
def test_lstm_kernels_at_the_mask_estimators_shapes(cuda, kind):
    """The three kernels and the Function against plain at ``chip_smoke``
    phases 3, 6 and 9's limits, each TF32 control failing them, on the
    route the mirror plans (``chip_smoke.lstm_kernels_case`` raises
    otherwise)."""
    rows = chip_smoke.lstm_kernels_case(
        'test', f'T=128 D*B=8 H=256 {kind}', 128, 4, 256, kind, in_size=257)
    assert set(rows) == {'fwd', 'fwd_train', 'bwd'}


def test_masked_istft_at_the_mask_estimators_request(cuda):
    row = chip_smoke.istft_case('test', 'one signal T=128 F=257', 1, 128)
    assert row['max_abs_err'] <= chip_smoke.ISTFT_TOL


def _mixtures(batch, samples, seed=0):
    return chip_smoke.tasnet_batch(batch, samples, seed=seed)


def _small_models():
    from padertorch_tpu_torch.models.bss import DeepClusteringModel
    from padertorch_tpu_torch.models.mask_estimator import (
        SimpleMaskEstimator)
    from padertorch_tpu_torch.models.or_pit import OneAndRestPIT
    from padertorch_tpu_torch.modules.convnet import ConvNet
    from padertorch_tpu_torch.contrib.examples.source_separation.pit \
        import data as pit_data
    from padertorch_tpu_torch.contrib.examples.speech_enhancement \
        .mask_estimator import train as me_train
    torch.manual_seed(0)
    me_batch = next(iter(me_train.prepare_dataset(
        me_train.synthetic_database(num_examples=3, num_samples=6000), 3,
        shuffle=False)))
    pit = pit_data.post_batch_transform([
        pit_data.pre_batch_transform(e)
        for e in pit_data.synthetic_database(num_examples=3, seed=3)])
    x_abs = pit['X_abs']
    dc_batch = {'Y_abs': pit['Y_abs'], 'num_frames': pit['num_frames'],
                'target_mask': (x_abs == x_abs.max(axis=2, keepdims=True))
                .astype('float32')}
    return {
        'convnet': (TasNet(
            encoder=TasEncoder(20, 64), decoder=TasDecoder(20, 64),
            separator=ConvNet(64, num_blocks=4, num_repeats=2,
                              hidden_channels=128)),
            _mixtures(3, 8000), {'si-sdr': 1.0, 'log-mse': 0.0,
                                 'log1p-mse': 0.0}),
        'or_pit': (OneAndRestPIT(TasNet(
            encoder=TasEncoder(20, 32), decoder=TasDecoder(20, 32),
            separator=DPRNN(16, 24, window_length=10, hop_size=5,
                            num_blocks=2))),
            _mixtures(3, 4000), None),
        'mask_estimator': (SimpleMaskEstimator(257, num_units=64,
                                               dropout=0.0), me_batch, None),
        'deep_clustering': (DeepClusteringModel(F=257, units=32, E=8),
                            dc_batch, None),
    }


@pytest.mark.parametrize('name', ['convnet', 'or_pit', 'mask_estimator',
                                  'deep_clustering'])
def test_first_training_step_on_the_card_matches_the_cpu(cuda, name,
                                                         tmp_path):
    """Loss and pre-clip gradient norm of one Adam step (clip 5) on the
    card against the CPU, 1e-4 relative (cuDNN's convolutions and the
    kernels sum in another order, TF32 off)."""
    model, batch, loss_weights = _small_models()[name]
    card = chip_smoke.first_step(copy.deepcopy(model), batch, tmp_path, 5.0,
                                 'cuda', loss_weights)
    cpu = chip_smoke.first_step(model, batch, tmp_path, 5.0, 'cpu',
                                loss_weights)
    np.testing.assert_allclose(card, cpu, rtol=1e-4)
    assert np.isfinite(card).all()


@pytest.mark.parametrize('head', ['ctc', 'transducer', 'aed'])
def test_asr_first_training_step_on_the_card_matches_the_cpu(cuda, head,
                                                             tmp_path):
    """A small head of the speech-recognition recipe (d_model 48, 4 heads
    of 12, which the attention wrapper pads to 16): loss and pre-clip
    gradient norm of one Adam step (clip 10) on the card against the CPU,
    1e-4 relative, the SpecAugment masks drawn from one seed on both; the
    step launches the attention kernels (and the transducer's prediction
    network the LSTM kernels)."""
    from padertorch_tpu_torch.contrib.examples.speech_recognition.ctc \
        import data, train
    cls = train.HEADS[head]
    torch.manual_seed(0)
    model = cls.from_config(cls.get_config({
        'vocab_size': 10, 'd_model': 48, 'num_layers': 1, 'num_heads': 4,
        'kernel_size': 7}))
    batch = next(iter(data.prepare_dataset(
        data.synthetic_database(num_examples=4), batch_size=4,
        shuffle=False, prefetch=False)))
    chip_smoke.reset_launches()
    torch.manual_seed(1)
    card = chip_smoke.first_step(copy.deepcopy(model), batch, tmp_path,
                                 10.0, 'cuda')
    launches = chip_smoke.asr_launches()
    torch.manual_seed(1)
    cpu = chip_smoke.first_step(model, batch, tmp_path, 10.0, 'cpu')
    np.testing.assert_allclose(card, cpu, rtol=1e-4)
    assert np.isfinite(card).all()
    # one conformer layer, and the decoder's 2 layers of self- and
    # cross-attention
    per_step = {'ctc': 1, 'transducer': 1, 'aed': 5}[head]
    assert launches['attention']['fwd_train'] == per_step
    assert launches['attention']['bwd'] == per_step
    want_lstm = 1 if head == 'transducer' else 0
    assert launches['lstm']['fwd_train'] == launches['lstm']['bwd'] \
        == want_lstm
