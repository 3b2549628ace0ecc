"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at shapes off the main path (ragged hidden widths, one
direction, other STFT geometries).  The LSTM training kernels (forward
with residuals, backward) are held against their step-by-step plain
versions (1e-5: the same f32 arithmetic, sums in another order) and,
through the ``autograd.Function``, against autograd through the plain
forward (1e-4 relative to each gradient's largest entry); the GRU
kernels likewise.  The attention kernels are held against the masked
softmax formula (``flash_attention_plain`` and autograd through it) in every
mask mode, for every head size of the template set and one outside it.
The WaveNet sampler is held against its plain step loop (greedy and
teacher-forced Gumbel indices equal, logits 2e-5) and the fused log-mel
front end against its plain version (1e-4 on log-mel values), both at odd
batch sizes, lengths and widths; a ``WaveNetVocoder`` and a ``SpeakerClf``
on the card are held against the CPU and moved to the JAX layout and back.
Marked
``cuda``: they skip without a card.  Run them on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -q
"""
import copy

import numpy as np
import pytest
import torch

from padertorch_tpu_torch.ops._stft import HostSTFT, STFT
from padertorch_tpu_torch.models.bss import PermutationInvariantTrainingModel
from padertorch_tpu_torch.models.tasnet import TasDecoder, TasEncoder, TasNet
from padertorch_tpu_torch.modules.dual_path_rnn import DPRNN
from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    MultiheadAttention, set_attention_backend)
from padertorch_tpu_torch.modules.dual_path_transformer import (
    DualPathTransformer)
from padertorch_tpu_torch.ops.kernels import gru as gru_kernels
from padertorch_tpu_torch.ops.kernels import lstm as lstm_kernels
from padertorch_tpu_torch.ops.kernels.attention import (
    flash_attention, flash_attention_fwd_plain, flash_attention_plain)
from padertorch_tpu_torch.ops.kernels import attention as attention_kernels
from padertorch_tpu_torch.ops.kernels.gru import (
    gru_cell_scan, gru_cell_scan_plain, gru_cell_scan_train_plain,
    gru_cell_scan_bwd_plain)
from padertorch_tpu_torch.ops.kernels.lstm import (
    lstm_cell_scan, lstm_cell_scan_plain, lstm_cell_scan_train_plain,
    lstm_cell_scan_bwd_plain)
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
        'fwd': before['fwd'], 'fwd_train': before['fwd_train'] + 1,
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


def test_lstm_kernels_raise_when_the_grid_does_not_fit(cuda):
    """Two directions of 1024 units: no unit slice leaves the whole grid
    co-resident on the card, and the wrappers say so instead of launching
    (the cooperative grid sync would hang otherwise)."""
    args, cotangents = _train_inputs(cuda, 2, 2, 1024, 3, 'none')
    gx, w, mask, h0, c0 = args
    with pytest.raises(RuntimeError, match='lstm_cell_scan kernel failed'):
        lstm_cell_scan(*args)
    with pytest.raises(RuntimeError, match='training forward kernel failed'):
        lstm_cell_scan(gx.clone().requires_grad_(), w, mask, h0, c0)
    out, c_seq, gates, _, _ = lstm_cell_scan_train_plain(*args)
    with pytest.raises(RuntimeError, match='backward kernel failed'):
        lstm_kernels._launch_bwd(gates, c_seq, w, 2, mask, *cotangents)
    torch.cuda.synchronize()


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
    got = masked_istft(spec, mask, stft=stft)
    want = masked_istft_plain(spec, mask, stft=stft)
    torch.cuda.synchronize()
    assert masked_istft.launches == before + 1
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
        'fwd': before['fwd'] + 1, 'fwd_train': before['fwd_train'] + 1,
        'bwd': before['bwd'] + 1}


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


def test_gru_kernels_raise_when_the_grid_does_not_fit(cuda):
    """Two directions of 2048 units: no unit slice leaves the whole grid
    co-resident on the card, and the wrappers say so instead of launching
    (the cooperative grid sync would hang otherwise)."""
    args, cotangents = _gru_inputs(cuda, 2, 2, 2048, 3, 'none')
    gx, w, mask, h0 = args
    with pytest.raises(RuntimeError, match='gru_cell_scan kernel failed'):
        gru_cell_scan(*args)
    with pytest.raises(RuntimeError, match='training forward kernel failed'):
        gru_cell_scan(gx.clone().requires_grad_(), w, mask, h0)
    _, acts, gh_n, h_prev, _ = gru_cell_scan_train_plain(*args)
    with pytest.raises(RuntimeError, match='backward kernel failed'):
        gru_kernels._launch_bwd(acts, gh_n, h_prev, w, 2, mask, *cotangents)
    torch.cuda.synchronize()


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
    'd8_one_query': (2, 2, 2, 1, 40, 8, {'key_padding_lens': [40, 3]}),
    'd64_long': (1, 2, 2, 1100, 1100, 64,
                 {'causal': True, 'key_padding_lens': [900]}),
}


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
    with pytest.raises(TypeError, match='float32'):
        flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError):
        flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :3], q[:, :3])          # 4 % 3 heads
    with pytest.raises(ValueError, match='128'):
        big = torch.zeros((1, 1, 3, 160), device=cuda)
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
        'fwd': before['fwd'], 'fwd_train': before['fwd_train'] + layers,
        'bwd': before['bwd'] + layers}
    with torch.no_grad():
        model.eval()
        assert torch.equal(model(example)['out'], model(example)['out'])
    assert flash_attention.launches['fwd'] == before['fwd'] + 2 * layers


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


def test_wavenet_sample_kernel_rejects_what_it_does_not_take(cuda):
    from padertorch_tpu_torch.ops.kernels.wavenet import wavenet_sample
    rng = np.random.RandomState(0)
    w = _wavenet_weights(2, 6, 16, 256, 256, rng, cuda)   # R % 4 != 0
    cond = torch.zeros(4, 1, 2, 12, device=cuda)
    with pytest.raises(ValueError, match='multiples of 4'):
        wavenet_sample(cond, w, (1, 2))
    w = _wavenet_weights(2, 64, 16, 256, 256, rng, cuda)
    cond = torch.zeros(4, 1, 2, 128, device=cuda)
    with pytest.raises(ValueError, match='shared memory'):
        wavenet_sample(cond, w, (512, 512))               # 256 KB of rings
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
    fused attention backend raises."""
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
    with pytest.raises(TypeError, match='float32'):
        mha(torch.zeros((1, 3, 64), device=cuda, dtype=torch.bfloat16))
