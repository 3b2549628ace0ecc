"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at shapes off the main path (ragged hidden widths, one
direction, other STFT geometries).  The LSTM training kernels (forward
with residuals, backward) are held against their step-by-step plain
versions (1e-5: the same f32 arithmetic, sums in another order) and,
through the ``autograd.Function``, against autograd through the plain
forward (1e-4 relative to each gradient's largest entry); the GRU
kernels likewise.  Marked
``cuda``: they skip without a card.  Run them on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -q
"""
import numpy as np
import pytest
import torch

from padertorch_tpu_torch.ops._stft import HostSTFT, STFT
from padertorch_tpu_torch.models.bss import PermutationInvariantTrainingModel
from padertorch_tpu_torch.models.tasnet import TasDecoder, TasEncoder, TasNet
from padertorch_tpu_torch.modules.dual_path_rnn import DPRNN
from padertorch_tpu_torch.ops.kernels import gru as gru_kernels
from padertorch_tpu_torch.ops.kernels import lstm as lstm_kernels
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
