"""The port's LoRA adapters (``padertorch_tpu_torch/lora.py``) on the CPU;
mirrors ``tests/test_lora.py``.

Identity at init, only the factors trainable, a gradient step that moves
only the factors, an exact merge that exports, the Trainer training only
the adapters through a checkpoint round trip; forward and gradients equal
to the JAX ``LoRALinear``'s at 1e-4 for the same weights, and
``migrate.py`` carrying ``LoRALinear`` and ``StatefulLSTM`` both ways.
(``test_wav2vec2_lora_finetune_surface`` waits for the wav2vec2 port.)
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import padertorch_tpu as jax_pt
from padertorch_tpu import nn as jax_nn
from padertorch_tpu import random as ptrandom
from padertorch_tpu import lora as jax_lora
from padertorch_tpu.module import combine, partition
from padertorch_tpu_torch import nn
from padertorch_tpu_torch.base import Model
from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    MultiheadAttention, TransformerEncoder)
from padertorch_tpu_torch.lora import (
    LoRALinear, apply_lora, mark_only_lora_trainable, merge_lora)
from padertorch_tpu_torch.migrate import (
    from_jax_state_dict, to_jax_state_dict)

torch.set_num_threads(2)


def _x(shape, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).normal(size=shape).astype('float32'))


def test_identity_at_init_and_targets():
    torch.manual_seed(0)
    mha = MultiheadAttention(16, 4).eval()
    x = _x((2, 6, 16), 1)
    with torch.no_grad():
        before = mha(x)
    assert apply_lora(mha, rank=4, targets=('q_proj', 'v_proj')) == 2
    assert isinstance(mha.q_proj, LoRALinear)
    assert type(mha.k_proj) in (nn.Linear, torch.nn.Linear)
    with torch.no_grad():
        assert torch.equal(mha(x), before)


def test_only_adapters_are_trainable():
    torch.manual_seed(1)
    enc = TransformerEncoder(d_model=16, num_layers=2, num_heads=4).eval()
    apply_lora(enc, rank=2)
    assert mark_only_lora_trainable(enc) > 0
    trainable = [p for p in enc.parameters() if p.requires_grad]
    # 2 layers x (4 attention projections + 2 of the FFN) x (A, B)
    assert len(trainable) == 2 * 6 * 2
    assert all(2 in p.shape for p in trainable)


def test_gradient_step_moves_only_adapters():
    torch.manual_seed(2)
    m = torch.nn.Sequential(nn.Linear(8, 8), torch.nn.ReLU(),
                            nn.Linear(8, 2)).eval()
    apply_lora(m, rank=2)
    mark_only_lora_trainable(m)
    x, y = _x((4, 8), 3), _x((4, 2), 4)
    base = m[0].weight.detach().clone()
    before = m(x).detach()
    torch.mean((m(x) - y) ** 2).backward()
    grads = [p.grad for p in m.parameters() if p.grad is not None]
    assert len(grads) == 4                  # (A, B) x 2 layers
    assert any(float(g.abs().max()) > 0 for g in grads)
    with torch.no_grad():
        for p in m.parameters():
            if p.grad is not None:
                p -= 0.5 * p.grad
        assert float((m(x) - before).abs().max()) > 1e-6
    assert torch.equal(m[0].weight, base)


def test_merge_is_exact_and_serves():
    from padertorch_tpu_torch.serve import export_fn, load_exported
    torch.manual_seed(3)
    m = torch.nn.Sequential(nn.Linear(16, 8)).eval()
    apply_lora(m, rank=4)
    with torch.no_grad():
        m[0].lora_b.copy_(_x((4, 8), 5) * 0.1)   # a delta that is not 0
        x = _x((3, 16), 6)
        want = m(x)
        assert merge_lora(m) == 1 and type(m[0]) is nn.Linear
        np.testing.assert_allclose(m(x).numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
    # the merged model exports like any dense one
    served = load_exported(export_fn(lambda b: m(b), x.numpy()),
                           device='cpu')
    np.testing.assert_allclose(served(x.numpy()).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-6)


class _Net(Model):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(8, 8)
        self.head = nn.Linear(8, 2)

    def forward(self, batch):
        return self.head(torch.relu(self.lin(batch['x'])))

    def review(self, batch, outputs):
        return {'loss': torch.mean((outputs - batch['y']) ** 2)}


def test_trainer_trains_only_adapters(tmp_path):
    """The Trainer's optimizer takes only the factors; the frozen base
    survives training and the checkpoint (written in the JAX layout by
    ``migrate.to_jax_state_dict``) restores both."""
    from padertorch_tpu_torch.train import SGD, Trainer

    def make_trainer(seed):
        torch.manual_seed(seed)
        m = _Net().eval()
        apply_lora(m, rank=2)
        mark_only_lora_trainable(m)
        return Trainer(m, str(tmp_path), SGD(lr=0.1),
                       stop_trigger=(1, 'epoch'),
                       checkpoint_trigger=(1, 'epoch'),
                       summary_trigger=(1, 'epoch'))

    rng = np.random.RandomState(0)
    data = [{'x': rng.randn(4, 8).astype('f'),
             'y': rng.randn(4, 2).astype('f')} for _ in range(8)]
    trainer = make_trainer(5)
    base = trainer.model.lin.weight.detach().clone()
    b_before = trainer.model.lin.lora_b.detach().clone()
    trainer.train(data)
    trained = trainer.model
    assert torch.equal(trained.lin.weight, base)
    assert float((trained.lin.lora_b - b_before).abs().max()) > 0
    restored = make_trainer(6)             # another init: the load wins
    restored.load_checkpoint()
    assert torch.equal(restored.model.lin.weight, base)
    assert torch.equal(restored.model.lin.lora_b, trained.lin.lora_b)


@pytest.fixture(scope='module')
def jax_pair():
    """A JAX module with one adapted Linear (a delta that is not 0) and
    the port's counterpart carrying its arrays."""
    class JaxHead(jax_pt.Module):
        def __init__(self):
            self.lin = jax_nn.Linear(12, 6)

        def forward(self, x):
            return self.lin(x)

    ptrandom.seed(11)
    jax_head = JaxHead()
    jax_lora.apply_lora(jax_head, rank=3, alpha=6)
    jax_head.lin.lora_b = jnp.asarray(
        np.random.default_rng(12).normal(size=(3, 6)).astype('f') * 0.3)
    head = torch.nn.Module()
    head.lin = nn.Linear(12, 6)
    apply_lora(head, rank=3, alpha=6)
    from_jax_state_dict(head, jax_head.state_dict())
    return jax_head, head


def test_forward_and_gradients_equal_jax(jax_pair):
    jax_head, head = jax_pair
    x = np.random.default_rng(13).normal(size=(5, 12)).astype('float32')
    y = np.random.default_rng(14).normal(size=(5, 6)).astype('float32')
    trainable, static = partition(jax_head)

    def jax_loss(tr):
        return jnp.mean((combine(tr, static)(jnp.asarray(x)) - y) ** 2)

    want_loss, want_grads = jax.value_and_grad(jax_loss)(trainable)
    head.zero_grad()
    out = head.lin(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jax_head(jnp.asarray(x))),
                               atol=1e-4)
    loss = torch.mean((out - torch.from_numpy(y)) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-4)
    want = jax_pt.module.state_dict(want_grads)
    assert sorted(want) == ['lin.lora_a', 'lin.lora_b']
    assert head.lin.weight.grad is None
    for name in ('lora_a', 'lora_b'):
        np.testing.assert_allclose(getattr(head.lin, name).grad.numpy(),
                                   want[f'lin.{name}'], atol=1e-4)


def test_migrate_round_trip_lora(jax_pair):
    jax_head, head = jax_pair
    sd = to_jax_state_dict(head)
    want = jax_head.state_dict()
    assert sorted(sd) == sorted(want) == [
        'lin.bias', 'lin.lora_a', 'lin.lora_b', 'lin.weight']
    for name, value in want.items():
        np.testing.assert_array_equal(sd[name], value)


def test_migrate_round_trip_stateful_lstm():
    """``StatefulLSTM``'s weights and, mid-stream, its carried state move
    both ways; the two packages then continue the stream alike."""
    from padertorch_tpu.modules.recurrent import (
        StatefulLSTM as JaxStatefulLSTM, set_rnn_backend)
    from padertorch_tpu_torch.modules.recurrent import StatefulLSTM
    ptrandom.seed(15)
    jax_lstm = set_rnn_backend(JaxStatefulLSTM(5, 4, num_layers=2), 'scan')
    x = np.random.default_rng(16).normal(size=(2, 6, 5)).astype('float32')
    lstm = StatefulLSTM(5, 4, num_layers=2).eval()
    from_jax_state_dict(lstm, jax_lstm.state_dict())
    assert lstm.states is None
    jax_lstm(jnp.asarray(x[:, :3]))             # mid-stream
    from_jax_state_dict(lstm, jax_lstm.state_dict())
    assert [tuple(s.shape) for s in lstm.states] == [(2, 2, 4)] * 2
    sd = to_jax_state_dict(lstm)
    assert sorted(sd) == sorted(jax_lstm.state_dict())
    for name, value in jax_lstm.state_dict().items():
        np.testing.assert_allclose(sd[name], value, atol=1e-7)
    with torch.no_grad():
        got = lstm(torch.from_numpy(x[:, 3:]))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_lstm(jnp.asarray(x[:, 3:]))),
                               atol=1e-5)
