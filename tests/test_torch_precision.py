"""The bf16 training policy (``padertorch_tpu_torch/train/precision.py``
and ``Trainer(precision=...)``) against the JAX package's.

- ``Precision``'s casts, as ``tests/test_train/test_precision.py`` holds
  the JAX class, its ``repr`` and the ways a trainer or a config names it;
- one train step under ``precision='bfloat16'`` for the uPIT model (with
  and without ``compute_dtype``), the DPRNN-TasNet, the SepFormer-TasNet
  (dense attention, and the fused backend as the recipe's ``--flash``
  forces it: the Pallas kernel in interpret mode against the port's plain
  bf16 kernels) and the WaveNet vocoder, at the sizes of the JAX
  package's ``test_bf16_policy_model_zoo``: the same weights and example
  in both packages, the losses within 1e-2 relative (both are bf16 values,
  whose unit in the last place is 2^-8 relative, computed in bf16 in
  another order); afterwards every master parameter and every Adam moment
  float32;
- the whole trainer loop with a validation hook, checkpoints and a resume
  under the policy;
- running statistics (``InputNormalization``) kept float32 and updated;
- summaries of bf16 review tensors.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.module import partition
from padertorch_tpu.train.trainer import Trainer as JaxTrainer
from padertorch_tpu_torch.base import Model
from padertorch_tpu_torch.migrate import from_jax_state_dict
from padertorch_tpu_torch.train.hooks import _fetch
from padertorch_tpu_torch.train.optimizer import Adam
from padertorch_tpu_torch.train.precision import Precision
from padertorch_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

LOSS_RTOL = 1e-2


def test_cast_floating_and_restore():
    p = Precision('bfloat16')
    tree = {
        'w': torch.ones(3),
        'i': torch.arange(3),
        'b': torch.tensor([True, False, True]),
        'c': torch.ones(2, dtype=torch.complex64),
        's': 1.5,
        'n': np.ones(2, 'float32'),
    }
    cast = p.cast_floating(tree)
    assert cast['w'].dtype == torch.bfloat16
    assert cast['i'].dtype == tree['i'].dtype
    assert cast['b'].dtype == torch.bool
    assert cast['c'].dtype == torch.complex64
    assert cast['s'].dtype == torch.bfloat16    # a python float is floating
    assert cast['n'].dtype == torch.bfloat16    # numpy has no bf16
    restored = p.restore_dtypes(cast, tree)
    assert restored['w'].dtype == torch.float32
    assert restored['c'].dtype == torch.complex64
    assert restored['i'] is cast['i']


def test_repr_and_the_ways_to_ask_for_it(tmp_path):
    from padertorch_tpu_torch.models.bss import (
        PermutationInvariantTrainingModel)
    p = Precision('bfloat16', cast_examples=False)
    assert repr(p) == ("Precision(compute_dtype='bfloat16', "
                       'cast_examples=False, cast_buffers=True)')
    assert Precision(torch.bfloat16).compute_dtype == torch.bfloat16
    model = {'factory': PermutationInvariantTrainingModel, 'F': 9,
             'recurrent_layers': 1, 'units': 4}
    for precision in ('bfloat16',
                      {'factory': 'padertorch_tpu.train.precision.Precision',
                       'cast_buffers': False}):
        config = Trainer.get_config({
            'model': model, 'storage_dir': str(tmp_path),
            'precision': precision})
        trainer = Trainer.from_config(config)
        assert isinstance(trainer.precision, Precision)
        assert trainer.precision.compute_dtype == torch.bfloat16
    assert trainer.precision.cast_buffers is False


def _jax_step_loss(trainer, batch):
    """The loss of one jitted train step of the JAX trainer."""
    trainer.iteration = 0
    params, static = partition(trainer.model)
    step = trainer._get_fn('train', trainer._make_train_step)
    out = step(params, static, trainer._opt_states,
               {k: jnp.asarray(v) for k, v in batch.items()},
               jax.random.PRNGKey(0), trainer._loss_weight_arrays())
    return float(np.asarray(jax.tree_util.tree_leaves(out[3])[0]))


def _port_step_loss(trainer, batch):
    loss, _, _, _ = trainer.train_step(trainer.model, batch)
    assert loss.dtype == torch.float32
    loss.backward()
    trainer.optimizer.step()
    trainer.optimizer.zero_grad()
    return float(loss.detach())


def _assert_masters_float32(trainer):
    for name, p in trainer.model.named_parameters():
        assert p.dtype == torch.float32, name
    moments = [v for state in trainer.optimizer.optimizer.state.values()
               for v in state.values()
               if isinstance(v, torch.Tensor) and v.is_floating_point()]
    assert moments, 'the optimizer took no step'
    assert {v.dtype for v in moments} == {torch.float32}


def _wave_batch(rng):
    return {
        'y': rng.randn(2, 2000).astype('float32'),
        's': rng.randn(2, 2, 2000).astype('float32'),
        'num_samples': np.asarray([2000, 1600], 'int32'),
    }


def _tasnet_pair(tmp_path, variant, separator):
    from padertorch_tpu.contrib.examples.source_separation.tasnet import (
        train as jax_train)
    from padertorch_tpu_torch.contrib.examples.source_separation.tasnet \
        import train as port_train
    updates = {'precision': 'bfloat16',
               'model': {'separator': separator,
                         'encoder': {'feature_size': 16}}}
    ptrandom.seed(0)
    jax_trainer = JaxTrainer.from_config(jax_train.get_trainer_config(
        tmp_path / 'jax', variant=variant, updates=updates))
    port = Trainer.from_config(port_train.get_trainer_config(
        tmp_path / 'port', variant=variant, updates=updates))
    from_jax_state_dict(port.model, jax_trainer.model.state_dict())
    return jax_trainer, port, _wave_batch(np.random.RandomState(0))


def _sepformer_flash_pair(tmp_path):
    """The SepFormer pair with both attention backends forced to the fused
    kernels (the recipe's ``--flash``)."""
    from padertorch_tpu.contrib.mk.modules.transformer import (
        set_attention_backend as jax_set_attention_backend)
    from padertorch_tpu_torch.contrib.mk.modules.transformer import (
        set_attention_backend)
    jax_trainer, port, batch = ZOO['sepformer'](tmp_path)
    jax_set_attention_backend(jax_trainer.model, True)
    set_attention_backend(port.model, True)
    return jax_trainer, port, batch


def _pit_pair(tmp_path, compute_dtype):
    from padertorch_tpu.models.bss import (
        PermutationInvariantTrainingModel as JaxPIT)
    from padertorch_tpu.train.optimizer import Adam as JaxAdam
    from padertorch_tpu_torch.models.bss import (
        PermutationInvariantTrainingModel)
    size = dict(F=17, recurrent_layers=1, units=8, K=2,
                compute_dtype=compute_dtype)
    weights = {'pit_mse_loss': 1.0, 'pit_ips_loss': 0.0}
    ptrandom.seed(0)
    jax_model = JaxPIT(**size)
    port = from_jax_state_dict(PermutationInvariantTrainingModel(**size),
                               jax_model.state_dict())
    rng = np.random.RandomState(0)
    batch = {
        'Y_abs': np.abs(rng.randn(2, 12, 17)).astype('float32'),
        'X_abs': np.abs(rng.randn(2, 12, 2, 17)).astype('float32'),
        'cos_phase_difference': np.cos(rng.randn(2, 12, 2, 17)).astype(
            'float32'),
        'num_frames': np.asarray([12, 9]),
    }
    return (JaxTrainer(jax_model, tmp_path / 'jax', JaxAdam(),
                       precision='bfloat16', loss_weights=weights),
            Trainer(port, tmp_path / 'port', Adam(), precision='bfloat16',
                    loss_weights=weights), batch)


def _wavenet_pair(tmp_path):
    from padertorch_tpu.contrib.examples.audio_synthesis.wavenet.model \
        import WaveNetVocoder as JaxVocoder
    from padertorch_tpu.train.optimizer import Adam as JaxAdam
    from padertorch_tpu_torch.contrib.examples.audio_synthesis.wavenet \
        .model import WaveNetVocoder
    updates = {'wavenet': {
        'n_layers': 2, 'max_dilation': 2, 'n_residual_channels': 8,
        'n_skip_channels': 16, 'n_cond_channels': 8, 'upsamp_window': 20,
        'upsamp_stride': 10}}
    ptrandom.seed(0)
    jax_model = JaxVocoder.from_config(JaxVocoder.get_config(updates))
    port = from_jax_state_dict(
        WaveNetVocoder.from_config(WaveNetVocoder.get_config(updates)),
        jax_model.state_dict())
    rng = np.random.RandomState(0)
    batch = {'features': rng.randn(2, 8, 6).astype('float32'),
             'audio_data': rng.randn(2, 80).clip(-0.99, 0.99).astype(
                 'float32')}
    return (JaxTrainer(jax_model, tmp_path / 'jax', JaxAdam(),
                       precision='bfloat16'),
            Trainer(port, tmp_path / 'port', Adam(), precision='bfloat16'),
            batch)


ZOO = {
    'pit': lambda tmp: _pit_pair(tmp, None),
    'pit-compute_dtype': lambda tmp: _pit_pair(tmp, 'bfloat16'),
    'dprnn': lambda tmp: _tasnet_pair(tmp, 'dprnn', {
        'input_size': 16, 'rnn_size': 8, 'window_length': 10,
        'hop_size': 5, 'num_blocks': 1}),
    'sepformer': lambda tmp: _tasnet_pair(tmp, 'sepformer', {
        'input_size': 16, 'window_length': 10, 'hop_size': 5,
        'num_blocks': 1, 'num_layers_intra': 1, 'num_layers_inter': 1,
        'num_heads': 2}),
    'sepformer-flash': _sepformer_flash_pair,
    'wavenet': _wavenet_pair,
}


@pytest.mark.parametrize('name', list(ZOO))
def test_one_policy_step_matches_the_jax_step(name, tmp_path):
    jax_trainer, port, batch = ZOO[name](tmp_path)
    bf16_outputs = []

    def record(module, inputs, output):
        if isinstance(output, torch.Tensor):
            bf16_outputs.append((type(module).__name__, output.dtype))

    handles = [m.register_forward_hook(record)
               for m in port.model.modules() if not list(m.children())]
    got = _port_step_loss(port, batch)
    for handle in handles:
        handle.remove()
    want = _jax_step_loss(jax_trainer, batch)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # the policy reached the layers: every leaf module that returns a
    # tensor returns bf16 (an f32 constant would promote the stream)
    assert bf16_outputs, name
    assert {dtype for _, dtype in bf16_outputs} == {torch.bfloat16}, \
        bf16_outputs
    _assert_masters_float32(port)


def test_the_policy_hands_the_fused_attention_bf16_operands(tmp_path,
                                                           monkeypatch):
    """Under ``precision='bfloat16'`` with the fused backend, every attention
    call of the SepFormer step gets bf16 q, k and v (the kernels' bf16
    variants on the card), forward and backward run through it, and the
    gradients reach the float32 masters."""
    from padertorch_tpu_torch.contrib.mk.modules import transformer as tf
    _, port, batch = ZOO['sepformer-flash'](tmp_path)
    seen = []
    real = tf.flash_attention

    def spy(q, k, v, **kwargs):
        seen.append((q.dtype, k.dtype, v.dtype, q.requires_grad))
        return real(q, k, v, **kwargs)

    monkeypatch.setattr(tf, 'flash_attention', spy)
    _port_step_loss(port, batch)
    # one intra and one inter layer in one block
    assert seen == [(torch.bfloat16,) * 3 + (True,)] * 2, seen
    _assert_masters_float32(port)


class _SeqModel(Model):
    """An LSTM and a head, as the JAX package's full-trainer test."""

    def __init__(self, bidirectional=True, layers=2):
        super().__init__()
        from padertorch_tpu_torch.modules.recurrent import LSTM
        self.rnn = LSTM(8, 16, num_layers=layers,
                        bidirectional=bidirectional)
        self.head = torch.nn.Linear(32 if bidirectional else 16, 4)

    def forward(self, example):
        out, _ = self.rnn(example['x'], seq_lens=example.get('lens'))
        return self.head(out)

    def review(self, example, output):
        return {'loss': torch.mean((output - example['y']) ** 2)}


def _seq_examples(n, lens=True):
    rng = np.random.RandomState(0)
    examples = []
    for _ in range(n):
        example = {'x': rng.randn(3, 20, 8).astype('float32'),
                   'y': rng.randn(3, 20, 4).astype('float32')}
        if lens:
            example['lens'] = np.asarray([20, 15, 9])
        examples.append(example)
    return examples


def test_full_trainer_loop_with_validation_checkpoints_and_resume(tmp_path):
    examples = _seq_examples(4)
    torch.manual_seed(0)
    first = Trainer(_SeqModel(), tmp_path, Adam(lr=1e-3),
                    precision='bfloat16', stop_trigger=(1, 'epoch'))
    first.register_validation_hook(examples[:2])
    first.train(examples)
    ckpts = sorted(p.name for p in (tmp_path / 'checkpoints').iterdir())
    assert 'ckpt_latest.ptt' in ckpts and 'ckpt_4.ptt' in ckpts, ckpts
    _assert_masters_float32(first)
    trained = {k: v.clone() for k, v in first.model.state_dict().items()}

    torch.manual_seed(0)
    again = Trainer(_SeqModel(), tmp_path, Adam(lr=1e-3),
                    precision='bfloat16', stop_trigger=(2, 'epoch'))
    again.register_validation_hook(examples[:2])
    again.load_checkpoint()
    assert again.iteration == first.iteration
    for key, value in again.model.state_dict().items():
        assert value.dtype == trained[key].dtype, key
        assert torch.equal(value, trained[key]), key
    again.train(examples, resume=True)
    assert again.iteration == 2 * first.iteration
    _assert_masters_float32(again)


class _NormalizedModel(Model):
    """Running statistics (``InputNormalization``) before a linear layer."""

    def __init__(self):
        super().__init__()
        from padertorch_tpu_torch.modules.normalization import (
            InputNormalization)
        self.norm = InputNormalization(
            data_format='bc', shape=(None, 12), statistics_axis='b',
            sequence_axis=None)
        self.net = torch.nn.Linear(12, 3)

    def forward(self, example):
        return self.net(self.norm(example['x']))

    def review(self, example, output):
        return {'loss': torch.mean((output - example['y']) ** 2)}


def test_running_statistics_stay_float32_and_move(tmp_path):
    rng = np.random.RandomState(1)
    examples = [{'x': (rng.randn(5, 12) + 3).astype('float32'),
                 'y': rng.randn(5, 3).astype('float32')} for _ in range(3)]

    def train(precision, storage_dir):
        torch.manual_seed(0)
        trainer = Trainer(_NormalizedModel(), storage_dir, Adam(lr=1e-2),
                          precision=precision, stop_trigger=(1, 'epoch'))
        trainer.train(examples)
        return trainer, dict(trainer.model.named_buffers())

    trainer, buffers = train('bfloat16', tmp_path / 'bf16')
    assert {b.dtype for b in buffers.values()
            if b.is_floating_point()} == {torch.float32}
    _assert_masters_float32(trainer)
    # updated in each forward, not lost with the bf16 copy the forward ran
    # on: where float32 training puts them, within bf16 rounding
    _, want = train(None, tmp_path / 'f32')
    assert float(want['norm.running_mean'].min()) > 0.3
    for name in ('norm.running_mean', 'norm.running_power'):
        np.testing.assert_allclose(buffers[name].numpy(),
                                   want[name].numpy(), rtol=2e-2)


def test_summaries_of_bf16_review_tensors():
    from padertorch_tpu_torch.summary.tbx_utils import (
        audio, mask_to_image, spectrogram_to_image, stft_to_image)
    scalar = torch.tensor(0.5, dtype=torch.bfloat16)
    assert _fetch(scalar).dtype == np.float32
    spec = torch.from_numpy(
        np.abs(np.random.RandomState(0).randn(12, 5))).to(torch.bfloat16)
    # grayscale images (the port does not import matplotlib's colormaps)
    assert spectrogram_to_image(spec, batch_first=None).shape == (1, 5, 12)
    assert stft_to_image(spec, batch_first=None).shape == (1, 5, 12)
    mask = torch.from_numpy(
        np.random.RandomState(1).rand(12, 5)).to(torch.bfloat16)
    assert mask_to_image(mask, batch_first=None).shape == (1, 5, 12)
    sig, rate = audio(torch.tensor([0.0, 0.5, -0.25], dtype=torch.bfloat16))
    assert rate == 16000
    np.testing.assert_allclose(float(np.abs(sig).max()), 0.95)
