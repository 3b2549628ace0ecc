"""The port's ``Adadelta``, ``Adafactor``, ``Lion`` and ``Muon`` against the
JAX package's (over optax): the same parameters and sequence of gradients,
made with numpy, give the same trajectory over five steps within 1e-6.

2-D weights are given to the port in its own layout, the transpose of the
JAX one ((out, in) against (in, out)), as ``migrate.py`` moves a
``Linear``'s or a recurrent layer's weight, and the two are compared
through that transpose.  This is where ``Muon``'s shape factor
``sqrt(max(1, n_out / n_in))`` shows: the weights are not square, and a
control that hands the port the JAX layout (so that it takes the
reciprocal factor) must leave the trajectory.  The cases cover weight
decay, momentum, Nesterov and not, a learning rate changed between steps,
``Adafactor(lr=None)``, factored and unfactored second moments, and a
state round trip through a ``.ptt`` file.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu import random as ptrandom
from padertorch_tpu.models.bss import (
    PermutationInvariantTrainingModel as JaxPIT)
from padertorch_tpu.module import partition, state_dict
from padertorch_tpu.train import optimizer as jax_optim
from padertorch_tpu_torch.migrate import _jax_to_port, from_jax_state_dict
from padertorch_tpu_torch.models.bss import PermutationInvariantTrainingModel
from padertorch_tpu_torch.serialize import dump_state, load_state
from padertorch_tpu_torch.train import optimizer as optim

torch.set_num_threads(2)

TOL = 1e-6
# JAX layout: (in, out) for the 2-D weights; three of them not square
SHAPES = {'wide': (5, 12), 'tall': (9, 4), 'square': (6, 6), 'bias': (7,),
          'conv': (3, 2, 4)}
STEPS = 5

CASES = [
    ('Adadelta', dict()),
    ('Adadelta', dict(lr=0.5, rho=0.8, weight_decay=0.1)),
    ('Lion', dict(lr=1e-2)),
    ('Lion', dict(lr=1e-2, betas=(0.8, 0.95), weight_decay=0.5)),
    ('Adafactor', dict(lr=1e-2, min_dim_size_to_factor=4)),
    ('Adafactor', dict(lr=1e-2)),   # nothing factored at 128
    ('Adafactor', dict(lr=None, min_dim_size_to_factor=4)),
    ('Adafactor', dict(lr=1e-2, min_dim_size_to_factor=4, momentum=0.9,
                       weight_decay=0.1, decay_offset=2,
                       clipping_threshold=None,
                       multiply_by_parameter_scale=False)),
    ('Muon', dict()),
    ('Muon', dict(lr=5e-2, beta=0.9, weight_decay=0.1,
                  adam_weight_decay=0.05, adam_betas=(0.8, 0.99))),
    ('Muon', dict(nesterov=False, ns_steps=3, gradient_clipping=0.5)),
]
IDS = [f'{name}-{i}' for i, (name, _) in enumerate(CASES)]


def _data(seed=0):
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype('float32') for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * 0.5).astype('float32')
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def _port_layout(a, transpose=True):
    return a.T.copy() if a.ndim == 2 and transpose else a.copy()


def _port_optimizer(name, kwargs, params, transpose=True):
    tensors = {k: torch.nn.Parameter(torch.from_numpy(
        _port_layout(v, transpose))) for k, v in params.items()}
    return getattr(optim, name)(**kwargs).set_parameters(
        tensors.items()), tensors


def _port_step(opt, tensors, grads, transpose=True):
    for k, p in tensors.items():
        p.grad = torch.from_numpy(_port_layout(grads[k], transpose))
    return opt.step()


def _jax_layout(tensor, transpose=True):
    a = tensor.detach().numpy().copy()
    return a.T if a.ndim == 2 and transpose else a


def _trajectories(name, kwargs, transpose=True, new_lr=None):
    """Parameters after each step in both packages (the learning rate set
    to ``new_lr`` after step 2 where given)."""
    params, grads = _data()
    jax_opt = getattr(jax_optim, name)(**kwargs)
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    jax_opt.set_parameters(jax_params)
    opt, tensors = _port_optimizer(name, kwargs, params, transpose)
    out = []
    for step, step_grads in enumerate(grads):
        if step == 2 and new_lr is not None:
            jax_opt.lr = new_lr
            opt.lr = new_lr
        jax_params, want_norm = jax_opt.apply(
            jax_params, {k: jnp.asarray(v) for k, v in step_grads.items()})
        got_norm = _port_step(opt, tensors, step_grads, transpose)
        out.append((float(got_norm), float(want_norm),
                    {k: _jax_layout(t, transpose)
                     for k, t in tensors.items()},
                    {k: np.asarray(v) for k, v in jax_params.items()}))
    return out


@pytest.mark.parametrize('name,kwargs', CASES, ids=IDS)
def test_trajectory_matches_jax(name, kwargs):
    new_lr = None if kwargs.get('lr', 1) is None else 3e-3
    for got_norm, want_norm, got, want in _trajectories(
            name, kwargs, new_lr=new_lr):
        np.testing.assert_allclose(got_norm, want_norm, rtol=1e-6)
        for k in SHAPES:
            np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL,
                                       err_msg=k)


def test_muon_in_the_jax_layout_leaves_the_trajectory():
    """The control: the port reading the JAX layout as its own takes the
    reciprocal shape factor (and sees the transposed matrix) on the
    non-square weights; the square one and the AdamW branch still agree."""
    *_, (_, _, got, want) = _trajectories('Muon', {}, transpose=False)
    for k in ('wide', 'tall'):
        assert np.abs(got[k] - want[k]).max() > 100 * TOL, k
    for k in ('bias', 'conv'):
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL)


def test_muon_takes_the_same_parameters_as_the_jax_muon():
    """Under ``migrate.py``'s mapping the port's Muon branch (2-D and
    trained) is the JAX one's (2-D leaves), for a BLSTM model: the LSTM's
    weights and the output layer's; the frozen ``bias_hh`` stays out."""
    ptrandom.seed(0)
    jax_model = JaxPIT(F=9, recurrent_layers=1, units=16, K=2)
    params, _ = partition(jax_model)
    jax_names = {k for k, v in state_dict(params).items()
                 if np.ndim(v) == 2}
    port = from_jax_state_dict(
        PermutationInvariantTrainingModel(F=9, recurrent_layers=1, units=16,
                                          K=2), jax_model.state_dict())
    opt = optim.Muon().set_parameters(port.named_parameters(), module=port)
    by_id = {id(target[0]): jax_name
             for jax_name, targets in _jax_to_port(port).items()
             for target in targets}
    port_names = {by_id[id(p)] for p in opt.parameters if p.dim() == 2}
    assert port_names == jax_names
    # w_ih and w_hh of two directions, two linear layers
    assert len(jax_names) == 6
    assert not any(p.dim() == 2 and not p.requires_grad
                   for p in port.parameters())
    assert opt.optimizer.reduction_axis == {}


def test_muon_keeps_an_embedding_table_in_its_layout():
    """An ``Embedding``'s (num, dim) table is the same in both packages:
    given the module, Muon sums over its axis 0 as optax does."""
    rng = np.random.RandomState(3)
    table = rng.randn(10, 4).astype('float32')
    grads = [rng.randn(10, 4).astype('float32') for _ in range(3)]
    module = torch.nn.Embedding(10, 4)
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(table))
    opt = optim.Muon().set_parameters(module.named_parameters(),
                                      module=module)
    jax_opt = jax_optim.Muon()
    jax_params = {'weight': jnp.asarray(table)}
    jax_opt.set_parameters(jax_params)
    for g in grads:
        module.weight.grad = torch.from_numpy(g.copy())
        opt.step()
        jax_params, _ = jax_opt.apply(jax_params, {'weight': jnp.asarray(g)})
    np.testing.assert_allclose(module.weight.detach().numpy(),
                               np.asarray(jax_params['weight']),
                               atol=TOL, rtol=TOL)


def test_adafactor_keeps_factored_moments():
    params, grads = _data()
    opt, tensors = _port_optimizer(
        'Adafactor', dict(min_dim_size_to_factor=3), params)
    _port_step(opt, tensors, grads[0])
    state = opt.state_dict()['state']
    # the port's (12, 5) 'wide' weight: rows reduced over its largest axis,
    # columns over the second largest; (3, 2, 4) over 4 and over 3
    assert {k: tuple(v.shape) for k, v in state['wide'].items()
            if k != 'step'} == {'v_row': (5,), 'v_col': (12,)}
    assert {k: tuple(v.shape) for k, v in state['conv'].items()
            if k != 'step'} == {'v_row': (3, 2), 'v_col': (2, 4)}
    assert set(state['bias']) == {'step', 'v'}


def test_lr_none_reads_none_and_refuses_a_learning_rate():
    params, _ = _data()
    opt, _ = _port_optimizer('Adafactor', dict(lr=None), params)
    assert opt.lr is None
    with pytest.raises(ValueError, match='lr=None'):
        opt.lr = 1e-3


@pytest.mark.parametrize('name,kwargs', [
    ('Adadelta', dict(weight_decay=0.1)),
    ('Lion', dict(lr=1e-2)),
    ('Adafactor', dict(min_dim_size_to_factor=4, momentum=0.9)),
    ('Muon', dict()),
])
def test_state_dict_round_trip_continues_exactly(tmp_path, name, kwargs):
    """Two steps, a checkpoint through the ``.ptt`` format, three more
    steps in a fresh optimizer: bit for bit five steps in one; the state
    is keyed by parameter name."""
    params, grads = _data(3)
    opt, tensors = _port_optimizer(name, kwargs, params)
    for step_grads in grads[:2]:
        _port_step(opt, tensors, step_grads)
    state = opt.state_dict()
    assert set(state['state']) == set(SHAPES)
    dump_state({'optimizer': state}, tmp_path / 'opt.ptt')
    middle = {k: _jax_layout(v) for k, v in tensors.items()}
    resumed, resumed_tensors = _port_optimizer(name, kwargs, middle)
    resumed.load_state_dict(load_state(tmp_path / 'opt.ptt')['optimizer'])
    for step_grads in grads[2:]:
        _port_step(opt, tensors, step_grads)
        _port_step(resumed, resumed_tensors, step_grads)
    for k in params:
        assert torch.equal(tensors[k], resumed_tensors[k]), k
