"""The port's optimizers (over ``torch.optim``) against the JAX package's
(over optax): the same parameters and the same sequence of gradients, made
with numpy, give the same trajectory.  1e-5 after 5 steps of size 1e-2
(f32; Adam divides by sqrt(v), which lifts rounding differences a little).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from padertorch_tpu.train import optimizer as jax_optim
from padertorch_tpu_torch.serialize import dump_state, load_state
from padertorch_tpu_torch.train import optimizer as optim

torch.set_num_threads(2)

ATOL = 1e-5
SHAPES = {'a': (4, 3), 'b': (3,), 'c': (2, 2, 2)}
STEPS = 5

CASES = [
    ('Adam', dict(lr=1e-2)),
    ('Adam', dict(lr=1e-2, gradient_clipping=0.5)),
    ('Adam', dict(lr=1e-2, weight_decay=0.1)),
    ('Adam', dict(lr=1e-2, amsgrad=True)),
    ('Adam', dict(lr=1e-2, amsgrad=True, weight_decay=0.1,
                  betas=(0.8, 0.9))),
    ('AdamW', dict(lr=1e-2)),
    ('AdamW', dict(lr=1e-2, weight_decay=0.2, amsgrad=True)),
    ('SGD', dict(lr=1e-2)),
    ('SGD', dict(lr=1e-2, momentum=0.9, weight_decay=0.1)),
    ('SGD', dict(lr=1e-2, momentum=0.9, nesterov=True,
                 gradient_clipping=0.5)),
]


def _data(seed=0):
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype('float32') for k, s in SHAPES.items()}
    # amsgrad needs gradients that shrink, or the max never binds
    grads = [{k: (rng.randn(*s) * (2.0 if t < 2 else 0.3)).astype('float32')
              for k, s in SHAPES.items()} for t in range(STEPS)]
    return params, grads


def _port_optimizer(name, kwargs, params):
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = getattr(optim, name)(**kwargs)
    opt.set_parameters(tensors.items())
    return opt, tensors


def _port_step(opt, tensors, grads):
    for k, p in tensors.items():
        p.grad = torch.from_numpy(grads[k].copy())
    return opt.step()


@pytest.mark.parametrize('name,kwargs', CASES)
def test_trajectory_matches_jax(name, kwargs):
    params, grads = _data()
    jax_opt = getattr(jax_optim, name)(**kwargs)
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    jax_opt.set_parameters(jax_params)
    opt, tensors = _port_optimizer(name, kwargs, params)
    for step_grads in grads:
        jax_params, want_norm = jax_opt.apply(
            jax_params, {k: jnp.asarray(v) for k, v in step_grads.items()})
        got_norm = _port_step(opt, tensors, step_grads)
        np.testing.assert_allclose(got_norm.numpy(), np.asarray(want_norm),
                                   rtol=1e-6)
        for k in params:
            np.testing.assert_allclose(
                tensors[k].detach().numpy(), np.asarray(jax_params[k]),
                atol=ATOL, rtol=0, err_msg=k)


def test_clip_returns_the_norm_from_before_the_clip():
    params, grads = _data(1)
    opt, tensors = _port_optimizer('SGD', dict(gradient_clipping=0.25),
                                   params)
    for k, p in tensors.items():
        p.grad = torch.from_numpy(grads[0][k].copy())
    want = np.sqrt(sum((g ** 2).sum() for g in grads[0].values()))
    norm = opt.clip_grad()
    np.testing.assert_allclose(norm.numpy(), want, rtol=1e-6)
    after = np.sqrt(sum(float((p.grad ** 2).sum())
                        for p in tensors.values()))
    np.testing.assert_allclose(after, 0.25, rtol=1e-5)
    # a clip that does not bind leaves the gradients as they are
    opt.gradient_clipping = 1e10
    before = {k: p.grad.clone() for k, p in tensors.items()}
    opt.clip_grad()
    assert all(torch.equal(p.grad, before[k]) for k, p in tensors.items())


def test_lr_setter_takes_effect():
    params, grads = _data(2)
    opt, tensors = _port_optimizer('SGD', dict(lr=0.1), params)
    assert opt.lr == 0.1
    opt.lr = 0.5
    assert opt.lr == 0.5
    _port_step(opt, tensors, grads[0])
    np.testing.assert_allclose(tensors['b'].detach().numpy(),
                               params['b'] - 0.5 * grads[0]['b'], atol=1e-6)


def test_parameters_without_grad_are_left_out():
    frozen = torch.nn.Parameter(torch.ones(3), requires_grad=False)
    free = torch.nn.Parameter(torch.ones(3))
    opt = optim.Adam().set_parameters([('frozen', frozen), ('free', free)])
    assert opt.names == ['free']
    assert opt.parameters == [free]


def test_unset_optimizer_says_so():
    with pytest.raises(AssertionError, match='set_parameters'):
        optim.Adam().step()


@pytest.mark.parametrize('name,kwargs', [
    ('Adam', dict(lr=1e-2, amsgrad=True)),
    ('SGD', dict(lr=1e-2, momentum=0.9)),
])
def test_state_dict_round_trip_continues_exactly(tmp_path, name, kwargs):
    """Two steps, a checkpoint through the ``.ptt`` file format, three more
    steps in a fresh optimizer: the same parameters, bit for bit, as five
    steps in one; the state is keyed by parameter name."""
    params, grads = _data(3)
    opt, tensors = _port_optimizer(name, kwargs, params)
    for step_grads in grads[:2]:
        _port_step(opt, tensors, step_grads)
    opt.lr = 5e-3
    state = opt.state_dict()
    assert set(state['state']) == set(SHAPES)
    dump_state({'optimizer': state}, tmp_path / 'opt.ptt')
    middle = {k: v.detach().numpy().copy() for k, v in tensors.items()}

    resumed, resumed_tensors = _port_optimizer(name, kwargs, middle)
    resumed.load_state_dict(load_state(tmp_path / 'opt.ptt')['optimizer'])
    assert resumed.lr == 5e-3
    for step_grads in grads[2:]:
        _port_step(opt, tensors, step_grads)
        _port_step(resumed, resumed_tensors, step_grads)
    for k in params:
        assert torch.equal(tensors[k], resumed_tensors[k]), k
