"""Reference model family for the distance estimator.

Counterpart of ``padertorch_tpu/contrib/examples/source_localization/
distance_estimator/model.py`` (reference
``contrib/examples/source_localization/distance_estimator/model.py``):
``SamePadding:12``, ``Pool:42``, ``_Conv:63`` (incl. the GLU gated-conv
branch), ``CNN1D/CNN2D:169,173``, ``HybridCNNnn:177``, ``GRU:206``,
``CRNN:218`` and the class-quantized CE ``DistanceEstimator:243``
(argmax class -> distance, mae/rmse, accuracy + allow-neighbors
pseudo-accuracy computed in ``modify_summary``).

The recipe's ``train.py`` default remains the compact regression CRNN;
this module provides the reference's configurable classification family
on the port's blocks: torch's convolutions and pooling (cuDNN on the
card), the port's ``Normalization`` as batch norm, its ``GRU`` (the
``gru_cell_scan`` kernels on the card) and ``fully_connected_stack``.
Submodules carry the JAX module's attribute names, so
``migrate.from_jax_state_dict`` moves the weights.  Where the JAX module
keeps ``None`` in a list (a layer without pooling, the last block without
dropout), the port keeps an ``Identity``.
"""
import numpy as np
import torch
import torch.nn.functional as F

from padertorch_tpu_torch import nn
from padertorch_tpu_torch.base import Model
from padertorch_tpu_torch.modules.fully_connected import (  # noqa: F401
    fully_connected_stack)
from padertorch_tpu_torch.modules.normalization import Normalization
from padertorch_tpu_torch.modules.recurrent import GRU as _FrameworkGRU
from padertorch_tpu_torch.ops.losses.classification import (
    softmax_cross_entropy)
from padertorch_tpu_torch.ops.mappings import ACTIVATION_FN_MAP

__all__ = [
    'SamePadding', 'Pool', 'Conv1D', 'Conv2D', 'CNN1D', 'CNN2D',
    'HybridCNN', 'GRU', 'CRNN', 'DistanceEstimator',
]


class SamePadding(torch.nn.Module):
    """Zero-pad the trailing spatial dim(s) so a VALID conv keeps the
    size (ref ``model.py:12``; torch's asymmetric rule for even
    kernels: pad right/bottom one more).

    >>> SamePadding([4, 3])(torch.ones(1, 1, 5, 5)).shape
    torch.Size([1, 1, 8, 7])
    """

    def __init__(self, kernel_size):
        super().__init__()
        assert isinstance(kernel_size, (tuple, list)), kernel_size
        assert len(kernel_size) in (1, 2), kernel_size
        self.pads = [self.split_padding(k) for k in kernel_size]

    @staticmethod
    def split_padding(kernel_size):
        if kernel_size % 2 == 0:
            return (int(np.floor((kernel_size - 1) / 2)),
                    int(np.ceil((kernel_size - 1) / 2)))
        return kernel_size // 2, kernel_size // 2

    def forward(self, x):
        return F.pad(x, [v for pair in reversed(self.pads) for v in pair])


class Pool(torch.nn.Module):
    """Max/avg pooling, stride = kernel, VALID (ref ``model.py:42``)."""

    def __init__(self, pool_type, kernel_size):
        super().__init__()
        assert pool_type in ('max', 'avg'), pool_type
        assert isinstance(kernel_size, (tuple, list)), kernel_size
        assert len(kernel_size) in (1, 2), kernel_size
        self.pool_type = pool_type
        self.kernel_size = tuple(kernel_size)

    def forward(self, x):
        n = len(self.kernel_size)
        if self.pool_type == 'max':
            pool = F.max_pool1d if n == 1 else F.max_pool2d
        else:
            pool = F.avg_pool1d if n == 1 else F.avg_pool2d
        return pool(x, self.kernel_size, self.kernel_size)


def _batch_norm(channels, spatial_ndim):
    """Channel batch norm over batch+spatial axes (torch
    BatchNorm1d/2d analog on the port's ``Normalization``)."""
    if spatial_ndim == 1:
        return Normalization(
            data_format='bct', shape=(None, channels, None),
            statistics_axis='bt')
    return Normalization(
        data_format='bcft', shape=(None, channels, None, None),
        statistics_axis='bft')


class _Conv(torch.nn.Module):
    """(Same-pad) conv + batch norm + activation with pre/post BN
    placement and a gated (GLU) branch (ref ``model.py:63``)."""

    conv_cls = None
    spatial_ndim = None

    def __init__(self, in_chs, out_chs, kernel_size, activation_fn='relu',
                 batch_norm=True, pre_activation=True, padding='same'):
        super().__init__()
        assert padding in ('same', False), padding
        assert isinstance(kernel_size, (tuple, list)), kernel_size
        assert len(kernel_size) == self.spatial_ndim, kernel_size
        self.pad = SamePadding(kernel_size) if padding else None
        self.conv = self.conv_cls(in_chs, out_chs, tuple(kernel_size))
        self.pre_activation = pre_activation
        self.gated = activation_fn == 'glu'
        if self.gated:
            self.conv_gate = self.conv_cls(
                in_chs, out_chs, tuple(kernel_size))
            self.bn_gate = (_batch_norm(out_chs, self.spatial_ndim)
                            if batch_norm else None)
        else:
            self.activation_fn = ACTIVATION_FN_MAP[activation_fn]()
        self.bn = (_batch_norm(out_chs, self.spatial_ndim)
                   if batch_norm else None)

    def forward(self, x):
        if self.pad is not None:
            x = self.pad(x)
        y = self.conv(x)
        if self.gated:
            g = self.conv_gate(x)
            if self.bn_gate is not None:
                g = self.bn_gate(g)
            if self.bn is not None:
                y = self.bn(y)
            return y * torch.sigmoid(g)
        if self.pre_activation and self.bn is not None:
            y = self.bn(y)
        y = self.activation_fn(y)
        if not self.pre_activation and self.bn is not None:
            y = self.bn(y)
        return y


class Conv1D(_Conv):
    conv_cls = nn.Conv1d
    spatial_ndim = 1


class Conv2D(_Conv):
    conv_cls = nn.Conv2d
    spatial_ndim = 2


class CNN(torch.nn.Module):
    """Conv/pool/dropout stack (ref ``model.py:128``)."""

    conv_block_cls = None

    def __init__(self, n_chs_input, n_chs, kernel_sizes, pool_layers,
                 activation_fn='relu', batch_norm=True,
                 pre_activation=True, padding='same', dropout_prob=0.):
        super().__init__()
        assert len(n_chs) == len(kernel_sizes) == len(pool_layers), (
            n_chs, kernel_sizes, pool_layers)
        in_chs = [n_chs[i - 1] if i > 0 else n_chs_input
                  for i in range(len(n_chs))]
        self.conv_layers = torch.nn.ModuleList([
            self.conv_block_cls(
                in_ch, out_ch, kernel_size, activation_fn, batch_norm,
                pre_activation, padding)
            for in_ch, out_ch, kernel_size
            in zip(in_chs, n_chs, kernel_sizes)
        ])
        self.pool_layers = torch.nn.ModuleList([
            Pool(**pool_layer) if pool_layer is not None else nn.Identity()
            for pool_layer in pool_layers
        ])
        # reference: dropout after every block but the last
        self.dropout_layers = torch.nn.ModuleList(
            [nn.Dropout(dropout_prob) for _ in range(len(n_chs) - 1)]
            + [nn.Identity()] if dropout_prob > 0
            else [nn.Identity() for _ in n_chs])
        self.n_chs = tuple(n_chs)

    def forward(self, x):
        for conv, pool, dropout in zip(
                self.conv_layers, self.pool_layers, self.dropout_layers):
            x = dropout(pool(conv(x)))
        return x


class CNN1D(CNN):
    conv_block_cls = Conv1D


class CNN2D(CNN):
    conv_block_cls = Conv2D


class HybridCNN(torch.nn.Module):
    """CNN2D over (B, C, F, T) then CNN1D over the flattened
    channel-frequency axis (ref ``model.py:177``); the config wiring
    derives the 1-d input channels from the 2-d output channels and the
    frequency bins surviving the 2-d pooling."""

    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['cnn_2d'] = {
            'factory': CNN2D,
            'n_chs_input': 1,
            'n_chs': [8, 16],
            'kernel_sizes': [[3, 3], [3, 3]],
            'pool_layers': [
                {'pool_type': 'max', 'kernel_size': [4, 1]}, None],
        }
        config['cnn_1d'] = {
            'factory': CNN1D,
            'n_chs': [32],
            'kernel_sizes': [[3]],
            'pool_layers': [None],
        }
        n_freq_bins_reduced = config['n_freq_bins']
        for pool_layer in config['cnn_2d']['pool_layers']:
            if pool_layer is not None:
                n_freq_bins_reduced = np.floor(
                    n_freq_bins_reduced / pool_layer['kernel_size'][0])
        config['cnn_1d']['n_chs_input'] = int(
            config['cnn_2d']['n_chs'][-1] * n_freq_bins_reduced)

    def __init__(self, cnn_2d: CNN2D, cnn_1d: CNN1D, n_freq_bins=257):
        super().__init__()
        self.cnn_2d = cnn_2d
        self.cnn_1d = cnn_1d
        self.n_freq_bins = n_freq_bins

    def forward(self, x):
        x = self.cnn_2d(x)                      # (B, C, F, T)
        b, c, f, t = x.shape
        x = x.reshape(b, c * f, t)              # 'b c f t -> b (c f) t'
        return self.cnn_1d(x)


class GRU(torch.nn.Module):
    """(B, C, T) -> last-frame hidden state (ref ``model.py:206``)."""

    def __init__(self, input_size, hidden_size, n_layers=1,
                 dropout_prob=0.):
        super().__init__()
        self.gru = _FrameworkGRU(
            input_size, hidden_size, num_layers=n_layers,
            dropout=dropout_prob)

    def forward(self, x):
        out, _ = self.gru(x.transpose(1, 2))   # (B, T, C)
        return out[:, -1, :]


class CRNN(torch.nn.Module):
    """HybridCNN -> GRU -> fully connected stack (ref ``model.py:218``)."""

    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['cnn'] = {'factory': HybridCNN}
        config['gru'] = {'factory': GRU, 'hidden_size': 64}
        config['fcn'] = {
            'factory': fully_connected_stack,
            'hidden_size': None,
            'output_size': 101,
        }
        # the nested HybridCNN finalize runs after this one: peek at what
        # it will produce where the user did not override the sub-config
        try:
            cnn_out = config['cnn']['cnn_1d']['n_chs'][-1]
        except (KeyError, TypeError):
            probe = {'n_freq_bins': 1}
            HybridCNN.finalize_dogmatic_config(probe)
            cnn_out = probe['cnn_1d']['n_chs'][-1]
        config['gru']['input_size'] = cnn_out
        config['fcn']['input_size'] = config['gru']['hidden_size']

    def __init__(self, cnn: HybridCNN, gru: GRU, fcn):
        super().__init__()
        self.cnn = cnn
        self.gru = gru
        self.fcn = fcn

    def forward(self, x):
        return self.fcn(self.gru(self.cnn(x)))


class DistanceEstimator(Model):
    """Class-quantized distance estimation (ref ``model.py:243``):
    the net emits ``num_cls`` logits over ``d_min + i * quant_step``
    bins, trained with cross entropy; mae/rmse follow from the argmax
    distance, and ``modify_summary`` turns the buffered class decisions
    into accuracy and the +-1-class ``acc_allow_neighbors``
    pseudo-accuracy the reference README reports.
    """

    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['net'] = {'factory': CRNN}

    def __init__(self, net, num_cls=101, quant_step=.1, d_min=0):
        super().__init__()
        self.net = net
        self.num_classes = num_cls
        self.quant_step = quant_step
        self.d_min = d_min

    def forward(self, inputs):
        return self.net(inputs['features'])

    def review(self, inputs, outputs):
        target = inputs['label']
        loss = softmax_cross_entropy(outputs, target)
        est_cls = torch.argmax(outputs, dim=-1)
        est_dist = est_cls.to(torch.float32) * self.quant_step + self.d_min
        ae = torch.abs(est_dist - inputs['distance'])
        se = (est_dist - inputs['distance']) ** 2
        return {
            'loss': loss,
            'scalars': {
                'mae': ae,
                'rmse': se,
                'target': target,
                'est_cls': est_cls,
            },
        }

    def modify_summary(self, summary):
        scalars = summary['scalars']
        if 'target' in scalars and 'est_cls' in scalars:
            target = np.asarray(scalars.pop('target'))
            est_cls = np.asarray(scalars.pop('est_cls'))
            near = (
                (est_cls == target)
                | (est_cls == target - 1)
                | (est_cls == target + 1)
            )
            scalars['acc_allow_neighbors'] = near.astype('float32')
            scalars['acc'] = (est_cls == target).astype('float32')
        if 'rmse' in scalars:
            scalars['rmse'] = np.sqrt(np.mean(scalars.pop('rmse')))
        return super().modify_summary(summary)
