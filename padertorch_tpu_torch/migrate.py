"""Carry the weights of a JAX model over to its port, and back.

The JAX package's ``state_dict()`` names arrays by their pytree path and
keeps its own layouts; the port keeps torch's.  Per layer type (JAX ->
port):

- ``LSTM``, ``GRU`` (G = 4 or 3 gate blocks): ``w_ih.{i}`` (in, G*H) ->
  ``weight_ih_l{k}[_reverse]`` (G*H, in) and ``w_hh.{i}`` (H, G*H) ->
  ``weight_hh_l{k}[_reverse]`` (G*H, H), transposed, with
  i = num_directions * k + direction; the fused bias ``b.{i}`` goes to
  ``bias_ih`` and ``bias_hh`` is zero (the cell only uses their sum); the
  other way, ``b.{i} = bias_ih + bias_hh``.  The JAX GRU has no hidden
  bias inside ``r * (...)``: a GRU whose ``bias_hh`` n block is not zero
  (a loaded ``torch.nn.GRU`` state) has no JAX counterpart and is refused;
- ``Linear``: ``weight`` (in, out) -> (out, in), transposed; ``bias``
  copied;
- ``LoRALinear``: the frozen ``weight`` (in, out) -> (out, in),
  transposed, ``bias`` copied, and the factors ``lora_a`` (in, r) and
  ``lora_b`` (r, out) copied (both packages keep that layout);
- ``StatefulLSTM``: its ``lstm`` moves as an ``LSTM``, and the carried
  state of a stream, the JAX ``_states.0`` and ``_states.1`` (h and c,
  (num_layers * D, B, H) in both), moves to and from ``states`` (a JAX
  state dict without them starts a new stream);
- ``QuantizedLinear``: ``weight_q`` (in, out) int8, ``scale`` and ``bias``
  copied; a ``weight_q``/``scale`` that the JAX ``from_linear`` padded to
  128-lane tiles is cut to ``in_features`` x ``out_features`` (taken from
  the port's module), and written back padded by the same rule (a padded
  layout where it costs at most 1.25 times the logical one), so that a
  round trip is exact;
- ``ConvTranspose1d``: ``weight`` (out, in, k) -> (in, out, k), axes 0 and
  1 swapped (the JAX layer flips the taps in its forward, so the values
  are torch's); ``bias`` copied;
- ``Conv1d``, ``Conv2d`` (OIH(W) in both; a grouped or depthwise
  ``Conv1d`` is (out, in / groups, k) in both), ``Embedding``,
  ``LayerNorm``, ``RMSNorm``, ``PReLU``, the TCN's ``GlobalLayerNorm`` and
  ``ChannelwiseLayerNorm`` (``gamma``, ``beta`` of shape (1, C, 1)),
  ``DynamicTanh`` (``alpha``, ``weight``, ``bias``),
  ``AutoPool`` (``alpha``) and the bias token of a ``MultiheadAttention``
  (``bias_k``, ``bias_v``): copied;
- buffers that are part of the JAX ``state_dict()`` are copied both ways:
  ``RoPE``'s ``inv_freq``, a ``Normalization``'s running statistics
  (``num_tracked_values``, ``running_mean``, ``running_power``, beside its
  ``gamma``/``beta``; the conformer's masked batch norm is one), the ``fbanks`` of ``MelTransform`` and
  ``FusedAudioLogMelExtractor``, a ``DeltaExtractor``'s ``coeffs``;
- lists of modules (``layers``, ``dpt_blocks``, a ``WaveNet``'s
  ``dilate_layers``/``res_layers``/``skip_layers``, a
  ``TransformerDecoder``'s and a ``ConformerEncoder``'s ``layers``, an
  ``AcousticEncoder``'s ``subsample_convs``) are ``nn.ModuleList``s
  in the port, whose keys (``layers.0. ...``) are the JAX pytree paths; the
  children of a ``Sequential`` sit in its ``layers`` list in the JAX
  package (``cnn.0.weight`` here is ``cnn.layers.0.weight`` there; a
  ``ConvNet``'s nested ones, ``conv_blocks.0.1.conv.conv.weight`` here, are
  ``conv_blocks.layers.0.layers.1.conv.conv.weight`` there).
- the stacks of ``contrib/je/modules/conv.py`` (``CNN1d``, ``CNN2d``) keep
  the JAX attribute names: ``convs.{i}.conv`` (copied), ``convs.{i}.norm``
  (a ``Normalization``, its running statistics with it) and the projection
  ``residual_skip_convs.{src}->{dst}`` (an ``nn.ModuleDict``); the audio
  tagger's ``WALNet``, both ``DistanceEstimator``s and the reference
  family's ``CRNN``/``HybridCNN`` (``conv_layers.{i}.conv``, ``.bn``,
  ``.conv_gate``, ``.bn_gate``; the ``GRU`` wrapper's ``gru.gru``) move
  with the rules above.

:func:`to_jax_state_dict` is the inverse of :func:`from_jax_state_dict`:
the port's trainer writes its checkpoints' ``model`` entry with it, so
one storage dir loads in both packages.  The arrays of a submodule (the
GAN vocoder's generator or discriminator) move with the submodule and
the names below its prefix.  :func:`from_jax_arrays` converts a part of a
JAX ``state_dict()``, such as the JAX ``EMAHook``'s average of the
parameters, into tensors keyed by the port's names without touching the
model (the port's ``EMAHook`` keeps its average so).  (``padertorch_tpu.migrate
.import_torch_state_dict`` also maps the port's ``state_dict()`` onto the
JAX model.)
"""
import numpy as np
import torch

from padertorch_tpu_torch.contrib.je.modules.features import (
    DeltaExtractor, FusedAudioLogMelExtractor, MelTransform)
from padertorch_tpu_torch.contrib.je.modules.reduce import AutoPool
from padertorch_tpu_torch.contrib.mk.modules.transformer import (
    DynamicTanh, MultiheadAttention, RoPE)
from padertorch_tpu_torch.modules.convnet import (
    ChannelwiseLayerNorm, GlobalLayerNorm)
from padertorch_tpu_torch.modules.normalization import Normalization
from padertorch_tpu_torch.lora import LoRALinear
from padertorch_tpu_torch.modules.recurrent import GRU, StatefulLSTM, _RNNBase
from padertorch_tpu_torch.nn import RMSNorm
from padertorch_tpu_torch.quantize import QuantizedLinear

__all__ = ['from_jax_state_dict', 'from_jax_arrays', 'to_jax_state_dict']


def _swap01(a):
    return np.swapaxes(a, 0, 1)


def _jax_int8_padding(k, n):
    """The JAX ``QuantizedLinear.from_linear`` layout of a (k, n) weight:
    padded to 128-lane tiles where that costs at most 1.25 times the
    logical size, else logical."""
    k_pad, n_pad = -(-k // 128) * 128, -(-n // 128) * 128
    if k_pad * n_pad <= 1.25 * k * n:
        return k_pad, n_pad
    return k, n


def _quantized_pairs(mod, dot):
    k, n = mod.in_features, mod.out_features
    k_pad, n_pad = _jax_int8_padding(k, n)
    pairs = {
        f'{dot}weight_q': [(mod.weight_q, lambda a: a[:k, :n],
                            lambda a: np.pad(a, ((0, k_pad - k),
                                                 (0, n_pad - n))))],
        f'{dot}scale': [(mod.scale, lambda a: a[:n],
                         lambda a: np.pad(a, (0, n_pad - n)))]}
    if mod.bias is not None:
        pairs[f'{dot}bias'] = [(mod.bias, np.asarray, np.asarray)]
    return pairs


# modules whose own parameters and buffers (not their children's) carry
# the JAX arrays' names and layouts
_COPIED_AS_THEY_ARE = (DynamicTanh, MultiheadAttention, RMSNorm, RoPE,
                       Normalization, MelTransform, DeltaExtractor,
                       FusedAudioLogMelExtractor, AutoPool, GlobalLayerNorm,
                       ChannelwiseLayerNorm)


def _jax_paths(model):
    """{port module name: its dotted path in the JAX model}: the same,
    but that a ``Sequential``'s children sit in its ``layers`` list."""
    paths = {'': ''}
    for name, mod in model.named_modules():
        for child_name, _ in mod.named_children():
            parts = [paths[name]] if paths[name] else []
            if isinstance(mod, torch.nn.Sequential):
                parts.append('layers')
            paths[f'{name}.{child_name}' if name else child_name] = \
                '.'.join([*parts, child_name])
    return paths


def _jax_to_port(model):
    """{jax name: [(port parameter or buffer, converter, inverse)]} for
    every parameter, and every buffer the JAX ``state_dict()`` holds too.
    Most converters are their own inverse."""
    pairs = {}
    paths = _jax_paths(model)
    for name, mod in model.named_modules():
        dot = f'{paths[name]}.' if name else ''
        if isinstance(mod, _RNNBase):
            for layer in range(mod.num_layers):
                for d, suffix in enumerate(mod._suffixes()):
                    i = layer * mod.num_directions + d
                    p = {n: getattr(mod, f'{n}_l{layer}{suffix}') for n in
                         ('weight_ih', 'weight_hh', 'bias_ih', 'bias_hh')}
                    pairs[f'{dot}w_ih.{i}'] = [(p['weight_ih'], np.transpose)]
                    pairs[f'{dot}w_hh.{i}'] = [(p['weight_hh'], np.transpose)]
                    pairs[f'{dot}b.{i}'] = [(p['bias_ih'], np.asarray),
                                            (p['bias_hh'], np.zeros_like)]
        elif isinstance(mod, QuantizedLinear):
            pairs.update(_quantized_pairs(mod, dot))
        elif isinstance(mod, LoRALinear):
            pairs[f'{dot}weight'] = [(mod.weight, np.transpose)]
            if mod.bias is not None:
                pairs[f'{dot}bias'] = [(mod.bias, np.asarray)]
            for factor in ('lora_a', 'lora_b'):
                pairs[f'{dot}{factor}'] = [(getattr(mod, factor),
                                            np.asarray)]
        elif isinstance(mod, _COPIED_AS_THEY_ARE):
            for pname, p in [*mod.named_parameters(recurse=False),
                             *mod.named_buffers(recurse=False)]:
                pairs[f'{dot}{pname}'] = [(p, np.asarray)]
        elif isinstance(mod, (torch.nn.Linear, torch.nn.ConvTranspose1d,
                              torch.nn.Conv1d, torch.nn.Conv2d,
                              torch.nn.Embedding, torch.nn.LayerNorm,
                              torch.nn.PReLU)):
            convert = (np.transpose if isinstance(mod, torch.nn.Linear)
                       else _swap01 if isinstance(mod,
                                                  torch.nn.ConvTranspose1d)
                       else np.asarray)
            if mod.weight is not None:
                pairs[f'{dot}weight'] = [(mod.weight, convert)]
            if getattr(mod, 'bias', None) is not None:
                pairs[f'{dot}bias'] = [(mod.bias, np.asarray)]
    covered = {id(target[0]) for targets in pairs.values()
               for target in targets}
    missed = [n for n, p in model.named_parameters() if id(p) not in covered]
    if missed:
        raise NotImplementedError(
            f'no JAX layout known for the parameters {missed}: only LSTM, '
            'GRU, Linear, LoRALinear, QuantizedLinear, Embedding, Conv1d, Conv2d, '
            'ConvTranspose1d, LayerNorm, RMSNorm, PReLU, GlobalLayerNorm, '
            'ChannelwiseLayerNorm, DynamicTanh, RoPE, MultiheadAttention, '
            'Normalization, AutoPool and the feature extractors move '
            'between the packages yet')
    return pairs


def _streams(model):
    """{JAX name of the carried state: (StatefulLSTM, index)} for the
    model's streaming LSTMs (``_states.0`` is h, ``_states.1`` c)."""
    paths = _jax_paths(model)
    streams = {}
    for name, mod in model.named_modules():
        if isinstance(mod, StatefulLSTM):
            dot = f'{paths[name]}.' if name else ''
            streams.update({f'{dot}_states.{i}': (mod, i) for i in (0, 1)})
    return streams


def from_jax_state_dict(model, sd):
    """Fill ``model``'s parameters from a JAX model's ``state_dict()``
    (``{dotted name: numpy array}``); returns ``model``.

    Raises ``KeyError`` if a JAX array has no target or a parameter of
    ``model`` gets no value, and ``ValueError`` on a shape mismatch.
    """
    streams = _streams(model)
    states = {}
    for name, (mod, i) in streams.items():
        states.setdefault(mod, [None, None])[i] = sd.get(name)
    for mod, (h, c) in states.items():
        device = mod.lstm.weight_ih_l0.device
        mod.states = None if h is None else tuple(
            torch.tensor(np.asarray(a)).to(device) for a in (h, c))
    sd = {name: value for name, value in sd.items() if name not in streams}
    pairs = _jax_to_port(model)
    unexpected = sorted(set(sd) - set(pairs))
    missing = sorted(set(pairs) - set(sd))
    if unexpected or missing:
        raise KeyError(f'from_jax_state_dict: JAX arrays without a target '
                       f'{unexpected}, parameters without a value {missing}')
    with torch.no_grad():
        for name, targets in pairs.items():
            for param, convert, *_ in targets:
                value = np.ascontiguousarray(convert(np.asarray(sd[name])))
                if tuple(value.shape) != tuple(param.shape):
                    raise ValueError(
                        f'{name}: {tuple(value.shape)} does not fit '
                        f'{tuple(param.shape)}')
                param.copy_(torch.tensor(value))
    return model


def from_jax_arrays(model, sd):
    """The JAX arrays ``sd`` (any part of the JAX model's ``state_dict()``,
    e.g. an average of its parameters) in the port's layouts, as
    ``{port parameter or buffer name: tensor}``; ``model`` is only read.

    Raises ``KeyError`` for an array that has no target in ``model``."""
    pairs = _jax_to_port(model)
    names = {id(t): n for n, t in [*model.named_parameters(),
                                   *model.named_buffers()]}
    out = {}
    for jax_name, value in sd.items():
        for target, convert, *_ in pairs[jax_name]:
            out[names[id(target)]] = torch.tensor(
                np.ascontiguousarray(convert(np.asarray(value))))
    return out


def to_jax_state_dict(model):
    """``model``'s parameters in the JAX model's ``state_dict()`` layout
    (``{dotted name: numpy array}``): the inverse of
    :func:`from_jax_state_dict`.  Where several parameters share one JAX
    array (a recurrent layer's two biases), their sum is written.  Raises
    ``ValueError`` for a GRU whose ``bias_hh`` n block is not zero."""
    for name, mod in model.named_modules():
        if not isinstance(mod, GRU):
            continue
        for bias_name, p in mod.named_parameters(recurse=False):
            if bias_name.startswith('bias_hh') and bool(
                    p.detach()[2 * mod.hidden_size:].ne(0).any()):
                raise ValueError(
                    f'{name}.{bias_name}: the n block of a GRU hidden bias '
                    'sits inside r * (W_hn h + b_hn); the JAX GRU has no '
                    'such bias, so it cannot be folded into its fused '
                    'bias')
    sd = {}
    for name, targets in _jax_to_port(model).items():
        params = [target[0].detach().cpu().numpy() for target in targets]
        invert = targets[0][-1]
        sd[name] = np.ascontiguousarray(invert(sum(params[1:], params[0])))
    for name, (mod, i) in _streams(model).items():
        if mod.states is not None:
            sd[name] = mod.states[i].detach().cpu().numpy()
    return sd
