"""Carry the JAX package's model weights into the port: every family of the zoo.

``dnn_state_from_jax``, ``unet_state_from_jax``, ``wav_unet_state_from_jax``,
``dcunet_state_from_jax``, ``conv_tasnet_state_from_jax`` and
``demucs_state_from_jax`` invert the JAX package's ``*_from_torch_state``
importers exactly (reference key names; transposed-conv weights flipped);
``tcn_state_from_jax`` names the flax modules, as the reference has no TCN.

``crn_state_from_jax``, ``mel_rnn_state_from_jax``,
``rnn_stft_mask_state_from_jax`` and ``sepformer_state_from_jax`` invert
the JAX package's ``crn_from_torch_state`` / ``mel_rnn_from_torch_state`` /
``rnn_stft_mask_from_torch_state`` / ``sepformer_from_torch_state``
exactly (a vanilla-RNN layer's single bias ``b`` lands in ``bias_ih`` with
``bias_hh`` zero, whose sum the JAX importer folds back); the DCCRN
converter is described below.

The JAX importers have no key layout for three options, so the port names
them here. Sepformer's ``RelPosMHAXL`` and RNN blocks take the reference's
speechbrain module names that ``SURVEY.md`` records (``Transformer.py``'s
``RelPosMHAXL``: ``self_att.in_proj_weight`` [3E, E] packed per head as
the flax ``in_proj``, ``self_att.linear_pos.weight``,
``self_att.pos_bias_{u,v}`` [D, H], ``self_att.out_proj.*``; ``basic.py``'s
RNN and Linear wrappers: ``{intra,inter}_mdl.mdl.rnn.*_l{k}[_reverse]`` and
``{intra,inter}_linear.w.*``). DCCRN's ``use_clstm=False`` branch, whose
reference keys no survey records, takes the flax names: ``lstm_{k}`` as
``lstm.{k}.*_l0`` and ``transform`` as ``transform.*``.

The library blocks that no model builds (``ops/norms.py``'s ``EMA`` and
``PCEN``; ``ops/complex_ops.py``'s ``ComplexConv2d``,
``ComplexConvTranspose2d``, ``ComplexDense`` and
``ComplexBatchNormStacked``) have no reference keys either: their
converters (``ema_state_from_jax``, ``pcen_state_from_jax``,
``complex_conv_state_from_jax``, ``complex_dense_state_from_jax``,
``complex_bn_stacked_state_from_jax``) name the flax modules, with torch's
layouts, and the stacked complex BN's affine under
``ComplexBatchNorm``'s names.

``dccrn_state_from_jax(params, batch_stats)`` takes the flax variable trees
(as numpy arrays, or anything ``np.asarray`` reads) and returns a
``state_dict`` for :class:`speech_enhancement_torch.models.dccrn.DCCRN`.
The keys and layouts are the reference torch DCCRN's:

* ``encoder.{i}.0.{real,imag}_conv.{weight,bias}``: Conv2d [Cout, Cin, 5, 2]
* ``decoder.{i}.0.{real,imag}_conv.{weight,bias}``: ConvTranspose2d
  [Cin, Cout, 5, 2], spatially flipped relative to the flax HWIO kernel
* ``{encoder,decoder}.{i}.1.{Wrr,Wri,Wii,Br,Bi}`` complex BN affine and
  ``{RMr,RMi,RVrr,RVri,RVii}`` running statistics
* ``{encoder,decoder}.{i}.2.weight`` PReLU alpha
* ``enhance.{l}.{real,imag}_lstm.{weight,bias}_{ih,hh}_l0`` (gate order
  i, f, g, o) and ``enhance.{last}.{r,i}_trans.{weight,bias}``

so the JAX package's own ``dccrn_from_torch_state`` maps the result back
exactly, and a reference ``.pth`` loads into the port as it is.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch

_CBN_PARAMS = (("gamma_rr", "Wrr"), ("gamma_ri", "Wri"), ("gamma_ii", "Wii"),
               ("beta_r", "Br"), ("beta_i", "Bi"))
_CBN_STATS = (("mean_r", "RMr"), ("mean_i", "RMi"), ("vrr", "RVrr"),
              ("vri", "RVri"), ("vii", "RVii"))


def _t(value) -> torch.Tensor:
    """A writable C-ordered f32 copy (a JAX array's numpy view is read-only)."""
    return torch.from_numpy(np.array(value, dtype=np.float32, order="C"))


def _block(sd: Dict[str, torch.Tensor], prefix: str, params: Mapping, stats: Mapping,
           transposed: bool) -> None:
    for part, key in (("real_conv", "wr"), ("imag_conv", "wi")):
        kernel = np.asarray(params[key], dtype=np.float32)  # HWIO [kh, kw, in, out]
        if transposed:
            weight = kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]  # [in, out, kh, kw]
        else:
            weight = kernel.transpose(3, 2, 0, 1)  # [out, in, kh, kw]
        sd[f"{prefix}.0.{part}.weight"] = _t(weight)
        sd[f"{prefix}.0.{part}.bias"] = _t(params["br" if part == "real_conv" else "bi"])
    if "cbn" in params:
        for jax_key, torch_key in _CBN_PARAMS:
            sd[f"{prefix}.1.{torch_key}"] = _t(params["cbn"][jax_key])
        for jax_key, torch_key in _CBN_STATS:
            sd[f"{prefix}.1.{torch_key}"] = _t(stats["cbn"][jax_key])
        sd[f"{prefix}.2.weight"] = _t(params["prelu"]["alpha"])


def _lstm(sd: Dict[str, torch.Tensor], prefix: str, params: Mapping) -> None:
    sd[f"{prefix}.weight_ih_l0"] = _t(np.asarray(params["w_ih"]).T)
    sd[f"{prefix}.weight_hh_l0"] = _t(np.asarray(params["w_hh"]).T)
    sd[f"{prefix}.bias_ih_l0"] = _t(params["b_ih"])
    sd[f"{prefix}.bias_hh_l0"] = _t(params["b_hh"])


def _linear(sd: Dict[str, torch.Tensor], prefix: str, tree: Mapping) -> None:
    """flax Dense -> torch ``nn.Linear`` ``{prefix}.weight`` [out, in] and ``.bias``."""
    sd[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        sd[f"{prefix}.bias"] = _t(tree["bias"])


def dccrn_state_from_jax(params: Mapping, batch_stats: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """flax DCCRN (params, batch_stats) -> the port's DCCRN ``state_dict``."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    n_enc = sum(1 for key in params if key.startswith("enc_"))
    n_dec = sum(1 for key in params if key.startswith("dec_"))
    n_rnn = sum(1 for key in params if key.startswith("clstm_"))
    for i in range(n_enc):
        _block(sd, f"encoder.{i}", params[f"enc_{i}"], batch_stats.get(f"enc_{i}", {}),
               transposed=False)
    for layer in range(n_rnn):
        block = params[f"clstm_{layer}"]
        _lstm(sd, f"enhance.{layer}.real_lstm", block["real_lstm"])
        _lstm(sd, f"enhance.{layer}.imag_lstm", block["imag_lstm"])
        for part, key in (("r_trans", "proj_r"), ("i_trans", "proj_i")):
            if key in block:
                _linear(sd, f"enhance.{layer}.{part}", block[key])
    n_lstm = sum(1 for key in params if key.startswith("lstm_"))
    for layer in range(n_lstm):  # use_clstm=False
        _lstm(sd, f"lstm.{layer}", params[f"lstm_{layer}"])
    if "transform" in params:
        _linear(sd, "transform", params["transform"])
    for i in range(n_dec):
        _block(sd, f"decoder.{i}", params[f"dec_{i}"], batch_stats.get(f"dec_{i}", {}),
               transposed=True)
    return sd


def _bn(sd: Dict[str, torch.Tensor], prefix: str, params: Mapping, stats: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])


def _stack_layer(sd: Dict[str, torch.Tensor], name: str, params: Mapping) -> None:
    """One flax LSTM, GRU or vanilla-RNN layer -> torch ``nn.LSTM`` /
    ``nn.GRU`` / ``nn.RNN`` keys ``*_{name}`` (``name`` is ``l{k}`` or
    ``l{k}_reverse``). A vanilla layer's single ``b`` becomes ``bias_ih``,
    with ``bias_hh`` zero."""
    sd[f"weight_ih_{name}"] = _t(np.asarray(params["w_ih"]).T)
    sd[f"weight_hh_{name}"] = _t(np.asarray(params["w_hh"]).T)
    if "b_ih" in params:
        sd[f"bias_ih_{name}"] = _t(params["b_ih"])
        sd[f"bias_hh_{name}"] = _t(params["b_hh"])
    elif "b" in params:
        sd[f"bias_ih_{name}"] = _t(params["b"])
        sd[f"bias_hh_{name}"] = torch.zeros_like(sd[f"bias_ih_{name}"])


def _rnn_stack(sd: Dict[str, torch.Tensor], prefix: str, rnn: Mapping) -> None:
    """flax ``RNNStack`` (``l{k}_fwd``, ``l{k}_bwd``) -> ``{prefix}.*_l{k}[_reverse]``."""
    n_layers = sum(1 for key in rnn if key.endswith("_fwd"))
    for k in range(n_layers):
        for key, suffix in ((f"l{k}_fwd", ""), (f"l{k}_bwd", "_reverse")):
            if key in rnn:
                layer_sd: Dict[str, torch.Tensor] = {}
                _stack_layer(layer_sd, f"l{k}{suffix}", rnn[key])
                sd.update({f"{prefix}.{name}": v for name, v in layer_sd.items()})


def crn_state_from_jax(params: Mapping, batch_stats: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """flax CRN (params, batch_stats) -> the port's CRN ``state_dict``: the
    exact inverse of the JAX package's ``crn_from_torch_state``
    (``conv_block_{i}`` Conv2d [out, in, 3, 2], ``lstm_layer.*_l{0,1}``,
    ``tran_conv_block_{i}`` ConvTranspose2d [in, out, 3, 2] spatially
    flipped, each block's ``norm``)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for i in range(1, 6):
        block = params[f"enc_{i}"]
        kernel = np.asarray(block["conv"]["kernel"], dtype=np.float32)  # [3, 2, in, out]
        sd[f"conv_block_{i}.conv.weight"] = _t(kernel.transpose(3, 2, 0, 1))
        sd[f"conv_block_{i}.conv.bias"] = _t(block["conv"]["bias"])
        _bn(sd, f"conv_block_{i}.norm", block["bn"], batch_stats[f"enc_{i}"]["bn"])
    for layer in (1, 2):
        if f"lstm{layer}" in params:
            layer_sd: Dict[str, torch.Tensor] = {}
            _stack_layer(layer_sd, f"l{layer - 1}", params[f"lstm{layer}"])
            sd.update({f"lstm_layer.{k}": v for k, v in layer_sd.items()})
    for i in range(1, 6):
        block = params[f"dec_{i}"]
        kernel = np.asarray(block["conv"]["kernel"], dtype=np.float32)  # [3, 2, in, out]
        sd[f"tran_conv_block_{i}.conv.weight"] = _t(kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
        sd[f"tran_conv_block_{i}.conv.bias"] = _t(block["bias"])
        _bn(sd, f"tran_conv_block_{i}.norm", block["bn"], batch_stats[f"dec_{i}"]["bn"])
    return sd


def rnn_stft_mask_state_from_jax(params: Mapping, batch_stats: Mapping
                                 ) -> "OrderedDict[str, torch.Tensor]":
    """flax RNNSTFTMask (params, batch_stats) -> the port's ``state_dict``:
    the exact inverse of the JAX package's ``rnn_stft_mask_from_torch_state``
    (``rnn.*_l{k}[_reverse]``, ``batchnorm.*``, ``fc_layers.0.*``)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _rnn_stack(sd, "rnn", params["rnn"])
    _bn(sd, "batchnorm", params["bn"], batch_stats["bn"])
    _linear(sd, "fc_layers.0", params["fc"])
    return sd


def mel_rnn_state_from_jax(params: Mapping, batch_stats: Mapping
                           ) -> "OrderedDict[str, torch.Tensor]":
    """flax MelRNN (params, batch_stats) -> the port's ``state_dict``: the
    exact inverse of the JAX package's ``mel_rnn_from_torch_state``
    (``rnn.*_l{k}``, ``batchnorm.*``, ``fc_layers.{0,2}.*``)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _rnn_stack(sd, "rnn", params["rnn"])
    _bn(sd, "batchnorm", params["bn"], batch_stats["bn"])
    _linear(sd, "fc_layers.0", params["fc1"])
    _linear(sd, "fc_layers.2", params["fc2"])
    return sd


def _attention(sd: Dict[str, torch.Tensor], p: str, mha: Mapping) -> None:
    """A layer's flax attention -> ``{p}.self_att.*``: flax's MHA as torch
    ``nn.MultiheadAttention`` under the wrapper's ``.att`` (query, key and
    value rows stacked in ``in_proj_weight`` [3E, E]), or RelPosMHAXL."""
    if "in_proj" in mha:  # RelPosMHAXL: the packed kernel as it is
        sd[f"{p}.self_att.in_proj_weight"] = _t(np.asarray(mha["in_proj"]["kernel"]).T)
        _linear(sd, f"{p}.self_att.linear_pos", mha["linear_pos"])
        for name in ("pos_bias_u", "pos_bias_v"):
            sd[f"{p}.self_att.{name}"] = _t(mha[name])
        _linear(sd, f"{p}.self_att.out_proj", mha["out_proj"])
        return
    embed = np.asarray(mha["query"]["kernel"]).shape[0]
    sd[f"{p}.self_att.att.in_proj_weight"] = _t(np.concatenate(
        [np.asarray(mha[n]["kernel"]).reshape(embed, -1).T for n in ("query", "key", "value")]))
    sd[f"{p}.self_att.att.in_proj_bias"] = _t(np.concatenate(
        [np.asarray(mha[n]["bias"]).reshape(-1) for n in ("query", "key", "value")]))
    sd[f"{p}.self_att.att.out_proj.weight"] = _t(
        np.asarray(mha["out"]["kernel"]).reshape(-1, embed).T)
    sd[f"{p}.self_att.att.out_proj.bias"] = _t(mha["out"]["bias"])


def _transformer_block(sd: Dict[str, torch.Tensor], prefix: str, params: Mapping) -> None:
    """flax SBTransformerBlock -> the reference's ``{prefix}.layers.{j}.*`` and
    ``{prefix}.norm.norm.*``."""
    def ln(key, tree):
        sd[f"{key}.norm.weight"] = _t(tree["scale"])
        sd[f"{key}.norm.bias"] = _t(tree["bias"])

    n_layers = sum(1 for key in params if key.startswith("layer_"))
    for j in range(n_layers):
        layer, p = params[f"layer_{j}"], f"{prefix}.layers.{j}"
        _attention(sd, p, layer["mha"])
        for name, key in (("ffn1", "0"), ("ffn2", "3")):
            _linear(sd, f"{p}.pos_ffn.ffn.{key}", layer[name])
        ln(f"{p}.norm1", layer["ln1"])
        ln(f"{p}.norm2", layer["ln2"])
    ln(f"{prefix}.norm", params["norm"])


def sepformer_state_from_jax(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """flax Sepformer params -> the port's Sepformer ``state_dict``: the exact
    inverse of the JAX package's ``sepformer_from_torch_state`` (Conv1d /
    1x1-conv / Conv2d kernels transposed back, the decoder's
    ConvTranspose1d kernel [in, out, K] flipped in time, gLN gamma / beta as
    ``weight`` / ``bias``); RelPosMHAXL layers and RNN blocks, which that
    importer does not map, under the keys the module docstring names."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def kernel(tree):
        return np.asarray(tree["kernel"], dtype=np.float32)

    def gln(key, tree):
        sd[f"{key}.weight"] = _t(tree["gamma"])
        sd[f"{key}.bias"] = _t(tree["beta"])

    sd["encoder.conv1d.weight"] = _t(kernel(params["encoder"]).transpose(2, 1, 0))
    gln("masknet.norm", params["input_norm"])
    sd["masknet.conv1d.weight"] = _t(kernel(params["input_proj"]).T[:, :, None])
    n_blocks = sum(1 for key in params if key.startswith("dual_"))
    for i in range(n_blocks):
        block, p = params[f"dual_{i}"], f"masknet.dual_mdl.{i}"
        for path in ("intra", "inter"):
            if f"{path}_linear" in block:  # an SBRNNBlock and its projection
                _rnn_stack(sd, f"{p}.{path}_mdl.mdl.rnn", block[path]["rnn"])
                _linear(sd, f"{p}.{path}_linear.w", block[f"{path}_linear"])
            else:
                _transformer_block(sd, f"{p}.{path}_mdl.mdl", block[path])
        gln(f"{p}.intra_norm", block["intra_norm"])
        gln(f"{p}.inter_norm", block["inter_norm"])
    sd["masknet.prelu.weight"] = _t(params["prelu"]["alpha"])
    sd["masknet.conv2d.weight"] = _t(kernel(params["spk_expand"]).T[:, :, None, None])
    sd["masknet.conv2d.bias"] = _t(params["spk_expand"]["bias"])
    for name in ("output", "output_gate"):
        sd[f"masknet.{name}.0.weight"] = _t(kernel(params[name]).transpose(2, 1, 0))
        sd[f"masknet.{name}.0.bias"] = _t(params[name]["bias"])
    sd["masknet.end_conv1x1.weight"] = _t(kernel(params["end_proj"]).T[:, :, None])
    sd["decoder.weight"] = _t(kernel(params["decoder"]).transpose(1, 2, 0)[:, :, ::-1])
    return sd


# -- the rest of the zoo -------------------------------------------------------

def _conv_k(sd: Dict[str, torch.Tensor], prefix: str, tree: Mapping) -> None:
    """flax Conv (kernel [*k, in, out]) -> torch Conv1d / Conv2d
    ``{prefix}.weight`` [out, in, *k] and ``.bias``."""
    kernel = np.asarray(tree["kernel"], dtype=np.float32)
    axes = (kernel.ndim - 1, kernel.ndim - 2) + tuple(range(kernel.ndim - 2))
    sd[f"{prefix}.weight"] = _t(kernel.transpose(axes))
    if "bias" in tree:
        sd[f"{prefix}.bias"] = _t(tree["bias"])


def _tconv_k(sd: Dict[str, torch.Tensor], prefix: str, tree: Mapping) -> None:
    """flax ConvTranspose (kernel [*k, in, out], not flipped) -> torch
    ConvTranspose1d / 2d ``{prefix}.weight`` [in, out, *k], flipped in space."""
    kernel = np.asarray(tree["kernel"], dtype=np.float32)
    spatial = tuple(range(kernel.ndim - 2))
    weight = kernel.transpose((kernel.ndim - 2, kernel.ndim - 1) + spatial)
    sd[f"{prefix}.weight"] = _t(np.flip(weight, axis=tuple(a + 2 for a in spatial)))
    if "bias" in tree:
        sd[f"{prefix}.bias"] = _t(tree["bias"])


def _gn(sd: Dict[str, torch.Tensor], prefix: str, tree: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(tree["scale"])
    sd[f"{prefix}.bias"] = _t(tree["bias"])


def dnn_state_from_jax(params: Mapping, batch_stats: Mapping
                       ) -> "OrderedDict[str, torch.Tensor]":
    """flax DNN -> the port's DNN ``state_dict``: the exact inverse of the
    JAX package's ``dnn_from_torch_state`` (``context``, ``model.{n}.model.0``
    Linear, ``model.{n}.model.1`` BatchNorm1d)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    if "context" in params:
        _linear(sd, "context", params["context"])
    n_layers = sum(1 for key in params if key.startswith("linear_"))
    for n in range(n_layers):
        _linear(sd, f"model.{n}.model.0", params[f"linear_{n}"])
        _bn(sd, f"model.{n}.model.1", params[f"bn_{n}"], batch_stats[f"bn_{n}"])
    return sd


def tcn_state_from_jax(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """flax DilatedTCN params -> the port's ``state_dict``. The reference has
    no TCN, so the keys are the flax modules' names (``encoder``,
    ``block_{r}_{b}.{dilated,norm,project}``, ``decoder`` as a torch
    ConvTranspose1d weight, the flax kernel flipped)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _conv_k(sd, "encoder", params["encoder"])
    for key in params:
        if key.startswith("block_"):
            _conv_k(sd, f"{key}.dilated", params[key]["dilated"])
            _gn(sd, f"{key}.norm", params[key]["norm"])
            _conv_k(sd, f"{key}.project", params[key]["project"])
    _tconv_k(sd, "decoder", params["decoder"])
    return sd


def wav_unet_state_from_jax(params: Mapping, batch_stats: Mapping
                            ) -> "OrderedDict[str, torch.Tensor]":
    """flax WavUNet -> the port's ``state_dict``: the exact inverse of the JAX
    package's ``wav_unet_from_torch_state`` (``encoder.{i}.main.{0,1}``,
    ``middle.{0,1}``, ``decoder.{i}.main.{0,1}``, ``out.0``)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def block(prefix, key):
        _conv_k(sd, f"{prefix}.0", params[key]["conv"])
        _bn(sd, f"{prefix}.1", params[key]["bn"], batch_stats[key]["bn"])

    n_layers = sum(1 for key in params if key.startswith("enc_"))
    for i in range(n_layers):
        block(f"encoder.{i}.main", f"enc_{i}")
    block("middle", "middle")
    for i in range(n_layers):
        block(f"decoder.{i}.main", f"dec_{i}")
    _conv_k(sd, "out.0", params["out"])
    return sd


def unet_state_from_jax(params: Mapping, batch_stats: Mapping
                        ) -> "OrderedDict[str, torch.Tensor]":
    """flax UNet -> the port's ``state_dict``: the exact inverse of the JAX
    package's ``unet_from_torch_state`` (DoubleConvs' conv at 0 and 3,
    BatchNorm at 1 and 4; the ConvTranspose2d ``up`` weights flipped)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def double_conv(prefix, key):
        for conv_i, bn_i, n in ((0, 1, 1), (3, 4, 2)):
            _conv_k(sd, f"{prefix}.{conv_i}", params[key][f"conv{n}"])
            _bn(sd, f"{prefix}.{bn_i}", params[key][f"bn{n}"], batch_stats[key][f"bn{n}"])

    n_layers = sum(1 for key in params if key.startswith("down_"))
    for n in range(n_layers):
        double_conv(f"encoder.{n}.maxpool_conv.0.double_conv", f"down_{n}")
    double_conv("middle.double_conv", "middle")
    for n in range(n_layers):
        if f"up_{n}" in params:
            _tconv_k(sd, f"decoder.{n}.up", params[f"up_{n}"])
        double_conv(f"decoder.{n}.conv.double_conv", f"dec_{n}")
    if "up_out" in params:
        _tconv_k(sd, "outconv.up", params["up_out"])
    double_conv("outconv.conv.double_conv", "dec_out")
    return sd


def dcunet_state_from_jax(params: Mapping, batch_stats: Mapping
                          ) -> "OrderedDict[str, torch.Tensor]":
    """flax DCUnet -> the port's ``state_dict``: the exact inverse of the JAX
    package's ``dcunet_from_torch_state`` (``encoder{i}.conv.conv_{re,im}``,
    ``decoder{i}.transconv.tconv_{re,im}`` flipped, each block's
    ``bn.bn_{re,im}``, ``linear.conv_{re,im}``)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def cbn(prefix, key):
        for part, name in (("bn_re", "bn_r"), ("bn_im", "bn_i")):
            _bn(sd, f"{prefix}.bn.{part}", params[key]["bn"][name],
                batch_stats[key]["bn"][name])

    n_blocks = sum(1 for key in params if key.startswith("enc_"))
    for i in range(n_blocks):
        _conv_k(sd, f"encoder{i}.conv.conv_re", params[f"enc_{i}"]["conv_r"])
        _conv_k(sd, f"encoder{i}.conv.conv_im", params[f"enc_{i}"]["conv_i"])
        cbn(f"encoder{i}", f"enc_{i}")
    for i in range(n_blocks):
        _tconv_k(sd, f"decoder{i}.transconv.tconv_re", params[f"dec_{i}"]["tconv_r"])
        _tconv_k(sd, f"decoder{i}.transconv.tconv_im", params[f"dec_{i}"]["tconv_i"])
        cbn(f"decoder{i}", f"dec_{i}")
    _conv_k(sd, "linear.conv_re", params["linear_r"])
    _conv_k(sd, "linear.conv_im", params["linear_i"])
    return sd


def conv_tasnet_state_from_jax(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """flax ConvTasNet params -> the port's ``state_dict``: the exact inverse
    of the JAX package's ``conv_tasnet_from_torch_state``, in the
    reference's ``separator.network`` layout, or its named layout when the
    blocks have skip convs; cLN / gLN affines as [1, N, 1]."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    blocks = sorted(key for key in params if key.startswith("block_"))
    skip = any("skip_conv" in params[key]["dsconv"] for key in blocks)
    if skip:
        ln, bottleneck = "separator.layer_norm", "separator.bottleneck_conv1x1"
        tcn, mask = "separator.temporal_conv_net", "separator.mask_conv1x1"
    else:
        ln, bottleneck = "separator.network.0", "separator.network.1"
        tcn, mask = "separator.network.2", "separator.network.3"

    def norm(prefix, tree):
        sd[f"{prefix}.gamma"] = _t(np.asarray(tree["gamma"]).reshape(1, -1, 1))
        sd[f"{prefix}.beta"] = _t(np.asarray(tree["beta"]).reshape(1, -1, 1))

    _conv_k(sd, "encoder.conv1d_U", params["encoder"])
    norm(ln, params["layer_norm"])
    _conv_k(sd, bottleneck, params["bottleneck"])
    for key in blocks:
        r, x = key.split("_")[1:]
        block, p = params[key], f"{tcn}.{r}.{x}"
        _conv_k(sd, f"{p}.net.0", block["conv1x1"])
        sd[f"{p}.net.1.weight"] = _t(block["prelu"]["alpha"])
        norm(f"{p}.net.2", block["norm"])
        ds = block["dsconv"]
        _conv_k(sd, f"{p}.net.3.net.0", ds["depthwise"])
        sd[f"{p}.net.3.net.1.weight"] = _t(ds["prelu"]["alpha"])
        norm(f"{p}.net.3.net.2", ds["norm"])
        _conv_k(sd, f"{p}.net.3.pointwise_conv", ds["pointwise"])
        if "skip_conv" in ds:
            _conv_k(sd, f"{p}.net.3.skip_conv", ds["skip_conv"])
    _conv_k(sd, mask, params["mask_conv"])
    sd["decoder.basis_signals.weight"] = _t(np.asarray(params["decoder"]["kernel"]).T)
    return sd


def _demucs_blstm(sd: Dict[str, torch.Tensor], prefix: str, tree: Mapping) -> None:
    _rnn_stack(sd, f"{prefix}.lstm", tree)
    _linear(sd, f"{prefix}.linear", tree["linear"])


def _demucs_dconv(sd: Dict[str, torch.Tensor], base: str, tree: Mapping) -> None:
    """DConv ``d{d}_*`` -> ``{base}.layers.{d}.{k}`` in the reference Sequential's
    positions (conv 0, norm 1, [BLSTM], [LocalState], 1x1, norm, GLU, scale)."""
    depth = sum(1 for key in tree if key.endswith("_conv"))
    for d in range(depth):
        p, j = f"{base}.layers.{d}", 3
        _conv_k(sd, f"{p}.0", tree[f"d{d}_conv"])
        if f"d{d}_norm1" in tree:
            _gn(sd, f"{p}.1", tree[f"d{d}_norm1"])
        if f"d{d}_lstm" in tree:
            _demucs_blstm(sd, f"{p}.{j}", tree[f"d{d}_lstm"])
            j += 1
        if f"d{d}_attn" in tree:
            for name, sub in tree[f"d{d}_attn"].items():
                _conv_k(sd, f"{p}.{j}.{name}", sub)
            j += 1
        _conv_k(sd, f"{p}.{j}", tree[f"d{d}_rewrite"])
        if f"d{d}_norm2" in tree:
            _gn(sd, f"{p}.{j + 1}", tree[f"d{d}_norm2"])
        sd[f"{p}.{j + 3}.scale"] = _t(tree[f"d{d}_scale"]["scale"])


def demucs_state_from_jax(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """flax Demucs params -> the port's ``state_dict``: the exact inverse of
    the JAX package's ``demucs_from_torch_state`` (``encoder.{i}.{k}`` and
    ``decoder.{depth - 1 - i}.{k}`` in the reference Sequentials' positions,
    ConvTranspose1d weights flipped, BLSTMs as ``lstm.*_l{k}[_reverse]`` and
    ``linear``)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    depth = sum(1 for key in params if key.startswith("enc_") and key.endswith("_conv"))
    for i in range(depth):
        e, j = f"encoder.{i}", 3
        _conv_k(sd, f"{e}.0", params[f"enc_{i}_conv"])
        if f"enc_{i}_norm" in params:
            _gn(sd, f"{e}.1", params[f"enc_{i}_norm"])
        if f"enc_{i}_dconv" in params:
            _demucs_dconv(sd, f"{e}.3", params[f"enc_{i}_dconv"])
            j = 4
        if f"enc_{i}_rewrite" in params:
            _conv_k(sd, f"{e}.{j}", params[f"enc_{i}_rewrite"])
            if f"enc_{i}_rwnorm" in params:
                _gn(sd, f"{e}.{j + 1}", params[f"enc_{i}_rwnorm"])
    for i in range(depth):
        d, j = f"decoder.{depth - 1 - i}", 0
        if f"dec_{i}_rewrite" in params:
            _conv_k(sd, f"{d}.0", params[f"dec_{i}_rewrite"])
            if f"dec_{i}_rwnorm" in params:
                _gn(sd, f"{d}.1", params[f"dec_{i}_rwnorm"])
            j = 3
        if f"dec_{i}_dconv" in params:
            _demucs_dconv(sd, f"{d}.{j}", params[f"dec_{i}_dconv"])
            j += 1
        _tconv_k(sd, f"{d}.{j}", params[f"dec_{i}_tconv"])
        if f"dec_{i}_norm" in params:
            _gn(sd, f"{d}.{j + 1}", params[f"dec_{i}_norm"])
    if "lstm" in params:
        _demucs_blstm(sd, "lstm", params["lstm"])
    return sd


# -- the library blocks no model builds ----------------------------------------

def ema_state_from_jax(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """flax ``EMA`` -> ``ops.norms.EMA``: ``alpha_logit`` when trainable (a
    fixed EMA has no parameter)."""
    return OrderedDict((k, _t(v)) for k, v in params.items())


def pcen_state_from_jax(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """flax ``PCEN`` -> ``ops.norms.PCEN``: ``alpha``, ``delta``, ``root`` and,
    with ``spcen``, ``smoother.alpha_logit``."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key in ("alpha", "delta", "root"):
        sd[key] = _t(params[key])
    for key, value in params.get("smoother", {}).items():
        sd[f"smoother.{key}"] = _t(value)
    return sd


def complex_conv_state_from_jax(params: Mapping, transposed: bool = False
                                ) -> "OrderedDict[str, torch.Tensor]":
    """flax ``ComplexConv2d`` (or, ``transposed``, ``ComplexConvTranspose2d``)
    -> the port's: ``conv_r`` / ``conv_i`` as torch Conv2d [out, in, kh, kw]
    (ConvTranspose2d [in, out, kh, kw], flipped in space)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name in ("conv_r", "conv_i"):
        (_tconv_k if transposed else _conv_k)(sd, name, params[name])
    return sd


def complex_dense_state_from_jax(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """flax ``ComplexDense`` -> the port's ``dense_r`` / ``dense_i`` Linears."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name in ("dense_r", "dense_i"):
        _linear(sd, name, params[name])
    return sd


def complex_bn_stacked_state_from_jax(params: Mapping, batch_stats: Mapping
                                      ) -> "OrderedDict[str, torch.Tensor]":
    """flax ``ComplexBatchNormStacked`` -> the port's: the affine under
    ``Wrr``...``Bi``, the running ``mean2`` and ``var2`` [2C] and ``vri``
    [C] under their flax names."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for jax_key, torch_key in _CBN_PARAMS:
        sd[torch_key] = _t(params[jax_key])
    for key in ("mean2", "var2", "vri"):
        sd[key] = _t(batch_stats[key])
    return sd
