"""Load the JAX package's parameters into the port's modules.

``load_tgn_params`` takes the flax parameter tree ``{"mem", "enc", "dec"}``
as nested dicts of arrays (anything ``numpy.asarray`` reads), as the JAX TGN
example builds it, and copies it into a ``TGNMemory``, a
``GraphAttentionEmbeddingRowwise`` or ``GraphAttentionEmbedding`` (the
two flax encoders share their parameter names) and a ``LinkPredictor``.
``load_dygformer_params`` takes ``{"enc", "dec"}`` as the JAX ``DyGFormer``
and ``LinkPredictor`` (or ``NodePredictor``) ``init`` build it (either
attention layout) and copies it into a ``DyGFormer`` and the head. ``load_tgat_params`` takes
``{"enc", "dec"}`` as the JAX ``TGAT`` and ``LinkPredictor`` ``init`` build
it and copies it into a ``TGAT`` and a ``LinkPredictor``. The TGN, TGAT and
DyGFormer loaders also take a ``NodePredictor`` head for ``"dec"`` (its tree
holds ``_MLP_0`` where the link head's holds ``mlp``).
``load_graphmixer_params`` takes ``{"enc", "dec"}`` as the JAX GraphMixer
example's ``GraphMixerEncoder`` and ``LinkPredictor`` ``init`` build it.
``load_tpnet_params`` takes ``{"enc", "dec"}`` as the JAX ``TPNet`` (with or
without its ``RandomProjectionModule``) and ``LinkPredictor`` or
``NodePredictor`` ``init`` build it; ``rp_state_from_numpy`` turns a JAX
``RandomProjectionState`` (as arrays) into the port's.
``load_ctan_params`` takes ``{"enc", "dec"}`` as the JAX CTAN example's
``CTAN`` and ``LinkPredictor`` ``init`` build it; ``load_tncn_params``
takes ``{"mem", "enc", "dec"}`` as the JAX TNCN example builds it (the
TGN memory and segment encoder, and an ``NCNPredictor``).
``load_gcn_params``, ``load_tgcn_params``, ``load_gclstm_params`` and
``load_roland_params`` take ``{"enc", "dec"}`` as the JAX snapshot link
examples build it (``GCN``, ``TGCN``, ``GCLSTM``, ``ROLAND`` and a
``LinkPredictor``), or ``{"enc", "head"}`` as the snapshot node and graph
examples build it (the head a ``NodePredictor`` or a ``GraphPredictor``);
``load_flax_gru_cell`` takes a flax ``GRUCell``'s parameters alone.
``load_tgn_memory_params`` takes the ``"mem"`` subtree alone,
``load_mlp_mixer_params`` a flax ``MLPMixer``'s variables.
``load_learnable_sum_merge`` takes a flax ``LearnableSumMerge``'s
variables and copies them into the port's. The parameter-free baselines
(EdgeBank, PopTrack, t-CoMem) have no parameters to carry across: each
predictor's state is built from the same edge arrays in both packages, and
the tests compare the states directly. The mappings:

* Dense ``kernel (in, out)`` -> ``Linear.weight`` = kernel^T, ``bias`` -> ``bias``
  (``lin_edge`` has no bias);
* ``TorchGRUCell`` ``wi/bi/wh/bh`` -> ``weight_ih``^T / ``bias_ih`` /
  ``weight_hh``^T / ``bias_hh``;
* ``Time2Vec`` ``w (1, T)`` / ``b (T,)`` -> ``w.weight`` (T, 1) / ``w.bias``;
* the ``LinkPredictor`` and ``GraphPredictor`` MLP's ``Dense_0``,
  ``Dense_1``, ... (under ``mlp``; ``_MLP_0`` for the ``NodePredictor``) -> its Linear layers in order (the
  same for the co-occurrence encoder's MLP);
* ``LayerNorm_i`` ``scale`` / ``bias`` -> ``LayerNorm.weight`` / ``bias``;
* ``MultiHeadDotProductAttention_0`` ``query``/``key``/``value`` kernels
  (D, H, dh) and ``out`` kernel (H, dh, D), flattened to (D, D), ->
  ``Linear.weight`` = kernel^T; biases (H, dh) flattened to (D,);
* ``FusedSelfAttention_0`` (``fused_attn=True``) ``qkv`` (D, 3D) and
  ``out`` (D, D) -> ``Linear.weight`` = kernel^T;
* ``LearnableSumMerge``'s ``Dense_0`` / ``Dense_1`` -> its ``src`` / ``dst``;
* an ``MLPMixer``'s ``LayerNorm_0`` / ``FeedForwardNet_0`` / ``LayerNorm_1``
  / ``FeedForwardNet_1`` -> ``token_norm`` / ``token_ffn`` / ``channel_norm``
  / ``channel_ffn``, a ``FeedForwardNet``'s ``Dense_0`` / ``Dense_1`` -> its
  ``fc1`` / ``fc2``;
* GraphMixer's ``Time2Vec_0`` / ``Dense_0`` / ``MLPMixer_i`` / ``Dense_1`` ->
  ``time_encoder`` / ``link_proj`` / ``mixers[i]`` / ``output_layer``;
* TPNet's ``time_encoder`` / ``proj_hidden`` / ``proj_out`` /
  ``mlp_mixers_i`` -> the modules of those names (``mlp_mixers[i]``), and
  ``random_projections``' ``Dense_0`` / ``Dense_1`` -> its ``fc1`` / ``fc2``;
* CTAN's ``time_enc`` / ``enc_x`` / ``W`` / ``b`` -> the same names, its
  ``phi``'s ``Dense_0`` (edge, no bias) / ``Dense_1`` / ``Dense_2`` /
  ``Dense_3`` -> ``phi.lin_edge`` / ``lin_query`` / ``lin_key`` /
  ``lin_value`` (flax's call order), ``W`` untransposed;
* the ``NCNPredictor``'s ``xsmlp`` ``layers_0`` / ``layers_2`` -> ``xsmlp[0]``
  / ``xsmlp[2]``;
* a ``GCNConv``'s ``Dense_0`` / ``bias`` -> its ``lin`` / ``bias``, a
  ``ChebConv``'s ``lin_k`` / ``bias`` -> ``lins[k]`` / ``bias``; GCN's
  ``GCNConv_i`` -> ``convs[i]``; GC-LSTM's ``W_*`` (x @ W, untransposed) and
  ``b_*`` (1, out) as they are;
* a flax ``GRUCell``'s ``ir``, ``iz``, ``in`` (with bias) and ``hr``, ``hz``
  (no bias), ``hn`` (with bias) -> ``weight_ih`` = [ir; iz; in]^T stacked
  in torch's (r, z, n) order, ``weight_hh`` = [hr; hz; hn]^T, ``bias_ih`` =
  [b_ir, b_iz, b_in], ``bias_hh`` = [0, 0, b_hn];
* TGAT's ``attn_i`` ``W_Q`` / ``W_KV`` (no bias) / ``W_O`` / ``layer_norm``
  and ``merge_layers_i`` ``Dense_0`` / ``Dense_1`` -> the ``TemporalAttention``
  Linear layers and LayerNorm and the ``MergeLayer``'s ``fc1`` / ``fc2``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from .nn.encoder.dygformer import FusedSelfAttention


def _copy(dst: torch.Tensor, value: Any, transpose: bool = False) -> None:
    arr = np.asarray(value, dtype=np.float32)
    if transpose:
        arr = arr.T
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: parameter {tuple(dst.shape)}, value {arr.shape}")
    dst.copy_(torch.tensor(arr))


def _dense(lin: nn.Linear, p: Mapping[str, Any]) -> None:
    _copy(lin.weight, p["kernel"], transpose=True)
    if lin.bias is not None:
        _copy(lin.bias, p["bias"])
    elif "bias" in p:
        raise ValueError("the flax Dense has a bias the Linear lacks")


def _time2vec(mod: nn.Module, p: Mapping[str, Any]) -> None:
    _copy(mod.w.weight, p["w"], transpose=True)
    _copy(mod.w.bias, p["b"])


@torch.no_grad()
def load_tgn_params(params: Mapping[str, Any], memory: nn.Module, encoder: nn.Module,
                    decoder: nn.Module) -> None:
    """Copy the flax tree ``{"mem", "enc", "dec"}`` into the three modules, in
    place; ``decoder`` is a ``LinkPredictor`` or a ``NodePredictor``."""
    load_tgn_memory_params(params["mem"], memory)
    _tgn_encoder(encoder, params["enc"]["params"])
    _head(decoder, params["dec"])


def _tgn_encoder(encoder: nn.Module, enc: Mapping[str, Any]) -> None:
    _time2vec(encoder.time_enc, enc["time_enc"])
    for name in ("lin_query", "lin_key", "lin_value", "lin_edge", "lin_skip"):
        _dense(getattr(encoder, name), enc[name])


@torch.no_grad()
def load_tgn_memory_params(variables: Mapping[str, Any], memory: nn.Module) -> None:
    """Copy a flax ``TGNMemory``'s variables (``{"params": {"time_enc", "gru"}}``)
    into a ``TGNMemory``, in place."""
    mem = variables["params"]
    _time2vec(memory.time_enc, mem["time_enc"])
    gru = mem["gru"]
    _copy(memory.gru.weight_ih, gru["wi"], transpose=True)
    _copy(memory.gru.bias_ih, gru["bi"])
    _copy(memory.gru.weight_hh, gru["wh"], transpose=True)
    _copy(memory.gru.bias_hh, gru["bh"])


def _mlp(seq: nn.Sequential, p: Mapping[str, Any]) -> None:
    linears = [m for m in seq if isinstance(m, nn.Linear)]
    if len(linears) != len(p):
        raise ValueError(f"the module has {len(linears)} Linear layers, the tree {len(p)}")
    for i, lin in enumerate(linears):
        _dense(lin, p[f"Dense_{i}"])


def _head(decoder: nn.Module, variables: Mapping[str, Any]) -> None:
    """A link head's ``mlp`` or a node head's ``_MLP_0``, whichever the tree holds."""
    p = variables["params"]
    _mlp(decoder.model, p["mlp"] if "mlp" in p else p["_MLP_0"])


def _layer_norm(ln: nn.Module, p: Mapping[str, Any]) -> None:
    _copy(ln.weight, p["scale"])
    _copy(ln.bias, p["bias"])


def _attention_dense(lin: nn.Linear, p: Mapping[str, Any]) -> None:
    D = lin.weight.shape[0]
    _copy(lin.weight, np.asarray(p["kernel"]).reshape(D, D), transpose=True)
    _copy(lin.bias, np.asarray(p["bias"]).reshape(D))


def fuse_attention_params(mha_params: Mapping[str, Any]) -> dict:
    """The JAX ``fuse_attention_params``: a flax ``MultiHeadDotProductAttention``
    subtree in the ``FusedSelfAttention`` layout (``qkv`` kernel (D, 3D),
    ``out`` kernel (D, D)), as numpy arrays."""
    D = np.asarray(mha_params["out"]["kernel"]).shape[-1]
    flat = lambda p, shape: np.asarray(p, dtype=np.float32).reshape(shape)
    names = ("query", "key", "value")
    return {
        "qkv": {"kernel": np.concatenate([flat(mha_params[n]["kernel"], (D, D)) for n in names], 1),
                "bias": np.concatenate([flat(mha_params[n]["bias"], (D,)) for n in names])},
        "out": {"kernel": flat(mha_params["out"]["kernel"], (D, D)),
                "bias": flat(mha_params["out"]["bias"], (D,))},
    }


@torch.no_grad()
def load_transformer_encoder_params(sub: Mapping[str, Any], layer: nn.Module) -> None:
    """Copy a flax ``TransformerEncoder`` subtree (either attention layout;
    fp32 LayerNorms, or the ``LayerNormBF16_i`` of a ``bf16_stream`` layer)
    into a ``TransformerEncoder``, in place. The tree's parameters are fp32
    whatever the layer's ``dtype``: flax's ``dtype=`` changes only the
    computation."""
    fused = "FusedSelfAttention_0" in sub
    if "MultiHeadDotProductAttention_0" not in sub and not fused:
        raise ValueError("the layer's tree needs the flax-MHA or the fused attention layout")
    if fused != isinstance(layer.attn, FusedSelfAttention):
        names = ("flax-MHA", "fused")
        raise ValueError(f"the tree has the {names[fused]} attention layout, the encoder "
                         f"the {names[not fused]} one")
    stream = "LayerNormBF16_0" in sub
    if stream != layer.bf16_stream:
        raise ValueError(f"the tree's LayerNorms are {('fp32', 'LayerNormBF16')[stream]}, the "
                         f"layer's {('fp32', 'LayerNormBF16')[layer.bf16_stream]} "
                         "(bf16_stream)")
    ln_names = ("LayerNormBF16_0", "LayerNormBF16_1") if stream else ("LayerNorm_0",
                                                                      "LayerNorm_1")
    _layer_norm(layer.ln1, sub[ln_names[0]])
    if fused:
        for name in ("qkv", "out"):
            _dense(getattr(layer.attn, name), sub["FusedSelfAttention_0"][name])
    else:
        for name in ("query", "key", "value", "out"):
            _attention_dense(getattr(layer.attn, name),
                             sub["MultiHeadDotProductAttention_0"][name])
    _layer_norm(layer.ln2, sub[ln_names[1]])
    _dense(layer.ffn1, sub["Dense_0"])
    _dense(layer.ffn2, sub["Dense_1"])


@torch.no_grad()
def load_dygformer_params(params: Mapping[str, Any], encoder: nn.Module,
                          decoder: nn.Module) -> None:
    """Copy the flax tree ``{"enc", "dec"}`` into a DyGFormer and a
    LinkPredictor or NodePredictor, in place."""
    enc = params["enc"]["params"]
    _time2vec(encoder.time_encoder, enc["time_encoder"])
    _mlp(encoder.co_occurrence_encoder.enc, enc["co_occurrence_encoder"])
    for name in ("proj_node", "proj_edge", "proj_time", "proj_cooc", "output_layer"):
        _dense(getattr(encoder, name), enc[name])
    n_tree = sum(1 for k in enc if k.startswith("transformers_"))
    if n_tree != len(encoder.transformers):
        raise ValueError(f"encoder has {len(encoder.transformers)} layers, the tree {n_tree}")
    for i, layer in enumerate(encoder.transformers):
        load_transformer_encoder_params(enc[f"transformers_{i}"], layer)
    _head(decoder, params["dec"])


@torch.no_grad()
def load_tgat_params(params: Mapping[str, Any], encoder: nn.Module, decoder: nn.Module) -> None:
    """Copy the flax tree ``{"enc", "dec"}`` into a TGAT and a LinkPredictor
    or NodePredictor, in place."""
    enc = params["enc"]["params"]
    _time2vec(encoder.time_encoder, enc["time_encoder"])
    n_tree = sum(1 for k in enc if k.startswith("attn_"))
    if n_tree != len(encoder.attn):
        raise ValueError(f"encoder has {len(encoder.attn)} layers, the tree {n_tree}")
    for i, (attn, merge) in enumerate(zip(encoder.attn, encoder.merge_layers)):
        sub = enc[f"attn_{i}"]
        for name in ("W_Q", "W_KV", "W_O"):
            _dense(getattr(attn, name), sub[name])
        _layer_norm(attn.layer_norm, sub["layer_norm"])
        _dense(merge.fc1, enc[f"merge_layers_{i}"]["Dense_0"])
        _dense(merge.fc2, enc[f"merge_layers_{i}"]["Dense_1"])
    _head(decoder, params["dec"])


@torch.no_grad()
def load_learnable_sum_merge(variables: Mapping[str, Any], merge: nn.Module) -> None:
    """Copy a flax ``LearnableSumMerge``'s ``{"params": {"Dense_0", "Dense_1"}}``
    into the port's ``LearnableSumMerge``, in place."""
    p = variables["params"]
    _dense(merge.src, p["Dense_0"])
    _dense(merge.dst, p["Dense_1"])


def _mlp_mixer(mixer: nn.Module, p: Mapping[str, Any]) -> None:
    """An ``MLPMixer``'s parameters (the flax subtree under ``params``)."""
    _layer_norm(mixer.token_norm, p["LayerNorm_0"])
    _layer_norm(mixer.channel_norm, p["LayerNorm_1"])
    for ffn, name in ((mixer.token_ffn, "FeedForwardNet_0"),
                      (mixer.channel_ffn, "FeedForwardNet_1")):
        _dense(ffn.fc1, p[name]["Dense_0"])
        _dense(ffn.fc2, p[name]["Dense_1"])


@torch.no_grad()
def load_mlp_mixer_params(variables: Mapping[str, Any], mixer: nn.Module) -> None:
    """Copy a flax ``MLPMixer``'s ``{"params": {...}}`` into the port's, in place."""
    _mlp_mixer(mixer, variables["params"])


def _mixers(mixers: nn.ModuleList, enc: Mapping[str, Any], prefix: str) -> None:
    n_tree = sum(1 for k in enc if k.startswith(prefix))
    if n_tree != len(mixers):
        raise ValueError(f"encoder has {len(mixers)} mixer blocks, the tree {n_tree}")
    for i, mixer in enumerate(mixers):
        _mlp_mixer(mixer, enc[f"{prefix}{i}"])


@torch.no_grad()
def load_graphmixer_params(params: Mapping[str, Any], encoder: nn.Module,
                           decoder: nn.Module) -> None:
    """Copy the flax tree ``{"enc", "dec"}`` into a ``GraphMixerEncoder`` and a
    LinkPredictor, in place."""
    enc = params["enc"]["params"]
    _time2vec(encoder.time_encoder, enc["Time2Vec_0"])
    _dense(encoder.link_proj, enc["Dense_0"])
    _dense(encoder.output_layer, enc["Dense_1"])
    _mixers(encoder.mixers, enc, "MLPMixer_")
    _head(decoder, params["dec"])


@torch.no_grad()
def load_tpnet_params(params: Mapping[str, Any], encoder: nn.Module, decoder: nn.Module) -> None:
    """Copy the flax tree ``{"enc", "dec"}`` into a TPNet and a LinkPredictor
    or NodePredictor, in place."""
    enc = params["enc"]["params"]
    _time2vec(encoder.time_encoder, enc["time_encoder"])
    _dense(encoder.proj_hidden, enc["proj_hidden"])
    _dense(encoder.proj_out, enc["proj_out"])
    _mixers(encoder.mlp_mixers, enc, "mlp_mixers_")
    rp = encoder.random_projections
    if (rp is None) != ("random_projections" not in enc):
        raise ValueError("the encoder and the tree disagree on random projections")
    if rp is not None:
        _dense(rp.fc1, enc["random_projections"]["Dense_0"])
        _dense(rp.fc2, enc["random_projections"]["Dense_1"])
    _head(decoder, params["dec"])


def rp_state_from_numpy(projections: Any, now_time: Any, device: Any = "cpu"):
    """A JAX ``RandomProjectionState``'s two arrays as the port's state on
    ``device``: its layer 0 is a jax.random draw the port cannot repeat."""
    from .nn.encoder.tpnet import RandomProjectionState

    return RandomProjectionState(
        torch.tensor(np.asarray(projections, dtype=np.float32), device=device),
        torch.tensor(np.asarray(now_time, dtype=np.float32), device=device))


@torch.no_grad()
def load_ctan_params(params: Mapping[str, Any], encoder: nn.Module, decoder: nn.Module) -> None:
    """Copy the flax tree ``{"enc", "dec"}`` of the JAX CTAN example into a
    ``CTAN`` and a ``LinkPredictor``, in place."""
    enc = params["enc"]["params"]
    _time2vec(encoder.time_enc, enc["time_enc"])
    _dense(encoder.enc_x, enc["enc_x"])
    for i, name in enumerate(("lin_edge", "lin_query", "lin_key", "lin_value")):
        _dense(getattr(encoder.phi, name), enc["phi"][f"Dense_{i}"])
    _copy(encoder.W, enc["W"])
    _copy(encoder.b, enc["b"])
    _head(decoder, params["dec"])


@torch.no_grad()
def load_tncn_params(params: Mapping[str, Any], memory: nn.Module, encoder: nn.Module,
                     decoder: nn.Module) -> None:
    """Copy the flax tree ``{"mem", "enc", "dec"}`` of the JAX TNCN example
    into a ``TGNMemory``, a ``GraphAttentionEmbedding`` and an
    ``NCNPredictor``, in place."""
    load_tgn_memory_params(params["mem"], memory)
    _tgn_encoder(encoder, params["enc"]["params"])
    mlp = params["dec"]["params"]["xsmlp"]
    _dense(decoder.xsmlp[0], mlp["layers_0"])
    _dense(decoder.xsmlp[2], mlp["layers_2"])


def _snapshot_head(decoder: nn.Module, params: Mapping[str, Any]) -> None:
    """The link examples' ``"dec"``, or the node and graph examples' ``"head"``."""
    _head(decoder, params["dec"] if "dec" in params else params["head"])


def _gcn_conv(conv: nn.Module, p: Mapping[str, Any]) -> None:
    _dense(conv.lin, p["Dense_0"])
    _copy(conv.bias, p["bias"])


def _cheb_conv(conv: nn.Module, p: Mapping[str, Any]) -> None:
    n_tree = sum(1 for k in p if k.startswith("lin_"))
    if n_tree != len(conv.lins):
        raise ValueError(f"the ChebConv has K = {len(conv.lins)}, the tree {n_tree}")
    for k, lin in enumerate(conv.lins):
        _dense(lin, p[f"lin_{k}"])
    _copy(conv.bias, p["bias"])


@torch.no_grad()
def load_flax_gru_cell(p: Mapping[str, Any], cell: nn.GRUCell) -> None:
    """Copy a flax ``GRUCell``'s parameters (``ir``, ``iz``, ``in``, ``hr``,
    ``hz``, ``hn``) into a ``torch.nn.GRUCell`` (or ``TorchGRUCell``), in
    place. Flax's hidden reset and update Denses have no bias, so
    ``bias_hh`` is [0, 0, b_hn]."""
    kernel = lambda names: np.concatenate([np.asarray(p[n]["kernel"], np.float32)
                                           for n in names], axis=1)
    H = cell.hidden_size
    _copy(cell.weight_ih, kernel(("ir", "iz", "in")), transpose=True)
    _copy(cell.weight_hh, kernel(("hr", "hz", "hn")), transpose=True)
    _copy(cell.bias_ih, np.concatenate([np.asarray(p[n]["bias"], np.float32)
                                        for n in ("ir", "iz", "in")]))
    _copy(cell.bias_hh, np.concatenate([np.zeros(2 * H, np.float32),
                                        np.asarray(p["hn"]["bias"], np.float32)]))


@torch.no_grad()
def load_gcn_params(params: Mapping[str, Any], encoder: nn.Module, decoder: nn.Module) -> None:
    """Copy the flax tree ``{"enc", "dec" or "head"}`` into a ``GCN`` and its
    head, in place."""
    enc = params["enc"]["params"]
    n_tree = sum(1 for k in enc if k.startswith("GCNConv_"))
    if n_tree != len(encoder.convs):
        raise ValueError(f"encoder has {len(encoder.convs)} layers, the tree {n_tree}")
    for i, conv in enumerate(encoder.convs):
        _gcn_conv(conv, enc[f"GCNConv_{i}"])
    _snapshot_head(decoder, params)


@torch.no_grad()
def load_tgcn_params(params: Mapping[str, Any], encoder: nn.Module, decoder: nn.Module) -> None:
    """Copy the flax tree ``{"enc", "dec" or "head"}`` into a ``TGCN`` and its
    head, in place."""
    enc = params["enc"]["params"]
    for g in ("u", "r", "c"):
        _gcn_conv(getattr(encoder, f"conv_{g}"), enc[f"conv_{g}"])
        _dense(getattr(encoder, f"linear_{g}"), enc[f"linear_{g}"])
    _snapshot_head(decoder, params)


@torch.no_grad()
def load_gclstm_params(params: Mapping[str, Any], encoder: nn.Module,
                       decoder: nn.Module) -> None:
    """Copy the flax tree ``{"enc", "dec" or "head"}`` into a ``GCLSTM`` and
    its head, in place."""
    enc = params["enc"]["params"]
    for g in ("i", "f", "c", "o"):
        _copy(getattr(encoder, f"W_{g}"), enc[f"W_{g}"])
        _copy(getattr(encoder, f"b_{g}"), enc[f"b_{g}"])
        _cheb_conv(getattr(encoder, f"conv_{g}"), enc[f"conv_{g}"])
    _snapshot_head(decoder, params)


@torch.no_grad()
def load_roland_params(params: Mapping[str, Any], encoder: nn.Module,
                       decoder: nn.Module) -> None:
    """Copy the flax tree ``{"enc", "dec" or "head"}`` into a ``ROLAND`` (any
    update mechanism) and its head, in place."""
    enc = params["enc"]["params"]
    own = {"learnable": {"tau"}, "gru": {"gru1", "gru2"}, "mlp": {"mlp1", "mlp2"}}
    extra = set(enc) - {"conv1", "conv2"}
    if extra != own.get(encoder.update, set()):
        raise ValueError(f"the tree holds {sorted(extra)}, a ROLAND with update "
                         f"{encoder.update!r} {sorted(own.get(encoder.update, set()))}")
    _gcn_conv(encoder.conv1, enc["conv1"])
    _gcn_conv(encoder.conv2, enc["conv2"])
    if encoder.update == "learnable":
        _copy(encoder.tau, enc["tau"])
    elif encoder.update == "gru":
        load_flax_gru_cell(enc["gru1"], encoder.gru1)
        load_flax_gru_cell(enc["gru2"], encoder.gru2)
    elif encoder.update == "mlp":
        _dense(encoder.mlp1, enc["mlp1"])
        _dense(encoder.mlp2, enc["mlp2"])
    _snapshot_head(decoder, params)
