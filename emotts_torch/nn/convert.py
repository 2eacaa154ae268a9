"""Weights carried across from the reference (JAX/flax) package.

``fs2_from_flax``, ``rank_from_flax``, ``hifigan_from_flax`` and
``disc_from_flax`` take the reference's parameter trees as nested dicts of
numpy arrays and return ``state_dict``s for this package's modules;
``hifigan_to_flax`` goes the other way, for the ``.npz`` a trained vocoder
is exported to.  Nothing here imports the reference: a tree is plain data
(``jax.device_get`` of the variables, or the ``.npz`` a vocoder was saved to).

Layout rules:

* flax ``Conv`` kernel (k, in, out) → torch ``conv1d`` weight (out, in, k);
* flax ``Dense`` kernel (in, out) → ``Linear`` weight (out, in);
* attention ``DenseGeneral``: query/key/value kernel (d_model, H, D) →
  (H·D, d_model), bias (H, D) → (H·D,); out kernel (H, D, d_model) →
  (d_model, H·D);
* LayerNorm/BatchNorm ``scale`` → ``weight``; ``batch_stats`` mean/var →
  ``running_mean``/``running_var``;
* HiFi-GAN kernels keep the reference's (k, in, out) layout (transposed-conv
  kernels time-flipped as stored there); a ResBlock's per-dilation kernels
  are stacked into (n_d, k, C, C);
* discriminator kernels: MPD (5, 1, in, out) → (out, in, 5, 1), MSD
  (k, in/g, out) → (out, in/g, k), the groups contiguous on both sides.

``rank_params_from_torch`` and ``fs2_params_from_reference_torch`` import
checkpoints trained with the reference's own PyTorch code (its rank model's
and its SpeechBrain-built FastSpeech2's ``best_model.pth``): they return the
same flax-layout numpy trees as ``emotts/nn/convert.py``, which
``rank_from_flax`` / ``fs2_from_flax`` then turn into state_dicts.  There a
torch ``Linear`` weight (out, in) becomes a Dense kernel (in, out), a packed
``MultiheadAttention`` ``in_proj`` (3H, H) the per-head q/k/v kernels
(H, heads, head_dim) and ``out_proj`` (heads, head_dim, H), a ``Conv1d``
weight (out, in, k) a Conv kernel (k, in, out).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from emotts_torch.nn.hifigan import convert_torch_state_dict

_INDEXED = re.compile(r"^(layer|conv|norm|bn|conv_mid)_(\d+)$")
_PLURAL = {"layer": "layers", "conv": "convs", "norm": "norms", "bn": "bns",
           "conv_mid": "conv_mid"}


def _module_path(parts) -> str:
    out = []
    for part in parts:
        m = _INDEXED.match(part)
        out.append(f"{_PLURAL[m.group(1)]}.{m.group(2)}" if m else part)
    return ".".join(out)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))  # a copy: writable


def _walk(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``params`` tree of Dense/DenseGeneral/Conv/LayerNorm/Embed
    leaves → state_dict entries, by the layout rules above."""
    sd: Dict[str, torch.Tensor] = {}
    for path, a in _walk(params):
        *mods, leaf = path
        name = _module_path(mods)
        in_attn = len(mods) >= 2 and mods[-2] == "attn"
        if leaf == "kernel":
            if in_attn and mods[-1] in ("query", "key", "value"):
                w = a.reshape(a.shape[0], -1).T  # (d_model, H, D) → (H·D, d_model)
            elif in_attn and mods[-1] == "out":
                w = a.reshape(-1, a.shape[-1]).T  # (H, D, d_model) → (d_model, H·D)
            elif a.ndim == 3:
                w = a.transpose(2, 1, 0)  # conv (k, in, out) → (out, in, k)
            elif a.ndim == 2:
                w = a.T  # dense (in, out) → (out, in)
            else:
                raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
            sd[f"{name}.weight"] = _t(w)
        elif leaf == "bias":
            sd[f"{name}.bias"] = _t(a.reshape(-1))
        elif leaf in ("scale", "embedding"):
            sd[f"{name}.weight"] = _t(a)
        else:
            raise ValueError(f"unexpected parameter {'/'.join(path)}")
    return sd


def rank_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': tree}`` (or the bare tree) of the reference's RankModel
    → state_dict of :class:`emotts_torch.nn.intensity.RankModel`."""
    return _params_to_state_dict(variables.get("params", variables))


def fs2_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` of the reference's FastSpeech2
    → state_dict of :class:`emotts_torch.nn.fastspeech2.FastSpeech2`."""
    sd = _params_to_state_dict(variables["params"])
    for path, a in _walk(variables.get("batch_stats", {})):
        *mods, leaf = path
        name = _module_path(mods)
        if leaf not in ("mean", "var"):
            raise ValueError(f"unexpected statistic {'/'.join(path)}")
        sd[f"{name}.running_{leaf}"] = _t(a)
        sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd


def hifigan_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The reference's HiFi-GAN params tree (``{'params': tree}`` or the bare
    tree) → state_dict of :class:`emotts_torch.nn.hifigan.HiFiGANGenerator`."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {
        "conv_pre_kernel": _t(p["conv_pre_kernel"]),
        "conv_pre_bias": _t(p["conv_pre_bias"]),
        "conv_post_kernel": _t(p["conv_post_kernel"]),
        "conv_post_bias": _t(p["conv_post_bias"]),
    }
    n_ups = len([k for k in p if re.match(r"^up_\d+_kernel$", k)])
    n_kernels = len([k for k in p if re.match(r"^resblock_0_\d+$", k)])
    for i in range(n_ups):
        sd[f"up_kernels.{i}"] = _t(p[f"up_{i}_kernel"])
        sd[f"up_biases.{i}"] = _t(p[f"up_{i}_bias"])
        for j in range(n_kernels):
            block = p[f"resblock_{i}_{j}"]
            n_d = len([k for k in block if re.match(r"^convs1_\d+_kernel$", k)])
            base = f"resblocks.{i * n_kernels + j}"
            for conv, w_name, b_name in (("convs1", "w1", "b1"),
                                         ("convs2", "w2", "b2")):
                sd[f"{base}.{w_name}"] = _t(np.stack(
                    [np.asarray(block[f"{conv}_{d}_kernel"]) for d in range(n_d)]
                ))
                sd[f"{base}.{b_name}"] = _t(np.stack(
                    [np.asarray(block[f"{conv}_{d}_bias"]) for d in range(n_d)]
                ))
    return sd


def hifigan_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """A :class:`emotts_torch.nn.hifigan.HiFiGANGenerator` state_dict → the
    reference's ``{'params': tree}`` of numpy arrays (the inverse of
    :func:`hifigan_from_flax`)."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    p = {k: sd[k] for k in ("conv_pre_kernel", "conv_pre_bias",
                            "conv_post_kernel", "conv_post_bias")}
    n_ups = len([k for k in sd if k.startswith("up_kernels.")])
    n_blocks = len({k.split(".")[1] for k in sd if k.startswith("resblocks.")})
    n_kernels = n_blocks // n_ups
    for i in range(n_ups):
        p[f"up_{i}_kernel"] = sd[f"up_kernels.{i}"]
        p[f"up_{i}_bias"] = sd[f"up_biases.{i}"]
        for j in range(n_kernels):
            base = f"resblocks.{i * n_kernels + j}"
            block = p[f"resblock_{i}_{j}"] = {}
            for conv, w_name, b_name in (("convs1", "w1", "b1"),
                                         ("convs2", "w2", "b2")):
                for d, (w, b) in enumerate(zip(sd[f"{base}.{w_name}"],
                                               sd[f"{base}.{b_name}"])):
                    block[f"{conv}_{d}_kernel"] = w
                    block[f"{conv}_{d}_bias"] = b
    return {"params": p}


def disc_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The reference trainer's discriminator tree ``{'mpd': {'params': …},
    'msd': {'params': …}}`` (a gradient tree of the same shape too) →
    state_dict of :class:`emotts_torch.nn.hifigan_disc.Discriminators`."""
    sd: Dict[str, torch.Tensor] = {}
    for part, sub in (("mpd", "period_"), ("msd", "scale_")):
        tree = variables[part]
        for path, a in _walk(tree.get("params", tree)):
            name, conv, leaf = path
            if not (name.startswith(sub) and conv.startswith("Conv_")):
                raise ValueError(f"unexpected parameter {part}/{'/'.join(path)}")
            key = f"{part}.discriminators.{name}.convs.{conv[5:]}"
            if leaf == "kernel":
                w = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.transpose(2, 1, 0)
                sd[f"{key}.weight"] = _t(w)
            elif leaf == "bias":
                sd[f"{key}.bias"] = _t(a)
            else:
                raise ValueError(f"unexpected parameter {part}/{'/'.join(path)}")
    return sd


# ---------------------------------------------------------------------------
# Reference (PyTorch) checkpoints → the flax-layout trees above
# ---------------------------------------------------------------------------


def _dense(sd, prefix):
    return {
        "kernel": np.asarray(sd[f"{prefix}.weight"]).T,
        "bias": np.asarray(sd[f"{prefix}.bias"]),
    }


def _conv(sd, prefix):
    return {
        "kernel": np.transpose(np.asarray(sd[f"{prefix}.weight"]), (2, 1, 0)),
        "bias": np.asarray(sd[f"{prefix}.bias"]),
    }


def _layernorm(sd, prefix):
    return {
        "scale": np.asarray(sd[f"{prefix}.weight"]),
        "bias": np.asarray(sd[f"{prefix}.bias"]),
    }


def _attention(sd, prefix, n_heads: int) -> Dict:
    w_in = np.asarray(sd[f"{prefix}.in_proj_weight"])  # (3H, H)
    b_in = np.asarray(sd[f"{prefix}.in_proj_bias"])  # (3H,)
    h3, hidden = w_in.shape
    if h3 != 3 * hidden:
        raise ValueError(f"{prefix}.in_proj_weight has shape {w_in.shape}, "
                         "not (3H, H)")
    d = hidden // n_heads

    def split(mat, vec, i):
        w = mat[i * hidden:(i + 1) * hidden]  # (H, H): out × in
        b = vec[i * hidden:(i + 1) * hidden]
        return {
            "kernel": w.T.reshape(hidden, n_heads, d),
            "bias": b.reshape(n_heads, d),
        }

    w_out = np.asarray(sd[f"{prefix}.out_proj.weight"])  # (H, H)
    b_out = np.asarray(sd[f"{prefix}.out_proj.bias"])
    return {
        "query": split(w_in, b_in, 0),
        "key": split(w_in, b_in, 1),
        "value": split(w_in, b_in, 2),
        "out": {"kernel": w_out.T.reshape(n_heads, d, hidden), "bias": b_out},
    }


def rank_params_from_torch(sd: Mapping, n_layers: int, n_heads: int) -> Dict:
    """The reference rank model's state_dict (``intensity_extractor.{
    input_proj, fft_block.layers.N.{self_attn, conv1, conv2, norm1, norm2},
    emotion_embedding, classifier}`` and ``projector``, numpy values) →
    ``{'params': tree}`` of the RankModel."""
    ext = "intensity_extractor"
    fft = {}
    for i in range(n_layers):
        layer = f"{ext}.fft_block.layers.{i}"
        fft[f"layer_{i}"] = {
            "attn": _attention(sd, f"{layer}.self_attn", n_heads),
            "ffn": {
                "conv1": _conv(sd, f"{layer}.conv1"),
                "conv2": _conv(sd, f"{layer}.conv2"),
            },
            "norm1": _layernorm(sd, f"{layer}.norm1"),
            "norm2": _layernorm(sd, f"{layer}.norm2"),
        }
    params = {
        "intensity_extractor": {
            "input_proj": _dense(sd, f"{ext}.input_proj"),
            "fft": fft,
            "emotion_embedding": {
                "embedding": np.asarray(sd[f"{ext}.emotion_embedding.weight"])
            },
            "classifier": _dense(sd, f"{ext}.classifier"),
        },
        "projector": {"kernel": np.asarray(sd["projector.weight"]).T},
    }
    return {"params": params}


# The reference FastSpeech2 is assembled from SpeechBrain wrapper modules whose
# keys differ from plain torch: ``linear.Linear`` stores its layer as ``.w``,
# ``CNN.Conv1d`` as ``.conv``, ``Embedding`` as ``.Embedding``, a Transformer
# layer's attention as ``self_att.att`` and its 1dcnn feed-forward as
# ``pos_ffn.{0,2}``; LayerNorms appear both as the wrapper (``.norm.weight``)
# and as plain ``nn.LayerNorm`` (``.weight``).  Every lookup accepts both
# spellings.  The imported weights run in the compat architecture
# (``fastspeech2.prenet_style: embedding``, ``postnet_style: speechbrain``).


def _get(sd: Mapping, *candidates: str) -> np.ndarray:
    for c in candidates:
        if c in sd:
            return np.asarray(sd[c])
    raise KeyError(
        f"none of {candidates} in checkpoint (have e.g. {sorted(sd)[:8]} ...)"
    )


def _sb_conv(sd, p):
    w = _get(sd, f"{p}.conv.weight", f"{p}.weight")  # (out, in, k)
    b = _get(sd, f"{p}.conv.bias", f"{p}.bias")
    return {"kernel": np.transpose(w, (2, 1, 0)), "bias": b}


def _sb_dense(sd, p, bias=True):
    out = {"kernel": _get(sd, f"{p}.w.weight", f"{p}.weight").T}
    if bias:
        out["bias"] = _get(sd, f"{p}.w.bias", f"{p}.bias")
    return out


def _sb_ln(sd, p):
    return {
        "scale": _get(sd, f"{p}.norm.weight", f"{p}.weight"),
        "bias": _get(sd, f"{p}.norm.bias", f"{p}.bias"),
    }


def _sb_embed(sd, p):
    return {"embedding": _get(sd, f"{p}.Embedding.weight", f"{p}.weight")}


def fs2_params_from_reference_torch(sd: Mapping, cfg) -> Dict:
    """The reference FastSpeech2's state_dict (numpy values) →
    ``{'params': tree, 'batch_stats': {}}`` of the compat FastSpeech2.

    ``cfg`` is the :class:`~emotts_torch.utils.config.FastSpeech2Config` the
    checkpoint was trained with (layer and head counts, PostNet depth)."""

    def attention(lp, n_heads):
        for cand in (f"{lp}.self_att.att", f"{lp}.self_attn", f"{lp}.self_att"):
            if f"{cand}.in_proj_weight" in sd:
                return _attention(sd, cand, n_heads)
        raise KeyError(f"no attention weights under {lp}")

    def fft_stack(prefix, n_layers, n_heads):
        out = {}
        for i in range(n_layers):
            lp = f"{prefix}.layers.{i}"
            out[f"layer_{i}"] = {
                "attn": attention(lp, n_heads),
                "ffn": {
                    "conv1": _sb_conv(sd, f"{lp}.pos_ffn.0"),
                    "conv2": _sb_conv(sd, f"{lp}.pos_ffn.2"),
                },
                "norm1": _sb_ln(sd, f"{lp}.norm1"),
                "norm2": _sb_ln(sd, f"{lp}.norm2"),
            }
        out["final_norm"] = _sb_ln(sd, f"{prefix}.norm")
        return out

    def predictor(prefix):
        return {
            "conv1": _sb_conv(sd, f"{prefix}.conv1"),
            "norm1": _sb_ln(sd, f"{prefix}.ln1"),
            "conv2": _sb_conv(sd, f"{prefix}.conv2"),
            "norm2": _sb_ln(sd, f"{prefix}.ln2"),
            "out": _sb_dense(sd, f"{prefix}.linear"),
        }

    postnet = {
        "conv_pre": _sb_conv(sd, "postnet.conv_pre"),
        "conv_post": _sb_conv(sd, "postnet.conv_post"),
        "ln1": _sb_ln(sd, "postnet.ln1"),
        "ln2": _sb_ln(sd, "postnet.ln2"),
        "ln3": _sb_ln(sd, "postnet.ln3"),
    }
    # "convs_intermedite" is SpeechBrain's own (misspelled) attribute name
    for i in range(cfg.postnet_n_convolutions - 2):
        for cand in (f"postnet.convs_intermedite.{i}",
                     f"postnet.convs_intermediate.{i}"):
            if f"{cand}.conv.weight" in sd or f"{cand}.weight" in sd:
                postnet[f"conv_mid_{i}"] = _sb_conv(sd, cand)
                break
        else:
            raise KeyError(f"postnet intermediate conv {i} not found")

    params = {
        "prenet": {
            "embed": {
                "embedding": _get(
                    sd,
                    "encPreNet.token_embedding.Embedding.weight",
                    "encPreNet.token_embedding.weight",
                    "encPreNet.embedding.weight",
                )
            }
        },
        "encoder": fft_stack("encoder", cfg.enc_num_layers, cfg.enc_num_head),
        "decoder": fft_stack("decoder", cfg.dec_num_layers, cfg.dec_num_head),
        "speaker_emb": _sb_embed(sd, "speaker_emb"),
        "concat_proj": _sb_dense(sd, "concat_proj", bias=False),
        "duration_predictor": predictor("durPred"),
        "pitch_predictor": predictor("pitchPred"),
        "energy_predictor": predictor("energyPred"),
        "pitch_embed": _sb_conv(sd, "pitchEmbed"),
        "energy_embed": _sb_conv(sd, "energyEmbed"),
        "mel_head": _sb_dense(sd, "linear"),
        "postnet": postnet,
    }
    return {"params": params, "batch_stats": {}}


def torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A reference ``best_model.pth`` (a state_dict, or one wrapped as
    ``{'state_dict': ...}``) as numpy arrays, read with ``weights_only``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return _numpy_values(sd)


def _numpy_values(sd: Mapping) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def load_vocoder_checkpoint(path: str) -> dict:
    """A vocoder checkpoint as the reference's nested ``{'params': tree}``:
    a flat ``.npz`` of converted params (keys ``a/b/c``), or a torch
    HiFi-GAN generator ``.pt``/``.pth`` (its state_dict, bare or as
    ``{'generator': sd}``), converted on the fly."""
    if not path.endswith(".npz"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "generator" in sd:
            sd = sd["generator"]
        return convert_torch_state_dict(_numpy_values(sd))
    params: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = params
            *parents, leaf = key.split("/")
            for parent in parents:
                node = node.setdefault(parent, {})
            node[leaf] = flat[key]
    return {"params": params}
