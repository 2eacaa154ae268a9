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
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

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


def load_vocoder_checkpoint(path: str) -> dict:
    """Load a vocoder checkpoint saved by the reference as a flat ``.npz``
    (keys ``a/b/c``) back into its nested ``{'params': tree}``."""
    if not path.endswith(".npz"):
        raise ValueError(
            f"only .npz vocoder checkpoints are read here, got {path!r}; "
            "convert torch checkpoints with the reference package first"
        )
    params: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = params
            *parents, leaf = key.split("/")
            for parent in parents:
                node = node.setdefault(parent, {})
            node[leaf] = flat[key]
    return {"params": params}
