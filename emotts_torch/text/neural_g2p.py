"""Neural grapheme-to-phoneme model.

The reference's G2P is the pretrained *neural* SoundChoice model
(fastspeech2/util.py:20-27, ``speechbrain/soundchoice-g2p``).  This module is
the rebuild's trained equivalent: a compact character-level transformer
encoder-decoder (2+2 layers, d=128) trained on the bundled pronunciation
lexicon plus its regular morphological expansions (tools/train_g2p.py).  It
slots into the G2P fallback chain *between* the lexicon/morphology lookup and
the rule LTS: lexicon -> morphology -> neural -> rules.

Two forward implementations share one flat weight dict (the packaged
``g2p_weights.npz``):

* **numpy** (inference, default) — the text frontend is host-side work and
  needs no device; greedy decode of one word is milliseconds on a CPU.
* **PyTorch** (training and batched decode, ``G2PTransformer``,
  ``batched_greedy_decode``) — the same math batched over padded words, with
  dropout for training; ``emotts_torch/text/g2p_train.py`` trains it.

Everything is fp32 with exact-erf GELU (TF32 off on a GPU), so the two paths
agree up to the order of their sums.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from scipy.special import erf
from torch import nn

from emotts_torch.text.vocab import VALID_SYMBOLS

# ---------------------------------------------------------------------------
# Vocabularies (fixed; versioned inside the weights file)
# ---------------------------------------------------------------------------

CHARS = "abcdefghijklmnopqrstuvwxyz'"
CHAR_PAD = 0
_CHAR_TO_ID = {c: i + 1 for i, c in enumerate(CHARS)}
N_CHAR_TOKENS = len(CHARS) + 1  # + pad

PHON_PAD, PHON_BOS, PHON_EOS = 0, 1, 2
_PHONES = list(VALID_SYMBOLS)  # 84 ARPABET symbols incl. stress variants
_PHONE_TO_ID = {p: i + 3 for i, p in enumerate(_PHONES)}
_ID_TO_PHONE = {i + 3: p for i, p in enumerate(_PHONES)}
N_PHON_TOKENS = len(_PHONES) + 3

MAX_WORD_LEN = 28  # characters
MAX_PHON_LEN = 32  # phonemes incl. EOS

# the weights file is shared with the JAX package by path, not duplicated
BUNDLED_WEIGHTS = str(
    Path(__file__).resolve().parents[2] / "emotts" / "text" / "data"
    / "g2p_weights.npz"
)

# default architecture (tools/train_g2p.py can train other sizes; the
# shipped npz stores __n_heads__ and everything else derives from shapes)
D_MODEL = 128
N_HEADS = 4
D_FF = 512
N_ENC = 2
N_DEC = 2
_EPS = 1e-5


def arch_of(p: Dict[str, np.ndarray], n_heads: Optional[int] = None) -> dict:
    """Derive the transformer dimensions from a flat weight dict."""
    n_enc = sum(1 for k in p if k.endswith("_attn_wq"))
    n_dec = sum(1 for k in p if k.startswith("dec") and k.endswith("_self_wq"))
    return dict(
        d_model=p["char_emb"].shape[1],
        d_ff=p["enc0_ff1"].shape[1],
        n_enc=n_enc,
        n_dec=n_dec,
        n_heads=N_HEADS if n_heads is None else int(n_heads),
    )


def encode_word(word: str) -> Optional[np.ndarray]:
    """Word -> padded char-id array (MAX_WORD_LEN,), or None if unencodable."""
    word = word.lower()
    if not word or len(word) > MAX_WORD_LEN:
        return None
    ids = np.zeros(MAX_WORD_LEN, dtype=np.int32)
    for i, ch in enumerate(word):
        cid = _CHAR_TO_ID.get(ch)
        if cid is None:
            return None
        ids[i] = cid
    return ids


def encode_phonemes(phones: List[str]) -> Optional[np.ndarray]:
    """Phoneme list -> decoder target ids ``[p1..pn, EOS, pad...]``."""
    if not phones or len(phones) + 1 > MAX_PHON_LEN:
        return None
    ids = np.zeros(MAX_PHON_LEN, dtype=np.int32)
    for i, p in enumerate(phones):
        pid = _PHONE_TO_ID.get(p)
        if pid is None:
            return None
        ids[i] = pid
    ids[len(phones)] = PHON_EOS
    return ids


def decode_phoneme_ids(ids) -> List[str]:
    out: List[str] = []
    for i in ids:
        i = int(i)
        if i == PHON_EOS or i == PHON_PAD:
            break
        if i in _ID_TO_PHONE:
            out.append(_ID_TO_PHONE[i])
    return out


# ---------------------------------------------------------------------------
# numpy forward (inference path)
# ---------------------------------------------------------------------------


def _ln(x, g, b):
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + _EPS) * g + b


def _gelu(x):
    return 0.5 * x * (1.0 + erf(x / np.sqrt(2.0).astype(x.dtype)))


def _attn(q_x, kv_x, p, pre, mask, n_heads=N_HEADS):
    """Multi-head attention.  q_x (Tq,D), kv_x (Tk,D); mask (Tq,Tk) additive."""
    q = q_x @ p[pre + "wq"]
    k = kv_x @ p[pre + "wk"]
    v = kv_x @ p[pre + "wv"]
    d_model = q.shape[-1]
    dh = d_model // n_heads
    tq, tk = q.shape[0], k.shape[0]
    q = q.reshape(tq, n_heads, dh).transpose(1, 0, 2)
    k = k.reshape(tk, n_heads, dh).transpose(1, 0, 2)
    v = v.reshape(tk, n_heads, dh).transpose(1, 0, 2)
    s = q @ k.transpose(0, 2, 1) / np.sqrt(np.float32(dh)) + mask
    s = s - s.max(-1, keepdims=True)
    a = np.exp(s)
    a = a / a.sum(-1, keepdims=True)
    o = (a @ v).transpose(1, 0, 2).reshape(tq, d_model)
    return o @ p[pre + "wo"]


def _enc_layer(x, p, pre, pad_mask, n_heads=N_HEADS):
    h = _ln(x, p[pre + "ln1_g"], p[pre + "ln1_b"])
    x = x + _attn(h, h, p, pre + "attn_", pad_mask, n_heads)
    h = _ln(x, p[pre + "ln2_g"], p[pre + "ln2_b"])
    return x + _gelu(h @ p[pre + "ff1"]) @ p[pre + "ff2"]


def _dec_layer(x, enc, p, pre, causal_mask, enc_pad_mask, n_heads=N_HEADS):
    h = _ln(x, p[pre + "ln1_g"], p[pre + "ln1_b"])
    x = x + _attn(h, h, p, pre + "self_", causal_mask, n_heads)
    h = _ln(x, p[pre + "ln2_g"], p[pre + "ln2_b"])
    x = x + _attn(h, enc, p, pre + "cross_", enc_pad_mask, n_heads)
    h = _ln(x, p[pre + "ln3_g"], p[pre + "ln3_b"])
    return x + _gelu(h @ p[pre + "ff1"]) @ p[pre + "ff2"]


def _np_encode(p: Dict[str, np.ndarray], char_ids: np.ndarray,
               n_heads=N_HEADS):
    t = int((char_ids != CHAR_PAD).sum())
    ids = char_ids[:t]
    x = p["char_emb"][ids] + p["char_pos"][:t]
    pad_mask = np.zeros((t, t), dtype=np.float32)
    for i in range(arch_of(p, n_heads)["n_enc"]):
        x = _enc_layer(x, p, f"enc{i}_", pad_mask, n_heads)
    return _ln(x, p["enc_ln_g"], p["enc_ln_b"])


def _np_step_logits(p, enc, prev: List[int], n_heads=N_HEADS) -> np.ndarray:
    """Next-token logits for one decoder prefix (numpy)."""
    t = len(prev)
    x = p["phon_emb"][np.array(prev)] + p["phon_pos"][:t]
    causal = np.triu(np.full((t, t), -1e9, dtype=np.float32), k=1)
    enc_mask = np.zeros((t, enc.shape[0]), dtype=np.float32)
    for i in range(arch_of(p, n_heads)["n_dec"]):
        x = _dec_layer(x, enc, p, f"dec{i}_", causal, enc_mask, n_heads)
    x = _ln(x, p["dec_ln_g"], p["dec_ln_b"])
    return x[-1] @ p["out_proj"]


def np_greedy_decode(p: Dict[str, np.ndarray], char_ids: np.ndarray,
                     n_heads: int = N_HEADS) -> List[int]:
    """Greedy autoregressive decode (numpy).  Returns phoneme ids (no EOS)."""
    enc = _np_encode(p, char_ids, n_heads)
    out: List[int] = []
    prev = [PHON_BOS]
    for step in range(MAX_PHON_LEN):
        nxt = int(np.argmax(_np_step_logits(p, enc, prev, n_heads)))
        if nxt == PHON_EOS or nxt == PHON_PAD:
            break
        out.append(nxt)
        prev.append(nxt)
    return out


def _log_softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max()
    return x - np.log(np.exp(x).sum())


def np_ensemble_greedy_decode(
    ps: List[Dict[str, np.ndarray]], char_ids: np.ndarray,
    n_heads: "Optional[List[int]]" = None,
) -> List[int]:
    """Greedy decode under the average of the members' per-step log-probs.

    Product-of-experts over independently-initialized members (mixed
    architectures allowed — ``n_heads`` per member); degenerates to
    ``np_greedy_decode`` for a single member (argmax of one log-softmax
    is the argmax of its logits)."""
    heads = n_heads or [N_HEADS] * len(ps)
    encs = [_np_encode(p, char_ids, h) for p, h in zip(ps, heads)]
    out: List[int] = []
    prev = [PHON_BOS]
    for step in range(MAX_PHON_LEN):
        logp = sum(
            _log_softmax(_np_step_logits(p, enc, prev, h))
            for p, enc, h in zip(ps, encs, heads)
        )
        nxt = int(np.argmax(logp))
        if nxt == PHON_EOS or nxt == PHON_PAD:
            break
        out.append(nxt)
        prev.append(nxt)
    return out


def np_beam_decode(
    p: Dict[str, np.ndarray], char_ids: np.ndarray, beam: int = 4,
    n_heads: int = N_HEADS,
) -> List[int]:
    """Length-normalized beam search (numpy).  Returns phoneme ids (no EOS)."""
    enc = _np_encode(p, char_ids, n_heads)
    # (prefix, logprob, done)
    beams = [([PHON_BOS], 0.0, False)]
    for step in range(MAX_PHON_LEN):
        if all(d for _, _, d in beams):
            break
        cand = []
        for prefix, lp, done in beams:
            if done:
                cand.append((prefix, lp, True))
                continue
            logits = _np_step_logits(p, enc, prefix, n_heads)
            logits = logits - logits.max()
            logp = logits - np.log(np.exp(logits).sum())
            top = np.argsort(logp)[-beam:]
            for tok in top:
                tok = int(tok)
                if tok == PHON_PAD:
                    continue
                cand.append((prefix + [tok], lp + float(logp[tok]),
                             tok == PHON_EOS))
        # keep top `beam` by length-normalized score (EOS counts in length)
        cand.sort(key=lambda c: c[1] / max(1, len(c[0]) - 1), reverse=True)
        beams = cand[:beam]
    best = max(beams, key=lambda c: c[1] / max(1, len(c[0]) - 1))
    seq = best[0][1:]  # drop BOS
    if seq and seq[-1] == PHON_EOS:
        seq = seq[:-1]
    return seq


# ---------------------------------------------------------------------------
# PyTorch forward (training + batched decode)
# ---------------------------------------------------------------------------


def g2p_device(device) -> torch.device:
    """The device a G2P entry point runs on (``resolve_device``: CUDA unless
    the caller asks for the CPU, and never elsewhere than asked).  On a GPU
    fp32 stays fp32 (TF32 off), as the numpy path computes."""
    from emotts_torch.train.rank_trainer import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def _keep_mask(shape, rate: float, generator: torch.Generator,
               device) -> torch.Tensor:
    """One dropout site's keep mask: True with probability ``1 − rate``,
    drawn from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def _embed(table, ids):
    """``table[ids]`` as a one-hot product: the same values, and a backward
    that is a product too.  Indexing's backward adds the rows of repeated
    ids with a serial kernel on a GPU (9.3 of a step's 35.9 device ms at the
    bundled size, ``PERF.md`` §6, PR 13); ``F.embedding``'s is as fast but
    not bit-reproducible from run to run."""
    return F.one_hot(ids.long(), table.shape[0]).to(table.dtype) @ table


def _ln_t(x, g, b):
    """The numpy path's ``_ln``: biased variance, ``_EPS`` inside the root."""
    return F.layer_norm(x, x.shape[-1:], g, b, _EPS)


def g2p_forward(p: Mapping[str, torch.Tensor], char_ids: torch.Tensor,
                phon_in: torch.Tensor, n_heads: int = N_HEADS, *,
                dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Teacher-forced logits, batched: char_ids (B, Tw), phon_in (B, Tp)
    (BOS-shifted) → (B, Tp, N_PHON_TOKENS).  Counterpart of
    ``emotts/text/neural_g2p.py::jax_forward`` over a dict of tensors of the
    flat weight layout: pre-LN encoder and decoder (LayerNorm with biased
    variance, as the mirror's), the additive −1e9 mask
    of padded characters in the encoder's self-attention and the decoder's
    cross-attention, a causal mask on the decoder's self-attention.

    Dropout (``dropout_rate`` > 0 and a ``generator``) sits at the mirror's
    seven sites — both embeddings, the attention probabilities, each
    attention output and the FFN's GELU output and output before their
    residual adds — and scales kept entries by ``1 / (1 − rate)``.  The masks
    come from ``generator``; their bits are not ``jax.random``'s."""
    arch = arch_of(p, n_heads)
    d_model = arch["d_model"]
    dh = d_model // n_heads
    dropping = dropout_rate > 0.0 and generator is not None

    def drop(x):
        if not dropping:
            return x
        keep = _keep_mask(x.shape, dropout_rate, generator, x.device)
        return torch.where(keep, x / (1.0 - dropout_rate), 0.0)

    def attn(q_x, kv_x, pre, mask):
        b, tq, tk = q_x.shape[0], q_x.shape[1], kv_x.shape[1]
        q = (q_x @ p[pre + "wq"]).view(b, tq, n_heads, dh).transpose(1, 2)
        k = (kv_x @ p[pre + "wk"]).view(b, tk, n_heads, dh).transpose(1, 2)
        v = (kv_x @ p[pre + "wv"]).view(b, tk, n_heads, dh).transpose(1, 2)
        s = q @ k.transpose(-1, -2) / math.sqrt(dh)
        a = drop(torch.softmax(s + mask, dim=-1))
        o = (a @ v).transpose(1, 2).reshape(b, tq, d_model)
        return o @ p[pre + "wo"]

    def ffn(x, pre):
        h = drop(F.gelu(x @ p[pre + "ff1"], approximate="none"))
        return h @ p[pre + "ff2"]

    char_pad = torch.where(char_ids == CHAR_PAD, -1e9, 0.0).to(
        p["char_emb"].dtype)[:, None, None, :]
    tw = char_ids.shape[1]
    x = drop(_embed(p["char_emb"], char_ids) + p["char_pos"][:tw])
    for i in range(arch["n_enc"]):
        pre = f"enc{i}_"
        h = _ln_t(x, p[pre + "ln1_g"], p[pre + "ln1_b"])
        x = x + drop(attn(h, h, pre + "attn_", char_pad))
        h = _ln_t(x, p[pre + "ln2_g"], p[pre + "ln2_b"])
        x = x + drop(ffn(h, pre))
    enc = _ln_t(x, p["enc_ln_g"], p["enc_ln_b"])

    tp = phon_in.shape[1]
    causal = torch.triu(torch.full((tp, tp), -1e9, dtype=enc.dtype,
                                   device=enc.device), diagonal=1)
    y = drop(_embed(p["phon_emb"], phon_in) + p["phon_pos"][:tp])
    for i in range(arch["n_dec"]):
        pre = f"dec{i}_"
        h = _ln_t(y, p[pre + "ln1_g"], p[pre + "ln1_b"])
        y = y + drop(attn(h, h, pre + "self_", causal))
        h = _ln_t(y, p[pre + "ln2_g"], p[pre + "ln2_b"])
        y = y + drop(attn(h, enc, pre + "cross_", char_pad))
        h = _ln_t(y, p[pre + "ln3_g"], p[pre + "ln3_b"])
        y = y + drop(ffn(h, pre))
    y = _ln_t(y, p["dec_ln_g"], p["dec_ln_b"])
    return y @ p["out_proj"]


class G2PTransformer(nn.Module):
    """The G2P transformer as a module for training: its parameters, in
    ``params``, are keyed by the flat weight names of ``g2p_weights.npz``
    (``char_emb``, ``enc0_attn_wq``, …), so weights cross between the two
    by name alone (:meth:`from_flat`, :meth:`to_flat`).  Depth and widths
    follow the weights (``arch_of``); ``n_heads`` is the file's
    ``__n_heads__``."""

    def __init__(self, params: Mapping[str, torch.Tensor], n_heads: int = N_HEADS):
        super().__init__()
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in params.items()})
        self.n_heads = int(n_heads)

    @classmethod
    def from_flat(cls, p: Mapping[str, np.ndarray], n_heads: int = N_HEADS,
                  device="cuda") -> "G2PTransformer":
        device = g2p_device(device)
        return cls({k: torch.tensor(np.asarray(v, np.float32), device=device)
                    for k, v in p.items()}, n_heads)

    def to_flat(self) -> Dict[str, np.ndarray]:
        """The weights as a flat dict of fp32 numpy arrays (copies)."""
        return {k: v.detach().cpu().numpy().astype(np.float32, copy=True)
                for k, v in self.params.items()}

    def forward(self, char_ids: torch.Tensor, phon_in: torch.Tensor, *,
                dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return g2p_forward(self.params, char_ids, phon_in, self.n_heads,
                           dropout_rate=dropout_rate, generator=generator)


def _greedy_block(members: Sequence[Mapping[str, torch.Tensor]],
                  heads: Sequence[int], chars: torch.Tensor) -> torch.Tensor:
    """(B, MAX_PHON_LEN − 1) greedy ids for one block of words."""
    b = chars.shape[0]
    dec_in = torch.zeros((b, MAX_PHON_LEN), dtype=torch.long, device=chars.device)
    dec_in[:, 0] = PHON_BOS
    for t in range(MAX_PHON_LEN - 1):
        if len(members) == 1:
            # argmax of one log-softmax == argmax of its logits
            scores = g2p_forward(members[0], chars, dec_in, heads[0])[:, t]
        else:
            scores = sum(
                torch.log_softmax(g2p_forward(m, chars, dec_in, h)[:, t], dim=-1)
                for m, h in zip(members, heads))
        nxt = scores.argmax(-1)
        prev = dec_in[:, t]
        dead = (prev == PHON_EOS) | (prev == PHON_PAD)
        dec_in[:, t + 1] = torch.where(dead, PHON_PAD, nxt)
    return dec_in[:, 1:]


def batched_greedy_decode(
    members: Union[Mapping, Sequence[Mapping]],
    char_ids: np.ndarray,
    n_heads=None,
    *,
    device="cuda",
    chunk: int = 512,
) -> np.ndarray:
    """Batched greedy decode on ``device`` (eval tooling); counterpart of
    ``emotts/text/neural_g2p.py::jax_batched_greedy_decode``.

    ``members`` is one weight dict or a list of them (an ensemble: the argmax
    of the summed per-step log-softmaxes, as ``np_ensemble_greedy_decode``);
    ``n_heads`` one head count or one per member.  ``char_ids`` is
    (B, MAX_WORD_LEN).  Returns (B, MAX_PHON_LEN − 1) int32 ids with an
    EOS-then-PAD tail, ready for ``decode_phoneme_ids`` row by row.

    Each step re-runs the full teacher-forced forward on the growing prefix,
    as the JAX mirror does; a row whose previous token is EOS or PAD emits
    PAD.  Words go in chunks of ``min(B, chunk)``, the tail padded up and cut
    back.  The members' weights move to the device once per call."""
    device = g2p_device(device)
    if isinstance(members, Mapping):
        members = [members]
    heads = list(n_heads) if isinstance(n_heads, (list, tuple)) else (
        [n_heads or N_HEADS] * len(members))
    chars_np = np.asarray(char_ids, np.int64)
    n = chars_np.shape[0]
    if n == 0:
        return np.zeros((0, MAX_PHON_LEN - 1), np.int32)
    size = min(n, chunk)
    outs = []
    with torch.inference_mode():
        dev_members = [{k: torch.as_tensor(v, dtype=torch.float32, device=device)
                        for k, v in m.items()} for m in members]
        chars = torch.from_numpy(chars_np).to(device)
        for i in range(0, n, size):
            block = chars[i:i + size]
            pad = size - block.shape[0]
            if pad:
                block = F.pad(block, (0, 0, 0, pad))
            res = _greedy_block(dev_members, heads, block)
            outs.append(res[:size - pad].cpu().numpy())
    return np.concatenate(outs, axis=0).astype(np.int32)


def init_params(seed: int = 0, d_model: int = D_MODEL, d_ff: int = D_FF,
                n_enc: int = N_ENC, n_dec: int = N_DEC) -> Dict[str, np.ndarray]:
    """Fresh fp32 weight dict (numpy; framework-agnostic layout)."""
    rng = np.random.default_rng(seed)
    D_MODEL_, D_FF_ = d_model, d_ff

    def dense(n_in, n_out):
        return (rng.standard_normal((n_in, n_out)) / np.sqrt(n_in)).astype(np.float32)

    p: Dict[str, np.ndarray] = {
        "char_emb": (rng.standard_normal((N_CHAR_TOKENS, D_MODEL_)) * 0.02).astype(
            np.float32
        ),
        "char_pos": (rng.standard_normal((MAX_WORD_LEN, D_MODEL_)) * 0.02).astype(
            np.float32
        ),
        "phon_emb": (rng.standard_normal((N_PHON_TOKENS, D_MODEL_)) * 0.02).astype(
            np.float32
        ),
        "phon_pos": (rng.standard_normal((MAX_PHON_LEN, D_MODEL_)) * 0.02).astype(
            np.float32
        ),
        "enc_ln_g": np.ones(D_MODEL_, np.float32),
        "enc_ln_b": np.zeros(D_MODEL_, np.float32),
        "dec_ln_g": np.ones(D_MODEL_, np.float32),
        "dec_ln_b": np.zeros(D_MODEL_, np.float32),
        "out_proj": dense(D_MODEL_, N_PHON_TOKENS),
    }

    def add_attn(pre):
        for n in ("wq", "wk", "wv", "wo"):
            p[pre + n] = dense(D_MODEL_, D_MODEL_)

    for i in range(n_enc):
        pre = f"enc{i}_"
        add_attn(pre + "attn_")
        p[pre + "ff1"] = dense(D_MODEL_, D_FF_)
        p[pre + "ff2"] = dense(D_FF_, D_MODEL_)
        for j in (1, 2):
            p[pre + f"ln{j}_g"] = np.ones(D_MODEL_, np.float32)
            p[pre + f"ln{j}_b"] = np.zeros(D_MODEL_, np.float32)
    for i in range(n_dec):
        pre = f"dec{i}_"
        add_attn(pre + "self_")
        add_attn(pre + "cross_")
        p[pre + "ff1"] = dense(D_MODEL_, D_FF_)
        p[pre + "ff2"] = dense(D_FF_, D_MODEL_)
        for j in (1, 2, 3):
            p[pre + f"ln{j}_g"] = np.ones(D_MODEL_, np.float32)
            p[pre + f"ln{j}_b"] = np.zeros(D_MODEL_, np.float32)
    return p


# ---------------------------------------------------------------------------
# Inference wrapper
# ---------------------------------------------------------------------------


class NeuralG2P:
    """Greedy-decode wrapper over the packaged weights (numpy path).

    Returns ``None`` for words it cannot encode (non-alpha chars, too long)
    so the caller can fall through to the rule LTS.

    ``weights_path`` may name one weight file or several (an ensemble —
    independently-seeded members whose per-step log-probs are averaged;
    measured +N pts held-out word-exact over one member, tools/train_g2p.py).
    Any sibling ``<stem>.member*.npz`` files of the primary weights are
    picked up automatically, so shipping an ensemble is just dropping the
    member files next to ``g2p_weights.npz``.
    """

    def __init__(self, weights_path=BUNDLED_WEIGHTS, beam: int = 1):
        self.beam = max(1, int(beam))
        if isinstance(weights_path, (str, Path)):
            primary = Path(weights_path)
            paths = [primary] + sorted(
                primary.parent.glob(primary.stem + ".member*.npz")
            )
        else:
            paths = [Path(p) for p in weights_path]
        self.members: List[Dict[str, np.ndarray]] = []
        self.member_heads: List[int] = []
        for path in paths:
            data = np.load(path)
            if int(data["__version__"][0]) != 1:
                raise ValueError(f"unsupported g2p weights version in {path}")
            self.members.append({
                k: data[k].astype(np.float32)
                for k in data.files
                if not k.startswith("__")
            })
            self.member_heads.append(
                int(data["__n_heads__"][0])
                if "__n_heads__" in data.files else N_HEADS
            )
        self.params = self.members[0]  # single-member API compat
        self.n_heads = self.member_heads[0]
        # per-instance decode cache (a class-level @lru_cache would key on
        # self and pin every instance + its params for process lifetime)
        self._cache: "OrderedDict[str, Optional[tuple]]" = OrderedDict()
        self._cache_max = 4096

    @staticmethod
    def available(weights_path: str = BUNDLED_WEIGHTS) -> bool:
        return Path(weights_path).exists()

    def _decode_cached(self, word: str) -> Optional[tuple]:
        cache = self._cache
        if word in cache:
            cache.move_to_end(word)
            return cache[word]
        ids = encode_word(word)
        res: Optional[tuple] = None
        if ids is not None:
            if len(self.members) > 1:
                out = np_ensemble_greedy_decode(self.members, ids,
                                                self.member_heads)
            elif self.beam > 1:
                out = np_beam_decode(self.params, ids, beam=self.beam,
                                     n_heads=self.n_heads)
            else:
                out = np_greedy_decode(self.params, ids, self.n_heads)
            if out:
                res = tuple(decode_phoneme_ids(out))
        cache[word] = res
        if len(cache) > self._cache_max:
            cache.popitem(last=False)
        return res

    def word_to_phonemes(self, word: str) -> Optional[List[str]]:
        res = self._decode_cached(word.lower())
        return list(res) if res else None
