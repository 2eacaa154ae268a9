"""Neural grapheme-to-phoneme model.

The reference's G2P is the pretrained *neural* SoundChoice model
(fastspeech2/util.py:20-27, ``speechbrain/soundchoice-g2p``).  This module is
the rebuild's trained equivalent: a compact character-level transformer
encoder-decoder (2+2 layers, d=128) trained on the bundled pronunciation
lexicon plus its regular morphological expansions (tools/train_g2p.py).  It
slots into the G2P fallback chain *between* the lexicon/morphology lookup and
the rule LTS: lexicon -> morphology -> neural -> rules.

This copy holds the numpy forward only (inference): the text frontend is
host-side work on a ~1M-param model and needs no device.  The training-side
mirror of the same math lives in ``emotts/text/neural_g2p.py`` and reads the
same flat weight dict (``g2p_weights.npz``).  Everything is fp32 with
exact-erf GELU.
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from scipy.special import erf

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
