"""Train the neural G2P (emotts_torch/text/neural_g2p.py) on the bundled
lexicon, on the GPU; the counterpart of ``tools/train_g2p.py``.

The data is in-repo only: the curated lexicon plus regular morphological
expansions generated through the same voicing rules the runtime morphology
uses (emotts_torch/text/g2p.py), so the model learns both root
orthography->ARPABET patterns and the regular-inflection system.  The pairs,
their split and their order are the JAX tool's.

Held-out evaluation splits by BASE word (derived forms follow their base to
the same side) so there is no orthographic leakage, and reports the rule-LTS
baseline on the same split.

Run:
    python tools/train_g2p_torch.py --out g2p_weights.npz [--device cuda]

The dataset lives on the device and each step gathers its rows there; the
batches are the JAX tool's (the same host permutation stream), the learning
rate its warmup-cosine schedule, the optimizer its AdamW (weight decay 1e-4
on every parameter).  Dropout masks come from a generator seeded from
(init seed, step): a resumed run draws the same masks, though not the JAX
tool's bits.  The resume checkpoint (``<out>.resume.npz``) is this trainer's
own format: the JAX tool cannot read it, nor this trainer the JAX tool's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from emotts_torch.text import homograph
from emotts_torch.text import neural_g2p as ng
from emotts_torch.text.g2p import G2P, letter_to_sound
from emotts_torch.train.state import AdamW, warmup_cosine_lr

Pairs = List[Tuple[str, List[str]]]

# the JAX package, whose data (the bundled weights) this trainer never writes
_JAX_PACKAGE = Path(__file__).resolve().parents[2] / "emotts"


# ---------------------------------------------------------------------------
# Data: lexicon + morphological expansion
# ---------------------------------------------------------------------------


def _derived_forms(word: str):
    """Candidate regular inflections of ``word`` (orthography only)."""
    out = []
    sibilant_end = word.endswith(("s", "x", "z", "ch", "sh"))
    if word.endswith("y") and len(word) > 2 and word[-2] not in "aeiou":
        out += [word[:-1] + "ies", word[:-1] + "ied", word[:-1] + "ier",
                word[:-1] + "iest", word[:-1] + "ily"]
    elif sibilant_end:
        out.append(word + "es")
    else:
        out.append(word + "s")
    if word.endswith("e"):
        out += [word + "d", word[:-1] + "ing", word + "r", word + "st",
                word[:-1] + "able", word[:-1] + "ish"]
    else:
        out += [word + "ed", word + "ing", word + "er", word + "est",
                word + "able", word + "ish"]
    out += [word + "ly", word + "ness", word + "ful", word + "less",
            word + "ment", word + "hood", word + "ship"]
    out += ["un" + word, "re" + word, "non" + word, "dis" + word,
            "mis" + word, "over" + word, "under" + word, "out" + word,
            "pre" + word]
    return out


def build_pairs(seed: int = 0, holdout_frac: float = 0.1) -> Tuple[Pairs, Pairs]:
    """(train_pairs, eval_pairs) of (word, phoneme-list), split by base word."""
    g2p = G2P(neural=False)  # the lexicon and its morphology alone
    base_words = sorted(g2p.lexicon.keys())
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(base_words))
    n_eval = int(len(base_words) * holdout_frac)
    eval_bases = {base_words[i] for i in order[:n_eval]}

    train, evalp = [], []
    skipped = 0
    for w in base_words:
        pron = g2p.lexicon[w]
        bucket = evalp if w in eval_bases else train
        if ng.encode_word(w) is None or ng.encode_phonemes(pron) is None:
            skipped += 1
            continue
        bucket.append((w, list(pron)))
        for d in _derived_forms(w):
            if d in g2p.lexicon:
                continue  # real entry wins; avoid duplicate conflicting targets
            # homograph verb stems first: 'used'/'closed'/'recorded' must
            # train on the verb voicing/stress, not the noun default
            morph = homograph.resolve_word(d) or g2p._morph(d)
            if morph is None:
                continue
            if ng.encode_word(d) is None or ng.encode_phonemes(morph) is None:
                continue
            bucket.append((d, morph))

    def dedup(pairs):
        """Derived forms that several bases generate: the first wins."""
        seen, out = set(), []
        for w, p in pairs:
            if w in seen:
                continue
            seen.add(w)
            out.append((w, p))
        return out

    train, evalp = dedup(train), dedup(evalp)
    # a derived form whose surface appears on both sides leaks; drop from train
    eval_words = {w for w, _ in evalp}
    train = [(w, p) for w, p in train if w not in eval_words]
    print(f"pairs: train={len(train)} eval={len(evalp)} (skipped {skipped})")
    return train, evalp


def vectorize(pairs: Pairs):
    """(chars (n, MAX_WORD_LEN), decoder input, targets (n, MAX_PHON_LEN))
    int32; the decoder input is the targets shifted right behind BOS."""
    n = len(pairs)
    chars = np.zeros((n, ng.MAX_WORD_LEN), np.int32)
    targets = np.zeros((n, ng.MAX_PHON_LEN), np.int32)
    for i, (w, p) in enumerate(pairs):
        chars[i] = ng.encode_word(w)
        targets[i] = ng.encode_phonemes(p)
    dec_in = np.zeros_like(targets)
    dec_in[:, 0] = ng.PHON_BOS
    dec_in[:, 1:] = targets[:, :-1]
    return chars, dec_in, targets


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def g2p_loss(logits: torch.Tensor, targets: torch.Tensor,
             smoothing: float) -> torch.Tensor:
    """Label-smoothed cross-entropy ``(1−s)·nll + s·mean(−logp)`` over the
    tokens that are not PHON_PAD (EOS counts), divided by their number."""
    mask = (targets != ng.PHON_PAD).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    uni = -logp.mean(-1)
    ce = (1.0 - smoothing) * nll + smoothing * uni
    return (ce * mask).sum() / mask.sum()


def train_step(model: ng.G2PTransformer, opt: AdamW, chars: torch.Tensor,
               dec_in: torch.Tensor, targets: torch.Tensor, *,
               dropout_rate: float, smoothing: float,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """One update on a batch; the loss (on the device, not synchronized)."""
    logits = model(chars, dec_in, dropout_rate=dropout_rate, generator=generator)
    loss = g2p_loss(logits, targets, smoothing)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def step_seed(init_seed: int, step: int) -> int:
    """The dropout generator's seed at update ``step``: a function of
    (init_seed, step) alone, so a resumed run draws the same masks."""
    return int(np.random.SeedSequence([init_seed, step]).generate_state(1, np.uint64)[0])


_FINGERPRINT_KEYS = ("d_model", "d_ff", "layers", "heads", "batch", "epochs",
                     "lr", "dropout", "label_smoothing", "swa_frac", "holdout",
                     "seed", "init_seed")


def _run_fingerprint(args) -> str:
    """Hyperparameters the resume semantics depend on: model dims shape the
    weights; batch/epochs/lr/seeds position the restored step inside the LR
    schedule and the dropout and batch streams; the data flags pin the split
    the optimizer state was trained on."""
    return json.dumps({k: getattr(args, k) for k in _FINGERPRINT_KEYS},
                      sort_keys=True)


def _save_resume(path, model: ng.G2PTransformer, opt: AdamW, swa_sum,
                 epoch_done: int, it: int, swa_n: int, fingerprint: str = ""):
    """Persist the full training state (weights, AdamW's moments and count,
    the SWA sum) so a killed run restarts at the last finished epoch."""
    out = {"__fingerprint__": np.array(fingerprint),
           "__count__": np.array([opt.param_groups[0].get("count", 0)], np.int64),
           "__epoch_done__": np.array([epoch_done], np.int64),
           "__it__": np.array([it], np.int64),
           "__swa_n__": np.array([swa_n], np.int64)}
    for k, p in model.params.items():
        out[f"param.{k}"] = p.detach().cpu().numpy()
        for m in ("mu", "nu"):
            out[f"{m}.{k}"] = opt.state[p][m].cpu().numpy()
        if swa_sum is not None:
            out[f"swa.{k}"] = swa_sum[k].cpu().numpy()
    tmp = str(path) + ".tmp.npz"
    np.savez(tmp, **out)
    Path(tmp).replace(path)  # atomic: never a torn checkpoint at `path`
    print(f"[resume] checkpoint @ epoch {epoch_done} -> {path}", flush=True)


def _load_resume(path, model: ng.G2PTransformer, opt: AdamW, fingerprint: str = ""):
    """Inverse of :func:`_save_resume` into ``model`` and ``opt``; returns
    (swa_sum, epoch_done, it, swa_n).  Refuses a checkpoint whose
    hyperparameter fingerprint differs from the current run's: it would
    desync the LR schedule and the dropout and batch streams against the
    restored optimizer count, or not fit the model."""
    data = np.load(path)
    saved_fp = (str(data["__fingerprint__"])
                if "__fingerprint__" in data.files else None)
    if fingerprint and saved_fp and saved_fp != fingerprint:
        raise SystemExit(
            f"[resume] REFUSING {path}: it was written by a run with "
            f"different hyperparameters.\n  checkpoint: {saved_fp}\n"
            f"  this run:  {fingerprint}\n"
            "Delete the stale checkpoint or rerun with matching flags."
        )
    swa_sum = {} if "swa.char_emb" in data.files else None
    with torch.no_grad():
        for k, p in model.params.items():
            p.copy_(torch.from_numpy(data[f"param.{k}"]))
            opt.state[p] = {m: torch.from_numpy(data[f"{m}.{k}"]).to(
                p.device, opt.moment_dtype) for m in ("mu", "nu")}
            if swa_sum is not None:
                swa_sum[k] = torch.from_numpy(data[f"swa.{k}"]).to(p.device)
    for group in opt.param_groups:
        group["count"] = int(data["__count__"][0])
    return (swa_sum, int(data["__epoch_done__"][0]), int(data["__it__"][0]),
            int(data["__swa_n__"][0]))


def train(args, pairs: Optional[Tuple[Pairs, Pairs]] = None,
          history: Optional[list] = None):
    """Train per ``args`` (the tool's flags); returns (final weights, SWA
    weights or None, train_pairs, eval_pairs), weights as flat numpy dicts.

    ``pairs`` = (train_pairs, eval_pairs) in place of :func:`build_pairs`'s
    (a caller's subset; the tool never passes it).  Where ``history`` is a
    list, each epoch appends ``dict(epoch, losses, seconds)``: its per-step
    losses and its wall time up to its last loss on the host."""
    device = ng.g2p_device(args.device)
    # the SPLIT seed stays args.seed so ensemble members trained with
    # different --init-seed share one honest held-out set
    init_seed = args.seed if args.init_seed is None else args.init_seed
    if pairs is None:
        pairs = build_pairs(seed=args.seed, holdout_frac=args.holdout)
    train_pairs, eval_pairs = pairs
    chars, dec_in, targets = vectorize(train_pairs)
    n = len(chars)
    # the dataset lives on the device; a step gathers its rows there
    d_chars, d_dec_in, d_targets = (torch.from_numpy(a).long().to(device)
                                    for a in (chars, dec_in, targets))

    model = ng.G2PTransformer.from_flat(ng.init_params(
        init_seed, d_model=args.d_model, d_ff=args.d_ff,
        n_enc=args.layers, n_dec=args.layers), args.heads, device)
    steps_per_epoch = max(1, n // args.batch)
    total_steps = steps_per_epoch * args.epochs
    warmup = min(200, total_steps // 10)
    opt = AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4,
                lr_schedule=lambda k: warmup_cosine_lr(k, args.lr, warmup, total_steps))
    dropout_gen = torch.Generator(device=device)

    np_rng = np.random.default_rng(init_seed + 1)
    # stochastic weight averaging over the cosine tail: the averaged iterate
    # sits nearer the basin center than any single late-schedule point
    swa_start = int(args.epochs * (1.0 - args.swa_frac))
    swa_sum: Optional[Dict[str, torch.Tensor]] = None
    swa_n, start_epoch, it = 0, 0, 0
    resume_path = Path(args.out).with_suffix(".resume.npz")
    if args.resume_from or (args.checkpoint_every and resume_path.exists()):
        src = Path(args.resume_from) if args.resume_from else resume_path
        swa_sum, start_epoch, it, swa_n = _load_resume(
            src, model, opt, fingerprint=_run_fingerprint(args))
        # replay the host-side permutation stream so batch order continues
        # exactly where the killed run left off
        for _ in range(start_epoch):
            np_rng.permutation(n)
        print(f"[resume] continuing from {src} at epoch {start_epoch}/"
              f"{args.epochs} (it={it}, swa_n={swa_n})", flush=True)
    t0 = time.time()
    for epoch in range(start_epoch, args.epochs):
        t_epoch = time.perf_counter()
        perm = np_rng.permutation(n)[:steps_per_epoch * args.batch]
        idxs = torch.from_numpy(perm.reshape(steps_per_epoch, args.batch)).to(device)
        losses = torch.empty(steps_per_epoch, device=device)
        for k in range(steps_per_epoch):
            idx = idxs[k]
            dropout_gen.manual_seed(step_seed(init_seed, it))
            losses[k] = train_step(
                model, opt, d_chars[idx], d_dec_in[idx], d_targets[idx],
                dropout_rate=args.dropout, smoothing=args.label_smoothing,
                generator=dropout_gen)
            it += 1
        if args.swa_frac > 0 and epoch >= swa_start:
            with torch.no_grad():
                if swa_sum is None:
                    swa_sum = {k: v.detach().clone() for k, v in model.params.items()}
                else:
                    for k, v in model.params.items():
                        swa_sum[k] += v
            swa_n += 1
        if history is not None:
            ep = losses.cpu().numpy()
            history.append(dict(epoch=epoch, losses=ep,
                                seconds=time.perf_counter() - t_epoch))
        if (epoch + 1) % max(1, args.epochs // 12) == 0 or epoch == 0:
            ep_loss = float(losses.mean())
            print(f"epoch {epoch + 1:3d}/{args.epochs}  loss {ep_loss:.4f}"
                  f"  ({time.time() - t0:.0f}s)", flush=True)
        if args.checkpoint_every and (epoch + 1) % args.checkpoint_every == 0 \
                and epoch + 1 < args.epochs:
            _save_resume(resume_path, model, opt, swa_sum, epoch + 1, it, swa_n,
                         fingerprint=_run_fingerprint(args))

    np_params = model.to_flat()
    swa_params = None
    if swa_n > 0:
        swa_params = {k: (v / swa_n).cpu().numpy().astype(np.float32)
                      for k, v in swa_sum.items()}
    return np_params, swa_params, train_pairs, eval_pairs


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def _edit(a, b):
    m, k = len(a), len(b)
    d = np.arange(k + 1)
    for i in range(1, m + 1):
        prev, d[0] = d[0], i
        for j in range(1, k + 1):
            cur = min(d[j] + 1, d[j - 1] + 1,
                      prev + (a[i - 1] != b[j - 1]))
            prev, d[j] = d[j], cur
    return int(d[k])


def _strip(ps):
    return [p.rstrip("012") for p in ps]


def evaluate(np_params, pairs: Pairs, label: str, decode: str = "greedy",
             beam: int = 4, n_heads=ng.N_HEADS, device="cuda") -> dict:
    """np_params: one weight dict, or a list of dicts (ensemble decode —
    summed per-step log-probs).  For an ensemble, n_heads may be a
    per-member list.  Greedy (single or ensemble) runs batched on
    ``device``; beam search stays on the sequential numpy path."""
    members = np_params if isinstance(np_params, list) else None
    heads_list = (n_heads if isinstance(n_heads, list)
                  else [n_heads] * (len(members) if members else 1))
    batched_hyps = None
    if decode == "greedy":
        ids_all = np.stack([ng.encode_word(w) for w, _ in pairs])
        rows = ng.batched_greedy_decode(
            members if members is not None else np_params, ids_all,
            heads_list if members is not None else heads_list[0], device=device)
        batched_hyps = [ng.decode_phoneme_ids(r) for r in rows]
    exact = exact_ns = 0
    per_num = per_den = 0
    lts_exact = lts_per_num = 0
    for i, (w, ref) in enumerate(pairs):
        if batched_hyps is not None:
            hyp = batched_hyps[i]
        else:
            ids = ng.encode_word(w)
            if members is not None:
                out = ng.np_ensemble_greedy_decode(members, ids, heads_list)
            else:
                out = ng.np_beam_decode(np_params, ids, beam=beam,
                                        n_heads=heads_list[0])
            hyp = ng.decode_phoneme_ids(out)
        lts = letter_to_sound(w)
        exact += hyp == ref
        exact_ns += _strip(hyp) == _strip(ref)
        per_num += _edit(hyp, ref)
        per_den += len(ref)
        lts_exact += lts == ref
        lts_per_num += _edit(lts, ref)
    n = len(pairs)
    print(f"[{label}] n={n} decode={decode}")
    print(f"  neural: exact {exact / n:.3f}  exact(no-stress) {exact_ns / n:.3f}"
          f"  PER {per_num / per_den:.3f}")
    print(f"  rule LTS: exact {lts_exact / n:.3f}  PER {lts_per_num / per_den:.3f}")
    return dict(exact=exact / n, exact_ns=exact_ns / n, per=per_num / per_den,
                lts_exact=lts_exact / n, lts_per=lts_per_num / per_den)


def load_weights(path) -> Tuple[Dict[str, np.ndarray], int]:
    """A weight file's flat fp32 dict and its head count."""
    data = np.load(path)
    heads = (int(data["__n_heads__"][0]) if "__n_heads__" in data.files
             else ng.N_HEADS)
    return ({k: np.asarray(data[k], np.float32)
             for k in data.files if not k.startswith("__")}, heads)


def eval_ensemble(paths: Sequence[str], holdout: float = 0.1, seed: int = 0,
                  limit: Optional[int] = None, device="cuda"):
    """Evaluate 1..N trained member files and their ensemble on the SAME
    held-out split they were trained against (split is seed-derived, so all
    members must share --seed)."""
    members, heads = zip(*(load_weights(p) for p in paths))
    _, eval_pairs = build_pairs(seed=seed, holdout_frac=holdout)
    if limit:
        rng = np.random.default_rng(11)
        eval_pairs = [eval_pairs[i]
                      for i in rng.permutation(len(eval_pairs))[:limit]]
    for i, m in enumerate(members):
        evaluate(m, eval_pairs, f"member {i} ({paths[i]})", n_heads=heads[i],
                 device=device)
    if len(members) > 1:
        return evaluate(list(members), eval_pairs, f"ensemble x{len(members)}",
                        n_heads=list(heads), device=device)
    return None


def save_weights(np_params, path, n_heads: int, metrics: Optional[dict] = None):
    """The weight file both packages' ``NeuralG2P`` read (version 1), with
    the held-out metrics where given."""
    out = dict(np_params)
    out["__version__"] = np.array([1], np.int32)
    out["__n_heads__"] = np.array([n_heads], np.int32)
    if metrics is not None:
        out["__eval_exact__"] = np.array([metrics["exact"]], np.float32)
        out["__eval_per__"] = np.array([metrics["per"]], np.float32)
    path = str(path)
    np.savez_compressed(path, **out)
    if not path.endswith(".npz"):
        path += ".npz"  # np.savez appends the suffix if missing
    size = Path(path).stat().st_size / 1e6
    print(f"saved {path} ({size:.1f} MB)", flush=True)


# ---------------------------------------------------------------------------
# The tool
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    """``tools/train_g2p.py``'s flags and defaults, with ``--device`` and an
    ``--out`` in the working directory."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="device to train and decode on (default cuda; cpu "
                    "runs on the host, which takes hours at full size)")
    ap.add_argument("--eval-ensemble", default=None, metavar="NPZ[,NPZ...]",
                    help="skip training; evaluate these member files and "
                    "their log-prob-summed ensemble on the shared held-out "
                    "split")
    ap.add_argument("--eval-limit", type=int, default=None,
                    help="subsample the held-out set for --eval-ensemble")
    ap.add_argument("--out", default="g2p_weights.npz",
                    help="weight file to write (default g2p_weights.npz in "
                    "the working directory; never inside the emotts/ package)")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=ng.D_MODEL)
    ap.add_argument("--d-ff", type=int, default=ng.D_FF)
    ap.add_argument("--layers", type=int, default=ng.N_ENC,
                    help="encoder AND decoder layer count")
    ap.add_argument("--heads", type=int, default=ng.N_HEADS)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dropout", type=float, default=0.2)
    ap.add_argument("--label-smoothing", type=float, default=0.1)
    ap.add_argument("--holdout", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-seed", type=int, default=None,
                    help="weight-init/order seed (default: --seed); vary "
                    "this, not --seed, to train ensemble members that share "
                    "one held-out split")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="E",
                    help="save a full resume checkpoint (weights+optimizer+"
                    "SWA) every E epochs to <out>.resume.npz; a restart "
                    "with the same flags auto-resumes from it")
    ap.add_argument("--resume-from", default=None, metavar="NPZ",
                    help="explicit resume checkpoint (default: "
                    "<out>.resume.npz when --checkpoint-every is set and "
                    "the file exists)")
    ap.add_argument("--swa-frac", type=float, default=0.25,
                    help="average weights over the last FRAC of epochs")
    ap.add_argument("--final-eval-limit", type=int, default=None,
                    help="subsample the held-out set for the post-training "
                    "evaluation")
    ap.add_argument("--beam-eval", type=int, default=0, metavar="N",
                    help="also run the sequential numpy beam-4 eval on N "
                    "held-out words (default off; the batched greedy sweep "
                    "is the headline metric)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("train_g2p_torch: torch.cuda.is_available() is false; pass "
              "--device cpu to train on the host", file=sys.stderr)
        return 2
    if Path(args.out).resolve().is_relative_to(_JAX_PACKAGE):
        print(f"train_g2p_torch: --out {args.out} lies inside the emotts/ "
              "package, whose weight file this tool never writes",
              file=sys.stderr)
        return 2

    if args.eval_ensemble:
        eval_ensemble(args.eval_ensemble.split(","), holdout=args.holdout,
                      seed=args.seed, limit=args.eval_limit, device=args.device)
        return 0

    raw_params, swa_params, train_pairs, eval_pairs = train(args)

    def score(params, pairs, label, **kw):
        return evaluate(params, pairs, label, n_heads=args.heads,
                        device=args.device, **kw)

    # crash insurance: persist the final iterate before any evaluation — to a
    # DISTINCT path, so a run that dies mid-eval can never leave an
    # unevaluated artifact at args.out masquerading as a shipped model
    unevaluated = Path(args.out).with_suffix(".unevaluated.npz")
    save_weights(raw_params, unevaluated, args.heads)

    if args.final_eval_limit and len(eval_pairs) > args.final_eval_limit:
        sub_rng = np.random.default_rng(11)
        keep = sub_rng.permutation(len(eval_pairs))[: args.final_eval_limit]
        eval_pairs = [eval_pairs[i] for i in keep]
    rng = np.random.default_rng(9)
    sample = [train_pairs[i] for i in rng.permutation(len(train_pairs))[:800]]

    # pick the better of final-iterate vs SWA on a held-out subsample
    sub = eval_pairs[:: max(1, len(eval_pairs) // 1000)]
    cands = [("final", raw_params)]
    if swa_params is not None:
        cands.append(("swa", swa_params))
    scored = [(score(p, sub, f"held-out sub ({name})")["exact"], name, p)
              for name, p in cands]
    scored.sort(reverse=True, key=lambda s: s[0])
    _, best_name, np_params = scored[0]
    print(f"selected: {best_name}")

    score(np_params, sample, "train sample")
    metrics = score(np_params, eval_pairs, "held-out")
    save_weights(np_params, args.out, args.heads, metrics)
    unevaluated.unlink(missing_ok=True)
    Path(args.out).with_suffix(".resume.npz").unlink(missing_ok=True)
    # base (lexicon-root) words only — the hardest, most honest subset:
    # unseen roots with no morphological signal
    lexicon = G2P(neural=False).lexicon
    base_eval = [(w, p) for w, p in eval_pairs if w in lexicon]
    if base_eval:
        score(np_params, base_eval, "held-out base words")
    if args.beam_eval:
        # seeded subsample (not a corpus-ordered head slice) so the beam
        # metric is representative of the held-out distribution
        beam_rng = np.random.default_rng(13)
        pick = beam_rng.permutation(len(eval_pairs))[: args.beam_eval]
        beam_sub = [eval_pairs[i] for i in pick]
        score(np_params, beam_sub, f"held-out beam ({len(beam_sub)})",
              decode="beam")
    return 0
