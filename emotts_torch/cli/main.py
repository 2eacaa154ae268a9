"""The ``emotts-torch`` command:
``python -m emotts_torch.cli.main <command> [--config cfg.yaml] [--device cuda|cpu] [a.b=c ...]``.

Counterpart of ``emotts/cli/main.py``, with the same commands, flags, printed
lines, output files and exit code 2 on bad arguments:

  prepare-corpus   EmoV-DB layout → corpus/<speaker>/<emotion>_<id>.{wav,lab}
  preprocess       features + rank pair lists (the mel on the card with
                   --device cuda)
  fs2-splits       FastSpeech2 train/valid lists
  train-rank       rank-model training
  bucketize        intensity prototypes (intensity.npy) from the rank model
  train-fs2        FastSpeech2 training on the frozen extractor
  synthesize       the demo sweep, long-form text (--text-file, --stream) or
                   SSML-lite (--ssml-file)
  convert-vocoder  torch HiFi-GAN checkpoint → .npz params
  import-reference reference-trained torch checkpoints (rank model and
                   FastSpeech2 best_model.pth, intensity.npy) → experiments
  train-vocoder    HiFi-GAN GAN training; exports the vocoder.npz that
                   synthesize reads
  evaluate         objective metrics on the held-out split → eval.json, with
                   the intensity-efficacy report folded in
  eval-intensity   the intensity-efficacy report (--plot: its figure)
  serve            the HTTP server
  g2p              per-word pronunciation trace

``--device`` (default ``cuda``) is where the commands that compute run.
Without a GPU they exit with code 2 unless ``--device cpu`` is given: no
command falls back to the CPU by itself.

Under ``torch.distributed.run`` (``python -m torch.distributed.run
--nproc-per-node N -m emotts_torch.cli.main train-rank …``) the three
trainers run data-parallel, one process per device: the command joins the
process group the launcher describes (NCCL on cuda, on ``cuda:LOCAL_RANK``;
``gloo`` with ``--device cpu``), rank 0 builds the kernels while the others
wait, and only rank 0 writes and prints.  Every other command runs on rank 0
alone.  Without the launcher's variables nothing changes.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import torch

from emotts_torch.utils.config import Config, load_config

COMMANDS = (
    "prepare-corpus",
    "preprocess",
    "fs2-splits",
    "train-rank",
    "bucketize",
    "train-fs2",
    "synthesize",
    "convert-vocoder",
    "import-reference",
    "train-vocoder",
    "evaluate",
    "eval-intensity",
    "serve",
    "g2p",
)
# the commands whose work runs on --device
DEVICE_COMMANDS = {"preprocess", "train-rank", "bucketize", "train-fs2",
                   "synthesize", "train-vocoder", "evaluate", "eval-intensity",
                   "serve"}
# the commands that run data-parallel under torch.distributed.run
DATA_PARALLEL_COMMANDS = ("train-rank", "train-fs2", "train-vocoder")


def _parse(argv):
    parser = argparse.ArgumentParser(prog="emotts-torch")
    parser.add_argument("command", choices=COMMANDS)
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument(
        "--device", default="cuda",
        help="device of the commands that compute (default cuda; cpu runs "
        "the plain PyTorch path on the host)",
    )
    parser.add_argument("--checkpoint", default=None, help="(convert-vocoder) torch ckpt")
    parser.add_argument("--output", default=None, help="(convert-vocoder) output .npz")
    parser.add_argument(
        "--resume", default=None, metavar="EXP_PATH",
        help="(train-*) resume full train state from an experiment directory",
    )
    parser.add_argument(
        "--rank-checkpoint", default=None, metavar="PTH",
        help="(import-reference) reference rank-model best_model.pth",
    )
    parser.add_argument(
        "--fs2-checkpoint", default=None, metavar="PTH",
        help="(import-reference) reference FastSpeech2 best_model.pth",
    )
    parser.add_argument(
        "--intensity", default=None, metavar="NPY",
        help="(import-reference) reference intensity.npy prototype bank",
    )
    parser.add_argument(
        "--text-file", default=None, metavar="PATH",
        help="(synthesize) long-form mode: split PATH into sentences and "
        "write one stitched wav for --speaker/--emotion/--level",
    )
    parser.add_argument(
        "--ssml-file", default=None, metavar="PATH",
        help="(synthesize) SSML-lite mode: render PATH's markup "
        "(<voice>/<emotion>/<prosody rate>/<break>/<phoneme>) to one wav; "
        "--speaker/--emotion/--level are the defaults for unmarked spans",
    )
    parser.add_argument("--speaker", default=None,
                        help="(synthesize --text-file) speaker name")
    parser.add_argument("--emotion", default=None,
                        help="(synthesize --text-file) emotion name")
    parser.add_argument("--level", type=float, default=0.0,
                        help="(synthesize --text-file) intensity level; "
                        "fractional values interpolate between bucket "
                        "prototypes (e.g. 1.5)")
    parser.add_argument("--conditioning", default="own",
                        choices=["own", "prototype"],
                        help="(evaluate) intensity conditioning for the "
                        "objective metrics: 'own' = each utterance's "
                        "extracted representation (training-time bridge); "
                        "'prototype' = the bucketized intensity bank at the "
                        "middle level, the user-facing synthesis path, "
                        "exaggerated by --contrast as m + c*(p - m)")
    parser.add_argument("--intensity-scale", type=float, default=1.0,
                        help="(synthesize --text-file) multiplier on the "
                        "intensity conditioning vector (0=neutral-like, "
                        ">1=exaggerated)")
    parser.add_argument("--pace", type=float, default=1.0,
                        help="(synthesize --text-file) speaking-rate multiplier")
    parser.add_argument("--speaker-mix", default=None, metavar="NAME:W,...",
                        help="(synthesize --text-file) blended voice, e.g. "
                        "bea:0.5,josh:0.5 (weights renormalize; overrides "
                        "--speaker)")
    parser.add_argument("--emotion-mix", default=None,
                        metavar="NAME[@LVL]:W,...",
                        help="(synthesize --text-file) blended affect, e.g. "
                        "amused:0.6,sleepy:0.4 or amused@2:0.7,angry@1:0.3 "
                        "(per-entry level defaults to --level; overrides "
                        "--emotion)")
    parser.add_argument("--host", default="127.0.0.1",
                        help="(serve) bind address")
    parser.add_argument("--port", type=int, default=8080,
                        help="(serve) TCP port (0 = pick a free one)")
    parser.add_argument("--text", default=None,
                        help="(g2p / eval-intensity) input text (default: "
                        "inference.text from the config)")
    parser.add_argument("--texts-file", default=None,
                        help="(eval-intensity) file of sentences, one per "
                        "line, to average the sweep over")
    parser.add_argument("--contrast", type=float, default=1.0,
                        help="(eval-intensity) exaggerate level prototypes "
                        "around their per-cell mean (diagnostic; 1.0 = the "
                        "production bank)")
    parser.add_argument("--plot", default=None, metavar="PNG",
                        help="(eval-intensity) also render the score-vs-"
                        "level sweep figure (needs matplotlib)")
    parser.add_argument("--stream", action="store_true",
                        help="(synthesize --text-file) streaming mode: vocode "
                        "in chunks and report time-to-first-audio")
    parser.add_argument("overrides", nargs="*", help="a.b.c=value overrides")
    return parser.parse_intermixed_args(argv)


def _experiment(cfg: Config, kind: str, name: str) -> str:
    return os.path.join(cfg.data.experiment_path, kind, name)


def _resolve_ids(args, cfg: Config):
    """(speaker, emotion) ids of --speaker/--emotion, 0 where not given."""
    from emotts_torch.infer.synthesize import resolve_name

    spk = (resolve_name(args.speaker, cfg.data.speakers, "speaker")
           if args.speaker is not None else 0)
    emo = (resolve_name(args.emotion, cfg.data.emotions, "emotion")
           if args.emotion is not None else 0)
    return spk, emo


def _mixes(args, cfg: Config):
    """--speaker-mix / --emotion-mix as the Synthesizer's blend lists."""
    from emotts_torch.infer.synthesize import resolve_name

    speaker_mix = emotion_mix = None
    if args.speaker_mix:
        speaker_mix = [
            (resolve_name(name, cfg.data.speakers, "speaker"), float(w))
            for name, w in (p.split(":") for p in args.speaker_mix.split(","))
        ]
    if args.emotion_mix:
        emotion_mix = []
        for part in args.emotion_mix.split(","):
            name, w = part.split(":")
            lvl = args.level
            if "@" in name:
                name, lvl_s = name.split("@")
                lvl = float(lvl_s)
            emotion_mix.append(
                (resolve_name(name, cfg.data.emotions, "emotion"), lvl, float(w)))
    return speaker_mix, emotion_mix


def _write(cfg: Config, name: str, wav) -> None:
    from emotts_torch.audio.wavio import write_wav

    os.makedirs(cfg.inference.output_path, exist_ok=True)
    out_wav = os.path.join(cfg.inference.output_path, name)
    write_wav(out_wav, wav, cfg.audio.sampling_rate)
    dur = len(wav) / cfg.audio.sampling_rate
    print(f"[synthesize] wrote {out_wav} ({dur:.1f}s)")


def _synthesize(args, cfg: Config) -> int:
    """The three modes of ``synthesize``; the arguments are checked before
    the models load."""
    from emotts_torch.infer.synthesize import load_synthesizer

    if args.ssml_file and (args.speaker_mix or args.emotion_mix):
        print("--speaker-mix/--emotion-mix cannot combine with "
              "--ssml-file; use <voice>/<emotion> spans instead",
              file=sys.stderr)
        return 2
    if args.text_file and not args.ssml_file and (
        (args.speaker is None and args.speaker_mix is None)
        or (args.emotion is None and args.emotion_mix is None)
    ):
        print("synthesize --text-file requires --speaker (or "
              "--speaker-mix) and --emotion (or --emotion-mix)",
              file=sys.stderr)
        return 2
    if (args.text_file and not args.ssml_file and args.stream
            and (args.speaker_mix or args.emotion_mix)):
        print("--speaker-mix/--emotion-mix are not supported "
              "with --stream yet", file=sys.stderr)
        return 2
    try:
        spk, emo = _resolve_ids(args, cfg)
        speaker_mix, emotion_mix = _mixes(args, cfg)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2

    synth = load_synthesizer(cfg, device=args.device)
    if args.ssml_file:
        from emotts_torch.text.ssml import SSMLError

        with open(args.ssml_file) as f:
            markup = f.read()
        try:
            wav = synth.synthesize_ssml(
                markup, speaker=spk, emotion=emo, level=args.level,
                intensity_scale=args.intensity_scale, pace=args.pace,
            )
        except SSMLError as e:
            print(f"SSML error: {e}", file=sys.stderr)
            return 2
        _write(cfg, "ssml.wav", wav)
    elif args.text_file:
        with open(args.text_file) as f:
            text = f.read()
        if args.stream:
            import time

            import numpy as np

            from emotts_torch.infer.streaming import stream_text

            t0 = time.perf_counter()
            ttfa = None
            chunks = []
            for chunk in stream_text(
                synth, text, spk, emo, level=args.level, pace=args.pace,
                intensity_scale=args.intensity_scale,
            ):
                if ttfa is None:
                    ttfa = time.perf_counter() - t0
                chunks.append(chunk)
            wav = np.concatenate(chunks)
            print(f"[synthesize] time-to-first-audio {ttfa * 1e3:.0f} ms "
                  f"({len(chunks)} chunks)")
        else:
            wav = synth.synthesize_text(
                text, spk, emo, level=args.level, pace=args.pace,
                intensity_scale=args.intensity_scale,
                speaker_mix=speaker_mix, emotion_mix=emotion_mix,
            )
        spk_label = (args.speaker_mix.replace(":", "").replace(",", "+")
                     if args.speaker_mix else args.speaker)
        emo_label = (args.emotion_mix.replace(":", "").replace(",", "+")
                     .replace("@", "") if args.emotion_mix else args.emotion)
        _write(cfg, f"longform_{spk_label}_{emo_label}_{args.level:g}.wav", wav)
    else:
        out = synth.intensity_sweep(cfg.inference.text, cfg.inference.output_path)
        print(f"[synthesize] wrote {len(out)} items to "
              f"{cfg.inference.output_path}")
    return 0


def _evaluate(args, cfg: Config) -> int:
    import json

    import numpy as np

    from emotts_torch.eval.evaluate import Evaluator
    from emotts_torch.eval.intensity_eval import evaluate_intensity_efficacy
    from emotts_torch.infer.synthesize import maybe_load_vocoder

    run_kwargs = {}
    if args.conditioning == "prototype":
        bank_path = os.path.join(
            _experiment(cfg, "rank_model", cfg.inference.rank_exp), "intensity.npy")
        run_kwargs = dict(conditioning="prototype",
                          intensity_bank=np.load(bank_path),
                          contrast=args.contrast)
    report = Evaluator(cfg, vocoder_params=maybe_load_vocoder(cfg),
                       device=args.device).run(**run_kwargs)
    print(f"[evaluate] {report['n_utterances']} utterances")
    for k, v in report["overall"].items():
        print(f"[evaluate]   {k}: {v:.4f}")
    # the intensity-efficacy sweep belongs to the standard report: run it
    # where its artifacts exist (intensity.npy, the best FS2 export) and fold
    # it into eval.json
    try:
        intensity = evaluate_intensity_efficacy(cfg, device=args.device)
    except FileNotFoundError as exc:
        print(f"[evaluate] intensity efficacy skipped: {exc}")
    else:
        for k in ("monotonic_fraction_strict", "pairwise_order_accuracy",
                  "emotion_silhouette_h"):
            v = intensity.get(k)
            val = f"{v:.4f}" if v is not None else "n/a"
            print(f"[evaluate]   intensity/{k}: {val}")
        with open(report["path"]) as f:
            merged = json.load(f)
        merged["intensity_efficacy"] = {
            k: v for k, v in intensity.items() if k != "path"}
        with open(report["path"], "w") as f:
            json.dump(merged, f, indent=2)
    print(f"[evaluate] report: {report['path']}")
    return 0


def _eval_intensity(args, cfg: Config) -> int:
    from emotts_torch.eval.intensity_eval import evaluate_intensity_efficacy
    from emotts_torch.utils.plotting import have_matplotlib, plot_intensity_sweep

    if args.plot and not have_matplotlib():
        print("eval-intensity --plot needs matplotlib, which is not "
              "installed; run without --plot", file=sys.stderr)
        return 2
    texts = None
    if args.texts_file:
        with open(args.texts_file) as f:
            texts = [ln.strip() for ln in f if ln.strip()]
    elif args.text:
        texts = [args.text]
    report = evaluate_intensity_efficacy(
        cfg, texts=texts, contrast=args.contrast, device=args.device)
    if args.plot:
        plot_intensity_sweep(report, args.plot)
        print(f"[eval-intensity] sweep plot: {args.plot}")
    print(f"[eval-intensity] {report['n_synthesized']} synthesized "
          f"({report['feature_path']}, contrast {args.contrast:g})")
    for k in ("monotonic_fraction_strict", "pairwise_order_accuracy",
              "monotonic_fraction_cell_mean", "emotion_silhouette_h"):
        v = report.get(k)
        val = f"{v:.4f}" if v is not None else "n/a"
        print(f"[eval-intensity]   {k}: {val}")
    print(f"[eval-intensity] report: {report['path']}")
    return 0


def _import_reference(args, cfg: Config) -> int:
    import shutil

    import numpy as np

    from emotts_torch.nn.convert import (fs2_from_flax,
                                         fs2_params_from_reference_torch,
                                         rank_from_flax, rank_params_from_torch,
                                         torch_state_dict)
    from emotts_torch.train.checkpoint import save_best_export

    if not (args.rank_checkpoint or args.fs2_checkpoint or args.intensity):
        print("import-reference requires at least one of "
              "--rank-checkpoint/--fs2-checkpoint/--intensity",
              file=sys.stderr)
        return 2
    f = cfg.fastspeech2
    if args.fs2_checkpoint and (f.prenet_style != "embedding"
                                or f.postnet_style != "speechbrain"):
        print(
            "import-reference: reference FastSpeech2 checkpoints need the "
            "compat architecture — set fastspeech2.prenet_style=embedding and "
            "fastspeech2.postnet_style=speechbrain in the config used for "
            "import AND for later synthesis/training",
            file=sys.stderr,
        )
        return 2
    rank_exp = _experiment(cfg, "rank_model", cfg.inference.rank_exp)
    if args.rank_checkpoint:
        tree = rank_params_from_torch(
            torch_state_dict(args.rank_checkpoint),
            cfg.rank_model.n_encoder_layers, cfg.rank_model.n_heads)
        path = save_best_export(rank_exp, rank_from_flax(tree))
        print(f"[import-reference] rank params → {path}")
    if args.fs2_checkpoint:
        tree = fs2_params_from_reference_torch(
            torch_state_dict(args.fs2_checkpoint), f)
        fs2_exp = _experiment(cfg, "fastspeech2", cfg.inference.fs2_exp)
        path = save_best_export(fs2_exp, fs2_from_flax(tree))
        print(f"[import-reference] fastspeech2 params → {path}")
    if args.intensity:
        bank = np.load(args.intensity)
        os.makedirs(rank_exp, exist_ok=True)
        dst = os.path.join(rank_exp, "intensity.npy")
        if os.path.abspath(args.intensity) != os.path.abspath(dst):
            shutil.copyfile(args.intensity, dst)
        print(f"[import-reference] intensity bank {bank.shape} → {dst}")
    return 0


def _train_fs2(args, cfg: Config) -> str:
    from emotts_torch.infer.synthesize import (build_vocoder,
                                               kernel_vocoder_structure,
                                               maybe_load_vocoder)
    from emotts_torch.train.checkpoint import load_best_params
    from emotts_torch.train.fs2_trainer import FS2Trainer, extractor_params_from_rank

    rank_params = load_best_params(
        _experiment(cfg, "rank_model", cfg.inference.rank_exp))
    vocoder = None
    vocoder_params = maybe_load_vocoder(cfg)
    if vocoder_params is not None:
        vocoder = build_vocoder(
            cfg, vocoder_params,
            kernel_vocoder_structure(cfg, vocoder_params, args.device), args.device)
    return FS2Trainer(cfg, extractor_params_from_rank(rank_params),
                      vocoder=vocoder, device=args.device
                      ).fit(exp_path=args.resume, resume=bool(args.resume))


def _launched() -> bool:
    """True under torch.distributed.run (its variables are set)."""
    return all(v in os.environ for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


@contextlib.contextmanager
def _process_group(args):
    """Join the launcher's process group for a data-parallel command: NCCL
    on ``cuda:LOCAL_RANK`` (``args.device`` becomes it), ``gloo`` on the
    CPU; rank 0 builds the CUDA kernels while the others wait, and the other
    ranks print nothing."""
    import torch.distributed as dist

    local = int(os.environ["LOCAL_RANK"])
    on_cuda = torch.device(args.device).type == "cuda"
    if on_cuda:
        torch.cuda.set_device(local)
        args.device = f"cuda:{local}"
    dist.init_process_group("nccl" if on_cuda else "gloo")
    try:
        if on_cuda:
            if dist.get_rank() == 0:
                from emotts_torch.ops import _build

                _build.build_all()
            dist.barrier(device_ids=[local])
        with contextlib.ExitStack() as quiet:
            if dist.get_rank():
                quiet.enter_context(contextlib.redirect_stdout(
                    quiet.enter_context(open(os.devnull, "w"))))
            yield
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])
    cfg: Config = load_config(args.config, args.overrides)
    on_cuda = torch.device(args.device).type == "cuda"
    if (args.command in DEVICE_COMMANDS and on_cuda
            and not torch.cuda.is_available()):
        print(f"{args.command}: --device {args.device} was asked for and no "
              "GPU is visible; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    if _launched():
        if args.command in DATA_PARALLEL_COMMANDS:
            with _process_group(args):
                return _run(args, cfg)
        if int(os.environ["RANK"]) != 0:
            return 0  # every other command is rank 0's alone
    return _run(args, cfg)


def _run(args, cfg: Config) -> int:
    on_cuda = torch.device(args.device).type == "cuda"
    if args.command == "prepare-corpus":
        from emotts_torch.cli.prepare_corpus import prepare_corpus

        n = prepare_corpus(cfg)
        print(f"[prepare] wrote {n} corpus utterances")

    elif args.command == "preprocess":
        from emotts_torch.data.preprocess import preprocess_all
        from emotts_torch.data.splits import build_rank_pair_lists

        # on the card the mel is the card's; on the CPU as data.device_mel says
        counts = preprocess_all(cfg, device_mel=cfg.data.device_mel or on_cuda,
                                device=args.device)
        train, test = build_rank_pair_lists(cfg)
        print(f"[preprocess] {sum(counts.values())} utterances; "
              f"{len(train)} train pairs, {len(test)} test pairs")

    elif args.command == "fs2-splits":
        from emotts_torch.data.splits import build_fs2_splits

        train, valid = build_fs2_splits(cfg)
        print(f"[fs2-splits] {len(train)} train / {len(valid)} valid")

    elif args.command == "train-rank":
        from emotts_torch.train.rank_trainer import RankTrainer

        exp = RankTrainer(cfg, device=args.device).fit(
            exp_path=args.resume, resume=bool(args.resume))
        print(f"[train-rank] experiment: {exp}")

    elif args.command == "bucketize":
        from emotts_torch.infer.bucketize import bucketize

        out = bucketize(cfg, device=args.device)
        print(f"[bucketize] prototypes saved to {out}")

    elif args.command == "train-fs2":
        exp = _train_fs2(args, cfg)
        print(f"[train-fs2] experiment: {exp}")

    elif args.command == "synthesize":
        return _synthesize(args, cfg)

    elif args.command == "convert-vocoder":
        from emotts_torch.infer.synthesize import save_vocoder_params_npz
        from emotts_torch.nn.convert import load_vocoder_checkpoint

        if not args.checkpoint or not args.output:
            print("convert-vocoder requires --checkpoint and --output", file=sys.stderr)
            return 2
        save_vocoder_params_npz(load_vocoder_checkpoint(args.checkpoint), args.output)
        print(f"[convert-vocoder] saved {args.output}")

    elif args.command == "serve":
        from emotts_torch.infer.server import make_server
        from emotts_torch.infer.synthesize import load_synthesizer

        synth = load_synthesizer(cfg, device=args.device)
        httpd = make_server(cfg, synth, host=args.host, port=args.port,
                            verbose=True, device=args.device)
        host, port = httpd.server_address[:2]
        print(f"[serve] listening on http://{host}:{port}  "
              f"(endpoints: GET /health, POST /synthesize, POST /batch)",
              flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()

    elif args.command == "evaluate":
        return _evaluate(args, cfg)

    elif args.command == "eval-intensity":
        return _eval_intensity(args, cfg)

    elif args.command == "train-vocoder":
        from emotts_torch.train.vocoder_trainer import VocoderTrainer

        exp = VocoderTrainer(cfg, device=args.device).fit(
            exp_path=args.resume, resume=bool(args.resume))
        print(f"[train-vocoder] experiment: {exp} "
              f"(generator exported to {exp}/vocoder.npz)")

    elif args.command == "import-reference":
        return _import_reference(args, cfg)

    elif args.command == "g2p":
        from emotts_torch.text.g2p import G2P

        text = args.text if args.text is not None else cfg.inference.text
        rows = G2P().explain(text)
        for word, tier, phones in rows:
            print(f"{word:>24s}  {tier:<10s}  {' '.join(phones)}")
        print("[g2p]", " ".join(p for _, _, ph in rows for p in ph))

    return 0


if __name__ == "__main__":
    sys.exit(main())
