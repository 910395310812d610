"""Command-line interface: ``python -m speechless_tpu_torch <command> ...``.

    python -m speechless_tpu_torch fill-cache --config english --data-dir D
    python -m speechless_tpu_torch train --config english --data-dir D --epochs 2
    python -m speechless_tpu_torch test --config english --data-dir D --run R --epoch 2
    python -m speechless_tpu_torch serve --config english --data-dir D --run R \\
        --epoch 9 --kenlm [--quantize [--int8-compute]] [--warm-beam] --port 8000
    python -m speechless_tpu_torch serve --checkpoint nets/run/weights-epoch9.npz \\
        --kenlm kenlm/english --device cuda:0 --port 8000
    python -m speechless_tpu_torch transcribe --checkpoint nets/run/weights-epoch9.npz \\
        --kenlm kenlm/english --json --nbest 3 a.wav b.flac
    python -m speechless_tpu_torch align a.flac --text "the cat sat" --config english \\
        --data-dir D --run R --epoch 9 [--quantize]
    python -m speechless_tpu_torch export --config english --data-dir D --run R \\
        --epoch 9 --kenlm --out bundle --batch-sizes 1 16 --streaming [--device-streaming]
    python -m speechless_tpu_torch transcribe --bundle bundle a.wav b.flac

    python -m speechless_tpu_torch transfer --config german --data-dir D --freeze 8 \
        --epochs 1691
    python -m speechless_tpu_torch average --config german --data-dir D --run R --last 2
    python -m speechless_tpu_torch convert nets/run/weights-epoch9.h5 weights-epoch9.npz
    python -m speechless_tpu_torch record --config english --data-dir D --run R --epoch 9

``train``, ``transfer``, ``test``, ``validate``, ``average``, ``summarize`` and
``fill-cache`` are the JAX CLI's workflows over a named `Configuration` (``english``,
``minimal_english``, ``german``, ``mixed_german_english``) and a data directory
(`configuration.py`), with its flags, defaults and refusals. ``transfer`` loads the
English baseline run remapped to the configuration's characters and continues its epoch
numbering, so ``--epochs`` counts from the donor's epoch (1689). ``average`` writes the
mean of several epoch checkpoints of a run as a new epoch.
``convert`` turns a checkpoint's weights from ``.npz`` into the reference's Keras ``.h5``
or back (`train/keras_import.py`; it needs h5py). ``record`` records from the microphone
until 3 s of silence (`io/recording.py`; it needs sounddevice or pyaudio), saves the wav
and its spectrogram under ``<data-dir>/recordings`` and prints the transcript of a run's
epoch (the latest with ``--run`` alone, the English baseline without ``--run``).
``serve`` runs the port's HTTP transcription API (`serving_http.py`: ``/v1/transcribe``
and the ``/v1/stream`` session routes); ``transcribe`` decodes wav or FLAC files
offline and prints ``file<TAB>text`` lines or one JSON object per file; ``align``
prints the word timestamps of a known transcript as one JSON object. Their model is
either a run of a configuration (``--config --data-dir --run --epoch``, as the JAX CLI
takes it) or a checkpoint file (``--checkpoint FILE --charset``), written by either
package, float or int8 (``layer{i}.{w,b}`` or ``layer{i}.{w_q,w_scale,b}``), or an export
bundle (``--bundle DIR``, `serving_export.py`), which ``export`` writes from such a model:
`torch.export` programs that replay with no model code.
``--kenlm`` alone takes the configuration's LM directory (``<data-dir>/kenlm/<name>``),
as the JAX flag does; ``--kenlm DIR`` names the directory. Every command runs on
``--device`` (default ``cuda:0``).
"""
import argparse
import json
import logging
from pathlib import Path

from .serving_host import CHARSETS

# Options a bundle bakes in at export time: with --bundle they would be ignored.
_BAKED_OPTIONS = ("kenlm", "lexicon", "quantize", "int8_compute", "charset")


def _configuration(name: str, data_dir=None, batch_size=None, batches_per_epoch=None):
    from .configuration import Configuration, DataDirectories

    directories = DataDirectories(Path(data_dir)) if data_dir else None
    factories = {
        "english": lambda: Configuration.english(directories=directories),
        "minimal_english": lambda: Configuration.minimal_english(directories=directories),
        "german": lambda: Configuration.german(directories=directories),
        "mixed_german_english": lambda: Configuration.mixed_german_english(
            directories=directories),
    }
    if name not in factories:
        raise SystemExit("Unknown configuration '{}'. Available: {}".format(
            name, ", ".join(sorted(factories))))
    configuration = factories[name]()
    if batch_size is not None:
        configuration.batch_size = batch_size
    if batches_per_epoch is not None:
        configuration.training_batches_per_epoch = batches_per_epoch
    return configuration


def _add_config_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--config", default="minimal_english",
                        help="named configuration (english, minimal_english, german, "
                             "mixed_german_english)")
    parser.add_argument("--data-dir", default=None,
                        help="data root (default: ~/speechless-data)")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--batches-per-epoch", type=int, default=None)
    parser.add_argument("--device", default="cuda:0", help="torch device to run on")


def _add_workflow_commands(sub) -> dict:
    """The JAX CLI's corpus, training and evaluation commands; returns their parsers."""
    p_train = sub.add_parser("train", help="train from scratch")
    _add_config_args(p_train)
    p_train.add_argument("--epochs", type=int, default=None, help="epoch limit")
    p_train.add_argument("--device-resident", action="store_true",
                         help="pack the corpus into device memory and sample batches "
                              "there (no host-to-device copy inside an epoch)")
    p_train.add_argument("--spec-augment", action="store_true",
                         help="SpecAugment masking during training (ops/specaugment.py, "
                              "default policy)")
    p_train.add_argument("--clip-norm", type=float, default=None,
                         help="global-norm gradient clipping (default: unclipped, "
                              "reference parity)")
    p_train.add_argument("--lr-warmup-steps", type=int, default=0,
                         help="linear learning-rate warmup from 0 over N steps "
                              "(default: none, reference parity)")
    p_train.add_argument("--lr-decay", choices=("cosine",), default=None,
                         help="anneal the learning rate after warmup (requires "
                              "--lr-decay-steps)")
    p_train.add_argument("--lr-decay-steps", type=int, default=None,
                         help="total schedule length in steps (incl. warmup) for "
                              "--lr-decay cosine")
    p_train.add_argument("--accumulate-steps", type=int, default=None,
                         help="gradient accumulation: one Adam update per N "
                              "micro-batches")
    p_train.add_argument("--remat", action="store_true",
                         help="gradient rematerialization (torch.utils.checkpoint): store "
                              "the block inputs only and recompute the rest in the "
                              "backward")

    p_transfer = sub.add_parser("transfer",
                                help="transfer-train from the best English model")
    _add_config_args(p_transfer)
    p_transfer.add_argument("--freeze", type=int, default=0, help="frozen layer count")
    p_transfer.add_argument("--reinitialize", action="store_true",
                            help="draw the layers above the frozen ones afresh")
    p_transfer.add_argument("--epochs", type=int, default=None,
                            help="epoch limit, counted on from the donor's epoch")
    p_transfer.add_argument("--spec-augment", action="store_true",
                            help="SpecAugment masking during training")
    p_transfer.add_argument("--clip-norm", type=float, default=None,
                            help="global-norm gradient clipping (default: unclipped)")

    p_test = sub.add_parser("test", help="evaluate a checkpoint grouped by sub-corpus")
    _add_config_args(p_test)
    p_test.add_argument("--run", required=True, help="run name under nets/")
    p_test.add_argument("--epoch", type=int, required=True)
    p_test.add_argument("--kenlm", action="store_true", help="beam search with LM fusion")
    p_test.add_argument("--beam-width", type=int, default=None)
    p_test.add_argument("--lm-weight", type=float, default=None,
                        help="LM fusion weight (default: the reference's 0.8)")
    p_test.add_argument("--word-count-weight", type=float, default=None)
    p_test.add_argument("--valid-word-count-weight", type=float, default=None)

    p_validate = sub.add_parser("validate", help="epoch-sweep evaluation to CSV")
    _add_config_args(p_validate)
    p_validate.add_argument("--run", required=True)
    p_validate.add_argument("--csv", required=True)
    p_validate.add_argument("--kenlm", action="store_true",
                            help="sweep with the LM-fused beam instead of greedy")

    p_average = sub.add_parser(
        "average", help="average several epoch checkpoints into one (decode-time "
                        "smoothing)")
    _add_config_args(p_average)
    p_average.add_argument("--run", required=True, help="run name under nets/")
    p_average.add_argument("--epochs", type=int, nargs="+", default=None,
                           help="explicit epochs to average")
    p_average.add_argument("--last", type=int, default=5,
                           help="without --epochs: average the last N available epochs "
                                "(default 5)")
    p_average.add_argument("--write-epoch", type=int, default=None,
                           help="epoch number of the averaged checkpoint (default: "
                                "max(epochs) + 1000, clear of any real epoch)")

    p_summarize = sub.add_parser("summarize", help="summarize + save the corpus CSV")
    _add_config_args(p_summarize)

    p_cache = sub.add_parser("fill-cache", help="precompute the spectrogram cache")
    _add_config_args(p_cache)
    p_cache.add_argument("--repair", action="store_true", help="verify + repair entries")
    return {"train": p_train, "test": p_test}


def _training_wav2letter_kwargs(args) -> dict:
    """The model options of ``train`` and ``transfer``, only those set on the command
    line (the others keep the model's defaults)."""
    kwargs = {"device": args.device}
    if args.spec_augment:
        kwargs["spec_augment"] = True
    for key, value in (("gradient_clip_norm", args.clip_norm),
                       ("lr_decay", getattr(args, "lr_decay", None)),
                       ("lr_decay_steps", getattr(args, "lr_decay_steps", None)),
                       ("accumulate_gradient_steps", getattr(args, "accumulate_steps", None))):
        if value is not None:
            kwargs[key] = value
    if getattr(args, "lr_warmup_steps", 0):
        kwargs["lr_warmup_steps"] = args.lr_warmup_steps
    if getattr(args, "remat", False):
        kwargs["remat"] = True
    return kwargs


def _average(configuration, args) -> None:
    """``average``: the mean of the chosen epochs of a run, written as a new epoch."""
    from .experiments import available_epochs
    from .train import checkpoint as ckpt

    directory = configuration.directories.nets_base_directory / args.run
    if args.epochs:
        epochs = sorted(args.epochs)
    else:
        if args.last < 1:
            raise SystemExit("--last must be >= 1")
        epochs = available_epochs(directory)[-args.last:]
        if not epochs:
            raise SystemExit("no checkpoints under {}".format(directory))
    write_epoch = args.write_epoch if args.write_epoch is not None else max(epochs) + 1000
    if write_epoch in epochs:
        raise SystemExit("--write-epoch {} would overwrite one of the averaged "
                         "checkpoints".format(write_epoch))
    params = ckpt.average_checkpoint_params(directory, epochs)
    path = ckpt.save_checkpoint(directory, write_epoch, params)
    print("Averaged epochs {} -> {}".format(epochs, path))


def _run_workflow(args, parsers: dict) -> None:
    """``train``, ``transfer``, ``test``, ``validate``, ``average``, ``summarize`` or
    ``fill-cache``."""
    if args.command == "train":
        if args.lr_decay is not None and args.lr_decay_steps is None:
            parsers["train"].error("--lr-decay requires --lr-decay-steps")
        if args.lr_decay_steps is not None and args.lr_decay is None:
            parsers["train"].error("--lr-decay-steps has no effect without --lr-decay")
    configuration = _configuration(args.config, args.data_dir, args.batch_size,
                                   args.batches_per_epoch)
    if args.command == "train":
        configuration.train_from_beginning(epoch_limit=args.epochs,
                                           device_resident=args.device_resident,
                                           wav2letter_kwargs=_training_wav2letter_kwargs(args))
    elif args.command == "transfer":
        configuration.train_transfer_from_best_english_model(
            frozen_layer_count=args.freeze,
            reinitialize_trainable_loaded_layers=args.reinitialize,
            epoch_limit=args.epochs, wav2letter_kwargs=_training_wav2letter_kwargs(args))
    elif args.command == "average":
        _average(configuration, args)
    elif args.command == "test":
        decoder_kwargs = {name: value for name, value in (
            ("beam_width", args.beam_width), ("lm_weight", args.lm_weight),
            ("word_count_weight", args.word_count_weight),
            ("valid_word_count_weight", args.valid_word_count_weight))
            if value is not None}
        if decoder_kwargs and not args.kenlm:
            # Without --kenlm the decode is greedy and every weight flag would be a
            # silent no-op.
            raise SystemExit("--beam-width/--lm-weight/--word-count-weight/"
                             "--valid-word-count-weight require --kenlm (greedy decode "
                             "uses no beam).")
        wav2letter = configuration.load_model(
            load_name=args.run, load_epoch=args.epoch,
            allowed_characters_for_loaded_model=None, use_kenlm=args.kenlm,
            device=args.device, **decoder_kwargs)
        configuration.test_model_grouped_by_loaded_corpus_name(wav2letter)
    elif args.command == "validate":
        from .experiments import validate_to_csv
        validate_to_csv(configuration, args.run, Path(args.csv), use_ken_lm=args.kenlm,
                        device=args.device)
    elif args.command == "summarize":
        configuration.summarize_and_save_corpus()
    else:
        configuration.fill_cache(repair_incorrect=args.repair)


def _record(args) -> None:
    """``record``: a microphone recording (its wav and spectrogram saved under the data
    directory's ``recordings``), transcribed by a run's epoch (the latest with ``--run``
    alone) or, without ``--run``, by the English baseline run."""
    from .io import record_plot_and_save

    configuration = _configuration(args.config, args.data_dir, args.batch_size,
                                   args.batches_per_epoch)
    example = record_plot_and_save(
        recording_directory=configuration.directories.recording_directory)
    if args.run is not None:
        epoch = args.epoch
        if epoch is None:
            from .experiments import available_epochs
            epochs = available_epochs(
                configuration.directories.nets_base_directory / args.run)
            if not epochs:
                raise SystemExit("No checkpoints found for run '{}'.".format(args.run))
            epoch = epochs[-1]
        wav2letter = configuration.load_model(load_name=args.run, load_epoch=epoch,
                                              allowed_characters_for_loaded_model=None,
                                              device=args.device)
    else:
        try:
            wav2letter = configuration.load_best_english_model(device=args.device)
        except FileNotFoundError:
            raise SystemExit(
                "No pinned best-English checkpoint under {} — pass --run <name> (and "
                "optionally --epoch) to select one of your trained runs.".format(
                    configuration.directories.nets_base_directory))
    print(wav2letter.predict(example))


def _convert_checkpoint(source: Path, destination: Path) -> None:
    """``convert``: a checkpoint's weights between the ``.npz`` of either package and the
    reference's Keras ``.h5``. An ``.h5`` file in a run directory also loads without
    conversion (`train/checkpoint.py::load_params`); this is for one-off conversion,
    mainly to take a model trained here back to Keras. The ``.npz`` to ``.h5`` direction
    infers the reference geometry from the weights (a first kernel of (250, 1, ...) is
    the raw-wave model), drops a trained-ASG pseudo-layer and refuses int8 weights."""
    from .models.wav2letter import Wav2LetterConfig
    from .train import checkpoint as ckpt
    from .train.keras_import import (is_keras_weight_file, load_keras_params,
                                     save_keras_params)

    if is_keras_weight_file(source) and destination.suffix == ".npz":
        ckpt.save_params_npz(destination, load_keras_params(source))
        print("Wrote {}".format(destination))
        return
    if source.suffix == ".npz" and is_keras_weight_file(destination):
        params = ckpt.load_params_npz(source)
        if any("w_q" in layer for layer in params):
            raise SystemExit("{} holds int8-quantized weights, which have no Keras "
                             "representation; convert the float checkpoint.".format(source))
        conv_layers = [layer for layer in params if "w" in layer]
        if len(conv_layers) != len(params):
            print("Dropping {} non-conv parameter group(s) (e.g. trained ASG "
                  "transitions) — Keras files carry conv weights only.".format(
                      len(params) - len(conv_layers)))
        if not conv_layers:
            raise SystemExit("{} holds no conv layers".format(source))
        first_kernel = conv_layers[0]["w"]
        config = Wav2LetterConfig(
            input_size_per_time_step=int(first_kernel.shape[1]),
            grapheme_set_size=int(conv_layers[-1]["w"].shape[2]),
            use_raw_wave_input=(first_kernel.shape[1] == 1 and first_kernel.shape[0] == 250))
        if len(config.layers) != len(conv_layers):
            raise SystemExit(
                "{} has {} conv layers — not the reference wav2letter geometry of {} "
                "layers, so Keras layer names cannot be assigned.".format(
                    source, len(conv_layers), len(config.layers)))
        save_keras_params(destination, config, conv_layers)
        print("Wrote {}".format(destination))
        return
    raise SystemExit("convert needs one .npz and one .h5/.hdf5 path "
                     "(got {} -> {})".format(source, destination))


def _model_args(parser: argparse.ArgumentParser, kenlm: bool = True,
                int8_compute: bool = False) -> None:
    """The serving commands' model options: a configuration's run or a checkpoint
    file, the LM, the lexicon and int8 serving."""
    _add_config_args(parser)
    parser.add_argument("--run", default=None, help="run name under nets/")
    parser.add_argument("--epoch", type=int, default=None)
    parser.add_argument("--checkpoint", default=None,
                        help="weights file (weights-epoch{n}.npz) instead of --run/--epoch")
    parser.add_argument("--charset", choices=sorted(CHARSETS), default=None,
                        help="the characters of a --checkpoint model (default english)")
    parser.add_argument("--bundle", default=None,
                        help="serve from an export bundle directory (see `export`) "
                             "instead of a checkpoint")
    parser.add_argument("--quantize", action="store_true",
                        help="serve from int8 per-channel weights")
    if int8_compute:
        parser.add_argument("--int8-compute", action="store_true",
                            help="also run the big convs as int8 products (implies "
                                 "--quantize)")
    if kenlm:
        parser.add_argument("--kenlm", nargs="?", const=True, default=None,
                            metavar="DIR",
                            help="LM-fused beam transcriptions: alone, with the "
                                 "configuration's LM (<data-dir>/kenlm/<name>); with DIR, "
                                 "with the ARPA model in DIR (default: greedy)")
        parser.add_argument("--lexicon", action="store_true",
                            help="lexicon-constrained beam: every decoded word is in the "
                                 "LM vocabulary (requires --kenlm)")
    else:
        parser.set_defaults(kenlm=None, lexicon=False)  # alignment needs no LM


def _check_backend_args(args, parser: argparse.ArgumentParser) -> None:
    """The JAX CLI's refusals (with its messages) before anything loads."""
    if args.bundle is not None:
        if args.checkpoint is not None or args.run is not None:
            parser.error("{} needs exactly one of --bundle or a checkpoint (--checkpoint "
                         "or --run/--epoch)".format(args.command))
        if args.lexicon:
            parser.error("--lexicon needs a live checkpoint (--run/--epoch): AOT bundles "
                         "bake their decoder at export time, so the flag would be "
                         "silently ignored")
        baked = ["--" + name.replace("_", "-") for name in _BAKED_OPTIONS
                 if getattr(args, name, None)]
        if baked:
            parser.error("{} with --bundle: a bundle bakes its LM, weights and "
                         "characters in at export time".format(", ".join(baked)))
        return
    if (args.checkpoint is None) == (args.run is None):
        parser.error("{} needs exactly one of --checkpoint or --run/--epoch".format(
            args.command))
    if args.run is not None and args.epoch is None:
        parser.error("--run requires --epoch")
    if args.run is not None and args.charset is not None:
        parser.error("--charset is for --checkpoint: --run serves the configuration's "
                     "characters")
    if args.lexicon and not args.kenlm:
        parser.error("--lexicon requires --kenlm (the vocabulary trie rides in the word "
                     "LM)")


def _serving_backend(args):
    """The backend of ``serve``, ``transcribe``, ``align`` and ``export``: an export
    bundle (`serving_export.ExportedTranscriber`), or a `serving.Transcriber` of a
    configuration's run (``--run --epoch``, as the JAX CLI builds it) or of a checkpoint
    file."""
    if getattr(args, "bundle", None) is not None:
        from .serving_export import ExportedTranscriber

        return ExportedTranscriber(Path(args.bundle), device=args.device)
    from .models.wav2letter import Wav2LetterConfig
    from .serving import Transcriber
    from .train.checkpoint import load_params_npz

    configuration = _configuration(args.config, args.data_dir, args.batch_size,
                                   args.batches_per_epoch)
    kenlm_directory = args.kenlm
    if kenlm_directory is True:
        kenlm_directory = (configuration.directories.kenlm_base_directory
                           / configuration.name.lower())
    options = dict(device=args.device, kenlm_directory=kenlm_directory,
                   quantize_weights=args.quantize,
                   int8_compute=getattr(args, "int8_compute", False),
                   lexicon_constrained=getattr(args, "lexicon", False))
    if args.run is not None:
        return Transcriber.from_checkpoint(
            configuration.directories.nets_base_directory / args.run, args.epoch,
            configuration.allowed_characters,
            mel_frequency_count=configuration.mel_frequency_count, **options)
    characters = CHARSETS[args.charset or "english"]
    params = load_params_npz(Path(args.checkpoint))
    first = params[0]["w" if "w" in params[0] else "w_q"]
    config = Wav2LetterConfig(input_size_per_time_step=first.shape[1],
                              grapheme_set_size=len(characters) + 1)
    return Transcriber(config, params, characters, **options)


def _transcribe(args, parser: argparse.ArgumentParser) -> None:
    """The ``transcribe`` command, with the JAX CLI's refusals before anything loads."""
    from . import serving_host
    from .features.audio_io import load_audio

    if args.timestamps and args.long_form:
        parser.error("--timestamps is per-utterance; long-form segmentation does not "
                     "carry emission offsets")
    if args.timestamps and not args.as_json:
        parser.error("--timestamps requires --json (the plain output is one "
                     "'file<TAB>text' line per file)")
    if args.nbest < 1:
        parser.error("--nbest must be >= 1")
    if args.nbest > 1 and not args.as_json:
        parser.error("--nbest requires --json")
    if args.nbest > 1 and (args.timestamps or args.long_form):
        parser.error("--nbest is mutually exclusive with --timestamps and --long-form")
    _check_backend_args(args, parser)
    if args.nbest > 1 and args.bundle is not None:
        parser.error("--nbest needs a checkpoint backend (--checkpoint or --run/--epoch); "
                     "AOT bundles export 1-best programs only")
    transcriber = _serving_backend(args)
    if args.bundle is None and args.nbest > transcriber.beam_width:
        parser.error("--nbest must be <= the decoder's beam width ({})".format(
            transcriber.beam_width))
    audios = [load_audio(Path(name)) for name in args.files]
    if args.nbest > 1:
        for name, audio in zip(args.files, audios):
            hypotheses = transcriber.transcribe_nbest(audio, args.nbest)
            print(json.dumps({"file": name,
                              "text": hypotheses[0][0] if hypotheses else "",
                              "hypotheses": [{"text": text, "score": round(score, 4)}
                                             for text, score in hypotheses]}))
        return
    if args.long_form:
        decoded = [(transcriber.transcribe_long_audio(audio), None) for audio in audios]
    elif len(audios) > 1 and transcriber.has_batched_programs:
        # A bundle's batched programs fix their batch size.
        decoded = transcriber.transcribe_batch(
            audios, **({"batch_size": args.dispatch_batch} if args.bundle is None else {}))
    else:
        decoded = [transcriber.transcribe_audio_with_confidence(audio) for audio in audios]
    if not args.timestamps:
        frames = [None] * len(audios)
    elif len(audios) > 1 and args.bundle is None:
        frames = transcriber.frame_tokens_batch(audios, batch_size=args.dispatch_batch)
    else:
        frames = [transcriber.frame_tokens(audio) for audio in audios]
    for name, tokens, (text, confidence) in zip(args.files, frames, decoded):
        if not args.as_json:
            print("{}\t{}".format(name, text))
            continue
        record = {"file": name, "text": text}
        if confidence is not None:
            record["confidence"] = confidence
        if args.timestamps:
            record["words"] = [
                {"word": word, "start_s": round(start, 4), "end_s": round(end, 4)}
                for word, start, end in serving_host.words_from_frame_tokens(
                    tokens, transcriber.codec, transcriber.blank_index,
                    transcriber.seconds_per_frame)]
        print(json.dumps(record))


def _align(args, parser: argparse.ArgumentParser) -> None:
    """The ``align`` command: one JSON object ``{"file", "text", "words"}``."""
    from .features.audio_io import load_audio

    if (args.text is None) == (args.text_file is None):
        parser.error("align needs exactly one of --text or --text-file")
    _check_backend_args(args, parser)
    transcript = (args.text if args.text is not None
                  else Path(args.text_file).read_text(encoding="utf8").strip())
    backend = _serving_backend(args)
    if not backend.supports_posteriors:
        raise SystemExit("this bundle has no frame-posterior programs; re-export with "
                         "--streaming")
    words = backend.align_audio(load_audio(Path(args.file)), transcript)
    print(json.dumps({"file": args.file, "text": transcript, "words": words}))


def _add_export_args(parser: argparse.ArgumentParser) -> None:
    """``export``'s options: the JAX CLI's, and the port's ``--checkpoint/--charset``."""
    _add_config_args(parser)
    parser.add_argument("--run", default=None, help="run name under nets/")
    parser.add_argument("--epoch", type=int, default=None)
    parser.add_argument("--checkpoint", default=None,
                        help="weights file (weights-epoch{n}.npz) instead of --run/--epoch")
    parser.add_argument("--charset", choices=sorted(CHARSETS), default=None,
                        help="the characters of a --checkpoint model (default english)")
    parser.add_argument("--out", required=True, help="bundle output directory")
    parser.add_argument("--kenlm", nargs="?", const=True, default=None, metavar="DIR",
                        help="export the word-LM-fused beam programs: alone, with the "
                             "configuration's LM; with DIR, with the ARPA model in DIR")
    parser.add_argument("--platforms", nargs="+", default=None, choices=("cuda", "cpu"),
                        help="devices to export for (default: the --device's type)")
    parser.add_argument("--batch-sizes", nargs="+", type=int, default=[1],
                        help="also export batched programs for offline serving, e.g. 1 16")
    parser.add_argument("--sample-buckets", nargs="+", type=int, default=None,
                        help="export only these length buckets (samples; default: all "
                             "of the Transcriber's)")
    parser.add_argument("--quantize", action="store_true",
                        help="int8 per-channel weights: a quarter of the weight bytes")
    parser.add_argument("--streaming", action="store_true",
                        help="also export the per-frame token and posterior programs "
                             "(streaming sessions, beam partials and align on the bundle)")
    parser.add_argument("--device-streaming", action="store_true",
                        help="also export the device-resident session pool's feed program "
                             "(its dimensions below are baked in)")
    parser.add_argument("--stream-window-s", type=float, default=8.0,
                        help="device-streaming: decode window seconds")
    parser.add_argument("--stream-max-sessions", type=int, default=64,
                        help="device-streaming: concurrent session capacity")
    parser.add_argument("--stream-max-batch", type=int, default=16,
                        help="device-streaming: feeds fused per dispatch")
    parser.add_argument("--stream-posteriors", action="store_true",
                        help="device-streaming: bake the per-frame posterior output into "
                             "the feed program (beam partials on the bundle's pool)")
    parser.set_defaults(bundle=None, lexicon=False)


def _export(args, parser: argparse.ArgumentParser) -> None:
    """The ``export`` command: a bundle of the model ``serve`` would load."""
    from .serving_export import export_transcriber

    _check_backend_args(args, parser)
    export_transcriber(
        _serving_backend(args), Path(args.out),
        platforms=args.platforms, sample_buckets=args.sample_buckets,
        batch_sizes=tuple(args.batch_sizes),
        streaming=args.streaming,
        device_streaming={"window_s": args.stream_window_s,
                          "max_sessions": args.stream_max_sessions,
                          "max_batch": args.stream_max_batch,
                          "posteriors": args.stream_posteriors}
        if args.device_streaming else None)
    print("Wrote {}".format(args.out))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="speechless_tpu_torch",
                                     description="wav2letter speech recognition on "
                                                 "PyTorch/CUDA")
    sub = parser.add_subparsers(dest="command", required=True)
    workflow_parsers = _add_workflow_commands(sub)
    p_serve = sub.add_parser("serve",
                             help="HTTP transcription service (dynamic micro-batching)")
    _model_args(p_serve, int8_compute=True)
    p_serve.add_argument("--host", default="127.0.0.1")
    p_serve.add_argument("--port", type=int, default=8000)
    p_serve.add_argument("--max-batch", type=int, default=16,
                         help="dynamic batcher: max requests per device dispatch")
    p_serve.add_argument("--max-wait-ms", type=float, default=10.0,
                         help="dynamic batcher: batching window after the first request")
    p_serve.add_argument("--max-queue", type=int, default=None,
                         help="bounded backlog: past this many queued requests the server "
                              "sheds load with 503 + Retry-After (default 8 x max-batch; "
                              "0 = unbounded)")
    p_serve.add_argument("--no-warm-up", action="store_true",
                         help="skip running every length bucket once before binding")
    p_serve.add_argument("--warm-beam", action="store_true",
                         help="also load (and build, where none is cached) the stream "
                              "beam's kernels before binding, so that the first beam "
                              "session's feeds load none")
    p_serve.add_argument("--device-streams", action="store_true",
                         help="device-resident streaming sessions: every session's window "
                              "stays on the device")
    p_serve.add_argument("--beam-mode", choices=("posterior", "resident"),
                         default="posterior",
                         help="'resident' keeps every beam session's carry in the device "
                              "pool and advances it inside the feed (needs "
                              "--device-streams)")
    p_serve.add_argument("--beam-engine", choices=("auto", "xla", "pallas"),
                         default="auto",
                         help="stream beam decoder: 'pallas' the span and stitch kernels, "
                              "'xla' the plain batched beam step, 'auto' the kernels "
                              "whenever they express the search")
    p_transcribe = sub.add_parser("transcribe",
                                  help="transcribe audio files offline (wav/flac)")
    p_transcribe.add_argument("files", nargs="+", help="audio files (wav or flac)")
    _model_args(p_transcribe)
    p_transcribe.add_argument("--timestamps", action="store_true",
                              help="include word-level emission timestamps (requires "
                                   "--json)")
    p_transcribe.add_argument("--long-form", action="store_true",
                              help="segment at silences for long recordings (> the "
                                   "largest sample bucket)")
    p_transcribe.add_argument("--json", action="store_true", dest="as_json",
                              help="one JSON object per file on stdout")
    p_transcribe.add_argument("--dispatch-batch", type=int, default=16,
                              help="files per batched device dispatch")
    p_transcribe.add_argument("--nbest", type=int, default=1,
                              help="emit the top-N hypotheses with path scores (requires "
                                   "--json)")
    p_align = sub.add_parser(
        "align", help="forced alignment: word timestamps for a known transcript")
    p_align.add_argument("file", help="audio file (wav or flac)")
    p_align.add_argument("--text", default=None,
                         help="the transcript to align (default: read from --text-file)")
    p_align.add_argument("--text-file", default=None, help="file holding the transcript")
    _model_args(p_align, kenlm=False)
    p_export = sub.add_parser("export", help="write an export bundle (torch.export "
                                             "programs + weights)")
    _add_export_args(p_export)
    p_convert = sub.add_parser(
        "convert", help="convert a checkpoint between .npz and the reference's Keras .h5")
    p_convert.add_argument("source", help="weights file (.npz or .h5/.hdf5)")
    p_convert.add_argument("destination", help="output file with the other extension")
    p_record = sub.add_parser("record", help="record from the microphone and transcribe")
    _add_config_args(p_record)
    p_record.add_argument("--run", default=None, help="run name to load (default: best)")
    p_record.add_argument("--epoch", type=int, default=None)
    args = parser.parse_args(argv)
    if args.command == "convert":
        _convert_checkpoint(Path(args.source), Path(args.destination))
        return
    if args.command == "record":
        _record(args)
        return
    if args.command in ("train", "transfer", "test", "validate", "average", "summarize",
                        "fill-cache"):
        _run_workflow(args, workflow_parsers)
        return
    if args.command == "transcribe":
        _transcribe(args, p_transcribe)
        return
    if args.command == "align":
        _align(args, p_align)
        return
    if args.command == "export":
        _export(args, p_export)
        return
    # Refused before any weights load or warm-up runs.
    _check_backend_args(args, p_serve)
    if args.beam_mode == "resident" and not args.device_streams:
        p_serve.error("--beam-mode resident needs --device-streams (the beam carry lives "
                      "in the pooled device state)")
    if args.beam_engine == "pallas" and args.lexicon:
        p_serve.error("--beam-engine pallas has no lexicon constraint: lexicon stream "
                      "sessions take --beam-engine xla (or auto)")

    from .serving_http import TranscriptionServer

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    transcriber = _serving_backend(args)
    if not args.no_warm_up and args.bundle is None:  # a bundle's programs are built
        transcriber.warm_up()
    server = TranscriptionServer(transcriber, host=args.host, port=args.port,
                                 max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                                 max_queue=args.max_queue,
                                 device_streams=args.device_streams,
                                 beam_engine=args.beam_engine, beam_mode=args.beam_mode)
    if args.device_streams and not args.no_warm_up:
        server.streams.warm_up()
    if args.warm_beam:
        from .ops import _kernels

        try:
            server.streams.warm_up_beam()
        except ValueError as error:  # a pool whose feed returns no posteriors
            raise SystemExit("--warm-beam: {}".format(error))
        logging.getLogger(__name__).info(
            "beam warm-up done; kernels built or found in this process: %s",
            ", ".join(_kernels.builds) or "none")
    server.serve_forever()


if __name__ == "__main__":
    main()
