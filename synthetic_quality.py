#!/usr/bin/env python3
"""Quality of the port's training and evaluation facade on a synthetic corpus: the port's
counterpart of `examples/scaled_quality_eval.py`.

    python3 synthetic_quality.py [--device cuda:0] [--out results.json] [--transfer]
    python3 synthetic_quality.py --asg [--trainable-transitions]
    python3 synthetic_quality.py --smoke --device cpu      # a tiny run of the same flow

Writes a LibriSpeech-layout corpus with `data/synthetic.py` (1,000 standard-tier
utterances of 2-10 s, seed 0; no download), fills the spectrogram cache, trains the
full-width wav2letter through `Configuration.train_or_resume` (batch 64, 100 batches an
epoch, 15 epochs, 10 updates a step call, bf16 on CUDA), builds a word trigram LM from
the training transcripts with the port's `arpa_builder`, and evaluates the epoch-15
checkpoint on the held-out 10 %: greedy decoding on the device and the host's LM beam
(width 100, the reference's weights). With ``--transfer`` it then transfers that model to
German characters as `examples/scaled_quality_eval.py` does: 300 synthetic German
utterances (seed 100, 80 % training), the output layer remapped and layers 0-7 frozen,
8 epochs (numbered on from the English run's), and greedy and LM-beam LER/WER on the
held-out 20 % with a German trigram of the training transcripts, printed beside the
JAX package's record `QUALITY_r02_german_beam.json` (nothing holds one to the other).
With ``--asg`` it trains the ASG criterion instead, as `examples/asg_quality_eval.py`
does: the same corpus, 20 epochs of 100 batches of 64 on the device-resident corpus
(``--trainable-transitions``: the tables trained too), and greedy LER/WER on the
held-out 10 % (per-frame argmax, or with trained tables the Viterbi over them; ASG has
no LM beam), printed beside the JAX package's record `QUALITY_r02_asg.json`.
Prints one JSON object of walls, the train rates from ``scalars.csv``, LER/WER and the
card's name and power limit, and writes it to ``--out``. Everything it writes lies
under ``--data-dir`` (default ``build/synthetic-quality`` in the checkout, which git
ignores); a second run reuses the corpus, the cache and the trained runs.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def card_name_and_power_limit() -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: n/a"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data-dir", type=Path, default=ROOT / "build" / "synthetic-quality")
    parser.add_argument("--out", type=Path, default=None,
                        help="results JSON (default: <data-dir>/quality_results.json)")
    parser.add_argument("--device", default="cuda:0")
    parser.add_argument("--utterances", type=int, default=1000)
    parser.add_argument("--epochs", type=int, default=None,
                        help="training epochs (default 15, with --asg 20)")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--steps-per-epoch", type=int, default=100)
    parser.add_argument("--multi-step", type=int, default=10,
                        help="updates per step call (trainer.make_multi_step)")
    parser.add_argument("--transfer", action="store_true",
                        help="then transfer the English model to German characters")
    parser.add_argument("--transfer-utterances", type=int, default=300)
    parser.add_argument("--transfer-epochs", type=int, default=8)
    parser.add_argument("--frozen-layers", type=int, default=8)
    parser.add_argument("--asg", action="store_true",
                        help="train the ASG criterion on the device-resident corpus "
                             "instead (examples/asg_quality_eval.py's recipe)")
    parser.add_argument("--trainable-transitions", action="store_true",
                        help="with --asg: train the transition tables too")
    parser.add_argument("--smoke", action="store_true",
                        help="24 utterances, 2 epochs of 4 batches of 8 (12 German "
                             "utterances, 1 transfer epoch): the flow, not the numbers")
    args = parser.parse_args()
    if args.trainable_transitions and not args.asg:
        parser.error("--trainable-transitions requires --asg")
    if args.epochs is None:
        args.epochs = 20 if args.asg else 15
    if args.smoke:
        args.utterances, args.epochs, args.batch_size = 24, 2, 8
        args.steps_per_epoch, args.multi_step = 4, 2
        args.transfer_utterances, args.transfer_epochs = 12, 1
    sys.path.insert(0, str(ROOT))

    import torch

    from speechless_tpu_torch.configuration import Configuration, DataDirectories
    from speechless_tpu_torch.data.corpus import TrainingTestSplit
    from speechless_tpu_torch.data.librispeech import LibriSpeechCorpus
    from speechless_tpu_torch.data.synthetic import generate_corpus
    from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
    from speechless_tpu_torch.utils.tools import log

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("synthetic_quality: no CUDA device (pass --device cpu)")
    results = {"card": card_name_and_power_limit(), "device": args.device,
               "torch": torch.__version__, "settings": {
                   "utterances": args.utterances, "seed": 0, "difficulty": "standard",
                   "epochs": args.epochs, "batch_size": args.batch_size,
                   "steps_per_epoch": args.steps_per_epoch, "multi_step": args.multi_step}}
    directories = DataDirectories(args.data_dir)
    start = time.perf_counter()
    generate_corpus(directories.corpus_base_directory / "English", "synthetic",
                    utterance_count=args.utterances, seed=0)
    results["corpus_s"] = time.perf_counter() - start
    config = Configuration(
        name="English",
        corpus_from_directory=lambda d: LibriSpeechCorpus(
            base_directory=d, corpus_name="synthetic",
            training_test_split=TrainingTestSplit.randomly(0.9)),
        directories=directories, batch_size=args.batch_size,
        training_batches_per_epoch=args.steps_per_epoch)
    start = time.perf_counter()
    config.fill_cache()
    results["cache_fill"] = {"wall_s": time.perf_counter() - start,
                             "examples": len(config.batch_generator.labeled_spectrograms)}
    build_kenlm_directory((e.label for e in config.corpus.training_examples),
                          directories.kenlm_base_directory / config.name.lower(),
                          allowed_characters=config.allowed_characters, order=3)

    if args.asg:
        asg(args, config, results)
        return
    run_name = "quality-english" + ("-smoke" if args.smoke else "")
    start = time.perf_counter()
    config.train_or_resume(run_name, epoch_limit=args.epochs, callback_step=5,
                           multi_step=args.multi_step,
                           wav2letter_kwargs={"device": args.device})
    train_wall_s = time.perf_counter() - start

    def evaluate(configuration, run, epoch, prefix=""):
        for name, use_kenlm in (("greedy", False), ("beam_lm", True)):
            wav2letter = configuration.load_model(run, epoch,
                                                  allowed_characters_for_loaded_model=None,
                                                  use_kenlm=use_kenlm, device=args.device)
            start = time.perf_counter()
            result = wav2letter.test_and_predict_batches(
                configuration.batch_generator.test_batches())
            results[prefix + name] = {
                "letter_error_rate": result.average_letter_error_rate,
                "word_error_rate": result.average_word_error_rate,
                "loss": result.average_loss, "examples": len(result.results),
                "decode_wall_s": time.perf_counter() - start}
            log("[{}] {}".format(prefix + name, result.summary_line()))

    results["train"] = {"wall_s": train_wall_s, "epochs": train_rates(config, run_name)}
    evaluate(config, run_name, args.epochs)
    if args.transfer:
        transfer(args, directories, run_name, results, evaluate)
    write_results(args, results, "quality_results.json")


def train_rates(configuration, run):
    scalars = configuration.directories.tensorboard_log_base_directory / run / "scalars.csv"
    rows = [line.split(",") for line in scalars.read_text().strip().splitlines()[1:]]
    return [{"epoch": int(r[0]), "step": int(r[1]), "loss": float(r[2]),
             "utterances_per_s": float(r[3]), "s_per_batch": float(r[4])} for r in rows]


def write_results(args, results, default_name: str) -> None:
    out = args.out or args.data_dir / default_name
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    print(json.dumps(results))


def asg(args, config, results) -> None:
    """`examples/asg_quality_eval.py`'s recipe: the ASG criterion (with
    ``--trainable-transitions`` trained tables) on the device-resident corpus, then
    greedy LER/WER on the held-out examples."""
    from speechless_tpu_torch.utils.tools import log

    options = {"device": args.device, "use_asg": True,
               "train_asg_transitions": args.trainable_transitions}
    run_name = "quality-asg" + ("-trainable" if args.trainable_transitions else "") + (
        "-smoke" if args.smoke else "")
    start = time.perf_counter()
    config.train_or_resume(run_name, epoch_limit=args.epochs, callback_step=5,
                           device_resident=True, wav2letter_kwargs=options)
    results["asg_train"] = {"wall_s": time.perf_counter() - start,
                            "trainable_transitions": args.trainable_transitions,
                            "epochs": train_rates(config, run_name)}
    wav2letter = config.load_model(run_name, args.epochs,
                                   allowed_characters_for_loaded_model=None, **options)
    start = time.perf_counter()
    result = wav2letter.test_and_predict_batches(config.batch_generator.test_batches())
    results["asg_greedy"] = {"letter_error_rate": result.average_letter_error_rate,
                             "word_error_rate": result.average_word_error_rate,
                             "loss": result.average_loss, "examples": len(result.results),
                             "decode_wall_s": time.perf_counter() - start}
    log("[asg] {}".format(result.summary_line()))
    record = ROOT / "QUALITY_r02_asg.json"
    if record.exists():
        results["jax_tpu_record_asg"] = json.loads(record.read_text())
    write_results(args, results, "asg_results{}.json".format(
        "_trainable" if args.trainable_transitions else ""))


def transfer(args, directories, english_run, results, evaluate) -> None:
    """English -> German: the English run's last epoch with its output layer remapped to
    the German characters and the first ``--frozen-layers`` layers frozen, trained on a
    synthetic German corpus, then evaluated greedily and with the LM beam."""
    from speechless_tpu_torch.configuration import Configuration
    from speechless_tpu_torch.data.corpus import TrainingTestSplit
    from speechless_tpu_torch.data.librispeech import LibriSpeechCorpus
    from speechless_tpu_torch.data.synthetic import generate_corpus
    from speechless_tpu_torch.experiments import available_epochs
    from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
    from speechless_tpu_torch.text.charsets import (english_frequent_characters,
                                                    german_frequent_characters)

    start = time.perf_counter()
    generate_corpus(directories.corpus_base_directory / "German", "synthetic-de",
                    utterance_count=args.transfer_utterances, seed=100,
                    characters=german_frequent_characters)
    german = Configuration(
        name="German", allowed_characters=german_frequent_characters,
        corpus_from_directory=lambda d: LibriSpeechCorpus(
            base_directory=d, corpus_name="synthetic-de",
            allowed_characters=german_frequent_characters,
            training_test_split=TrainingTestSplit.randomly(0.8)),
        directories=directories, batch_size=args.batch_size,
        training_batches_per_epoch=args.steps_per_epoch)
    german.fill_cache()
    build_kenlm_directory((e.label for e in german.corpus.training_examples),
                          directories.kenlm_base_directory / german.name.lower(),
                          allowed_characters=german.allowed_characters, order=3)
    results["transfer_corpus_s"] = time.perf_counter() - start

    # The transfer run continues the donor's epoch numbering (the reference's
    # initial_epoch = load_epoch), so its last epoch is the donor's plus the budget.
    run = "quality-german-transfer-freeze-{}".format(args.frozen_layers) + (
        "-smoke" if args.smoke else "")
    last_epoch = args.epochs + args.transfer_epochs
    start = time.perf_counter()
    if last_epoch not in available_epochs(directories.nets_base_directory / run):
        wav2letter = german.load_model(
            english_run, args.epochs, frozen_layer_count=args.frozen_layers,
            allowed_characters_for_loaded_model=english_frequent_characters,
            device=args.device)
        german.train(wav2letter, run_name=run, epoch_limit=last_epoch,
                     callback_step=args.transfer_epochs, multi_step=args.multi_step)
    results["transfer_train"] = {"wall_s": time.perf_counter() - start,
                                 "frozen_layers": args.frozen_layers,
                                 "utterances": args.transfer_utterances,
                                 "epochs": train_rates(german, run)}
    evaluate(german, run, last_epoch, prefix="transfer_")
    record = ROOT / "QUALITY_r02_german_beam.json"
    if record.exists():
        results["jax_tpu_record_german_beam"] = json.loads(record.read_text())


if __name__ == "__main__":
    main()
