#!/usr/bin/env python3
"""Quality of the port's training and evaluation facade on a synthetic corpus: the port's
counterpart of `examples/scaled_quality_eval.py` without the transfer part.

    python3 synthetic_quality.py [--device cuda:0] [--out results.json]
    python3 synthetic_quality.py --smoke --device cpu      # a tiny run of the same flow

Writes a LibriSpeech-layout corpus with `data/synthetic.py` (1,000 standard-tier
utterances of 2-10 s, seed 0; no download), fills the spectrogram cache, trains the
full-width wav2letter through `Configuration.train_or_resume` (batch 64, 100 batches an
epoch, 15 epochs, 10 updates a step call, bf16 on CUDA), builds a word trigram LM from
the training transcripts with the port's `arpa_builder`, and evaluates the epoch-15
checkpoint on the held-out 10 %: greedy decoding on the device and the host's LM beam
(width 100, the reference's weights). Prints one JSON object of walls, the train rate
from ``scalars.csv``, LER/WER and the card's name and power limit, and writes it to
``--out``. Everything it writes lies under ``--data-dir`` (default
``build/synthetic-quality`` in the checkout, which git ignores); a second run reuses
the corpus, the cache and the trained run.
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
    parser.add_argument("--epochs", type=int, default=15)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--steps-per-epoch", type=int, default=100)
    parser.add_argument("--multi-step", type=int, default=10,
                        help="updates per step call (trainer.make_multi_step)")
    parser.add_argument("--smoke", action="store_true",
                        help="24 utterances, 2 epochs of 4 batches of 8: the flow, not "
                             "the numbers")
    args = parser.parse_args()
    if args.smoke:
        args.utterances, args.epochs, args.batch_size = 24, 2, 8
        args.steps_per_epoch, args.multi_step = 4, 2
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

    run_name = "quality-english" + ("-smoke" if args.smoke else "")
    start = time.perf_counter()
    config.train_or_resume(run_name, epoch_limit=args.epochs, callback_step=5,
                           multi_step=args.multi_step,
                           wav2letter_kwargs={"device": args.device})
    scalars_file = directories.tensorboard_log_base_directory / run_name / "scalars.csv"
    rows = [line.split(",") for line in scalars_file.read_text().strip().splitlines()[1:]]
    results["train"] = {
        "wall_s": time.perf_counter() - start,
        "epochs": [{"epoch": int(r[0]), "step": int(r[1]), "loss": float(r[2]),
                    "utterances_per_s": float(r[3]), "s_per_batch": float(r[4])}
                   for r in rows]}

    for name, use_kenlm in (("greedy", False), ("beam_lm", True)):
        wav2letter = config.load_model(run_name, args.epochs,
                                       allowed_characters_for_loaded_model=None,
                                       use_kenlm=use_kenlm, device=args.device)
        start = time.perf_counter()
        result = wav2letter.test_and_predict_batches(config.batch_generator.test_batches())
        results[name] = {"letter_error_rate": result.average_letter_error_rate,
                         "word_error_rate": result.average_word_error_rate,
                         "loss": result.average_loss, "examples": len(result.results),
                         "decode_wall_s": time.perf_counter() - start}
        log("[{}] {}".format(name, result.summary_line()))
    out = args.out or args.data_dir / "quality_results.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    print(json.dumps(results))


if __name__ == "__main__":
    main()
