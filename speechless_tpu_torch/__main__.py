"""Command-line interface: ``python -m speechless_tpu_torch serve ...``.

    python -m speechless_tpu_torch serve --checkpoint nets/run/weights-epoch9.npz \\
        --kenlm kenlm/english --device cuda:0 --port 8000

serves the port's HTTP transcription API (`serving_http.py`: ``/v1/transcribe`` and the
``/v1/stream`` session routes) from a checkpoint written by either package
(``layer{i}.{w,b}`` entries).
"""
import argparse
import logging
from pathlib import Path

from .models.wav2letter import Wav2LetterConfig
from .serving import CHARSETS, Transcriber
from .serving_http import TranscriptionServer
from .train.checkpoint import load_params_npz


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="speechless_tpu_torch",
                                     description="wav2letter speech recognition on "
                                                 "PyTorch/CUDA")
    sub = parser.add_subparsers(dest="command", required=True)
    p_serve = sub.add_parser("serve",
                             help="HTTP transcription service (dynamic micro-batching)")
    p_serve.add_argument("--checkpoint", required=True,
                         help="weights file (weights-epoch{n}.npz)")
    p_serve.add_argument("--kenlm", default=None,
                         help="directory holding lm.arpa: serve LM-fused beam "
                              "transcriptions (default: greedy)")
    p_serve.add_argument("--charset", choices=sorted(CHARSETS), default="english")
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
    p_serve.add_argument("--device", default="cuda:0", help="torch device to serve on")
    p_serve.add_argument("--device-streams", action="store_true",
                         help="device-resident streaming sessions (not ported yet)")
    p_serve.add_argument("--beam-mode", choices=("posterior", "resident"),
                         default="posterior",
                         help="'resident' keeps the beam carry in the device pool (not "
                              "ported yet)")
    args = parser.parse_args(argv)
    # Refused before any weights load or warm-up runs.
    if args.device_streams or args.beam_mode == "resident":
        p_serve.error("--device-streams and --beam-mode resident (device-resident "
                     "streaming sessions) are not ported yet (ROADMAP.md, item 11)")

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    characters = CHARSETS[args.charset]
    params = load_params_npz(Path(args.checkpoint))
    config = Wav2LetterConfig(input_size_per_time_step=params[0]["w"].shape[1],
                              grapheme_set_size=len(characters) + 1)
    transcriber = Transcriber(config, params, characters, device=args.device,
                              kenlm_directory=args.kenlm)
    if not args.no_warm_up:
        transcriber.warm_up()
    TranscriptionServer(transcriber, host=args.host, port=args.port,
                        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                        max_queue=args.max_queue).serve_forever()


if __name__ == "__main__":
    main()
