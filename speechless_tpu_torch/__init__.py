"""speechless_tpu_torch — the PyTorch/CUDA port of `speechless_tpu` for NVIDIA Hopper.

The JAX package (`speechless_tpu`) stays the reference; this package mirrors its module
paths so each counterpart is easy to find. It imports `torch` and never `jax` nor
anything of `speechless_tpu`: it keeps its own copies of the JAX package's jax-free host
modules (`text.charsets`, `text.graphemes`, `text.metrics`, `utils.microbatch`,
`utils.tools`, `utils.tensorboard`, `lm.char_ngram`, `data/`, `features/example.py`,
`train/preemption.py` and the C++ sources of `native/`).

Ported so far: the LM-fused serving path — features, the wav2letter conv stack, the
word-LM beam on the hand-written CUDA beam-step kernel (`csrc/lm_beam_step.cu`), the
`Transcriber`, and the HTTP server (`python -m speechless_tpu_torch serve`); the CTC
training step (`train/trainer.py`) on the hand-written CTC kernels
(`csrc/ctc_alpha.cu`, and `csrc/ctc_beta_grad.cu`, the β recursion fused with the
gradient) with `.npz` checkpoints (`train/checkpoint.py`);
streaming sessions (`serving_streaming.py`, `csrc/stream_stitch.cu`); and offline
decoding on every beam route (`ops/device_beam.py`: the whole-utterance kernel
`csrc/prefix_beam.cu`, the plain batched beam with char LM, lexicon and n-best),
served by ``?nbest=N``, ``serve --lexicon`` and ``python -m speechless_tpu_torch
transcribe``; and the training and evaluation facade (`system.py::Wav2Letter`,
`configuration.py`, `experiments.py`, the corpus pipeline in `data/`) behind ``python -m
speechless_tpu_torch train | test | validate | summarize | fill-cache``; and the model
variants: the ASG criterion (`ops/asg.py`), the raw-wave family and the activations,
and the reference's Keras ``.h5`` checkpoints (`train/keras_import.py`, ``convert``).
"""

__version__ = "0.2.0"
