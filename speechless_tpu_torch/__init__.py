"""speechless_tpu_torch — the PyTorch/CUDA port of `speechless_tpu` for NVIDIA Hopper.

The JAX package (`speechless_tpu`) stays the reference; this package mirrors its module
paths so each counterpart is easy to find. It imports `torch` and never `jax`. Of the
JAX package it reuses only the jax-free host modules `speechless_tpu.text.graphemes`,
`speechless_tpu.text.charsets` and `speechless_tpu.utils.microbatch`.

Ported so far: the LM-fused serving path — features, the wav2letter conv stack, the
word-LM beam on the hand-written CUDA beam-step kernel (`csrc/lm_beam_step.cu`), the
`Transcriber`, and the HTTP server (`python -m speechless_tpu_torch serve`).
"""

__version__ = "0.1.0"
