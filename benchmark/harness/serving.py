"""What the serving drivers share: the weights, audio and word LM made from the seed, the
`Transcriber` over them, and the record of what each dispatch computed.

`Observer` wraps the Transcriber's ``_log_probs`` on the instance (features -> model ->
log-softmax of one dispatch): it counts each dispatch's rows and frames, and keeps the
log-probs of the utterances the check samples (each known by its length, which differs
from every other's), which the check holds to the reference. It reads only shapes and
host lengths and keeps a view of each sampled row, so it adds no wait for the card
between the model and the beam; the check trims a row to its valid frames after the
window.
"""
import gc
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import traffic as inputs
from . import yardstick
from ..reference import w2l as plain


class Observer:
    def __init__(self, transcriber, wanted_samples):
        self.wanted = set(int(n) for n in wanted_samples)
        self.saved = {}
        self.dispatches = []
        self.counting = False
        original = transcriber._log_probs

        def observed(wavs, lengths):
            log_probs, counts = original(wavs, lengths)
            if self.counting:
                self.dispatches.append((int(log_probs.shape[0]), int(log_probs.shape[1])))
            for row, samples in enumerate(lengths.tolist()):
                if samples in self.wanted:
                    self.saved[samples] = log_probs[row]
            return log_probs, counts

        transcriber._log_probs = observed


def peaky_output(weights, layers, clips, serve: dict, device):
    """``weights`` with the output layer set so that frames are decisive and mostly
    blank, as a trained CTC model's are: Glorot weights give every frame nearly the
    same logits (a class offset with a small frame-to-frame part), so the layer is
    rescaled to make the frame-to-frame part's deviation ``output_logit_std`` and its
    bias cancels the offsets, plus ``blank_bias`` for the blank (the last class). The
    offsets and deviation are read from ``clips`` through the plain stack (fp32)."""
    from ..reference import mel, serve as plain_serve

    with torch.no_grad():
        logits = torch.cat([
            plain.forward(weights, layers, torch.from_numpy(mel.features(
                clip, plain_serve.bucket(len(clip)))).to(device, torch.float32)[None])[
                0, : plain_serve.valid_frames(len(clip))] for clip in clips])
    offset = logits.mean(0)
    scale = serve["output_logit_std"] / float((logits - offset).std())
    w, b = weights[-1]
    bias = -scale * offset
    bias[-1] += serve["blank_bias"]
    return weights[:-1] + [(w * scale, bias)]


class Serving:
    """Weights, audio clips, LM and Transcriber of one serving cell."""

    def __init__(self, record, device, seed: int, clips: int, fault=None):
        from speechless_tpu_torch.models import wav2letter as w2l
        from speechless_tpu_torch.serving import Transcriber

        config, mix = record.config, record.traffic
        self.config, self.mix, self.device = config, mix, device
        self.serve = config["serve"]
        self.layers = config["layers"]
        self.alphabet = config["alphabet"]
        record.stage("kernel_load")  # the span and backtrace kernels load at first launch
        generator = torch.Generator(device=device).manual_seed(seed)
        weights = plain.glorot_weights(self.layers, config["input_size"], generator, device)
        seconds = inputs.length_seconds(mix["lengths"], clips)
        self.samples = inputs.distinct_samples(seconds)[inputs.permutation(seed, clips)]
        self.clips = inputs.audio_clips(self.samples, seed, device)
        self.weights = peaky_output(weights, self.layers, self.clips[:4], self.serve, device)
        program = w2l.Wav2LetterConfig(input_size_per_time_step=config["input_size"],
                                       grapheme_set_size=config["classes"])
        params = [{"w": w.permute(2, 1, 0).cpu().numpy(), "b": b.cpu().numpy()}
                  for w, b in self.weights]
        lm_weight = self.serve["lm_weight"]
        if fault and fault.startswith("lm_weight_x"):  # a fault: the LM scores mis-scaled
            lm_weight *= float(fault[len("lm_weight_x"):])
        directory = Path(tempfile.mkdtemp(prefix="speechless-bench-"))
        try:
            self.arpa = inputs.write_lm(mix["lm"], seed, directory).read_text()
            record.stage("inputs")
            self.transcriber = Transcriber(
                program, params, list(self.alphabet), device=device,
                kenlm_directory=directory, beam_width=self.serve["beam_width"],
                lm_weight=lm_weight,
                word_count_weight=self.serve["word_count_weight"],
                valid_word_count_weight=self.serve["valid_word_count_weight"],
                prune_classes=self.serve["prune_classes"])
        finally:
            shutil.rmtree(directory, ignore_errors=True)
        record.stage("transcriber")
        self.seed = seed
        self.choose_sample(range(clips))
        self.observer = Observer(self.transcriber, self.samples[self.sample])
        self.frames = [yardstick.feature_frames(int(n)) for n in self.samples]
        self.flops = [yardstick.serve_flops(self.layers, config["input_size"], f)
                      for f in self.frames]

    def choose_sample(self, candidates) -> None:
        """The clips the check compares: the longest of ``candidates`` and others drawn
        from the seed, ``check_requests`` in all; the observer keeps their log-probs."""
        candidates = sorted(candidates)
        longest = max(candidates, key=lambda i: self.samples[i])
        others = [candidates[i] for i in np.random.default_rng(self.seed).permutation(
            len(candidates)) if candidates[i] != longest]
        self.sample = [longest] + others[: self.mix["check_requests"] - 1]
        if hasattr(self, "observer"):
            self.observer.wanted = set(int(self.samples[i]) for i in self.sample)

    def span_bytes(self) -> float:
        classes = self.layers[-1]["filters"]
        k = min(self.serve["prune_classes"], classes)
        lanes = yardstick.next_pow2(max(self.serve["beam_width"], 8))
        return sum(yardstick.span_bytes(rows, frames, k, classes, lanes)
                   for rows, frames in self.observer.dispatches)

    def release(self) -> None:
        """Free the program's state (the observer's hook holds the Transcriber in a
        reference cycle)."""
        del self.transcriber
        gc.collect()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()
