"""The plain reference against the port at tiny sizes on the CPU."""
import numpy as np
import pytest
import torch

from benchmark.harness import core, traffic
from benchmark.reference import beam, mel, serve, train
from benchmark.reference import w2l as plain
from benchmark.reference.lm import Arpa

CONFIG = core.load_json("configs", "w2l-mel-en")
LM_SPEC = dict(core.load_json("traffic", "test-clean-batch")["lm"], vocabulary=60,
               sentences=300, word_letters=[2, 4])


def weights(seed=0):
    return plain.glorot_weights(CONFIG["layers"], 128,
                                torch.Generator().manual_seed(seed), "cpu")


def test_plain_stack_matches_the_port_model():
    from speechless_tpu_torch.models import wav2letter as w2l

    w = weights()
    program = w2l.build_model(
        w2l.Wav2LetterConfig(128, 29),
        [{"w": a.permute(2, 1, 0).numpy(), "b": b.numpy()} for a, b in w], device="cpu")
    x = torch.randn(2, 37, 128, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.allclose(program(x), plain.forward(w, CONFIG["layers"], x), atol=1e-4)


def test_features_match_the_port():
    from speechless_tpu_torch.features.spectrogram import features_batch

    audio = traffic.audio_clips(np.array([7000, 12345]), 3, "cpu")
    bucket = 16384
    wavs = np.zeros((2, bucket), np.float32)
    for row, clip in enumerate(audio):
        wavs[row, :len(clip)] = clip
    program, _ = features_batch(torch.from_numpy(wavs), torch.tensor([7000, 12345]))
    for row, clip in enumerate(audio):
        reference = mel.features(clip, bucket)
        assert np.abs(program[row].numpy() - reference).max() < 2e-4


def test_ctc_matches_the_port_loss():
    from speechless_tpu_torch.ops.ctc_kernels import ctc_loss_from_logits

    g = torch.Generator().manual_seed(2)
    logits = torch.randn(3, 20, 29, generator=g)
    frames = torch.tensor([40, 33, 25])
    labels = torch.randint(0, 28, (3, 6), generator=g, dtype=torch.int32)
    counts = torch.tensor([6, 4, 5], dtype=torch.int32)
    labels[1, 4:] = -1
    labels[2, 5:] = -1
    program = ctc_loss_from_logits(logits, (frames // 2).to(torch.int32), labels, counts, 28)
    assert torch.allclose(program.double(), train.ctc_losses(logits, frames, labels, counts, 2),
                          rtol=1e-5)


@pytest.fixture(scope="module")
def lm_file(tmp_path_factory):
    directory = tmp_path_factory.mktemp("lm")
    traffic.write_lm(LM_SPEC, 5, directory)
    return directory


def test_arpa_scores_match_the_port_reader(lm_file):
    from speechless_tpu_torch.lm.ngram import ArpaLanguageModel

    program = ArpaLanguageModel.load(lm_file / "lm.arpa")
    reference = Arpa((lm_file / "lm.arpa").read_text())
    words = sorted(reference.vocabulary)[:12] + ["zzzz"]
    for c1 in words[:4] + ["<s>"]:
        for c2 in words[4:8] + ["<s>"]:
            for w in words:
                context = [x for x in (c1, c2) if x != "<s>"] if c1 != "<s>" else (
                    [c2] if c2 != "<s>" else [])
                if c1 == "<s>" or c2 == "<s>":
                    continue
                assert reference.score(reference.normal(c1), reference.normal(c2),
                                       reference.normal(w)) == pytest.approx(
                    program.score_word(context, w), abs=1e-9)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_matches_the_port_beam(lm_file, seed):
    from speechless_tpu_torch.lm.device_lm import build_device_word_lm
    from speechless_tpu_torch.lm.ngram import ArpaLanguageModel
    from speechless_tpu_torch.ops.decode_lm import beam_search_decode_lm

    alphabet = CONFIG["alphabet"]
    g = torch.Generator().manual_seed(seed)
    logits = 8.0 * torch.randn(2, 40, 29, generator=g)
    log_probs = logits.log_softmax(-1)
    lengths = torch.tensor([40, 31])
    word_lm = build_device_word_lm(ArpaLanguageModel.load(lm_file / "lm.arpa"),
                                   list(alphabet))
    serve_config = CONFIG["serve"]
    tokens, counts = beam_search_decode_lm(
        log_probs, lengths, 28, word_lm, beam_width=serve_config["beam_width"],
        max_decoded_length=40, prune_classes=serve_config["prune_classes"],
        **beam.weights_of(serve_config))
    reference = Arpa((lm_file / "lm.arpa").read_text())
    for row in range(2):
        program = "".join(alphabet[c] for c in tokens[row, :int(counts[row])].tolist())
        lp = log_probs[row, :int(lengths[row])].double().numpy()
        text = beam.decode(lp, alphabet, reference, serve_config["beam_width"],
                           serve_config["prune_classes"], beam.weights_of(serve_config))
        assert text == program


def test_buckets_match_the_transcriber():
    from speechless_tpu_torch.serving import Transcriber

    assert serve.SAMPLE_BUCKETS == Transcriber.__init__.__kwdefaults__["sample_buckets"]
    for samples in (1, 16384, 16385, 524288, 524289, 700000):
        assert serve.bucket(samples) == Transcriber._bucket(
            type("T", (), {"sample_buckets": serve.SAMPLE_BUCKETS})(), samples)
