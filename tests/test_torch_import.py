"""The port (`speechless_tpu_torch`) never imports jax nor anything of the JAX package
(`speechless_tpu`): no module of the port or `chip_smoke.py` names one, and a fresh
interpreter imports every module of the package, serves a small LM-fused transcription
through the HTTP server, takes one training step, trains the facade one epoch through
`Configuration.train` and runs `Configuration.test_model` on the CPU, then checks
``sys.modules`` (the machines with a GPU have no jax). A spawned cache-fill worker that
has computed an entry holds no torch (so no CUDA state) at all."""
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys, tempfile, urllib.request
from pathlib import Path

import numpy as np

import speechless_tpu_torch
for module in pkgutil.walk_packages(speechless_tpu_torch.__path__, "speechless_tpu_torch."):
    importlib.import_module(module.name)

from speechless_tpu_torch.lm.arpa_builder import build_kenlm_directory
from speechless_tpu_torch.models import wav2letter as w2l
from speechless_tpu_torch.serving import Transcriber
from speechless_tpu_torch.serving_http import TranscriptionServer
from speechless_tpu_torch.text.charsets import english_frequent_characters as alphabet
from speechless_tpu_torch.train import trainer

layers = (w2l.ConvSpec("striding_conv", 8, 48, 2),
          w2l.ConvSpec("output_conv", len(alphabet) + 1, 1, 1, "linear"))
config = w2l.Wav2LetterConfig(128, len(alphabet) + 1, layers=layers)
with tempfile.TemporaryDirectory() as lm_directory:
    build_kenlm_directory(["the cat sat", "a dog ran"], Path(lm_directory), alphabet)
    transcriber = Transcriber(config, w2l.init_params(config, seed=0), alphabet,
                              device="cpu", kenlm_directory=lm_directory, beam_width=4,
                              sample_buckets=(16384,))
server = TranscriptionServer(transcriber, port=0)
server.start()
try:
    audio = np.random.default_rng(0).normal(size=8000).astype(np.float32) * 0.1
    request = urllib.request.Request(
        "http://127.0.0.1:{}/v1/transcribe".format(server.port),
        data=json.dumps({"pcm": audio.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=120) as response:
        assert response.status == 200
        assert json.loads(response.read())["text"] == transcriber.transcribe_audio(audio)
finally:
    server.stop()

optimizer = trainer.make_optimizer(1e-3)
state = trainer.init_train_state(config, optimizer, params=w2l.init_params(config, seed=0),
                                 device="cpu")
wavs = np.random.default_rng(1).normal(size=(1, 2, 4000)).astype(np.float32) * 0.1
labels = np.array([[[0, 1, 2], [3, 4, -1]]], np.int32)
state, metrics = trainer.make_multi_wav_step(config, optimizer, device="cpu")(
    state, trainer.WavBatch(wavs, np.full((1, 2), 4000, np.int32), labels,
                            np.array([[3, 2]], np.int32)))
assert state.step == 1 and np.isfinite(float(metrics["loss"]))

import multiprocessing
from speechless_tpu_torch.configuration import Configuration, DataDirectories
from speechless_tpu_torch.data import LibriSpeechCorpus, TrainingTestSplit, batching
from speechless_tpu_torch.features.audio_io import write_wav
from speechless_tpu_torch.system import Wav2Letter

with tempfile.TemporaryDirectory() as data:
    chapter = Path(data) / "corpus" / "English" / "mini" / "a" / "1" / "2"
    chapter.mkdir(parents=True)
    texts = ["the cat", "a dog", "the dog sat"]
    for i, text in enumerate(texts):
        write_wav(chapter / "1-2-{}.wav".format(i),
                  np.random.default_rng(i).normal(size=6000).astype(np.float32) * 0.1)
    (chapter / "1-2.trans.txt").write_text(
        "".join("1-2-{} {}\n".format(i, text.upper()) for i, text in enumerate(texts)))
    config = Configuration(
        "English", lambda d: LibriSpeechCorpus(d, "mini",
                                               training_test_split=TrainingTestSplit.overfit(2)),
        directories=DataDirectories(Path(data)), batch_size=2, training_batches_per_epoch=1)
    wav2letter = Wav2Letter(128, alphabet, device="cpu")
    config.train(wav2letter, run_name="run", epoch_limit=1)
    assert (Path(data) / "nets" / "run" / "weights-epoch1.npz").exists()
    config.test_model(wav2letter)
    entry = config.batch_generator.labeled_spectrograms[0]
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        pool.apply(batching._cache_spectrogram, (entry,))
        worker_modules = pool.apply(eval, (
            "sorted(m for m in __import__('sys').modules "
            "if m.split('.')[0] in ('torch', 'jax', 'speechless_tpu'))",))
    assert entry.is_cached()
    assert worker_modules == [], worker_modules
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "speechless_tpu"))
print("JAX-FREE" if not leaked else "IMPORTED {}".format(leaked))
"""


ALLOWED_FROM_JAX_PACKAGE = set()  # the port keeps its own copies (text/, utils/)


def test_port_imports_nothing_of_the_jax_package():
    """No module of the port (`data/german.py`, `data/device_dataset.py` and
    `ops/specaugment.py` among them) and nothing in `chip_smoke.py` or the card's timing
    and quality scripts imports jax or any module of `speechless_tpu`."""
    import ast

    sources = sorted((REPO / "speechless_tpu_torch").rglob("*.py")) + [
        REPO / name for name in ("chip_smoke.py", "ctc_step_split.py", "backtrace_split.py",
                                 "synthetic_quality.py")]
    names = {path.relative_to(REPO / "speechless_tpu_torch").as_posix() for path in sources
             if path.is_relative_to(REPO / "speechless_tpu_torch")}
    assert {"data/german.py", "data/device_dataset.py", "ops/specaugment.py"} <= names
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(encoding="utf8"))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib"), (path, name)
                if name.split(".")[0] == "speechless_tpu":
                    assert name in ALLOWED_FROM_JAX_PACKAGE, (path, name)


def test_port_serves_and_trains_without_importing_jax():
    result = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                            text=True, timeout=300, cwd=str(REPO))
    assert result.stdout.strip().endswith("JAX-FREE"), (result.stdout, result.stderr[-3000:])
