"""Synthetic speech-like corpus generation for realistic-scale quality evaluation.

The port's own copy of `speechless_tpu/data/synthetic.py`: with the same arguments it
writes byte-equal wavs and transcripts. LibriSpeech downloads (the original speechless
`english_corpus.py:122-160`) need network access; where there is none, end-to-end
quality numbers (LER/WER through greedy and LM-fused beam decoding) come from a
synthesized corpus with a *learnable* audio<->text mapping:

* every character (including space and apostrophe; umlauts for the German charset) is
  rendered as a unique two-tone "phone" from a canonical per-character registry — the
  same character sounds the same in every generated corpus, so cross-charset transfer
  (English model -> German charset) is acoustically meaningful;
* per-utterance variability keeps the task non-trivial: speaker frequency warp, per-phone
  duration/amplitude/phase jitter, a random echo tap, and additive noise with a
  per-utterance SNR drawn from a wide range;
* text is sampled word-by-word from a seeded Markov chain over an English-like vocabulary
  (with apostrophe words), so a word n-gram LM has real structure to exploit during beam
  fusion.

The directory tree follows the LibriSpeech layout (`<corpus>/<set>/<speaker>/<chapter>/`
with per-chapter ``*.trans.txt``), so `LibriSpeechCorpus` (data/librispeech.py) parses it
unchanged and quality runs drive the exact production facade: wav decode -> spectrogram
cache -> bucketed batches -> train -> decode.
"""
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.tools import log, mkdir

SAMPLE_RATE = 16000

# Canonical registry: index of every character this generator can voice. Shared characters
# keep their index (and therefore their tone pair) across charsets.
_REGISTRY = list("abcdefghijklmnopqrstuvwxyz '") + list("äöüß")

# Difficulty tiers (VERDICT round-2 #1: the standard tier saturates — 0.012% LER at 5k
# utterances — so decoder/LM/transfer deltas become unmeasurable; the hard tier is
# calibrated to land greedy decoding in a 5-15% LER band where they stay visible).
# Each tier is canonical per character: the same character sounds the same in every
# corpus generated at that tier, so cross-charset transfer stays meaningful.
DIFFICULTY_TIERS = {
    # 90 Hz low-band spacing, mild warp/jitter, SNR-comfortable noise.
    "standard": dict(low_spacing=90.0, high_spacing=260.0, warp=0.03,
                     duration_jitter=0.4, amplitude=(0.10, 0.30),
                     noise_range=(0.02, 0.15), babble_voices=0),
    # Confusable tone grid (~2 mel bins of low-band spacing at 500 Hz), wider speaker
    # warp and tempo jitter, lower signal amplitude, heavier noise floor plus babble
    # voices built from the same character tones (structured interference the mel
    # frontend cannot trivially separate). Calibrated DOWN from an initial
    # (38 Hz, 0.09 warp, 3 voices, 0.10-0.30 noise) setting that drove held-out greedy
    # LER to ~79% (the 1k-utterance training set memorizes instead of generalizing);
    # the target band is 5-15% greedy LER so beam/LM/transfer deltas stay measurable.
    # Calibration curve (1k utts, 40 epochs, clip 1.0 — evidence/QUALITY_r03_*):
    # 38 Hz/3 voices -> greedy 79% LER (train set memorizes); 55 Hz/2 voices -> greedy
    # 15.8% (word errors too dense for LM rescue, beam gap 1.16x); 65 Hz -> greedy
    # 2.77% (below band, gap 1.42x); 60 Hz -> 66% (the memorize-vs-learn transition is
    # a CLIFF in uniform-noise tiers). Final design grades difficulty PER UTTERANCE
    # instead: tone geometry from the reliably-generalizing 65 Hz point, noise drawn
    # from a wide (0.02, 0.26) range — like real corpora whose SNR varies per
    # utterance — so held-out error is a smooth mixture of clean and noisy utterances
    # rather than cliff-dominated, and the word LM has a mid-noise band to rescue.
    # On top of the graded utterance SNR, a fraction of UTTERANCES carry CONFUSION
    # bursts: individual phones rendered as a near-50/50 mix of the true character's
    # tones and another character's tones. The evidence for a burst phone is genuinely
    # consistent with two characters — no training disambiguates it — so greedy
    # decoding argmaxes the wrong one about half the time while the word-trigram beam
    # recovers it from context (a confused character almost always breaks the word).
    # Two calibration lessons shape the knobs (evidence/QUALITY_r03_hard_cal*.json):
    # (1) plain per-phone NOISE bursts are learnable — a model trained on them reads
    # through level-0.2 bursts on 18% of phones (cal7: held-out greedy 2.3% LER,
    # gap only 1.61x); (2) unconditional confusion bursts on 15% of ALL phones with
    # grid-NEIGHBOR partners poison the tightest decision margins in every utterance
    # and tip training over the memorize-vs-learn cliff (cal8: train loss 2.2 but
    # held-out greedy 53% LER from epoch 5 on — the model never generalizes). And a
    # third: bursts must be SPARSE WITHIN WORDS to stay rescuable — 25% of phones on a
    # 30% utterance subset put 2+ bursts in half the affected words, which no LM can
    # recover (cal9: greedy 8.1% in band, but gap only 1.25x). Hence: bursts on a
    # majority utterance subset (the clean rest still anchors generalization) at a low
    # per-phone rate, so isolated single-character corruptions dominate, and the mix
    # partner is a FAR character (uniform over non-neighbors in the shared base
    # registry), which leaves neighbor decision margins unpoisoned.
    # Locked operating point (cal11, evidence/QUALITY_r03_hard_cal11.json): greedy
    # 5.8% LER / 20.4% WER, word-LM beam 3.98% / 11.5% — mid-band with a 1.45x LER /
    # 1.77x WER beam gap. A thinner/tighter probe (0.85 utt x 0.09 phone, mix .4-.6;
    # cal12) landed just under band at the same 1.45x gap: the residual unrescued
    # errors are valid-word substitutions and multi-burst words, which scale with the
    # burst mass itself, so the gap plateaus while in-band — this point maximizes
    # measurability on both axes.
    "hard": dict(low_spacing=65.0, high_spacing=170.0, warp=0.05,
                 duration_jitter=0.5, amplitude=(0.09, 0.24),
                 noise_range=(0.02, 0.16), babble_voices=2,
                 utterance_confusion_prob=0.75, phone_confusion_prob=0.12,
                 phone_confusion_mix=(0.35, 0.65), confusion_partner="any"),
}

# Two-tone grids: 7 low x 5 high = 35 combinations >= len(_REGISTRY). Tones sit well below
# Nyquist (8 kHz) and are separable by the 128-bin mel frontend, but the low-band
# spacing keeps neighboring characters acoustically close enough that noisy utterances
# produce real substitution errors for the LM to correct.
_LOW_BASE = 500.0
_HIGH_BASE = 1500.0


def character_tones(character: str, difficulty: str = "standard"
                    ) -> Tuple[float, float]:
    """The canonical (low, high) tone pair voicing ``character`` at a difficulty tier."""
    tier = DIFFICULTY_TIERS[difficulty]
    index = _REGISTRY.index(character)
    return (_LOW_BASE + tier["low_spacing"] * (index % 7),
            _HIGH_BASE + tier["high_spacing"] * (index // 7))


def _confusable_neighbors(index: int) -> List[int]:
    """Registry indices adjacent to ``index`` in the tone grid: same high tone, one
    low-spacing step away (~2 mel bins at the hard tier); grid-row edges fall back to
    the adjacent high row. These are the characters a confusion burst mixes in."""
    row, col = divmod(index, 7)
    neighbors = []
    if col > 0:
        neighbors.append(index - 1)
    if col < 6 and index + 1 < len(_REGISTRY):
        neighbors.append(index + 1)
    if not neighbors:
        for other in (index - 7, index + 7):
            if 0 <= other < len(_REGISTRY):
                neighbors.append(other)
    return neighbors


# English-like vocabulary, including apostrophe words so the full a-z+' charset is voiced.
DEFAULT_VOCABULARY = (
    "the a of to and in is it he she they we you that this was for on are with his her "
    "as at be have from or had by word but not what all were when your can said there "
    "use an each which do how their if will up other about out many then them these so "
    "some would make like him into time has look two more write go see number way could "
    "people my than first water been call who oil its now find long down day did get "
    "come made may part over new sound take only little work know place year live me "
    "back give most very after thing our just name good sentence man think say great "
    "where help through much before line right too mean old any same tell boy follow "
    "came want show also around form three small set put end does another well large "
    "must big even such because turn here why ask went men read need land different "
    "home us move try kind hand picture again change off play spell air away animal "
    "house point page letter mother answer found study still learn should world "
    "don't isn't it's can't won't that's didn't doesn't wasn't couldn't").split()

GERMAN_EXTRA_VOCABULARY = (
    "über schön müde größe straße hören fähig wörter können müssen "
    "mädchen grün früh spät täglich").split()


def _markov_successors(vocabulary: Sequence[str], branching: int, seed: int
                       ) -> List[List[int]]:
    """A fixed successor list per word: sentences sampled from these chains have genuine
    bigram/trigram structure for the Kneser-Ney LM to learn."""
    rand = np.random.RandomState(seed)
    return [rand.choice(len(vocabulary), size=branching, replace=False).tolist()
            for _ in vocabulary]


def sample_sentence(rand: np.random.RandomState, vocabulary: Sequence[str],
                    successors: List[List[int]], word_count: int) -> str:
    word = int(rand.randint(len(vocabulary)))
    words = [vocabulary[word]]
    for _ in range(word_count - 1):
        word = successors[word][int(rand.randint(len(successors[word])))]
        words.append(vocabulary[word])
    return " ".join(words)


def _babble(length: int, voices: int, rand: np.random.RandomState,
            difficulty: str, sample_rate: int) -> np.ndarray:
    """Structured interference: ``voices`` background speakers uttering random
    characters from the same tone registry (re-voiced every ~0.2-0.4 s), so the noise
    occupies exactly the mel bands the classifier must read."""
    noise = np.zeros(length, np.float32)
    for _ in range(voices):
        warp = 1.0 + 0.12 * (2.0 * rand.rand() - 1.0)
        position = 0
        while position < length:
            span = int((0.2 + 0.2 * rand.rand()) * sample_rate)
            span = min(span, length - position)
            low, high = character_tones(
                _REGISTRY[int(rand.randint(len(_REGISTRY)))], difficulty)
            t = np.arange(span) / sample_rate
            tone = (np.sin(2 * np.pi * low * warp * t + 2 * np.pi * rand.rand())
                    + np.sin(2 * np.pi * high * warp * t + 2 * np.pi * rand.rand()))
            envelope = np.hanning(span) if span else np.ones(0)
            noise[position:position + span] += (tone * envelope).astype(np.float32)
            position += span
    return noise


def synthesize_utterance(text: str, rand: np.random.RandomState,
                         phone_duration_s: float = 0.09,
                         noise_level: Optional[float] = None,
                         sample_rate: int = SAMPLE_RATE,
                         difficulty: str = "standard") -> np.ndarray:
    """Render ``text`` as a tone sequence with speaker/phone/channel variability."""
    tier = DIFFICULTY_TIERS[difficulty]
    warp = 1.0 + tier["warp"] * (2.0 * rand.rand() - 1.0)   # per-"speaker" warp
    if noise_level is None:
        lo, hi = tier["noise_range"]
        noise_level = lo + (hi - lo) * rand.rand()
    amp_lo, amp_hi = tier["amplitude"]
    jitter = tier["duration_jitter"]
    burst_prob = tier.get("phone_burst_prob", 0.0)
    burst_level = tier.get("phone_burst_level", 0.0)
    confusion_prob = tier.get("phone_confusion_prob", 0.0)
    confusion_mix = tier.get("phone_confusion_mix", (0.0, 0.0))
    confusion_partner = tier.get("confusion_partner", "neighbor")
    # Per-utterance gate: most utterances stay burst-free so training sees mostly
    # clean gradients (unconditional bursts drove training over the memorize-vs-learn
    # cliff — see the tier comment).
    if rand.rand() >= tier.get("utterance_confusion_prob", 1.0):
        confusion_prob = 0.0
    segments = []
    for character in text:
        low, high = character_tones(character, difficulty)
        duration = phone_duration_s * (1.0 - jitter / 2 + jitter * rand.rand())
        t = np.arange(int(duration * sample_rate)) / sample_rate
        amplitude = amp_lo + (amp_hi - amp_lo) * rand.rand()
        tone = amplitude * (np.sin(2 * np.pi * low * warp * t + 2 * np.pi * rand.rand())
                            + np.sin(2 * np.pi * high * warp * t + 2 * np.pi * rand.rand()))
        # Per-PHONE noise bursts: with probability p this single character is buried
        # under strong noise (a click/cough/dropout analog) while its neighbors stay
        # clean — the isolated in-word corruption a word-LM beam can actually rescue
        # (per-utterance SNR alone makes whole utterances unreadable instead).
        if burst_prob and rand.rand() < burst_prob:
            tone = tone + burst_level * rand.randn(len(t))
        # Per-PHONE confusion bursts: mix in another character's tones at a ratio near
        # 0.5. The evidence is then genuinely consistent with TWO characters — no
        # amount of training disambiguates it — so greedy decoding argmaxes the wrong
        # one about half the time while the word-LM beam recovers it from context.
        # Spaces are excluded on both sides: a char<->space confusion corrupts the WORD
        # BOUNDARY ("number" -> "u ber"), and broken word structure is the one error
        # class a word-level LM cannot rescue (measured: space-involved bursts kept the
        # beam-vs-greedy gap at ~1.25x; in-word substitutions are the rescuable kind).
        if (confusion_prob and character != " "
                and rand.rand() < confusion_prob):
            index = _REGISTRY.index(character)
            if confusion_partner == "neighbor":
                candidates = _confusable_neighbors(index)
            else:  # "any": a far partner leaves neighbor decision margins unpoisoned
                # Partners come from the base a-z+' registry shared by every charset
                # (an umlaut partner in an English corpus would mix in tones that map
                # to no English character — a learnable noise burst, not a confusion),
                # minus the space (word-boundary corruption, see above).
                excluded = set(_confusable_neighbors(index)) | {index,
                                                               _REGISTRY.index(" ")}
                candidates = [i for i in range(28) if i not in excluded]
            other = _REGISTRY[candidates[int(rand.randint(len(candidates)))]]
            low2, high2 = character_tones(other, difficulty)
            tone2 = amplitude * (
                np.sin(2 * np.pi * low2 * warp * t + 2 * np.pi * rand.rand())
                + np.sin(2 * np.pi * high2 * warp * t + 2 * np.pi * rand.rand()))
            mix = confusion_mix[0] + (confusion_mix[1] - confusion_mix[0]) * rand.rand()
            tone = (1.0 - mix) * tone + mix * tone2
        envelope = np.hanning(len(t)) if len(t) else np.ones(0)
        segments.append((tone * envelope).astype(np.float32))
    audio = np.concatenate(segments) if segments else np.zeros(1, np.float32)
    # One random echo tap (crude room simulation).
    delay = int((0.02 + 0.04 * rand.rand()) * sample_rate)
    if len(audio) > delay:
        echoed = audio.copy()
        echoed[delay:] += 0.3 * audio[:-delay]
        audio = echoed
    if tier["babble_voices"]:
        audio = audio + (0.55 * noise_level) * _babble(
            len(audio), tier["babble_voices"], rand, difficulty, sample_rate)
    audio = audio + noise_level * rand.randn(len(audio)).astype(np.float32)
    # CTC/ASG feasibility floor: the model must emit at least one frame per grapheme
    # (plus a blank frame per adjacent repeat) at the frontend's 128-sample hop and the
    # net's stride-2, i.e. T' = samples/256 >= len(text) + repeats. The hard tier's wide
    # tempo jitter can otherwise render an utterance shorter than its own transcript
    # (observed: 3/1000 utterances with no valid alignment -> 1e30 losses); pad the tail
    # with the same noise floor up to the feasible minimum plus a safety margin.
    repeats = sum(1 for a, b in zip(text, text[1:]) if a == b)
    min_samples = (len(text) + repeats + 8) * 2 * 128
    if len(audio) < min_samples:
        tail = noise_level * rand.randn(min_samples - len(audio)).astype(np.float32)
        audio = np.concatenate([audio, tail])
    return np.clip(audio, -0.99, 0.99).astype(np.float32)


def generate_corpus(base_directory: Path,
                    corpus_name: str = "synthetic",
                    utterance_count: int = 1000,
                    speaker_count: int = 20,
                    min_duration_s: float = 2.0,
                    max_duration_s: float = 10.0,
                    characters: Optional[Sequence[str]] = None,
                    vocabulary: Optional[Sequence[str]] = None,
                    branching: int = 6,
                    seed: int = 0,
                    difficulty: str = "standard",
                    overwrite: bool = False) -> Path:
    """Write a LibriSpeech-layout synthetic corpus under ``base_directory/corpus_name``.

    Deterministic in ``seed``. Returns the corpus directory. Skips generation when the
    directory already holds the expected utterance count (unless ``overwrite``).
    ``difficulty`` selects a `DIFFICULTY_TIERS` entry ("hard" lands greedy decoding in
    a 5-15% LER band so beam/LM/transfer deltas stay measurable)."""
    from ..features.audio_io import write_wav

    corpus_directory = Path(base_directory) / corpus_name
    marker = corpus_directory / ".complete"
    # The marker records the FULL generation signature: a call with any different
    # parameter must regenerate, and regeneration wipes the tree so shrinking
    # utterance_count cannot leave stale wavs without transcript entries.
    # (difficulty joins the tuple only when non-standard, keeping round-2 markers valid;
    # the "v<n>" literal is the GENERATOR VERSION — bump it whenever synthesize_utterance
    # changes behavior without a tier-parameter change (v2: feasibility padding;
    # v3: space-excluded confusion bursts) — and the tier's parameter values join so
    # recalibrating a tier regenerates its corpora.)
    signature = str((utterance_count, speaker_count, min_duration_s, max_duration_s,
                     tuple(characters) if characters is not None else None,
                     tuple(vocabulary) if vocabulary is not None else None,
                     branching, seed)
                    + ((difficulty, "v3",
                        tuple(sorted(DIFFICULTY_TIERS[difficulty].items())))
                       if difficulty != "standard" else ()))
    if marker.exists() and not overwrite:
        if marker.read_text() == signature:
            log("Synthetic corpus {} already generated; reusing.".format(corpus_directory))
            return corpus_directory
    if corpus_directory.exists():
        import shutil
        shutil.rmtree(corpus_directory)
    if vocabulary is None:
        vocabulary = list(DEFAULT_VOCABULARY)
        if characters is not None and any(c in "äöüß" for c in characters):
            vocabulary += GERMAN_EXTRA_VOCABULARY
    if characters is not None:
        vocabulary = [w for w in vocabulary if all(c in characters for c in w)]
    successors = _markov_successors(vocabulary, branching, seed=seed + 1)
    rand = np.random.RandomState(seed)
    # Average seconds per character (phone 0.09 s avg incl. jitter) -> word budget.
    seconds_per_word = 0.09 * (np.mean([len(w) for w in vocabulary]) + 1)
    total_seconds = 0.0
    per_speaker = (utterance_count + speaker_count - 1) // speaker_count
    # The chapter field encodes the generation signature so example ids are unique
    # across tiers AND regenerations: the spectrogram cache is keyed by example id
    # within one Configuration (features/example.py:244), so a corpus variant reusing
    # ids would silently train on stale cached features paired with fresh transcripts
    # (standard chapter stays "1": round-2 corpora/caches remain valid).
    import zlib
    chapter = ("1" if difficulty == "standard"
               else format(zlib.crc32(signature.encode()), "08x"))
    for speaker in range(speaker_count):
        chapter_directory = (corpus_directory / "all" / str(speaker + 1) / chapter)
        mkdir(chapter_directory)
        lines = []
        for index in range(per_speaker):
            utterance = speaker * per_speaker + index
            if utterance >= utterance_count:
                break
            duration = min_duration_s + (max_duration_s - min_duration_s) * rand.rand()
            word_count = max(2, int(round(duration / seconds_per_word)))
            text = sample_sentence(rand, vocabulary, successors, word_count)
            audio = synthesize_utterance(text, rand, difficulty=difficulty)
            total_seconds += len(audio) / SAMPLE_RATE
            stem = "{}-{}-{:04d}".format(speaker + 1, chapter, utterance)
            write_wav(chapter_directory / (stem + ".wav"), audio, SAMPLE_RATE)
            lines.append("{} {}".format(stem, text.upper()))
        (chapter_directory / "{}-{}.trans.txt".format(speaker + 1, chapter)).write_text(
            "\n".join(lines) + "\n", encoding="utf8")
    marker.write_text(signature)
    log("Generated synthetic corpus: {} utterances, {:.1f} min of audio at {}.".format(
        utterance_count, total_seconds / 60.0, corpus_directory))
    return corpus_directory
